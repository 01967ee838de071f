"""The port's package boundaries: no JAX inside it, the card by default,
and a loud refusal of the paths that later slices port (the alpha
restart loop, big scenes without a BVH, the mesh sharding context)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu_torch.camera import make_camera
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.models.restir import init_state
from strolle_tpu_torch.ops.kernels import ref_kernel, trace_kernels
from strolle_tpu_torch.ops.trace import trace_surface
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.scene.demo import dungeon, dungeon_camera
from strolle_tpu_torch.scene.types import make_lights, make_materials

ROOT = Path(__file__).resolve().parents[1]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "strolle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    pkg = ROOT / "strolle_tpu_torch"
    for module in ("bvh/traverse.py", "ops/kernels/cluster_kernels.py",
                   "ops/kernels/bvh_kernels.py", "ops/trace.py"):
        assert pkg / module in files, module
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "strolle_tpu"), f"{path}: imports {mod}"


def test_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for call in (
        lambda: cornell_box(),
        lambda: cornell_camera(8, 8),
        lambda: make_camera([0, 0, 1], [0, 0, 0]),
        lambda: make_materials([{}]),
        lambda: make_lights([{}]),
        lambda: init_state(cornell_camera(8, 8, device="cpu")),
        lambda: dungeon(),
        lambda: dungeon_camera(8, 8),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_paths_raise():
    from strolle_tpu_torch.ops import trace as trace_mod
    from strolle_tpu_torch.scene.types import Geometry

    scene = cornell_box(device="cpu")
    cam = cornell_camera(4, 4, device="cpu")
    with pytest.raises(ValueError, match="megakernel"):
        trace_sample(scene, cam, 1, depth=1, include_sky=True, use_megakernel=True)
    # a big scene without a BVH (the JAX package's brute-force route for
    # it is not ported), and the alpha restart loop
    g = scene.geometry
    big = scene.replace(geometry=Geometry(
        *(torch.cat([getattr(g, f)] * 29) for f in ("positions", "normals", "uvs", "tangents",
                                                    "material_id"))))
    assert big.geometry.num_triangles > 1024
    for bad, match in ((big, "1024"), (scene.replace(has_alpha=True), "alpha")):
        for mk in (None, False):
            with pytest.raises(NotImplementedError, match=match):
                trace_sample(bad, cam, 1, depth=1, include_sky=False, use_megakernel=mk)
    o = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="1024"):
        trace_kernels.trace_closest_brute(torch.zeros(1032, 12), o, o)
    for strategy in ("stream", "cluster", "packet", "jnp"):
        trace_mod.BIG_SCENE_STRATEGY = strategy
        try:
            for use_pallas in (None, True, False):
                for bad in (big, scene.replace(has_alpha=True)):
                    with pytest.raises(NotImplementedError):
                        trace_surface(bad, o, o, use_pallas=use_pallas)
                    with pytest.raises(NotImplementedError):
                        trace_mod.trace_anyhit(bad, o, o, 1.0)
        finally:
            trace_mod.BIG_SCENE_STRATEGY = "stream"
    with pytest.raises(NotImplementedError, match="multi-device"):
        trace_mod.trace_rows_sharded(None)
    with pytest.raises(NotImplementedError, match="1024"):
        ref_kernel.trace_sample_megakernel(
            torch.zeros(1032, 24), torch.zeros(1, 12), torch.zeros(1, 13), 1,
            o, o, torch.zeros(4, dtype=torch.int64), depth=1,
        )


def test_wrappers_reject_bad_inputs():
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        trace_kernels.trace_closest_brute(torch.zeros(8, 9), o, o)
    with pytest.raises(TypeError):
        trace_kernels.trace_anyhit_brute(
            torch.zeros(8, 12, dtype=torch.float64), o, o, torch.ones(4)
        )
    with pytest.raises(TypeError, match="int64"):
        ref_kernel.trace_sample_megakernel(
            torch.zeros(8, 24), torch.zeros(1, 12), torch.zeros(1, 13), 1,
            o, o, torch.zeros(4, dtype=torch.int32), depth=1,
        )
    assert np.isfinite(trace_kernels.trace_closest_brute(torch.zeros(8, 12), o, o)[0].numpy()).sum() == 0

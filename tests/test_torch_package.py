"""The port's package boundaries: no JAX inside it, the card by default,
a loud refusal of what the port does not take (a scene the megakernel
refuses, over 1024 rows for it), and big scenes without a BVH traced
through kernels A and B as the JAX package traces them."""

import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.ops import trace as jax_trace
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu_torch import convert
from strolle_tpu_torch.camera import make_camera, pixel_rays, screen_grid
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
    files = sorted((ROOT / "strolle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "stream_turns.py"]
    assert len(files) > 10
    pkg = ROOT / "strolle_tpu_torch"
    for module in ("bvh/traverse.py", "ops/kernels/cluster_kernels.py",
                   "ops/kernels/bvh_kernels.py", "ops/trace.py",
                   "ops/kernels/probe_kernels.py", "models/heatmap.py",
                   "parallel/sharding.py", "parallel/frame_sharding.py",
                   "parallel/distributed.py", "entry.py", "examples/_common.py"):
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
    scene = cornell_box(device="cpu")
    cam = cornell_camera(4, 4, device="cpu")
    with pytest.raises(ValueError, match="megakernel"):
        trace_sample(scene, cam, 1, depth=1, include_sky=True, use_megakernel=True)
    o = torch.zeros(4, 3)
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


def _big_cornell():
    """Cornell's 36 triangles 29 times over (1,044, no BVH) in both
    packages: every triangle has 28 exact copies, so ties abound."""
    from strolle_tpu.scene.types import Geometry as JaxGeometry
    from torch_port_arrays import scene_arrays

    js = jax_cornell_box()
    g = js.geometry
    jbig = dataclasses.replace(js, geometry=JaxGeometry(
        *(jnp.concatenate([getattr(g, f)] * 29) for f in ("positions", "normals", "uvs",
                                                          "tangents", "material_id"))))
    return jbig, convert.scene_from_arrays(scene_arrays(jbig), device="cpu")


def test_big_scene_without_bvh_matches_jax():
    """A scene over 1024 triangles without a BVH: trace_closest and
    trace_anyhit take kernels A and B over all rows and trace_surface takes
    trace_closest + surface_at, as the JAX package's brute route does on
    the CPU; tri and occlusion exact, t/u/v within 1e-5. Kernel 4 and the
    megakernel keep their 1024-triangle gate."""
    from strolle_tpu_torch.ops.trace import trace_anyhit, trace_closest

    jbig, big = _big_cornell()
    assert big.geometry.num_triangles == 1044 and big.bvh is None
    # 16x16 primary rays and 16x16 rays from inside the box, one batch
    cam = cornell_camera(16, 16, device="cpu")
    po, pd = pixel_rays(cam, screen_grid(cam))
    rs = np.random.RandomState(2)
    ro = rs.uniform(-0.9, 0.9, (16, 16, 3)).astype(np.float32) + np.float32([0, 1, 0])
    rd = rs.normal(size=(16, 16, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    o, d = np.stack([po.numpy(), ro]), np.stack([pd.numpy(), rd])
    to, td = torch.tensor(o), torch.tensor(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    hit = trace_closest(big, to, td)
    want = jax.jit(jax_trace.trace_closest)(jbig, jo, jd)
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(want.tri))
    assert (hit.tri >= 0).float().mean() > 0.5
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(hit, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    # half the rays end before their closest hit
    scale = rs.uniform(0.5, 1.5, o.shape[:-1]).astype(np.float32)
    t_max = np.where(np.isfinite(hit.t.numpy()), hit.t.numpy() * scale, 1.0)
    occ = trace_anyhit(big, to, td, torch.tensor(t_max))
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jax.jit(jax_trace.trace_anyhit)(jbig, jo, jd, jnp.asarray(t_max))))
    assert 0 < occ.float().mean() < 1
    surf = trace_surface(big, to, td)
    jsurf = jax.jit(jax_trace.trace_surface)(jbig, jo, jd)
    for k in ("tri", "is_some", "material_id"):
        np.testing.assert_array_equal(getattr(surf, k).numpy(), np.asarray(getattr(jsurf, k)),
                                      err_msg=k)
    for k in ("point", "normal", "uv", "depth", "base_color"):
        np.testing.assert_allclose(getattr(surf, k).numpy(), np.asarray(getattr(jsurf, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    cam = cornell_camera(4, 4, device="cpu")
    for mk in (None, False):
        img = trace_sample(big, cam, 1, depth=1, include_sky=False, use_megakernel=mk)
        assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
    with pytest.raises(ValueError, match="megakernel"):
        trace_sample(big, cam, 1, depth=1, include_sky=False, use_megakernel=True)


#: JAX names whose port goes by another name or lives in another module:
#: (JAX module, name) -> (port module, name). The kernel entry points drop
#: their ``_pallas``; the stream kernels' per-tile lists are built per warp.
RENAMED = {
    ("ops/pallas/trace_kernels.py", "trace_closest_brute_pallas"):
        ("ops/kernels/trace_kernels.py", "trace_closest_brute"),
    ("ops/pallas/trace_kernels.py", "trace_anyhit_brute_pallas"):
        ("ops/kernels/trace_kernels.py", "trace_anyhit_brute"),
    ("ops/pallas/trace_kernels.py", "trace_surface_pallas"):
        ("ops/kernels/trace_kernels.py", "trace_surface"),
    ("ops/pallas/stream_kernels.py", "stream_trace_surface_pallas"):
        ("ops/kernels/stream_kernels.py", "stream_trace_surface"),
    ("ops/pallas/stream_kernels.py", "stream_trace_anyhit_pallas"):
        ("ops/kernels/stream_kernels.py", "stream_trace_anyhit"),
    ("ops/pallas/stream_kernels.py", "cull_lists"): ("ops/kernels/stream_kernels.py", "warp_lists"),
    ("ops/pallas/cluster_kernels.py", "cluster_trace_surface_pallas"):
        ("ops/kernels/cluster_kernels.py", "cluster_trace_surface"),
    ("ops/pallas/cluster_kernels.py", "cluster_trace_anyhit_pallas"):
        ("ops/kernels/cluster_kernels.py", "cluster_trace_anyhit"),
    ("ops/pallas/bvh_kernels.py", "bvh_trace_surface_pallas"):
        ("ops/kernels/bvh_kernels.py", "bvh_trace_surface"),
    ("ops/pallas/bvh_kernels.py", "bvh_trace_anyhit_pallas"):
        ("ops/kernels/bvh_kernels.py", "bvh_trace_anyhit"),
    ("ops/pallas/probe_kernels.py", "probe_spatial_pallas"):
        ("ops/kernels/probe_kernels.py", "probe_spatial"),
    # the DTensor placements live beside the frame split that takes them
    ("parallel/distributed.py", "replicated"): ("parallel/frame_sharding.py", "replicated"),
    ("parallel/distributed.py", "row_sharding"): ("parallel/frame_sharding.py", "row_sharding"),
}

#: JAX names with no port, and why none is needed.
JAX_ONLY = {
    # registers frozen dataclasses as JAX pytrees; the port's dataclasses
    # are walked by utils/pytree.py's tree_map instead
    ("utils/pytree.py", "pytree_dataclass"),
    ("utils/pytree.py", "static"),
    # the TPU kernels' DMA layout (four 32-float records to a 128-lane
    # row); the CUDA kernels read the [T', 28] rows with 16-byte loads
    ("ops/pallas/stream_kernels.py", "pack4_rows"),
}


def _port_module(rel: str) -> str:
    """The port module that holds a JAX module's names."""
    if rel == "native/__init__.py":
        return "native.py"
    return rel.replace("ops/pallas/", "ops/kernels/", 1)


def _public_names(path: Path) -> set:
    """Public top-level functions and classes."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@functools.cache
def _bound_names(path: Path) -> set:
    """Every name a module binds at its top level: definitions,
    assignments and imports (a name re-exported from another port module
    is there)."""
    out = set()
    for n in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def test_every_public_jax_name_has_a_port():
    """Every public top-level function or class of every module of the JAX
    package is bound in the matching port module (``ops/pallas/`` maps to
    ``ops/kernels/``, ``native/__init__.py`` to ``native.py``), under the
    same name or as ``RENAMED`` says, unless ``JAX_ONLY`` lists it; both
    tables name only what is there."""
    jax_root, port_root = ROOT / "strolle_tpu", ROOT / "strolle_tpu_torch"
    missing, seen = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        for name in sorted(_public_names(path)):
            seen.add((rel, name))
            if (rel, name) in JAX_ONLY:
                continue
            mod, port_name = RENAMED.get((rel, name), (_port_module(rel), name))
            port = port_root / mod
            if not port.exists() or port_name not in _bound_names(port):
                missing.append(f"{rel}::{name} -> {mod}::{port_name}")
    assert not missing, missing
    assert set(RENAMED) | JAX_ONLY <= seen
    for rel, name in JAX_ONLY:
        assert name not in _bound_names(port_root / _port_module(rel)), (rel, name)

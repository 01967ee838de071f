"""The port's package boundaries: no JAX inside it, the card by default,
and a loud refusal of the paths that later slices port."""

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
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_paths_raise():
    scene = cornell_box(device="cpu")
    cam = cornell_camera(4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="sky"):
        trace_sample(scene, cam, 1, depth=1, include_sky=True)
    for bad in (scene.replace(has_alpha=True), scene.replace(atlas=torch.zeros(4, 4, 4))):
        for mk in (None, False):
            with pytest.raises(NotImplementedError):
                trace_sample(bad, cam, 1, depth=1, include_sky=False, use_megakernel=mk)
    o = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError, match="1024"):
        trace_kernels.trace_closest_brute(torch.zeros(1032, 12), o, o)
    for use_pallas in (None, True, False):
        for bad in (scene.replace(has_alpha=True), scene.replace(atlas=torch.zeros(4, 4, 4))):
            with pytest.raises(NotImplementedError):
                trace_surface(bad, o, o, use_pallas=use_pallas)
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

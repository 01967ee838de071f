"""Builds the port's CUDA kernels and binds them through ctypes.

Every ``csrc/*.cu`` file goes into ONE ``nvcc`` command that produces
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library is built at first use into
``strolle_tpu_torch/_build/`` under a name that hashes the sources and
flags, so an edited source is never served by a stale build. Nothing is
built or imported from CUDA when this module is imported.

Each C entry point launches on the stream it is given and returns the
``cudaError_t`` of the launch; ``check`` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: ``--fmad=false`` keeps every multiply and add separately rounded, as
#: PyTorch's one-op-per-kernel plain versions are, so a kernel can be
#: held to its plain version at a tight tolerance (and ray-triangle
#: edge decisions do not flip between the two). It costs the kernels
#: their fused multiply-adds. No --use_fast_math: its approximate
#: sin/cos/division would flip branches at triangle edges.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

#: Launch counts of each kernel, incremented by its wrapper right where
#: it launches the kernel and nowhere else.
LAUNCHES: dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rows, n_rows, o, d, n_rays, t, tri, u, v, stream
    "strolle_trace_closest_brute": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    # rows, n_rows, o, d, t_max, n_rays, occluded, stream
    "strolle_trace_anyhit_brute": [_P, _I, _P, _P, _P, _I, _P, _P],
    # rows, n_rows, o, d, n_rays, t, tri, u, v, normal, uv, mat, stream
    "strolle_trace_surface": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # tris, n_tris, mats, n_mats, lights, n_lights, lcount, o, d, state0,
    # n_rays, depth, flat, no_metal, out, stream
    "strolle_trace_sample_megakernel": [
        _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P,
    ],
}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compiles all kernel sources with one nvcc command; returns the
    path of the shared library (reused when it already exists)."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libstrolle_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (BUILD_DIR / "nvcc.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized
    int. The caller launches with ``device`` as the current device."""
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_tensors(name: str, *tensors: torch.Tensor) -> None:
    """Validates the tensors handed to a kernel: all on one CUDA device,
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")

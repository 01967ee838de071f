"""Builds the port's CUDA kernels and binds them through ctypes.

Every ``csrc/*.cu`` file goes into ONE ``nvcc`` command that produces
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library is built at first use into
``strolle_tpu_torch/_build/`` under a name that hashes the sources and
flags, so an edited source is never served by a stale build. Nothing is
built or imported from CUDA when this module is imported.

Each C entry point launches on the stream it is given and returns the
``cudaError_t`` of the launch; ``check`` turns a non-zero code into an
exception. ``check_walk_inputs``, ``launch_walk``, ``surface_outputs``
and ``surface_dict`` are the plumbing the walking kernels' wrappers
(stream, cluster and BVH: kernels 5, 6 and 8-11) share.
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
_U = ctypes.c_uint32
_F = ctypes.c_float
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
    # clus, subs, n_clusters, list_cap, rows, n_rows, o, d, tcap, n_rays, t,
    # tri, u, v, work (NULL: the timed variant), stream
    "strolle_stream_trace_surface": [
        _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
    ],
    # clus, subs, n_clusters, list_cap, rows, n_rows, o, d, t_max, n_rays,
    # occluded, work, stream
    "strolle_stream_trace_anyhit": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    # clus, n_clusters, list_cap, rows, n_rows, o, d, n_rays, t, tri, normal,
    # uv, mat, work (NULL: the timed variant), stream
    "strolle_cluster_trace_surface": [
        _P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
    ],
    # clus, n_clusters, list_cap, rows, n_rows, o, d, t_max, n_rays, occluded,
    # work, stream
    "strolle_cluster_trace_anyhit": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    # nodes, rows, o, d, n_rays, t, tri, normal, uv, mat, work, stream
    "strolle_bvh_trace_surface": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # nodes, rows, o, d, t_max, n_rays, occluded, work, stream
    "strolle_bvh_trace_anyhit": [_P, _P, _P, _P, _P, _I, _P, _P, _P],
    # stack, h, w, dy, dx, seed, gi, tries, n_var, n_lvls, depth_tol,
    # normal_min, j_lo, j_hi, c_lo, c_hi, oy, ox, found, jac (NULL in DI
    # mode), stream
    "strolle_probe_spatial": [
        _P, _I, _I, _P, _P, _U, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P,
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


#: Width of a ``trace_kernels.pack_geometry`` row, the triangle rows the
#: walking kernels read.
GEOM_ROW_WIDTH = 28


def check_walk_inputs(name, table, width, geom_rows, o, d):
    """Shapes, types and devices a walking kernel's wrapper takes:
    ``table`` [N, width] (cluster or node rows), [T', 28] rows, o/d
    [..., 3] of one shape, all float32 on the CPU or a CUDA card."""
    if table.ndim != 2 or table.shape[1] != width:
        raise ValueError(f"{name}: expected [N, {width}] rows, got {tuple(table.shape)}")
    if geom_rows.ndim != 2 or geom_rows.shape[1] != GEOM_ROW_WIDTH:
        raise ValueError(
            f"{name}: rows must be [T, {GEOM_ROW_WIDTH}], got {tuple(geom_rows.shape)}"
        )
    if o.shape != d.shape or o.shape[-1] != 3:
        raise ValueError(f"{name}: o/d must be [..., 3] of one shape")
    for t in (table, geom_rows, o, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {o.device}")


def launch_walk(entry: str, head: tuple, o, d, ray_arg, outs, work) -> None:
    """One launch of a walking kernel on CUDA tensors. The C entry takes
    ``head`` (its tables, as pointers, and their sizes), o, d, ``ray_arg``
    (the scene-box cap or t_max; None where it takes neither), the ray
    count, ``outs``, the optional [R, 2] int32 ``work`` counts (NULL: the
    timed variant) and the stream."""
    if o.device.type != "cuda":
        raise ValueError(f"{entry}: the kernel takes CUDA tensors, got {o.device}")
    n = o.numel() // 3
    if work is not None and (work.dtype != torch.int32 or tuple(work.shape) != (n, 2)):
        raise ValueError(f"{entry}: work must be int32 [{n}, 2]")
    tables = tuple(x for x in head if isinstance(x, torch.Tensor))
    extra = () if ray_arg is None else (ray_arg,)
    check_tensors(entry, *tables, o, d, *extra, *outs, *(() if work is None else (work,)))
    lib = library()
    if n == 0:
        return
    with torch.cuda.device(o.device):
        err = getattr(lib, entry)(
            *(x.data_ptr() if isinstance(x, torch.Tensor) else x for x in head),
            o.data_ptr(), d.data_ptr(), *(x.data_ptr() for x in extra), n,
            *(x.data_ptr() for x in outs), None if work is None else work.data_ptr(),
            stream(o.device),
        )
    check(entry, err)


def surface_outputs(batch, device):
    """Empty (t, tri, normal, uv, mat_id) of a resolving surface kernel (8, 10)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.empty(batch, **f32), torch.empty(batch, **i32), torch.empty(batch + (3,), **f32),
            torch.empty(batch + (2,), **f32), torch.empty(batch, **i32))


def surface_dict(t, tri, normal, uv, mat) -> dict:
    """A resolving surface kernel's outputs as the JAX package returns them."""
    hit = tri >= 0
    return {"t": t, "hit": hit, "normal": normal, "uv": uv, "mat_id": mat,
            "tri": torch.where(hit, tri, -1)}

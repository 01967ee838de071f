"""Brute-force closest-hit and any-hit kernels (port of
strolle_tpu/ops/pallas/trace_kernels.py: ``trace_closest_brute_pallas``
and ``trace_anyhit_brute_pallas``).

Triangles are packed [T, 12] rows: v0(3), e1(3), e2(3), pad(3). The
CUDA kernels are in ``csrc/trace_kernels.cu``; each wrapper below runs
its plain PyTorch version for CPU tensors and launches the kernel for
CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..intersect import ray_triangle_edges
from . import cuda_lib

#: Most triangles the brute-force kernels take (and the most the JAX
#: package sends to them).
MAX_TRIS = 1024
#: Triangles per vectorised step of the plain versions.
PLAIN_CHUNK = 128


def pack_triangles(positions: torch.Tensor) -> torch.Tensor:
    """[T, 3, 3] vertices -> [T, 12] (v0, e1, e2, pad) rows."""
    v0 = positions[:, 0]
    e1 = positions[:, 1] - v0
    e2 = positions[:, 2] - v0
    pad = torch.zeros_like(v0)
    return torch.cat([v0, e1, e2, pad], dim=-1)


def _row_isect(rows: torch.Tensor, of: torch.Tensor, df: torch.Tensor):
    """Rays [R, 1, 3] against a block of rows [C, 12] -> [R, C]."""
    return ray_triangle_edges(of, df, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])


def trace_closest_brute_plain(rows, o, d, chunk: int = PLAIN_CHUNK):
    """Plain version of kernel A: the closest hit over all rows, the
    lowest index winning ties (strict ``<`` in ascending order; argmin
    returns the first minimum). Returns (t, tri, u, v) over o's batch
    shape; t = +inf and tri = -1 on a miss."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 1, 3)
    df = d.reshape(-1, 1, 3)
    r = of.shape[0]
    bt = torch.full((r,), math.inf, dtype=torch.float32, device=o.device)
    btri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros((r,), dtype=torch.float32, device=o.device)
    bv = torch.zeros_like(bu)
    for c0 in range(0, rows.shape[0], chunk):
        t, u, v, _ = _row_isect(rows[c0 : c0 + chunk], of, df)
        j = torch.argmin(t, dim=-1, keepdim=True)
        tj = t.gather(-1, j)[:, 0]
        better = tj < bt
        bt = torch.where(better, tj, bt)
        btri = torch.where(better, (j[:, 0] + c0).to(torch.int32), btri)
        bu = torch.where(better, u.gather(-1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(-1, j)[:, 0], bv)
    return bt.reshape(batch), btri.reshape(batch), bu.reshape(batch), bv.reshape(batch)


def trace_anyhit_brute_plain(rows, o, d, t_max, chunk: int = PLAIN_CHUNK):
    """Plain version of kernel B: True where any row is hit at t < t_max."""
    batch = o.shape[:-1]
    of = o.reshape(-1, 1, 3)
    df = d.reshape(-1, 1, 3)
    tm = torch.broadcast_to(t_max, batch).reshape(-1, 1)
    occ = torch.zeros((of.shape[0],), dtype=torch.bool, device=o.device)
    for c0 in range(0, rows.shape[0], chunk):
        t, _, _, _ = _row_isect(rows[c0 : c0 + chunk], of, df)
        occ = occ | torch.any(t < tm, dim=-1)
    return occ.reshape(batch)


def _check_inputs(name: str, rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    if rows.ndim != 2 or rows.shape[1] != 12:
        raise ValueError(f"{name}: rows must be [T, 12], got {tuple(rows.shape)}")
    if rows.shape[0] > MAX_TRIS:
        raise NotImplementedError(
            f"{name}: {rows.shape[0]} triangles > {MAX_TRIS}; big scenes take "
            "the stream kernels, ported in slice 3"
        )
    if o.shape != d.shape or o.shape[-1] != 3:
        raise ValueError(f"{name}: o/d must be [..., 3] of one shape")
    for t in (rows, o, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows.device}")


def trace_closest_brute(rows, o, d):
    """Closest hit of rays o/d [..., 3] against packed rows [T, 12].
    Returns (t, tri, u, v) over o's batch shape. CPU tensors run the
    plain version; CUDA tensors launch kernel A."""
    _check_inputs("trace_closest_brute", rows, o, d)
    if rows.device.type == "cpu":
        return trace_closest_brute_plain(rows, o, d)
    cuda_lib.check_tensors("trace_closest_brute", rows, o, d)
    lib = cuda_lib.library()
    batch = o.shape[:-1]
    n = o.numel() // 3
    dev = o.device
    t = torch.empty(batch, dtype=torch.float32, device=dev)
    tri = torch.empty(batch, dtype=torch.int32, device=dev)
    u = torch.empty(batch, dtype=torch.float32, device=dev)
    v = torch.empty(batch, dtype=torch.float32, device=dev)
    if n == 0:
        return t, tri, u, v
    with torch.cuda.device(dev):
        err = lib.strolle_trace_closest_brute(
            rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(), n,
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            cuda_lib.stream(dev),
        )
    cuda_lib.check("trace_closest_brute", err)
    cuda_lib.count_launch("trace_closest_brute")
    return t, tri, u, v


def trace_anyhit_brute(rows, o, d, t_max):
    """Occlusion flag of rays o/d [..., 3] against packed rows [T, 12]:
    True where any triangle is hit at t < t_max. CPU tensors run the
    plain version; CUDA tensors launch kernel B."""
    _check_inputs("trace_anyhit_brute", rows, o, d)
    if rows.device.type == "cpu":
        return trace_anyhit_brute_plain(rows, o, d, t_max)
    batch = o.shape[:-1]
    t_max = torch.broadcast_to(t_max.to(torch.float32), batch).contiguous()
    cuda_lib.check_tensors("trace_anyhit_brute", rows, o, d, t_max)
    lib = cuda_lib.library()
    n = o.numel() // 3
    dev = o.device
    occ = torch.empty(batch, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev):
        err = lib.strolle_trace_anyhit_brute(
            rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), n, occ.data_ptr(), cuda_lib.stream(dev),
        )
    cuda_lib.check("trace_anyhit_brute", err)
    cuda_lib.count_launch("trace_anyhit_brute")
    return occ

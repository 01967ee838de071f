"""Brute-force closest-hit, any-hit and surface kernels (port of
strolle_tpu/ops/pallas/trace_kernels.py: ``trace_closest_brute_pallas``,
``trace_anyhit_brute_pallas`` and ``trace_surface_pallas``).

Triangles are packed [T, 12] rows: v0(3), e1(3), e2(3), pad(3) for the
closest- and any-hit kernels, and [T, 28] rows (``pack_geometry``) for
the surface kernel. The CUDA kernels are in ``csrc/trace_kernels.cu``;
each wrapper below runs its plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from ..intersect import fma_cross, fma_dot, ray_triangle_edges
from . import cuda_lib

#: Most triangles kernel 4 and the megakernel take, as the JAX package
#: routes them; kernels A and B take any number.
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


def pack_geometry(geom) -> torch.Tensor:
    """Geometry -> [T, 28] rows for the surface kernel: v0(3) e1(3) e2(3)
    n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) material id(1) pad(3)."""
    p = geom.positions
    v0 = p[:, 0]
    cols = [
        v0, p[:, 1] - v0, p[:, 2] - v0,
        geom.normals[:, 0], geom.normals[:, 1], geom.normals[:, 2],
        geom.uvs[:, 0], geom.uvs[:, 1], geom.uvs[:, 2],
        geom.material_id.to(torch.float32)[:, None],
        torch.zeros((p.shape[0], 3), dtype=torch.float32, device=p.device),
    ]
    return torch.cat(cols, dim=-1)


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


def resolve_winner(rows, d, tri, u, v):
    """The winner's attributes from its [28] row, as kernels 4, 8 and 10
    resolve them: the interpolated normal, flipped by the sign of the
    Möller-Trumbore determinant and normalised by 1 / sqrt(max(|n|^2,
    1e-20)), the interpolated uv and the material id; zeros where tri < 0.
    Returns (normal [..., 3], uv [..., 2], mat_id)."""
    r = rows[torch.clamp(tri, min=0).long()]  # [..., 28]
    some = (tri >= 0)[..., None]
    det = fma_dot(r[..., 3:6], fma_cross(d, r[..., 6:9]))
    dsign = torch.where(det >= 0.0, 1.0, -1.0)[..., None]
    bu = u[..., None]
    bv = v[..., None]
    w = 1.0 - bu - bv
    n = w * r[..., 9:12] + bu * r[..., 12:15] + bv * r[..., 15:18]
    n2 = n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2]
    # a correctly rounded sqrt and division on both devices (the CUDA
    # kernels do the same), where the JAX kernels take rsqrt
    flip = dsign * (1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)))[..., None]
    uv = w * r[..., 18:20] + bu * r[..., 20:22] + bv * r[..., 22:24]
    return (torch.where(some, n * flip, 0.0), torch.where(some, uv, 0.0),
            torch.where(some[..., 0], r[..., 24].to(torch.int32), 0))


def trace_surface_plain(rows, o, d, chunk: int = PLAIN_CHUNK) -> dict:
    """Plain version of kernel 4: kernel A's closest hit over the [T, 28]
    rows, then the winner's attributes (``resolve_winner``). A miss gives
    t = +inf, tri = -1 and zeros."""
    t, tri, u, v = trace_closest_brute_plain(rows[:, :12], o, d, chunk)
    normal, uv, mat_id = resolve_winner(rows, d, tri, u, v)
    return {"t": t, "tri": tri, "u": u, "v": v, "normal": normal, "uv": uv, "mat_id": mat_id}


def _check_inputs(name: str, rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                  width: int = 12):
    if rows.ndim != 2 or rows.shape[1] != width:
        raise ValueError(f"{name}: rows must be [T, {width}], got {tuple(rows.shape)}")
    if o.shape != d.shape or o.shape[-1] != 3:
        raise ValueError(f"{name}: o/d must be [..., 3] of one shape")
    for t in (rows, o, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows.device}")


def trace_closest_brute(rows, o, d):
    """Closest hit of rays o/d [..., 3] against packed rows [T, 12], any T.
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
    """Occlusion flag of rays o/d [..., 3] against packed rows [T, 12], any
    T: True where any triangle is hit at t < t_max. CPU tensors run the
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


def trace_surface(rows, o, d) -> dict:
    """Closest hit of rays o/d [..., 3] against [T, 28] pack_geometry
    rows, with the winner's attributes resolved: a dict of t, tri, u, v,
    normal [..., 3], uv [..., 2] and mat_id over o's batch shape. CPU
    tensors run the plain version; CUDA tensors launch kernel 4."""
    _check_inputs("trace_surface", rows, o, d, width=28)
    if rows.shape[0] > MAX_TRIS:
        raise NotImplementedError(
            f"trace_surface: {rows.shape[0]} triangles > {MAX_TRIS}; big scenes take "
            "trace_closest + surface_at or the big-scene kernels"
        )
    if rows.device.type == "cpu":
        return trace_surface_plain(rows, o, d)
    cuda_lib.check_tensors("trace_surface", rows, o, d)
    lib = cuda_lib.library()
    batch = o.shape[:-1]
    n = o.numel() // 3
    dev = o.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(batch + shape, dtype=dtype, device=dev)

    out = {
        "t": empty(), "tri": empty(dtype=torch.int32), "u": empty(), "v": empty(),
        "normal": empty(3), "uv": empty(2), "mat_id": empty(dtype=torch.int32),
    }
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.strolle_trace_surface(
            rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(), n,
            *(out[k].data_ptr() for k in ("t", "tri", "u", "v", "normal", "uv", "mat_id")),
            cuda_lib.stream(dev),
        )
    cuda_lib.check("trace_surface", err)
    cuda_lib.count_launch("trace_surface")
    return out

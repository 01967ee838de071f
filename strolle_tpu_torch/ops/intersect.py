"""Ray-triangle intersection (port of strolle_tpu/ops/intersect.py)."""

from __future__ import annotations

import math

import torch

from . import math as vm

F32_EPS = 1.1920929e-07


def ray_triangle(o, d, v0, v1, v2):
    """Möller-Trumbore. All inputs broadcastable [..., 3].

    Returns (t, u, v, det): a hit needs ``u in [0,1]``, ``v >= 0``,
    ``u+v <= 1``, ``t > 0`` and ``|det| >= eps``; misses get t = +inf.
    ``det`` lets callers apply the normal flip ``copysign(1, det)``.
    """
    return ray_triangle_edges(o, d, v0, v1 - v0, v2 - v0)


def fma(a, b, c):
    """float32 a * b + c with one rounding, as a fused multiply-add (the
    exact product and the sum are formed in float64; a result that double
    rounding could move lies within 2^-29 of a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def fma_dot(a, b):
    """Dot product over the last axis as XLA:CPU compiles ``sum(a * b)``:
    fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def fma_cross(a, b):
    """Cross product as XLA:CPU compiles ``a1 * b2 - a2 * b1``:
    fma(a1, b2, -(a2 * b1)) per component."""
    return torch.stack(
        [
            fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )


def ray_triangle_edges(o, d, v0, e1, e2):
    """Möller-Trumbore on a triangle given as v0 and its edges
    e1 = v1 - v0, e2 = v2 - v0 (the packed [T, 12] rows).

    The products and sums round as the JAX package's do on the CPU,
    where XLA fuses them into multiply-adds (``fma_dot``, ``fma_cross``),
    and as the CUDA kernels do with explicit ``fmaf``. A ray that meets
    two coplanar triangles at one distance then picks the same triangle
    in all three.
    """
    pvec = fma_cross(d, e2)
    det = fma_dot(e1, pvec)
    inv_det = torch.where(
        torch.abs(det) < F32_EPS, 0.0, 1.0 / torch.where(det == 0, 1.0, det)
    )
    tvec = o - v0
    u = fma_dot(tvec, pvec) * inv_det
    qvec = fma_cross(tvec, e1)
    v = fma_dot(d, qvec) * inv_det
    t = fma_dot(e2, qvec) * inv_det
    valid = (
        (torch.abs(det) >= F32_EPS)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    return torch.where(valid, t, math.inf), u, v, det


def ray_sphere(o, d, center, radius):
    """Smallest positive t of the ray against a sphere, or +inf."""
    oc = o - center
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - c
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    return torch.where((disc >= 0.0) & (t > 0.0), t, math.inf)

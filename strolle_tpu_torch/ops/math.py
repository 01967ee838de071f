"""Vector math over trailing-axis-3 tensors (port of strolle_tpu/ops/math.py).

Dot products are written out component by component, left to right, so
the rounding is the same as the CUDA kernels' ``a.x*b.x + a.y*b.y +
a.z*b.z``.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis, keeps no dims."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dotk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product with the last axis kept (for broadcasting)."""
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(a: torch.Tensor) -> torch.Tensor:
    """Vector length; 0 for the zero vector (no NaN through sqrt(0))."""
    n2 = dot(a, a)
    pos = n2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: the zero vector stays near zero instead of NaN."""
    return a * torch.rsqrt(torch.clamp(dotk(a, a), min=eps))


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect incident vector ``i`` about normal ``n`` (GLSL convention)."""
    return i - 2.0 * dotk(i, n) * n


def copysign1(x: torch.Tensor) -> torch.Tensor:
    """+1.0 where x >= 0 else -1.0 (a sign that is never 0)."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def any_orthonormal_pair(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branch-free orthonormal basis around unit vector ``n`` (Duff et
    al., "Building an Orthonormal Basis, Revisited", JCGT 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def sqr(x: torch.Tensor) -> torch.Tensor:
    return x * x


def lerp(a, b, t):
    return a + (b - a) * t


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 relative luminance."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def perc_luma(rgb: torch.Tensor) -> torch.Tensor:
    """Perceptual luminance, sqrt(luma); 0 for black."""
    lum = luma(rgb)
    pos = lum > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, lum, 1.0)), 0.0)


def with_luma(rgb: torch.Tensor, new_luma: torch.Tensor) -> torch.Tensor:
    """``rgb`` scaled to luma ``new_luma``; black stays black."""
    old = luma(rgb)
    scale = torch.where(old > 0.0, new_luma / torch.clamp(old, min=1e-20), 0.0)
    return rgb * scale[..., None]


def octahedral_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    s = torch.sum(torch.abs(n), dim=-1, keepdim=True)
    v = n / torch.clamp(s, min=1e-20)
    xy = v[..., :2]
    flipped = (1.0 - torch.abs(xy.flip(-1))) * torch.where(xy >= 0.0, 1.0, -1.0)
    return torch.where(v[..., 2:3] >= 0.0, xy, flipped)


def octahedral_decode(e: torch.Tensor) -> torch.Tensor:
    """Octahedral [..., 2] -> unit vector [..., 3]."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    t = torch.clamp(-z, min=0.0)
    x = x - torch.where(x >= 0.0, t, -t)
    y = y - torch.where(y >= 0.0, t, -t)
    return normalize(torch.stack([x, y, z], dim=-1))

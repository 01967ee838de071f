"""Texture-atlas sampling, bilinear with UV repeat (port of
strolle_tpu/ops/texture.py).

An all-zero atlas rect means "untextured: use the multiplier"; otherwise
the atlas is sampled at ``rect.xy + wrap(uv) * rect.zw`` and multiplies
it. Texels are RGBA8, as in the reference's atlas: each texel and its
x+1, y+1 and x+1,y+1 neighbours (clamped at the atlas edge) are packed
into one row of four 32-bit words, so a bilinear fetch is one gather.
Torch on the CPU has no shift for uint32, so the words are packed in
int64 masked to 32 bits and stored as int32 with the same bits; unpacking
shifts and masks each byte.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _wrap(t: torch.Tensor) -> torch.Tensor:
    """UV repeat-wrap: frac(t) for t > 0, else 1 - frac(-t)."""
    pos = torch.remainder(t, 1.0)
    neg = 1.0 - torch.remainder(-t, 1.0)
    return torch.where(t > 0.0, pos, neg)


def packed_corner_matrix(image: torch.Tensor) -> torch.Tensor:
    """[A*A, 4] int32 rows: the texel and its clamp-shifted x+1 / y+1 /
    x+1,y+1 neighbours, each RGBA8-packed (R in the low byte). The table
    is made from the detached image and carries no gradient, as the JAX
    package's (nothing differentiates with respect to atlas texels)."""
    h, w = image.shape[0], image.shape[1]
    q = torch.round(torch.clamp(image.detach(), 0.0, 1.0) * 255.0).to(torch.int64)
    p = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)) & MASK32
    p = torch.where(p >= 2**31, p - 2**32, p).to(torch.int32)
    sx = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    sy = torch.cat([p[1:], p[-1:]], dim=0)
    sxy = torch.cat([sy[:, 1:], sy[:, -1:]], dim=1)
    return torch.stack([p, sx, sy, sxy], dim=-1).reshape(h * w, 4)


def _unpack_rgba8(u: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [((u >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16, 24)], dim=-1
    ) * (1.0 / 255.0)


def sample_atlas_bilinear(atlas, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from ``atlas`` (scene.types.Atlas, image [A, A, 4])
    at normalised uv [..., 2]: one gather of the packed corner table at
    the floor corner. Gradients flow through the blend weights (uv) only:
    the corner table is integer texels made from the detached image."""
    h, w = atlas.image.shape[0], atlas.image.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = torch.clamp(x0.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y0.to(torch.int64), 0, h - 1)
    g = atlas.corners[(yi * w + xi).reshape(-1)].reshape(xi.shape + (4,))
    c00, c10, c01, c11 = (_unpack_rgba8(g[..., i]) for i in range(4))
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_material_channel(scene, multiplier, rect, uv, enabled: bool = True):
    """multiplier if rect == 0 else multiplier * atlas(rect.xy + wrap(uv) * rect.zw).
    ``enabled=False`` (``Materials.tex_channels``) skips the fetch for a
    channel no material textures."""
    if scene.atlas is None or not enabled:
        return multiplier
    textured = torch.any(rect != 0.0, dim=-1, keepdim=True)
    auv = rect[..., 0:2] + _wrap(uv) * rect[..., 2:4]
    texel = sample_atlas_bilinear(scene.atlas, auv)
    return torch.where(textured, multiplier * texel, multiplier)

"""Shared-offset spatial probing (port of strolle_tpu/ops/offsets.py).

Each spatial-resampling try draws a small table of shared disk offsets
(one per radius level x direction variant); every pixel picks an entry
(its adaptive radius level + a random variant) and fetches its neighbour
there, mirrored at the screen edges like ``camera.contain_xy``. The JAX
package fetches through dynamically sliced copies of a mirror-padded
field stack, because its vector unit cannot gather; on the GPU the
fetch is a direct gather at the mirrored coordinate, which gives the
same values (the offsets never exceed the pad margin, and the pad is
the contain_xy mirror).
"""

from __future__ import annotations

import functools

import torch

from . import rng


def mirror_pad(a: torch.Tensor, m: int) -> torch.Tensor:
    """Pad [H, W] (or [C, H, W] on the last two dims) by ``m`` with the
    contain_xy mirror rule: low edge index -k -> k, high edge n + k ->
    n - 1 - k. Requires m < dim."""

    def pad_axis(x, ax):
        n = x.shape[ax]
        lo = x.narrow(ax, 1, m).flip(ax)
        hi = x.narrow(ax, n - m, m).flip(ax)
        return torch.cat([lo, x, hi], dim=ax)

    return pad_axis(pad_axis(a, a.ndim - 2), a.ndim - 1)


def draw_offset_table(seed: int, radii, variants: int, margin: int | None = None,
                      device=None):
    """``len(radii) * variants`` shared disk offsets: entry
    ``l * variants + j`` is a uniform-disk sample of radius ``radii[l]``
    truncated to integer pixels (and clipped to ``margin``). Returns
    (dy, dx), two int32 [V] tensors."""
    v = len(radii) * variants
    k = torch.arange(v, dtype=torch.int64, device=device)
    lvl = k // variants
    state = rng.wnoise_new(seed, k, lvl)
    state, disk = rng.sample_disk(state)
    r = _radii_table(tuple(radii), str(torch.device(device or "cpu")))[lvl]
    dx = (disk[..., 0] * r).to(torch.int32)
    dy = (disk[..., 1] * r).to(torch.int32)
    if margin is not None:
        dx = torch.clamp(dx, -margin, margin)
        dy = torch.clamp(dy, -margin, margin)
    return dy, dx


@functools.cache
def _radii_table(radii: tuple, device: str) -> torch.Tensor:
    """The radius ladder on the device, made once (a host-to-device copy
    in every try would stall the launch queue)."""
    return torch.tensor(radii, dtype=torch.float32, device=device)


def probe_margin(base_radius: float, h: int, w: int) -> int:
    """Largest usable pad margin: the search radius, capped so the
    mirror stays within one reflection on small viewports."""
    return max(1, min(int(base_radius), h - 1, w - 1))


class SharedOffsetTaps:
    """Screen fields fetched at per-pixel table offsets, mirrored at the
    edges. The fields cover the whole screen; the pixels that fetch are
    the whole screen's, or with ``rows`` (a ``parallel.rows.RowBlock``)
    the block's, each at its global row."""

    def __init__(self, arrays, margin: int, rows=None):
        self.arrays = arrays
        self.h, self.w = arrays[0].shape[:2]
        self.m = margin
        self.y0, self.n = (0, self.h) if rows is None else (rows.y0, rows.rows)

    def coords(self, dy, dx, sel):
        """The mirrored (y, x) each pixel's selector points at."""
        oy, ox = self.offset_of(dy, dx, sel)
        dev = sel.device
        ys = torch.arange(self.y0, self.y0 + self.n, dtype=torch.int32, device=dev)[:, None]
        xs = torch.arange(self.w, dtype=torch.int32, device=dev)[None, :]
        y, x = ys + oy, xs + ox
        y = torch.where(y < 0, -y, y)
        x = torch.where(x < 0, -x, x)
        y = torch.where(y >= self.h, 2 * self.h - y - 1, y)
        x = torch.where(x >= self.w, 2 * self.w - x - 1, x)
        return y, x

    def take(self, dy, dx, sel):
        """All fields at per-pixel offsets ``(dy[sel], dx[sel])``, with
        their original shapes and dtypes."""
        y, x = self.coords(dy, dx, sel)
        idx = (y.long() * self.w + x.long()).reshape(-1)
        return [
            a.reshape((self.h * self.w,) + a.shape[2:])[idx].reshape(
                (self.n, self.w) + a.shape[2:]
            )
            for a in self.arrays
        ]

    def offset_of(self, dy, dx, sel):
        """The per-pixel (dy, dx) the selector resolves to."""
        s = sel.long()
        return dy[s], dx[s]


def radius_levels(base: float, floor: float = 5.0) -> tuple[float, ...]:
    """The adaptive-radius ladder: base, base/2, ... clamped at floor."""
    out = [base]
    while out[-1] * 0.5 > floor:
        out.append(out[-1] * 0.5)
    out.append(floor)
    return tuple(out)

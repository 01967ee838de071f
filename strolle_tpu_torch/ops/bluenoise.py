"""Blue-noise sampling (port of strolle_tpu/ops/bluenoise.py).

Reads the same [256, 256, 4] table, ``assets/blue_noise.npy``, at
``(pixel + (71, 11) * frame) % 256``. Where the file is absent the table
is generated by the same seeded numpy recipe (rank-ordered high-pass
filtered white noise) in memory.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

SIZE = 256
_TABLE = Path(__file__).resolve().parents[2] / "assets" / "blue_noise.npy"


def _generate_channel(rs: np.random.RandomState) -> np.ndarray:
    """White noise, high-passed in Fourier space, rank-remapped to a
    uniform [0, 1) histogram."""
    white = rs.rand(SIZE, SIZE)
    f = np.fft.fft2(white)
    fy = np.fft.fftfreq(SIZE)[:, None]
    fx = np.fft.fftfreq(SIZE)[None, :]
    dist = np.sqrt(fx * fx + fy * fy)
    hp = dist / (dist.max() + 1e-9)
    shaped = np.real(np.fft.ifft2(f * hp))
    order = np.argsort(shaped, axis=None)
    ranked = np.empty(SIZE * SIZE)
    ranked[order] = (np.arange(SIZE * SIZE) + 0.5) / (SIZE * SIZE)
    return ranked.reshape(SIZE, SIZE).astype(np.float32)


def generate() -> np.ndarray:
    rs = np.random.RandomState(0x5713)
    return np.stack([_generate_channel(rs) for _ in range(4)], axis=-1)


@functools.cache
def table_numpy() -> np.ndarray:
    if _TABLE.exists():
        return np.load(_TABLE)
    return generate()


@functools.cache
def texture(device) -> torch.Tensor:
    """The [256, 256, 4] table on ``device``."""
    return torch.as_tensor(table_numpy(), device=torch.device(device))


def sample_pair(grid_xy: torch.Tensor, frame: int):
    """(first [..., 2], second [..., 2]): blue-noise pairs at integer pixel
    coords ``grid_xy`` [..., 2] (global rows, as ``screen_grid`` gives
    them), with the per-frame (71, 11) scroll."""
    frame = int(frame)
    u = (grid_xy[..., 0].long() + 71 * frame) % SIZE
    v = (grid_xy[..., 1].long() + 11 * frame) % SIZE
    texel = texture(str(grid_xy.device))[v, u]
    return texel[..., 0:2], texel[..., 2:4]


def sample_pair_screen(h: int, w: int, frame: int, device, y0: int = 0):
    """Blue-noise pairs for ``h`` screen rows from row ``y0`` (the whole
    screen by default), pixel (x, y) = (col, row): four [h, w] planes
    (x1, y1, x2, y2)."""
    frame = int(frame)
    ys = (torch.arange(y0, y0 + h, device=device) + 11 * frame) % SIZE
    xs = (torch.arange(w, device=device) + 71 * frame) % SIZE
    tiled = texture(str(torch.device(device)))[ys][:, xs]
    return tiled[..., 0], tiled[..., 1], tiled[..., 2], tiled[..., 3]

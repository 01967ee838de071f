"""Camera model: matrices and primary-ray generation (port of
strolle_tpu/camera.py).

The matrices are built in numpy exactly as the JAX package builds them,
``np.linalg.inv`` included, so both packages hold the same bits; only
the per-pixel ray generation runs on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .ops import math as vm


@dataclasses.dataclass(frozen=True)
class Camera:
    projection_view: torch.Tensor  # f32[4,4]  world -> clip
    ndc_to_world: torch.Tensor  # f32[4,4]  inverse(projection_view)
    origin: torch.Tensor  # f32[3]
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.projection_view.device


def perspective_infinite_reverse(fov_y: float, aspect: float, near: float) -> np.ndarray:
    """Reversed-Z infinite-far RH projection (ndc z = 1 at the near
    plane, -> 0 at infinity)."""
    f = 1.0 / np.tan(0.5 * fov_y)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """RH view matrix (world -> view)."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def make_camera(
    eye,
    target,
    up=(0.0, 1.0, 0.0),
    fov_y: float = np.pi / 4,
    width: int = 512,
    height: int = 512,
    near: float = 0.1,
    device=None,
) -> Camera:
    device = resolve_device(device)
    proj = perspective_infinite_reverse(fov_y, width / height, near)
    view = look_at(np.asarray(eye), np.asarray(target), np.asarray(up))
    pv = (proj @ view).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        projection_view=t(pv),
        ndc_to_world=t(np.linalg.inv(pv).astype(np.float32)),
        origin=t(eye),
        width=int(width),
        height=int(height),
    )


def _project_point(m: torch.Tensor, x, y, z) -> torch.Tensor:
    """4x4 matrix (w = 1) applied as unrolled elementwise ops, then the
    perspective divide; [..., 3]."""
    out = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] for i in range(4)]
    return torch.stack(out[:3], dim=-1) / out[3][..., None]


def pixel_rays(camera: Camera, pixels_xy: torch.Tensor):
    """Rays through pixel centres for integer pixel coords [..., 2].

    Returns (origins [..., 3], dirs [..., 3]): unprojects at reversed-Z
    ndc depths 1.0 (near) and float32 eps (far).
    """
    sp = pixels_xy.to(torch.float32) + 0.5
    # (sp * 2 / size - 1) * (1, -1) per axis, dividing tensor by tensor
    # (a scalar divisor may become a reciprocal multiply); the sizes are
    # filled on the device rather than copied there
    sx, sy = sp[..., 0] * 2.0, sp[..., 1] * 2.0
    x = sx / torch.full_like(sx, float(camera.width)) - 1.0
    y = -(sy / torch.full_like(sy, float(camera.height)) - 1.0)
    m = camera.ndc_to_world
    eps = float(np.finfo(np.float32).eps)
    # m[i, 3] * w with w = 1 is m[i, 3] exactly
    far = _project_point(m, x, y, torch.full_like(x, eps))
    near = _project_point(m, x, y, torch.ones_like(x))
    return near, vm.normalize(far - near)


def world_to_screen_xy(camera: Camera, pos: torch.Tensor):
    """World point -> screen pixel coords as separate (x, y) planes."""
    m = camera.projection_view
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    cx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    cy = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    ndc_x = cx / cw
    ndc_y = -(cy / cw)
    sx = (0.5 * ndc_x + 0.5) * camera.width
    sy = (0.5 * ndc_y + 0.5) * camera.height
    return sx, sy


def screen_xy(camera: Camera, rows=None):
    """Integer pixel coordinates as two [H, W] int32 planes (x, y); of
    the block's rows only where ``rows`` (a ``parallel.rows.RowBlock``)
    is given."""
    g = screen_grid(camera, rows)
    return g[..., 0], g[..., 1]


def contain_xy(camera: Camera, x: torch.Tensor, y: torch.Tensor):
    """Mirror out-of-bounds integer coords back inside: -k -> k at the
    low edge, n + k -> n - 1 - k at the high edge."""
    w, h = camera.width, camera.height
    x = torch.where(x < 0, -x, x)
    y = torch.where(y < 0, -y, y)
    x = torch.where(x >= w, 2 * w - x - 1, x)
    y = torch.where(y >= h, 2 * h - y - 1, y)
    return x, y


def contain(camera: Camera, pos_xy: torch.Tensor) -> torch.Tensor:
    x, y = contain_xy(camera, pos_xy[..., 0], pos_xy[..., 1])
    return torch.stack([x, y], dim=-1)


def screen_grid(camera: Camera, rows=None) -> torch.Tensor:
    """Integer pixel coordinates [H, W, 2] (x, y order), int32; with
    ``rows`` (a ``parallel.rows.RowBlock``) the block's [rows, W, 2],
    each at its global row."""
    dev = camera.device
    y0, n = (0, camera.height) if rows is None else (rows.y0, rows.rows)
    ys, xs = torch.meshgrid(
        torch.arange(y0, y0 + n, dtype=torch.int32, device=dev),
        torch.arange(camera.width, dtype=torch.int32, device=dev),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)


def cameras_approx_eq(a: Camera, b: Camera) -> torch.Tensor:
    """Camera equality at the 0.0025 tolerance that drives the
    reference-mode accumulation reset on movement."""
    return torch.all(torch.abs(a.projection_view - b.projection_view) <= 0.0025)

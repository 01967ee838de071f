"""Primary visibility, velocity and the reprojection map (port of
strolle_tpu/restir/primary.py). Primaries are ray-cast through the same
surface trace as every other ray."""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera, pixel_rays, screen_grid, screen_xy, world_to_screen_xy
from ..ops import gather, math as vm
from ..ops.hit import Surface
from ..ops.trace import trace_surface
from ..scene.types import Scene


@dataclasses.dataclass(frozen=True)
class Reprojection:
    """Per-pixel reprojection record."""

    prev_x: torch.Tensor  # f32[H, W]
    prev_y: torch.Tensor  # f32[H, W]
    confidence: torch.Tensor  # f32[H, W]
    validity: torch.Tensor  # i32[H, W] 4-bit bilinear-tap mask

    @property
    def is_some(self) -> torch.Tensor:
        return self.confidence > 0.0

    @property
    def prev_xy_round(self):
        # round half to even, as jnp.round
        return (
            torch.round(self.prev_x).to(torch.int32),
            torch.round(self.prev_y).to(torch.int32),
        )

    @staticmethod
    def none(shape, device) -> "Reprojection":
        z = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        return Reprojection(prev_x=z, prev_y=z, confidence=z,
                            validity=torch.zeros(tuple(shape), dtype=torch.int32, device=device))


def primary_pass(scene: Scene, camera: Camera, prev_camera: Camera,
                 use_pallas: bool | None = None, rows=None):
    """Ray-cast primary visibility of the whole screen, or of the rows of
    ``rows`` (a ``parallel.rows.RowBlock``). Returns (Surface [H, W],
    velocity as (vel_x, vel_y) [H, W] planes): the hit point's screen motion against
    the previous camera, zeroed where small or where nothing was hit.
    Where the scene carries per-instance motion, the hit point first goes
    back through its instance's previous-of-current affine (a miss takes
    triangle 0's instance; its velocity is zeroed anyway)."""
    o, d = pixel_rays(camera, screen_grid(camera, rows))
    surf = trace_surface(scene, o, d, use_pallas=use_pallas)
    curr_x, curr_y = world_to_screen_xy(camera, surf.point)
    if scene.motion is not None:
        inst = scene.motion.instance_id[torch.clamp(surf.tri, min=0).long()]
        a = scene.motion.prev_of_curr[inst.long()]  # [H, W, 12]
        p = surf.point
        prev_point = torch.stack(
            [a[..., 4 * r] * p[..., 0] + a[..., 4 * r + 1] * p[..., 1]
             + a[..., 4 * r + 2] * p[..., 2] + a[..., 4 * r + 3] for r in range(3)],
            dim=-1,
        )
    else:
        prev_point = surf.point
    prev_x, prev_y = world_to_screen_xy(prev_camera, prev_point)
    vel_x = curr_x - prev_x
    vel_y = curr_y - prev_y
    small = vel_x * vel_x + vel_y * vel_y < 0.001
    kill = small | ~surf.is_some
    return surf, (torch.where(kill, 0.0, vel_x), torch.where(kill, 0.0, vel_y))


def surface_similarity(a_normal, a_depth, b_normal, b_depth):
    """Similarity of the previous-frame surface ``a`` to the current
    ``b``: 0 for sky, else 2*dot (0 below 0.5) times the depth gate."""
    a_sky = a_depth == 0.0
    b_sky = b_depth == 0.0
    d = torch.clamp(vm.dot(a_normal, b_normal), min=0.0)
    normal_score = torch.where(d <= 0.5, 0.0, 2.0 * d)
    depth_score = torch.where(torch.abs(a_depth - b_depth) >= 0.1 * b_depth, 0.0, 1.0)
    return torch.where(a_sky | b_sky, 0.0, normal_score * depth_score)


def build_reprojection_map(camera: Camera, surf: Surface, prev_surf: Surface,
                           velocity, rows=None) -> Reprojection:
    """prev pos = pos - velocity; confidence from the similarity of the
    rounded previous tap; validity bits for the 4 bilinear taps. With
    ``rows`` (a ``parallel.rows.RowBlock``) ``surf`` and ``velocity`` are
    the block's and ``prev_surf`` is the whole screen's."""
    h, w = camera.height, camera.width
    xs, ys = screen_xy(camera, rows)
    vel_x, vel_y = velocity
    prev_px = xs.to(torch.float32) - vel_x
    prev_py = ys.to(torch.float32) - vel_y

    taps, fy, fx = gather.take_bilinear((prev_surf.normal, prev_surf.depth), prev_py, prev_px)
    cx = fx + 1
    cy = fy + 1
    rx = torch.round(prev_px).to(torch.int32)
    ry = torch.round(prev_py).to(torch.int32)
    in_bounds = (rx >= 0) & (rx < w) & (ry >= 0) & (ry < h)
    up_y = ry > fy
    up_x = rx > fx

    def pick(cond, a, b):
        return torch.where(cond[..., None] if a.ndim == 3 else cond, a, b)

    pn = pick(up_x, pick(up_y, taps[3][0], taps[1][0]), pick(up_y, taps[2][0], taps[0][0]))
    pd = pick(up_x, pick(up_y, taps[3][1], taps[1][1]), pick(up_y, taps[2][1], taps[0][1]))
    confidence = surface_similarity(pn, pd, surf.normal, surf.depth)
    confidence = torch.where(in_bounds & (surf.depth > 0.0), confidence, 0.0)

    validity = torch.zeros(xs.shape, dtype=torch.int32, device=xs.device)
    corners = ((fx, fy), (cx, fy), (fx, cy), (cx, cy))
    for bit, ((px, py), (tn, td)) in enumerate(zip(corners, taps)):
        inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        ok = inb & (surface_similarity(tn, td, surf.normal, surf.depth) >= 0.25)
        validity = validity | torch.where(ok, 1 << bit, 0).to(torch.int32)
    some = confidence > 0.0
    validity = torch.where(some, validity, 0)
    return Reprojection(
        prev_x=torch.where(some, prev_px, 0.0),
        prev_y=torch.where(some, prev_py, 0.0),
        confidence=confidence,
        validity=validity,
    )


def bilinear_reproject(reproj: Reprojection, values: torch.Tensor) -> torch.Tensor:
    """Validity-masked 4-tap bilinear fetch of ``values`` [H, W, C] (the
    whole screen) at the reprojected coordinates of ``reproj``'s pixels;
    zeros where no tap is valid."""
    px, py = reproj.prev_x, reproj.prev_y
    corner_taps, fy, fx = gather.take_bilinear((values,), py, px)
    ux = px - fx.to(torch.float32)
    uy = py - fy.to(torch.float32)
    corner_w = ((1 - ux) * (1 - uy), ux * (1 - uy), (1 - ux) * uy, ux * uy)
    weights = [
        torch.where(((reproj.validity >> bit) & 1) > 0, wgt, 0.0)
        for bit, wgt in enumerate(corner_w)
    ]
    wsum = weights[0] + weights[1] + weights[2] + weights[3]
    out = 0
    for (tap,), wg in zip(corner_taps, weights):
        out = out + tap * wg[..., None]
    return torch.where(wsum[..., None] > 0.0, out / torch.clamp(wsum, min=1e-20)[..., None], 0.0)

"""The realtime ReSTIR frame (port of strolle_tpu/models/restir.py).

One ``render_frame`` call threads a RenderState (previous surface and
camera, reservoir history, denoiser state, frame counter) through the
stages:

    prelude   primary_pass (ray-cast G-buffer + velocity), the
              reprojection map, miss-pixel sky, blue noise
    history   one gather of the DI/GI history at the reprojected pixels
    DI        sampling -> temporal -> spatial -> resolving
    GI        reprojection -> sampling -> temporal -> spatial ->
              preview x2 -> resolve
    denoise   SVGF on the DI- and GI-diffuse channels
    compose

``RenderConfig`` switches DI, GI and the denoiser off as the JAX
package's does: a channel that is off is zero and its state passes
through.

The stage functions keep the JAX package's names and arguments, so a
test can feed both packages the same inputs stage by stage; the row
block is a keyword at the end. With ``mesh`` (a ``torch.distributed``
DeviceMesh, ``parallel/frame_sharding.py``) the frame is split by rows:
each rank holds, computes and returns only its block of rows
(``parallel.rows.RowBlock``, passed through every stage), traces only
its block's rays, and all-gathers only the arrays that reprojection,
the spatial taps and the à-trous stencils read. The frame counter is a
Python int: the GI schedule is decided on the host and no frame reads a
tensor back to pick its passes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera, pixel_rays, screen_grid
from ..config import DEFAULT_TUNING, Tuning
from ..denoise.svgf import DenoiserState, denoise_channel, denoise_pair
from ..device import resolve_device
from ..ops import bluenoise, gather, rng
from ..ops.hit import Surface
from ..parallel.rows import RowBlock, span, whole
from ..restir import di as di_mod
from ..restir import gi as gi_mod
from ..restir.gi import GiReservoirs
from ..restir.primary import Reprojection, build_reprojection_map, primary_pass
from ..restir.reservoir import DiReservoirs
from ..scene.types import Scene
from ..sky.atmosphere import luts_for, sample_atmosphere, sample_sky, sun_direction
from ..utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static pipeline configuration (the JAX package's). ``mode`` is the
    camera mode the renderer picks a channel for; the frame itself
    computes every channel whatever it says."""

    #: image | di_diffuse | di_specular | gi_diffuse | gi_specular |
    #: albedo | depth | reference | bvh_heatmap
    mode: str = "image"
    #: SVGF on the diffuse channels that run
    denoise: bool = True
    needs_di: bool = True
    needs_gi: bool = True
    #: evaluate the atmosphere for miss pixels
    include_sky: bool = False
    #: take trace_closest + surface_at (use_pallas=False), the route
    #: gradients flow through, instead of the fused surface kernel
    differentiable: bool = False
    tuning: Tuning = DEFAULT_TUNING


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Temporal state carried from frame to frame."""

    frame: int
    prev_camera: Camera
    prev_surface: Surface  # [H, W]
    di_prev: DiReservoirs  # resolved DI reservoirs
    gi_prev: GiReservoirs  # GI history (the spatial-or-temporal source)
    di_diff_denoiser: DenoiserState
    gi_diff_denoiser: DenoiserState


def init_state(camera: Camera, device=None, rows=None) -> RenderState:
    """The state before the first frame: on the CUDA card unless
    ``device`` says otherwise (without a card, ``device="cpu"`` is
    required); of the block of ``rows`` only, where given (a
    ``parallel.rows.RowBlock``)."""
    device = resolve_device(device)
    shape = (span(rows, camera.height)[1], camera.width)
    return RenderState(
        frame=0,
        prev_camera=camera,
        prev_surface=Surface.empty(shape, device),
        di_prev=DiReservoirs.empty(shape, device),
        gi_prev=GiReservoirs.empty(shape, device),
        di_diff_denoiser=DenoiserState.empty(shape, device),
        gi_diff_denoiser=DenoiserState.empty(shape, device),
    )


def derive_seed(seed: int, k: int) -> int:
    """Per-pass seed: one PCG state step of seed + k-th golden-ratio mix
    (host integers, the same u32 value as the JAX package's)."""
    mix = (0x9E3779B9 * (k + 1)) & rng.MASK32
    s = (int(seed) + mix) & rng.MASK32
    return (s * 747796405 + 2891336453) & rng.MASK32


def render_frame(scene: Scene, camera: Camera, state: RenderState, seed: int,
                 config: RenderConfig = RenderConfig(), luts=None, mesh=None):
    """Renders one frame; returns (channels dict, new state). ``luts``
    default to the sun-altitude-keyed cache (``luts_for``) wherever the
    sky or GI (which samples it for its miss rays) runs. ``mesh`` splits
    the frame's rows over its ranks (see the module docstring): ``state``
    holds this rank's block of rows and so do the channels and the new
    state. That split is forward only: a scene or state that requires
    grad raises."""
    rows = None
    if mesh is not None:
        rows = RowBlock.of(mesh, camera.height)
        if state.prev_surface.depth.shape[0] != rows.rows:
            raise ValueError(
                f"a row-split frame takes this rank's {rows.rows} rows of the state, not "
                f"{state.prev_surface.depth.shape[0]}: build it with init_state_sharded or "
                "slice a whole one with shard_render_state")
        _check_forward_only(scene, state)
    if luts is None and (config.include_sky or config.needs_gi):
        luts = luts_for(scene.sun_altitude, camera.device)
    use_pallas = False if config.differentiable else None
    frame = int(state.frame)
    seed = int(seed)
    tuning = config.tuning
    # the history every reprojected read taps, at the whole screen's height
    prev_surface, di_hist, gi_hist = whole(rows, (
        state.prev_surface, state.di_prev if config.needs_di else None,
        state.gi_prev if config.needs_gi else None))
    surf, reproj, sky, bn_first, bn_second = _stage_prelude(
        scene, camera, state.prev_camera, prev_surface, frame, luts, config.include_sky,
        use_pallas, rows=rows,
    )
    # the current surface every cross-pixel tap reads, at the whole height
    surf_all = whole(rows, surf)
    zeros4 = torch.zeros((span(rows, camera.height)[1], camera.width, 4), device=camera.device)
    di_diff = di_spec = gi_diff = gi_spec = zeros4
    di_prev, gi_prev = state.di_prev, state.gi_prev
    # DI temporal and GI reprojection gather their history at the same
    # reprojected pixels: when both run, one gather serves both
    di_pre = gi_pre = None
    if config.needs_di and config.needs_gi:
        di_rhs, gi_rep, rhs_surf = _stage_history(camera, reproj, di_hist, gi_hist, prev_surface)
        di_pre, gi_pre = (di_rhs, rhs_surf), (gi_rep, rhs_surf)
    if config.needs_di:
        di_diff, di_spec, di_prev = _stage_di(
            scene, camera, surf, prev_surface, reproj, di_hist, seed, frame,
            bn_first, sky, tuning, use_pallas, di_pre, rows=rows, surf_all=surf_all,
        )
    if config.needs_gi:
        gi_diff, gi_spec, gi_prev = _stage_gi(
            scene, camera, surf, prev_surface, reproj, gi_hist, seed, frame,
            bn_second, luts, use_pallas, tuning, gi_pre, rows=rows, surf_all=surf_all,
        )
    di_den, gi_den = state.di_diff_denoiser, state.gi_diff_denoiser
    di_rgb, gi_rgb = di_diff[..., :3], gi_diff[..., :3]
    if config.denoise and config.needs_di and config.needs_gi:
        (di_rgb, di_den), (gi_rgb, gi_den) = _stage_denoise_pair(
            di_diff, gi_diff, surf, reproj, di_den, gi_den, frame, tuning, rows=rows,
            surf_all=surf_all,
        )
    elif config.denoise and config.needs_di:
        di_rgb, di_den = _stage_denoise(di_diff, surf, reproj, di_den, frame, "di", tuning,
                                        rows=rows, surf_all=surf_all)
    elif config.denoise and config.needs_gi:
        gi_rgb, gi_den = _stage_denoise(gi_diff, surf, reproj, gi_den, frame, "gi", tuning,
                                        rows=rows, surf_all=surf_all)
    channels = _stage_compose(surf, di_rgb, gi_rgb, di_spec, gi_spec)
    new_state = RenderState(
        frame=frame + 1, prev_camera=camera, prev_surface=surf, di_prev=di_prev,
        gi_prev=gi_prev, di_diff_denoiser=di_den, gi_diff_denoiser=gi_den,
    )
    return channels, new_state


def render_frame_fused(scene, camera, state, seed, config=RenderConfig(), luts=None, mesh=None):
    """The JAX package's one-program frame. Eager PyTorch has no program
    to fuse, so this is ``render_frame``."""
    return render_frame(scene, camera, state, seed, config, luts, mesh)


def _check_forward_only(scene: Scene, state: RenderState) -> None:
    leaves = []
    tree_map(lambda x: leaves.append(x) or x, (scene, state))
    if any(x.requires_grad for x in leaves):
        raise ValueError("a row-split frame is forward only: its scene and state must not "
                         "require grad")


def _stage_prelude(scene, camera, prev_camera, prev_surface, frame, luts=None,
                   include_sky=False, use_pallas=None, rows=None):
    """G-buffer + reprojection map + miss-pixel sky (through ``luts`` when
    given, else the analytic march; zero with the sky off) + blue noise,
    of the whole screen or of the block of ``rows``; ``prev_surface``
    covers the whole screen."""
    w = camera.width
    y0, h = span(rows, camera.height)
    dev = camera.device
    surf, velocity = primary_pass(scene, camera, prev_camera, use_pallas, rows)
    reproj = build_reprojection_map(camera, surf, prev_surface, velocity, rows)
    if include_sky:
        sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=dev)
        _, prim_d = pixel_rays(camera, screen_grid(camera, rows))
        sky = sample_atmosphere(luts, sun, prim_d) if luts is not None else sample_sky(sun, prim_d)
    else:
        sky = torch.zeros((h, w, 3), device=dev)
    bn1x, bn1y, bn2x, bn2y = bluenoise.sample_pair_screen(h, w, frame, dev, y0)
    return (surf, reproj, sky, torch.stack([bn1x, bn1y], -1), torch.stack([bn2x, bn2y], -1))


def _stage_history(camera, reproj, di_prev, gi_prev, prev_surface):
    """One gather at the reprojected coords serves DI temporal, GI
    reprojection and the previous-surface taps. The history covers the
    whole screen; ``reproj`` may be a row block's."""
    rpx, rpy = reproj.prev_xy_round
    rx = torch.clamp(rpx, 0, camera.width - 1)
    ry = torch.clamp(rpy, 0, camera.height - 1)
    return gather.gather_tree((di_prev, gi_prev, prev_surface), ry, rx)


def _stage_di(scene, camera, surf, prev_surface, reproj, di_prev, seed, frame, bn_first, sky,
              tuning=DEFAULT_TUNING, use_pallas=None, prefetched=None, rows=None,
              surf_all=None):
    """The four DI passes. ``use_pallas`` reaches the spatial probe (False
    keeps the tensor probe, and so does a row block). ``prev_surface``,
    ``di_prev`` and ``surf_all`` (``surf`` gathered) cover the whole
    screen."""
    a = di_mod.di_sampling(scene, camera, surf, derive_seed(seed, 0), bn_first, tuning, rows)
    b = di_mod.di_temporal(scene, camera, surf, prev_surface, reproj, a, di_prev,
                           derive_seed(seed, 1), tuning, prefetched, rows)
    c = di_mod.di_spatial(scene, camera, surf, b, derive_seed(seed, 2), frame, tuning,
                          use_pallas, rows, surf_all)
    return di_mod.di_resolving(scene, camera, surf, c, sky)


def _stage_gi(scene, camera, surf, prev_surface, reproj, gi_prev, seed, frame, bn_second,
              luts, use_pallas=None, tuning=DEFAULT_TUNING, prefetched=None, rows=None,
              surf_all=None):
    return gi_mod.gi_pipeline(scene, camera, surf, prev_surface, reproj, gi_prev, seed,
                              frame, bn_second, luts, use_pallas, tuning, prefetched, rows,
                              surf_all)


def _stage_denoise(samples, surf, reproj, den_state, frame, kind, tuning=DEFAULT_TUNING,
                   rows=None, surf_all=None):
    """SVGF on one channel, where the other does not run."""
    return denoise_channel(samples, surf, reproj, den_state, frame, kind=kind, tuning=tuning,
                           rows=rows, surf_all=surf_all)


def _stage_denoise_pair(di_samples, gi_samples, surf, reproj, di_state, gi_state, frame,
                        tuning=DEFAULT_TUNING, rows=None, surf_all=None):
    return denoise_pair(di_samples, gi_samples, surf, reproj, di_state, gi_state, frame,
                        tuning=tuning, rows=rows, surf_all=surf_all)


def _stage_compose(surf, di_diff_rgb, gi_diff_rgb, di_spec, gi_spec):
    """Emissive + (DI + GI diffuse) x albedo + specular on hits; the DI
    channel (the sky radiance) on misses."""
    albedo = surf.base_color[..., :3]
    image = torch.where(
        surf.is_some[..., None],
        surf.emissive + (di_diff_rgb + gi_diff_rgb) * albedo + di_spec[..., :3] + gi_spec[..., :3],
        di_diff_rgb,
    )
    return {
        "image": image,
        "di_diffuse": di_diff_rgb,
        "di_specular": di_spec[..., :3],
        "gi_diffuse": gi_diff_rgb,
        "gi_specular": gi_spec[..., :3],
        "albedo": albedo,
        "depth": surf.depth,
    }

"""ReSTIR GI: one-bounce indirect lighting with reservoir reuse (port of
strolle_tpu/restir/gi.py).

    reproject(gi0)                  -> rep
    sampling a+b (rep)              -> cand     (covered pixels)
    temporal(cand, rep)             -> t
    [odd tracing frames] spatial(t) -> s        ; source = s | t
    preview1(source, r=128)         -> p1
    preview2(p1, r=64)              -> p2
    resolve: shade from p2, keep ``source`` as next frame's history

Frames 0-3 of each 6-frame cycle trace new BRDF rays on a checkerboard
half; frames 4-5 replay the stored reservoir rays and validate their
radiance. The frame counter is a Python int, so the schedule is a host
branch: a skipped pass launches nothing.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..camera import Camera, contain_xy, screen_xy
from ..config import DEFAULT_TUNING, Tuning
from ..ops import brdf, checkerboard as cb, gather, math as vm, offsets as shoff, rng
from ..ops.hit import Surface
from ..ops.lights import gather_light, radiance, shadow_ray_wnoise
from ..ops.trace import trace_anyhit, trace_surface
from ..parallel.rows import span, whole
from ..scene.types import Scene
from ..sky.atmosphere import SUN_DISTANCE, sample_atmosphere, sample_sky, sun_direction
from . import di, reservoir as rsv
from .di import _probe_kernel_enabled, checkerboard_active, probe_fused, try_seed
from .mis import mis_eval
from .primary import Reprojection


def is_gi_tracing(frame: int) -> bool:
    """6-frame cycle: frames 0-3 trace, 4-5 validate."""
    return int(frame) % 6 < 4


@dataclasses.dataclass(frozen=True)
class GiReservoirs:
    """Per-pixel GI reservoirs."""

    m: torch.Tensor  # f32[...]
    w: torch.Tensor  # f32[...]
    pdf: torch.Tensor  # f32[...]
    confidence: torch.Tensor  # f32[...]
    rng: torch.Tensor  # int64[...]  stored RNG state (a u32 value) for replay
    radiance: torch.Tensor  # f32[..., 3]
    v1_point: torch.Tensor  # f32[..., 3]
    v2_point: torch.Tensor  # f32[..., 3]
    v2_normal: torch.Tensor  # f32[..., 3]

    @property
    def is_empty(self) -> torch.Tensor:
        return self.m == 0.0

    @property
    def exists(self) -> torch.Tensor:
        """v2_point != 0."""
        return torch.any(self.v2_point != 0.0, dim=-1)

    def replace(self, **updates) -> "GiReservoirs":
        return dataclasses.replace(self, **updates)

    @staticmethod
    def empty(shape, device) -> "GiReservoirs":
        shape = tuple(shape)
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
        return GiReservoirs(
            m=z, w=z, pdf=z, confidence=z,
            rng=torch.zeros(shape, dtype=torch.int64, device=device),
            radiance=z3, v1_point=z3, v2_point=z3, v2_normal=z3,
        )


def _where(mask, a, b):
    return torch.where(mask[..., None] if a.ndim > mask.ndim else mask, a, b)


def select(mask, a: GiReservoirs, b: GiReservoirs) -> GiReservoirs:
    return GiReservoirs(
        **{f.name: _where(mask, getattr(a, f.name), getattr(b, f.name))
           for f in dataclasses.fields(GiReservoirs)}
    )


_SAMPLE_FIELDS = ("pdf", "rng", "radiance", "v1_point", "v2_point", "v2_normal")


def _select_sample(mask, cand: GiReservoirs, res: GiReservoirs) -> GiReservoirs:
    return res.replace(**{f: _where(mask, getattr(cand, f), getattr(res, f))
                          for f in _SAMPLE_FIELDS})


def update(state, res, cand, weight, enabled=None):
    return rsv.update(state, res, cand, weight, enabled, select_sample_fn=_select_sample)


def merge(state, res, rhs, pdf, enabled=None):
    return rsv.merge(state, res, rhs, pdf, enabled, update_fn=update)


def norm_mis(res, pdf):
    return rsv.norm(res, pdf, 1.0, 1.0)


def norm_avg(res, pdf):
    return rsv.norm(res, pdf, 1.0, res.m)


def clamp_w(res, mx: float):
    return res.replace(w=torch.clamp(res.w, max=mx))


# ---------------------------------------------------------------------------
# sample math
# ---------------------------------------------------------------------------


def sample_dir(res: GiReservoirs, point):
    return vm.normalize(res.v2_point - point)


def sample_cosine(res: GiReservoirs, surf: Surface):
    return torch.clamp(vm.dot(sample_dir(res, surf.point), surf.normal), min=0.0)


def sample_pdf(res: GiReservoirs, surf: Surface):
    """luma(radiance) * cosine * (diffuse + specular brdf luma), white
    albedo; 0 where the sample does not exist or nothing was hit."""
    white = torch.ones_like(surf.base_color)
    d = sample_dir(res, surf.point)
    diff = vm.luma(brdf.diffuse_eval(white, surf.metallic))
    spec = vm.luma(brdf.specular_eval(white, surf.metallic, surf.roughness,
                                      surf.reflectance, surf.normal, d, -surf.dir))
    pdf = vm.luma(res.radiance) * sample_cosine(res, surf) * (diff + spec)
    return torch.where(res.exists & surf.is_some, pdf, 0.0)


def sample_ray(res: GiReservoirs, hit_point):
    """Reconnection ray from the surface toward v2, 0.01 short of it."""
    d = res.v2_point - hit_point
    dist = vm.length(d)
    return hit_point, d / torch.clamp(dist, min=1e-20)[..., None], torch.clamp(dist - 0.01, min=0.0)


def _jacobian_partial(p, v2_point, v2_normal):
    vec = p - v2_point
    dist = vm.length(vec)
    cos = vm.saturate(vm.dot(v2_normal, vec / torch.clamp(dist, min=1e-20)[..., None]))
    return dist, cos


def jacobian_old_parts(v1_point, v2_point, v2_normal):
    """(od, oc): the candidate-side half of the reconnection Jacobian."""
    return _jacobian_partial(v1_point, v2_point, v2_normal)


def jacobian_apply(od, oc, v2_point, v2_normal, exists, new_hit_point):
    nd, nc = _jacobian_partial(new_hit_point, v2_point, v2_normal)
    x = nc * od * od
    y = oc * nd * nd
    j = torch.where(y == 0.0, 0.0, x / torch.where(y == 0.0, 1.0, y))
    return torch.where(exists, j, 1.0)


# ---------------------------------------------------------------------------
# checkerboard coverage
# ---------------------------------------------------------------------------


def got_checkerboard_at(xs, ys, f: int):
    return (xs % 2) == ((int(f) + ys) % 2)


def gi_coverage(xs, ys, frame: int):
    """Pixels gi_sampling traces this frame."""
    key = frame // 2 if is_gi_tracing(frame) else frame
    return got_checkerboard_at(xs, ys, key)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def gi_reproject(camera: Camera, surf: Surface, reproj: Reprojection, gi_prev: GiReservoirs,
                 prev_surf: Surface | None = None, prefetched=None):
    """The previous reservoir at the reprojected position; confidence :=
    1, v1 := the current hit point. Returns (rep, the previous surface
    at the same position, or None). ``gi_prev`` and ``prev_surf`` cover
    the whole screen; ``surf`` and ``reproj`` may be a row block's."""
    shape = surf.depth.shape
    dev = surf.depth.device
    if prefetched is not None:
        rep, rhs_surf = prefetched
    else:
        rpx, rpy = reproj.prev_xy_round
        rx = torch.clamp(rpx, 0, camera.width - 1)
        ry = torch.clamp(rpy, 0, camera.height - 1)
        if prev_surf is not None:
            rep, rhs_surf = gather.gather_tree((gi_prev, prev_surf), ry, rx)
        else:
            rep, rhs_surf = gather.gather_tree(gi_prev, ry, rx), None
    rep = select(reproj.is_some, rep, GiReservoirs.empty(shape, dev))
    rep = rep.replace(confidence=torch.ones(shape, device=dev), v1_point=surf.point)
    return select(surf.is_some, rep, GiReservoirs.empty(shape, dev)), rhs_surf


def _sky(luts, sun, d):
    if luts is not None:
        return sample_atmosphere(luts, sun, d)
    return sample_sky(sun, d)


def gi_sampling(scene: Scene, camera: Camera, surf: Surface, rep: GiReservoirs, seed_a: int,
                seed_b: int, frame: int, luts=None, use_pallas: bool | None = None,
                tuning: Tuning = DEFAULT_TUNING, rows=None) -> GiReservoirs:
    """Trace the bounce ray (a fresh BRDF sample on tracing frames, the
    stored reservoir ray on validation frames), then shade the secondary
    vertex with sky-vs-RIS light selection and one shadow ray. Covered
    pixels only; the others come back empty. With ``rows`` (a
    ``parallel.rows.RowBlock``) the inputs are the block's."""
    shape = surf.depth.shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera, rows)
    tracing = is_gi_tracing(frame)
    covered = gi_coverage(xs, ys, frame)

    # --- part A: the bounce ray ---------------------------------------
    if tracing:
        state_a = rng.wnoise_new(seed_a, xs, ys)
        _, gi_dir, gi_pdf, _ = brdf.layered_sample(
            state_a, surf.base_color, surf.metallic, surf.roughness, surf.reflectance,
            surf.normal, -surf.dir,
        )
        gi_origin = surf.point
        active = covered & surf.is_some
    else:
        gi_dir = sample_dir(rep, rep.v1_point)
        gi_pdf = torch.ones(shape, device=dev)
        gi_origin = rep.v1_point
        active = covered & ~rep.is_empty

    cb_parity = None
    if cb.compaction_pays(scene, shape[1]):
        cb_parity = cb.row_parity(frame // 2 if tracing else frame, shape[0], dev,
                                  span(rows, shape[0])[0])
        gi_surf = cb.expand_tree(cb_parity, trace_surface(
            scene, cb.compact(cb_parity, gi_origin), cb.compact(cb_parity, gi_dir),
            regularize=True, use_pallas=use_pallas,
        ), 0)
    else:
        gi_surf = trace_surface(scene, gi_origin, gi_dir, regularize=True,
                                use_pallas=use_pallas)

    # --- part B: shade the secondary vertex ---------------------------
    state = rng.wnoise_new(seed_b, xs, ys) if tracing else rep.rng
    rng0 = state  # stored in the sample for validation replay

    sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=dev)
    lcount = scene.lights.count
    atmosphere_pdf = 0.0 if scene.sun_altitude <= -1.0 else tuning.sky_sample_prob

    state, u_sky = rng.next_f32(state)
    pick_sky = (u_sky < atmosphere_pdf) | (lcount == 0)

    # sky branch: hemisphere sample around the secondary normal
    sky_state, sky_dir = rng.sample_hemisphere(state, gi_surf.normal)
    sky_rad = _sky(luts, sun, sky_dir) * vm.dotk(gi_surf.normal, sky_dir)

    # light branch: RIS over the lights at the secondary hit
    eph_state = state
    eph_m = torch.zeros(shape, device=dev)
    eph_w = torch.zeros(shape, device=dev)
    eph_pdf = torch.zeros(shape, device=dev)
    eph_light = torch.zeros(shape, dtype=torch.int32, device=dev)
    eph_rad = torch.zeros(shape + (3,), device=dev)
    eph_spec = torch.zeros(shape + (3,), device=dev)
    max_samples = min(lcount, tuning.di_candidates)
    ipdf = float(lcount)
    for nth in range(min(tuning.di_candidates, scene.lights.capacity)):
        eph_state, word = rng.next_u32(eph_state)
        if nth >= max_samples:
            # a disabled candidate only advances the RNG (its draw and
            # its acceptance word)
            eph_state, _ = rng.next_u32(eph_state)
            continue
        lid = (word % max(lcount, 1)).to(torch.int32)
        lr = radiance(gather_light(scene.lights, lid), gi_surf)
        cpdf = vm.perc_luma(lr.radiance)
        eph_m = eph_m + 1.0
        eph_w = eph_w + cpdf * ipdf
        eph_state, uu = rng.next_f32(eph_state)
        accept = uu * eph_w < cpdf * ipdf
        eph_pdf = torch.where(accept, cpdf, eph_pdf)
        eph_light = torch.where(accept, lid, eph_light)
        eph_rad = torch.where(accept[..., None], lr.radiance, eph_rad)
        eph_spec = torch.where(accept[..., None], lr.spec_brdf, eph_spec)
    denom = eph_pdf * eph_m
    eph_w = torch.where(denom == 0.0, 0.0, eph_w / torch.where(denom == 0.0, 1.0, denom))

    light_ok = eph_w > 0.0
    light_pdf_l = torch.where(
        light_ok, (1.0 / torch.where(light_ok, eph_w, 1.0)) * (1.0 - atmosphere_pdf), 1.0
    )
    light_rad_l = torch.where(light_ok[..., None], eph_rad * (1.0 + eph_spec), 0.0)

    light_id = torch.where(pick_sky, -1, torch.where(light_ok, eph_light, 0))
    light_pdf = torch.where(pick_sky, atmosphere_pdf, light_pdf_l)
    light_rad = torch.where(pick_sky[..., None], sky_rad, light_rad_l)
    state = torch.where(pick_sky, sky_state, eph_state)

    # secondary miss: the bounce ray sees the sky directly
    miss = ~gi_surf.is_some
    light_id = torch.where(miss, -1, light_id)
    light_pdf = torch.where(miss, 1.0, light_pdf)
    light_rad = torch.where(miss[..., None], _sky(luts, sun, gi_dir), light_rad)
    # the NEE/RIS pdf is a sampling statistic: detached, as the resampling
    # weights are (reservoir.resampling_weight)
    light_pdf = light_pdf.detach()

    # shadow ray at the secondary vertex
    lg = gather_light(scene.lights, torch.clamp(light_id, min=0))
    state, w_o, w_d, w_len = shadow_ray_wnoise(state, lg, gi_surf.point)
    to_sky = (light_id < 0)[..., None]
    sr_o = torch.where(to_sky, gi_surf.point, w_o)
    sr_d = torch.where(to_sky, sky_dir, w_d)
    sr_len = torch.where(light_id < 0, math.inf, w_len)
    sr_len = torch.where(miss | ~active | (light_pdf <= 0.0), 0.0, sr_len)
    if cb_parity is not None:
        occluded = cb.expand(cb_parity, trace_anyhit(
            scene, cb.compact(cb_parity, sr_o), cb.compact(cb_parity, sr_d),
            cb.compact(cb_parity, sr_len),
        ), False)
    else:
        occluded = trace_anyhit(scene, sr_o, sr_d, sr_len)
    vis = torch.where(occluded, 0.0, 1.0)

    rad = torch.where(
        (light_pdf > 0.0)[..., None],
        light_rad * (vis / torch.clamp(light_pdf, min=1e-20))[..., None],
        0.0,
    )
    rad = torch.where(
        gi_surf.is_some[..., None],
        rad * gi_surf.base_color[..., :3] / math.pi + gi_surf.emissive,
        rad,
    )

    # --- the candidate reservoir --------------------------------------
    v1 = gi_origin
    v2 = torch.where(gi_surf.is_some[..., None], gi_surf.point, v1 + gi_dir * SUN_DISTANCE)
    v2n = torch.where(gi_surf.is_some[..., None], gi_surf.normal, -gi_dir)
    valid = active & (gi_pdf > 0.0)
    cand = GiReservoirs(
        m=torch.where(valid, 1.0, 0.0),
        w=torch.where(valid, 1.0 / torch.clamp(gi_pdf, min=1e-20), 0.0),
        pdf=torch.zeros(shape, device=dev),
        confidence=torch.zeros(shape, device=dev),
        rng=rng0,
        radiance=torch.where(valid[..., None], rad, 0.0),
        v1_point=torch.where(valid[..., None], v1, 0.0),
        v2_point=torch.where(valid[..., None], v2, 0.0),
        v2_normal=torch.where(valid[..., None], v2n, 0.0),
    )
    return cand.replace(pdf=torch.where(valid, sample_pdf(cand, surf), 0.0))


def gi_temporal(scene: Scene, camera: Camera, surf: Surface, prev_surf: Surface,
                reproj: Reprojection, cand: GiReservoirs, rep: GiReservoirs, seed: int,
                frame: int, tuning: Tuning = DEFAULT_TUNING,
                rhs_surf: Surface | None = None, rows=None) -> GiReservoirs:
    """MIS merge with the history on tracing frames; merge-only with
    sample validation on validation frames. With ``rows`` (a
    ``parallel.rows.RowBlock``) the per-pixel inputs are the block's,
    while ``prev_surf`` covers the whole screen."""
    shape = surf.depth.shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera, rows)
    state = rng.wnoise_new(seed, xs, ys)
    tracing = is_gi_tracing(frame)
    empty = GiReservoirs.empty(shape, dev)

    if tracing:
        got_sample = got_checkerboard_at(xs, ys, frame // 2) & (frame % 2 == 0)
    else:
        got_sample = got_checkerboard_at(xs, ys, frame)
    lhs = select(got_sample, cand, empty)
    rhs = select(reproj.is_some, rep, empty)
    rhs = rhs.replace(confidence=torch.ones(shape, device=dev),
                      m=torch.clamp(rhs.m, max=tuning.gi_temporal_m_clamp))

    if tracing:
        if rhs_surf is None:
            rpx, rpy = reproj.prev_xy_round
            rx = torch.clamp(rpx, 0, camera.width - 1)
            ry = torch.clamp(rpy, 0, camera.height - 1)
            rhs_surf = gather.gather_tree(prev_surf, ry, rx)
        lhs_rhs_pdf = torch.where((lhs.m > 0.0) & rhs_surf.is_some, sample_pdf(lhs, rhs_surf), 0.0)
        rhs_lhs_pdf = torch.where(rhs.m > 0.0, sample_pdf(rhs, surf), 0.0)
        mis = mis_eval(
            lhs_m=lhs.m, rhs_m=rhs.m, rhs_jacobian=torch.ones(shape, device=dev),
            lhs_lhs_pdf=lhs.pdf, lhs_rhs_pdf=lhs_rhs_pdf, rhs_lhs_pdf=rhs_lhs_pdf,
            rhs_rhs_pdf=rhs.pdf,
        )
        main = empty
        main_pdf = torch.zeros(shape, device=dev)
        state, main, acc = update(state, main, lhs, mis.lhs_mis * mis.lhs_pdf * lhs.w)
        main_pdf = torch.where(acc, mis.lhs_pdf, main_pdf)
        state, main, acc = update(state, main, rhs, mis.rhs_mis * mis.rhs_pdf * rhs.w)
        main_pdf = torch.where(acc, mis.rhs_pdf, main_pdf)
        main = main.replace(m=lhs.m + mis.m, confidence=torch.ones(shape, device=dev))
        main = norm_mis(main, main_pdf)
    else:
        # validation: compare the replayed radiance with the history's
        validate = ~lhs.is_empty & ~rhs.is_empty & rhs.exists & reproj.is_some
        moved = vm.length(lhs.radiance - rhs.radiance) > tuning.gi_validation_threshold
        v3 = validate[..., None]
        rhs = rhs.replace(
            confidence=torch.where(validate & moved, 0.0, rhs.confidence),
            radiance=torch.where(v3, lhs.radiance, rhs.radiance),
            v2_point=torch.where(v3, lhs.v2_point, rhs.v2_point),
            v2_normal=torch.where(v3, lhs.v2_normal, rhs.v2_normal),
        )
        main = empty
        main_pdf = torch.zeros(shape, device=dev)
        state, main, acc = merge(state, main, rhs, rhs.pdf)
        main_pdf = torch.where(acc, rhs.pdf, main_pdf)
        main = norm_avg(main.replace(confidence=rhs.confidence), main_pdf)

    main = main.replace(pdf=main_pdf, v1_point=surf.point)
    main = clamp_w(main, tuning.gi_w_clamp)
    return select(surf.is_some, main, empty)


def probe_taps(surf: Surface, res: GiReservoirs) -> tuple:
    """The planes gi_spatial's tensor probe fetches at the neighbours:
    ``di.probe_taps`` (depth, normal, gate), the Jacobian's old parts,
    v2_point and v2_normal."""
    p_od, p_oc = jacobian_old_parts(res.v1_point, res.v2_point, res.v2_normal)
    return (*di.probe_taps(surf, res), p_od, p_oc, res.v2_point, res.v2_normal)


def _gi_probe_tensor(camera: Camera, surf: Surface, taps, seed: int, tuning: Tuning, state,
                     rows=None):
    """The tensor probe of gi_spatial: (rhs_x, rhs_y, found, state,
    the clamped Jacobian). ``taps``: ``probe_taps`` over the whole
    screen; with ``rows`` (a ``parallel.rows.RowBlock``) the pixels that
    probe, ``surf``'s, are the block's."""
    shape = surf.depth.shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera, rows)
    radii = shoff.radius_levels(tuning.gi_spatial_radius)
    n_lvls = len(radii)
    n_var = 2
    margin = shoff.probe_margin(tuning.gi_spatial_radius, camera.height, camera.width)

    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    rhs_x = torch.zeros(shape, dtype=torch.int32, device=dev)
    rhs_y = torch.zeros(shape, dtype=torch.int32, device=dev)
    rhs_jac = torch.zeros(shape, device=dev)
    probe = shoff.SharedOffsetTaps(taps, margin=margin, rows=rows)
    level = torch.zeros(shape, dtype=torch.int32, device=dev)
    j_lo, j_hi = 1.0 / tuning.gi_jacobian_reject, tuning.gi_jacobian_reject
    c_lo, c_hi = 1.0 / tuning.gi_jacobian_clamp, tuning.gi_jacobian_clamp
    for nth in range(tuning.gi_spatial_samples):
        dy, dx = shoff.draw_offset_table(try_seed(seed, nth), radii, n_var, margin=margin,
                                         device=dev)
        state, word = rng.next_u32(state)
        sel = level * n_var + (word % n_var).to(torch.int32)
        c_depth, c_normal, c_gate, c_od, c_oc, c_v2, c_v2n = probe.take(dy, dx, sel)
        oy, ox = probe.offset_of(dy, dx, sel)
        cx, cy = contain_xy(camera, xs + ox, ys + oy)
        same = (cx == xs) & (cy == ys)
        depth_bad = torch.abs(c_depth - surf.depth) > 0.33 * surf.depth
        normal_bad = vm.dot(c_normal, surf.normal) < 0.33
        gate_fail = (c_gate < 1.0) | depth_bad | normal_bad
        shrink = ~done & ~same & gate_fail
        level = torch.where(shrink, torch.clamp(level + 1, max=n_lvls - 1), level)
        c_exists = torch.any(c_v2 != 0.0, dim=-1)
        jac = jacobian_apply(c_od, c_oc, c_v2, c_v2n, c_exists, surf.point)
        jac_ok = (jac >= j_lo) & (jac <= j_hi)
        accept = ~done & ~same & ~gate_fail & (c_gate >= 2.0) & jac_ok
        rhs_x = torch.where(accept, cx, rhs_x)
        rhs_y = torch.where(accept, cy, rhs_y)
        rhs_jac = torch.where(accept, torch.clamp(jac, c_lo, c_hi), rhs_jac)
        done = done | accept

    return rhs_x, rhs_y, done, state, rhs_jac


def probe_planes(surf: Surface, res: GiReservoirs):
    """The fused probe's fields after the surface's gates in GI mode: m,
    v1_point, v2_point, v2_normal, the surface point."""
    return (res.m, res.v1_point, res.v2_point, res.v2_normal, surf.point)


def gi_spatial(scene: Scene, camera: Camera, surf: Surface, res: GiReservoirs, seed: int,
               frame: int, tuning: Tuning = DEFAULT_TUNING,
               use_pallas: bool | None = None, rows=None,
               surf_all: Surface | None = None) -> GiReservoirs:
    """DI's spatial reuse plus the reconnection Jacobian (reject outside
    [1/10, 10], clamp to [1/3, 3]) on both the MIS and the merge weight.
    Checkerboarded; the probe takes di_spatial's routes (in GI mode the
    fused probe's Jacobian may differ from the tensor probe's in its last
    bits). With ``rows`` (a ``parallel.rows.RowBlock``) the inputs are
    the block's, and the neighbours are read as di_spatial reads them."""
    shape = surf.depth.shape
    h, w = shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera, rows)
    state = rng.wnoise_new(seed, xs, ys)
    active = checkerboard_active(camera, frame, rows)
    lhs = res

    res_all = whole(rows, res)
    surf_all = whole(rows, surf) if surf_all is None else surf_all
    if _probe_kernel_enabled(use_pallas, rows):
        rhs_x, rhs_y, done, state, rhs_jac = probe_fused(
            camera, surf, probe_planes(surf, res), seed, tuning.gi_spatial_samples, tuning.gi_spatial_radius,
            state, jac_reject=tuning.gi_jacobian_reject, jac_clamp=tuning.gi_jacobian_clamp)
    else:
        rhs_x, rhs_y, done, state, rhs_jac = _gi_probe_tensor(
            camera, surf, probe_taps(surf_all, res_all), seed, tuning, state, rows)

    found = done & active & surf.is_some & ~lhs.is_empty
    rhs, rhs_surf = gather.gather_tree((res_all, surf_all), rhs_y, rhs_x)
    rhs = select(found, rhs, GiReservoirs.empty(shape, dev))

    lhs_rhs_pdf = torch.where(found, sample_pdf(lhs, rhs_surf), 0.0)
    rhs_lhs_pdf = torch.where(found, sample_pdf(rhs, surf), 0.0)
    a_o, a_d, a_len = sample_ray(lhs, rhs_surf.point)
    b_o, b_d, b_len = sample_ray(rhs, surf.point)
    a_len = torch.where(found & (lhs_rhs_pdf > 0.0), a_len, 0.0)
    b_len = torch.where(found & (rhs_lhs_pdf > 0.0), b_len, 0.0)
    if cb.compaction_pays(scene, w):
        parity = cb.row_parity(int(frame) // 2 + 1, h, dev, span(rows, h)[0])
        a_occ, b_occ = cb.paired_anyhit(
            trace_anyhit, scene, parity, (a_o, a_d, a_len), (b_o, b_d, b_len)
        )
    else:
        a_occ = trace_anyhit(scene, a_o, a_d, a_len)
        b_occ = trace_anyhit(scene, b_o, b_d, b_len)
    lhs_rhs_vis = torch.where(a_occ, 0.0, 1.0)
    rhs_lhs_vis = torch.where(b_occ, 0.0, 1.0)

    mis = mis_eval(
        lhs_m=lhs.m, rhs_m=rhs.m, rhs_jacobian=rhs_jac, lhs_lhs_pdf=lhs.pdf,
        lhs_rhs_pdf=lhs_rhs_pdf * lhs_rhs_vis, rhs_lhs_pdf=rhs_lhs_pdf * rhs_lhs_vis,
        rhs_rhs_pdf=rhs.pdf,
    )
    main = GiReservoirs.empty(shape, dev)
    main_pdf = torch.zeros(shape, device=dev)
    state, main, acc = update(state, main, lhs, mis.lhs_mis * mis.lhs_pdf * lhs.w)
    main_pdf = torch.where(acc, mis.lhs_pdf, main_pdf)
    state, main, acc = update(state, main, rhs, mis.rhs_mis * mis.rhs_pdf * rhs.w * rhs_jac)
    main_pdf = torch.where(acc, mis.rhs_pdf, main_pdf)
    main = main.replace(m=lhs.m + mis.m, confidence=torch.ones(shape, device=dev),
                        pdf=main_pdf, v1_point=lhs.v1_point)
    main = clamp_w(norm_mis(main, main_pdf), tuning.gi_w_clamp)
    return select(found, main, lhs)


def gi_preview(scene: Scene, camera: Camera, surf: Surface, center: GiReservoirs,
               neighbors: GiReservoirs, seed: int, max_radius: float,
               tuning: Tuning = DEFAULT_TUNING, rows=None,
               surf_all: Surface | None = None) -> GiReservoirs:
    """Merge-only spatial pass (no visibility rays) over up to 8 - m
    disk samples: depth gate 25%, normal gate 0.5, Jacobian-weighted
    merges, norm_avg. With ``rows`` (a ``parallel.rows.RowBlock``) the
    inputs are the block's: the neighbours' planes are gathered to the
    whole screen (one all-gather), and their surface is ``surf_all``'s
    (gathered here where not given)."""
    shape = surf.depth.shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera, rows)
    state = rng.wnoise_new(seed, xs, ys)

    main = GiReservoirs.empty(shape, dev)
    main_pdf = torch.zeros(shape, device=dev)
    state, main, acc = merge(state, main, center, center.pdf)
    main_pdf = torch.where(acc, center.pdf, main_pdf)
    # max_samples = floor(lerp(8, 0, m / 8))
    max_samples = torch.floor(8.0 * (1.0 - torch.clamp(main.m / 8.0, 0.0, 1.0))).to(torch.int32)

    n_var = 4
    margin = shoff.probe_margin(max_radius, camera.height, camera.width)
    nb_od, nb_oc = jacobian_old_parts(neighbors.v1_point, neighbors.v2_point, neighbors.v2_normal)
    surf_all = whole(rows, surf) if surf_all is None else surf_all
    probe = shoff.SharedOffsetTaps(
        (surf_all.depth, surf_all.normal, surf_all.is_some,
         *whole(rows, (neighbors.m, neighbors.w, neighbors.radiance, neighbors.v2_point,
                       neighbors.v2_normal, nb_od, nb_oc))),
        margin=margin, rows=rows,
    )
    j_lo, j_hi = 1.0 / tuning.gi_jacobian_reject, tuning.gi_jacobian_reject
    c_lo, c_hi = 1.0 / tuning.gi_jacobian_clamp, tuning.gi_jacobian_clamp
    zero = torch.zeros(shape, device=dev)
    zero3 = torch.zeros(shape + (3,), device=dev)
    zero_rng = torch.zeros(shape, dtype=torch.int64, device=dev)
    stopped = torch.zeros(shape, dtype=torch.bool, device=dev)
    for nth in range(8):
        dy, dx = shoff.draw_offset_table(try_seed(seed, nth), (max_radius,), n_var,
                                         margin=margin, device=dev)
        state, word = rng.next_u32(state)
        sel = (word % n_var).to(torch.int32)
        c_depth, c_normal, c_some, c_m, c_w, c_rad, c_v2, c_v2n, c_od, c_oc = probe.take(
            dy, dx, sel
        )
        oy, ox = probe.offset_of(dy, dx, sel)
        cx, cy = contain_xy(camera, xs + ox, ys + oy)
        same = (cx == xs) & (cy == ys)
        stopped = stopped | same  # the reference bails out entirely here
        in_budget = nth < max_samples
        depth_bad = torch.abs(c_depth - surf.depth) > 0.25 * surf.depth
        normal_bad = vm.dot(c_normal, surf.normal) < 0.5
        cand = GiReservoirs(m=c_m, w=c_w, pdf=zero, confidence=zero, rng=zero_rng,
                            radiance=c_rad, v1_point=zero3, v2_point=c_v2, v2_normal=c_v2n)
        cpdf = sample_pdf(cand, surf)
        jac = jacobian_apply(c_od, c_oc, c_v2, c_v2n, cand.exists, surf.point)
        jac_ok = (jac >= j_lo) & (jac <= j_hi)
        jac = torch.clamp(jac, c_lo, c_hi)
        ok = in_budget & ~stopped & c_some & ~depth_bad & ~normal_bad & ~cand.is_empty & jac_ok
        state, main, acc = merge(state, main, cand, cpdf * jac, ok)
        main_pdf = torch.where(acc, cpdf, main_pdf)

    main = main.replace(confidence=center.confidence, pdf=main_pdf, v1_point=center.v1_point)
    main = clamp_w(norm_avg(main, main_pdf), tuning.gi_w_clamp)
    return select(surf.is_some, main, GiReservoirs.empty(shape, dev))


def gi_resolve(surf: Surface, res: GiReservoirs):
    """radiance = w * cosine * sample radiance, demodulated into diffuse
    and specular with the confidence in alpha."""
    cosine = sample_cosine(res, surf)
    rad = res.w[..., None] * cosine[..., None] * res.radiance
    rad = torch.where(surf.is_some[..., None], rad, 0.0)
    confidence = torch.where(surf.is_some, res.confidence, 1.0)
    diff_brdf = (1.0 - surf.metallic) / math.pi
    d = sample_dir(res, surf.point)
    spec_brdf = brdf.specular_eval(surf.base_color, surf.metallic, surf.roughness,
                                   surf.reflectance, surf.normal, d, -surf.dir)
    diff = rad * diff_brdf[..., None]
    spec = rad * spec_brdf
    return (
        torch.cat([diff, confidence[..., None]], dim=-1),
        torch.cat([spec, confidence[..., None]], dim=-1),
    )


def gi_pipeline(scene: Scene, camera: Camera, surf: Surface, prev_surf: Surface,
                reproj: Reprojection, gi_prev: GiReservoirs, seed: int, frame: int,
                bnoise_second=None, luts=None, use_pallas: bool | None = None,
                tuning: Tuning = DEFAULT_TUNING, prefetched=None, rows=None, surf_all=None):
    """The per-frame GI schedule. Sampling runs on even tracing frames
    and on all validation frames; odd tracing frames skip it and run the
    spatial pass instead. With ``rows`` (a ``parallel.rows.RowBlock``)
    the per-pixel inputs and outputs are the block's, while ``prev_surf``,
    ``gi_prev`` and ``surf_all`` (``surf`` gathered; here where not given)
    cover the whole screen."""
    from ..models.restir import derive_seed

    frame = int(frame)
    surf_all = whole(rows, surf) if surf_all is None else surf_all
    tracing = is_gi_tracing(frame)
    rep, rep_surf = gi_reproject(camera, surf, reproj, gi_prev, prev_surf, prefetched)
    odd_tracing = tracing and frame % 2 == 1
    if odd_tracing:
        cand = GiReservoirs.empty(surf.depth.shape, surf.depth.device)
    else:
        cand = gi_sampling(scene, camera, surf, rep, derive_seed(seed, 10),
                           derive_seed(seed, 11), frame, luts, use_pallas, tuning, rows)
    t = gi_temporal(scene, camera, surf, prev_surf, reproj, cand, rep, derive_seed(seed, 12),
                    frame, tuning, rhs_surf=rep_surf, rows=rows)
    if odd_tracing:
        source = gi_spatial(scene, camera, surf, t, derive_seed(seed, 13), frame, tuning,
                            use_pallas, rows, surf_all)
    else:
        source = t
    p1 = gi_preview(scene, camera, surf, source, source, derive_seed(seed, 14),
                    tuning.gi_spatial_radius, tuning, rows, surf_all)
    p2 = gi_preview(scene, camera, surf, p1, p1, derive_seed(seed, 15),
                    tuning.gi_spatial_radius / 2.0, tuning, rows, surf_all)
    diff, spec = gi_resolve(surf, p2)
    return diff, spec, source

"""ReSTIR DI: initial candidates, temporal reuse, spatial reuse, resolve
(port of strolle_tpu/restir/di.py).

    sampling               -> A   (fresh candidates, m = 1)
    temporal(prev=di0, A)  -> B
    spatial(B)             -> C   (checkerboarded half; other half = B)
    resolving(C)           -> di0' + demodulated diffuse/specular

The neighbour probe of the spatial pass has the JAX package's two
routes: by default the tensor probe (shared offset tables,
ops/offsets.py), and with ``STROLLE_PROBE_KERNEL=1`` in the environment
(read on the host at each call) the fused probe, ``probe_fused``: the
route entry of ``ops/kernels/probe_kernels.py`` (on the card one launch
of kernel 7, which draws the tables itself), unless the caller passes
``use_pallas=False``, as the differentiable frame does. In DI mode the
two routes give the same result.
"""

from __future__ import annotations

import math
import os

import torch

from ..camera import Camera, contain_xy, screen_xy
from ..config import DEFAULT_TUNING, Tuning
from ..ops import checkerboard as cb
from ..ops import gather, math as vm, offsets as shoff, rng
from ..ops.hit import Surface
from ..ops.kernels import probe_kernels
from ..ops.kernels.probe_kernels import try_seed
from ..ops.lights import gather_light, radiance, shadow_ray_bnoise
from ..ops.trace import _TRACE_MESH, trace_anyhit
from ..scene.types import LIGHT_NONE, Scene
from . import reservoir as rsv
from .mis import mis_eval
from .primary import Reprojection


def _white(surf: Surface) -> Surface:
    return surf.replace(base_color=torch.ones_like(surf.base_color))


def di_sample_pdf(scene: Scene, light_id, light_point, surf: Surface, prev=False):
    """Luma of the light's radiance at the hit with white albedo; zero
    for dead lights or points outside the light sphere."""
    light = gather_light(scene.lights, light_id, prev=prev)
    rad = radiance(light, _white(surf))
    ok = (light.kind != LIGHT_NONE) & (vm.length(light.pos - light_point) <= light.radius)
    return torch.where(ok & surf.is_some, vm.luma(rad.sum), 0.0)


def sample_shadow_ray(light_point, hit_point):
    """From the stored light point toward the hit: (origin, dir, length)."""
    d = hit_point - light_point
    length = vm.length(d)
    return light_point, d / torch.clamp(length, min=1e-20)[..., None], length


def _candidate_pdf(scene: Scene, surf: Surface, light_id) -> torch.Tensor:
    """perc_luma of the drawn light's radiance at every pixel (white
    albedo). The JAX package evaluates all lights as [H, W, L] planes
    and selects; evaluating the drawn light gives the same values."""
    rad = radiance(gather_light(scene.lights, light_id), _white(surf))
    return vm.perc_luma(rad.radiance)


def di_sampling(scene: Scene, camera: Camera, surf: Surface, seed: int,
                bnoise_sample, tuning: Tuning = DEFAULT_TUNING) -> rsv.DiReservoirs:
    """RIS over up to 16 uniform light picks, then one blue-noise shadow
    ray; occluded candidates keep their sample with w = 0."""
    shape = surf.depth.shape
    dev = surf.depth.device
    xs, ys = screen_xy(camera)
    state = rng.wnoise_new(seed, xs, ys)

    lcount = scene.lights.count
    max_samples = min(lcount, tuning.di_candidates)
    sample_ipdf = float(lcount)

    eph = rsv.DiReservoirs.empty(shape, dev)
    eph_pdf = torch.zeros(shape, device=dev)
    for nth in range(min(tuning.di_candidates, scene.lights.capacity)):
        state, word = rng.next_u32(state)
        light_id = (word % max(lcount, 1)).to(torch.int32)
        if nth >= max_samples:
            # a disabled candidate changes nothing but the RNG, which
            # still draws the update's acceptance word
            state, _ = rng.next_u32(state)
            continue
        cand_pdf = _candidate_pdf(scene, surf, light_id)
        cand = eph.replace(light_id=light_id, pdf=cand_pdf)
        state, eph, accepted = rsv.update(state, eph, cand, cand_pdf * sample_ipdf, surf.is_some)
        eph_pdf = torch.where(accepted, cand_pdf, eph_pdf)
    eph = rsv.norm_avg(eph, eph_pdf)

    light = gather_light(scene.lights, eph.light_id)
    sr_o, sr_d, sr_len = shadow_ray_bnoise(bnoise_sample, light, surf.point)
    occluded = trace_anyhit(scene, sr_o, sr_d, sr_len)

    valid = (eph.m > 0.0) & surf.is_some
    return rsv.DiReservoirs(
        m=torch.where(valid, 1.0, 0.0),
        w=torch.where(valid & ~occluded, eph.w, 0.0),
        pdf=torch.zeros(shape, device=dev),
        confidence=torch.zeros(shape, device=dev),
        light_id=torch.where(valid, eph.light_id, 0),
        light_point=torch.where(valid[..., None], sr_o, 0.0),
        is_occluded=occluded & valid,
    )


def di_temporal(scene: Scene, camera: Camera, surf: Surface, prev_surf: Surface,
                reproj: Reprojection, curr: rsv.DiReservoirs, prev: rsv.DiReservoirs,
                seed: int, tuning: Tuning = DEFAULT_TUNING,
                prefetched=None) -> rsv.DiReservoirs:
    """Temporal merge with the reprojected history: M clamp, light
    kill/remap, defensive pairwise MIS, norm_mis. ``prefetched``:
    (rhs, rhs_surf) already gathered at the reprojected position."""
    xs, ys = screen_xy(camera)
    state = rng.wnoise_new(seed, xs, ys)
    shape = surf.depth.shape
    dev = surf.depth.device

    lhs = curr.replace(
        pdf=torch.where(
            ~curr.is_empty, di_sample_pdf(scene, curr.light_id, curr.light_point, surf),
            curr.pdf,
        )
    )
    has_rep = reproj.is_some
    if prefetched is not None:
        rhs, rhs_surf = prefetched
    else:
        rpx, rpy = reproj.prev_xy_round
        rx = torch.clamp(rpx, 0, camera.width - 1)
        ry = torch.clamp(rpy, 0, camera.height - 1)
        rhs, rhs_surf = gather.gather_tree((prev, prev_surf), ry, rx)
    rhs = rsv.select(has_rep, rhs, rsv.DiReservoirs.empty(shape, dev))
    rhs = rsv.clamp_m(rhs, tuning.di_temporal_m_clamp)

    # light slot lifecycle (kill / remap)
    lid = torch.clamp(rhs.light_id, 0, scene.lights.capacity - 1).long()
    killed = (scene.lights.killed[lid] != 0) & ~rhs.is_empty
    remapped = scene.lights.remap[lid]
    rhs = rhs.replace(
        w=torch.where(killed, 0.0, rhs.w),
        light_id=torch.where((remapped >= 0) & ~killed & ~rhs.is_empty, remapped, rhs.light_id),
    )

    lhs_rhs_pdf = torch.where(
        (lhs.m > 0.0) & rhs_surf.is_some,
        di_sample_pdf(scene, lhs.light_id, lhs.light_point, rhs_surf, prev=True),
        0.0,
    )
    rhs_lhs_pdf = torch.where(
        (rhs.m > 0.0) & ~killed, di_sample_pdf(scene, rhs.light_id, rhs.light_point, surf), 0.0
    )
    mis = mis_eval(
        lhs_m=lhs.m, rhs_m=rhs.m, rhs_jacobian=torch.ones(shape, device=dev),
        lhs_lhs_pdf=lhs.pdf, lhs_rhs_pdf=lhs_rhs_pdf, rhs_lhs_pdf=rhs_lhs_pdf,
        rhs_rhs_pdf=rhs.pdf,
    )
    main = rsv.DiReservoirs.empty(shape, dev)
    main_pdf = torch.zeros(shape, device=dev)
    state, main, acc = rsv.update(state, main, lhs, mis.lhs_mis * mis.lhs_pdf * lhs.w)
    main_pdf = torch.where(acc, mis.lhs_pdf, main_pdf)
    state, main, acc = rsv.update(state, main, rhs, mis.rhs_mis * mis.rhs_pdf * rhs.w)
    main_pdf = torch.where(acc, mis.rhs_pdf, main_pdf)
    main = main.replace(m=lhs.m + mis.m, pdf=main_pdf,
                        confidence=torch.where(killed, 0.0, 1.0))
    main = rsv.norm_mis(main, main_pdf)
    return rsv.select(surf.is_some, main, rsv.DiReservoirs.empty(shape, dev))


def checkerboard_active(camera: Camera, frame: int) -> torch.Tensor:
    """Pixels the spatial pass processes this frame: x parity equals
    (frame // 2 + 1 + y) % 2."""
    xs, ys = screen_xy(camera)
    return (xs % 2) == ((int(frame) // 2 + 1 + ys) % 2)


def _di_probe_tensor(camera: Camera, surf: Surface, res: rsv.DiReservoirs, seed: int,
                     tuning: Tuning, state):
    """The tensor probe of di_spatial: (rhs_x, rhs_y, found, state)."""
    h, w = surf.depth.shape
    shape = (h, w)
    dev = surf.depth.device
    xs, ys = screen_xy(camera)
    radii = shoff.radius_levels(tuning.di_spatial_radius)
    n_lvls = len(radii)
    n_var = 2
    margin = shoff.probe_margin(tuning.di_spatial_radius, h, w)

    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    rhs_x = torch.zeros(shape, dtype=torch.int32, device=dev)
    rhs_y = torch.zeros(shape, dtype=torch.int32, device=dev)
    # 0 = sky, 1 = surface with an empty reservoir, 2 = surface and m > 0
    gate = torch.where(surf.is_some, torch.where(res.m > 0.0, 2.0, 1.0), 0.0)
    probe = shoff.SharedOffsetTaps((surf.depth, surf.normal, gate), margin=margin)
    level = torch.zeros(shape, dtype=torch.int32, device=dev)
    for nth in range(tuning.di_spatial_samples):
        dy, dx = shoff.draw_offset_table(try_seed(seed, nth), radii, n_var, margin=margin,
                                         device=dev)
        state, word = rng.next_u32(state)
        sel = level * n_var + (word % n_var).to(torch.int32)
        c_depth, c_normal, c_gate = probe.take(dy, dx, sel)
        oy, ox = probe.offset_of(dy, dx, sel)
        cx, cy = contain_xy(camera, xs + ox, ys + oy)
        same = (cx == xs) & (cy == ys)
        depth_bad = torch.abs(c_depth - surf.depth) > 0.33 * surf.depth
        normal_bad = vm.dot(c_normal, surf.normal) < 0.33
        gate_fail = (c_gate < 1.0) | depth_bad | normal_bad
        shrink = ~done & ~same & gate_fail
        level = torch.where(shrink, torch.clamp(level + 1, max=n_lvls - 1), level)
        accept = ~done & ~same & ~gate_fail & (c_gate >= 2.0)
        rhs_x = torch.where(accept, cx, rhs_x)
        rhs_y = torch.where(accept, cy, rhs_y)
        done = done | accept

    return rhs_x, rhs_y, done, state


def _probe_kernel_enabled(use_pallas) -> bool:
    """The fused probe runs when ``STROLLE_PROBE_KERNEL=1``, the caller
    does not ask for the tensor route (``use_pallas=False``) and no device
    mesh splits the frame's trace rows (``ops.trace.trace_rows_sharded``):
    under a mesh the JAX package takes the tensor probe, which in GI mode
    is not bit-equal to the kernel."""
    return (os.environ.get("STROLLE_PROBE_KERNEL", "0") == "1" and use_pallas is not False
            and _TRACE_MESH.get() is None)


def _draw_probe_tables(seed: int, tries: int, radii, n_var: int, margin: int, device):
    """The per-try shared offset tables, concatenated [tries * V]:
    exactly the draws the tensor probe makes."""
    dys, dxs = zip(*(shoff.draw_offset_table(try_seed(seed, nth), radii, n_var, margin=margin,
                                             device=device) for nth in range(tries)))
    return torch.cat(dys), torch.cat(dxs)


def _probe_kw(surf: Surface, tries: int, radius: float, gi_kw: dict) -> dict:
    """The keyword arguments both entries of kernel 7 share for one pass."""
    h, w = surf.depth.shape
    return dict(mode="gi" if gi_kw else "di", tries=tries, n_var=2,
                margin=shoff.probe_margin(radius, h, w), depth_tol=0.33, normal_min=0.33,
                **gi_kw)


def probe_inputs(surf: Surface, planes, seed: int, tries: int, radius: float, **gi_kw):
    """Kernel 7's stack-entry inputs for one spatial pass, in the JAX
    kernel's layout: (stack, dy_tab, dx_tab, the keyword arguments of
    ``probe_kernels.probe_spatial``). The stack is the surface's gate
    planes (depth, normal, is_some) and ``planes`` (m, then in GI mode,
    given ``jac_reject`` and ``jac_clamp``, the reservoir's and the
    surface's points, ``gi.probe_planes``: three planes each). The
    spatial passes build none of it: their route, ``probe_fused``, reads
    the fields where they lie."""
    radii = shoff.radius_levels(radius)
    kw = dict(_probe_kw(surf, tries, radius, gi_kw), n_lvls=len(radii))
    dy_tab, dx_tab = _draw_probe_tables(seed, tries, radii, 2, kw["margin"], surf.depth.device)
    m, *vectors = planes
    stack = torch.stack([surf.depth, *surf.normal.unbind(-1), surf.is_some.to(torch.float32), m,
                         *(c for f in vectors for c in f.unbind(-1))])
    return stack, dy_tab, dx_tab, kw


def probe_fused(camera: Camera, surf: Surface, planes, seed: int, tries: int, radius: float,
                state, **gi_kw):
    """The fused probe route of the spatial passes: kernel 7's route entry
    (``probe_kernels.probe_route``) over the surface's depth, normal and
    is_some and ``planes`` (m, then in GI mode, given ``jac_reject`` and
    ``jac_clamp``, ``gi.probe_planes``), read where they lie, with the
    offset tables drawn from ``seed`` as ``_draw_probe_tables`` draws
    them. ``state`` is the pass's stream, ``rng.wnoise_new(seed, x, y)``
    on ``camera``'s pixels. Returns (rhs_x, rhs_y, found, state advanced
    by one word per try, [the clamped Jacobian]): the accepted
    neighbour's mirrored coordinates (0 where none), as the tensor probe
    gives them. On the card this is one kernel launch; on the CPU the
    route entry's plain version."""
    if tuple(surf.depth.shape) != (camera.height, camera.width):
        raise ValueError(f"probe_fused: fields of shape {tuple(surf.depth.shape)} for a "
                         f"{camera.width}x{camera.height} camera")
    return probe_kernels.probe_route((surf.depth, surf.normal, surf.is_some, *planes), seed,
                                     state, radii=shoff.radius_levels(radius),
                                     **_probe_kw(surf, tries, radius, gi_kw))


def di_spatial(scene: Scene, camera: Camera, surf: Surface, res: rsv.DiReservoirs,
               seed: int, frame: int, tuning: Tuning = DEFAULT_TUNING,
               use_pallas: bool | None = None) -> rsv.DiReservoirs:
    """Checkerboarded spatial reuse: one similar neighbour in <= 8 tries
    at shared offsets (radius 128 px halving to >= 5 on rejection, depth
    within 33%, normal dot >= 0.33), both cross-visibility rays traced,
    merged with visibility-weighted MIS. The other half passes through.
    The probe takes the fused route where ``_probe_kernel_enabled``."""
    h, w = surf.depth.shape
    shape = (h, w)
    dev = surf.depth.device
    xs, ys = screen_xy(camera)
    state = rng.wnoise_new(seed, xs, ys)
    active = checkerboard_active(camera, frame)
    lhs = res

    if _probe_kernel_enabled(use_pallas):
        rhs_x, rhs_y, done, state = probe_fused(
            camera, surf, (res.m,), seed, tuning.di_spatial_samples, tuning.di_spatial_radius, state)
    else:
        rhs_x, rhs_y, done, state = _di_probe_tensor(camera, surf, res, seed, tuning, state)

    found = done & active & surf.is_some
    rhs, rhs_surf = gather.gather_tree((res, surf), rhs_y, rhs_x)
    rhs = rsv.select(found, rhs, rsv.DiReservoirs.empty(shape, dev))

    lhs_rhs_pdf = torch.where(
        found, di_sample_pdf(scene, lhs.light_id, lhs.light_point, rhs_surf), 0.0
    )
    rhs_lhs_pdf = torch.where(
        found, di_sample_pdf(scene, rhs.light_id, rhs.light_point, surf), 0.0
    )
    # cross-visibility rays
    a_o, a_d, a_len = sample_shadow_ray(lhs.light_point, rhs_surf.point)
    b_o, b_d, b_len = sample_shadow_ray(rhs.light_point, surf.point)
    a_len = torch.where(found & (lhs_rhs_pdf > 0.0), a_len, 0.0)
    b_len = torch.where(found & (rhs_lhs_pdf > 0.0), b_len, 0.0)
    if cb.compaction_pays(scene, w):
        parity = cb.row_parity(int(frame) // 2 + 1, h, dev)
        a_occ, b_occ = cb.paired_anyhit(
            trace_anyhit, scene, parity, (a_o, a_d, a_len), (b_o, b_d, b_len)
        )
    else:
        a_occ = trace_anyhit(scene, a_o, a_d, a_len)
        b_occ = trace_anyhit(scene, b_o, b_d, b_len)
    lhs_rhs_vis = torch.where(a_occ, 0.0, 1.0)
    rhs_lhs_vis = torch.where(b_occ, 0.0, 1.0)

    mis = mis_eval(
        lhs_m=lhs.m, rhs_m=rhs.m, rhs_jacobian=torch.ones(shape, device=dev),
        lhs_lhs_pdf=lhs.pdf, lhs_rhs_pdf=lhs_rhs_pdf * lhs_rhs_vis,
        rhs_lhs_pdf=rhs_lhs_pdf * rhs_lhs_vis, rhs_rhs_pdf=rhs.pdf,
    )
    main = rsv.DiReservoirs.empty(shape, dev)
    main_pdf = torch.zeros(shape, device=dev)
    state, main, acc = rsv.update(state, main, lhs, mis.lhs_mis * mis.lhs_pdf * lhs.w)
    main_pdf = torch.where(acc, mis.lhs_pdf, main_pdf)
    state, main, acc = rsv.update(state, main, rhs, mis.rhs_mis * mis.rhs_pdf * rhs.w)
    main_pdf = torch.where(acc, mis.rhs_pdf, main_pdf)
    # the reference sets the merged sample's occlusion flag from the
    # lhs@rhs visibility here; reproduced as it is
    main = main.replace(is_occluded=torch.where(acc, lhs_rhs_vis == 0.0, main.is_occluded))
    main = main.replace(m=lhs.m + mis.m, pdf=main_pdf)
    main = rsv.norm_mis(main, main_pdf)
    return rsv.select(found, main, lhs)


def di_resolving(scene: Scene, camera: Camera, surf: Surface, res: rsv.DiReservoirs,
                 sky_radiance: torch.Tensor):
    """Final DI shade: re-trace the winning shadow ray, derive the
    temporal confidence (0 where the occlusion flag flipped), output
    demodulated diffuse + specular with the confidence in alpha, and
    keep the reservoir as next frame's history."""
    sr_o, sr_d, sr_len = sample_shadow_ray(res.light_point, surf.point)
    sr_len = torch.where(surf.is_some, sr_len, 0.0)
    is_occluded = trace_anyhit(scene, sr_o, sr_d, sr_len)

    confidence = torch.where(res.is_occluded == is_occluded, res.confidence, 0.0)
    out_res = res.replace(
        confidence=torch.where(surf.is_some, 1.0, res.confidence),
        is_occluded=torch.where(surf.is_some, is_occluded, res.is_occluded),
    )
    light = gather_light(scene.lights, res.light_id)
    rad = radiance(light, surf)
    lit = surf.is_some & ~is_occluded
    rad_rgb = torch.where(lit[..., None], rad.radiance * res.w[..., None], 0.0)
    spec_brdf = torch.where(lit[..., None], rad.spec_brdf, 0.0)
    rad_rgb = torch.where(surf.is_some[..., None], rad_rgb, sky_radiance)
    confidence = torch.where(surf.is_some, confidence, 1.0)

    diff_brdf = (1.0 - surf.metallic) / math.pi
    diff = rad_rgb * diff_brdf[..., None]
    spec = rad_rgb * spec_brdf
    return (
        torch.cat([diff, confidence[..., None]], dim=-1),
        torch.cat([spec, confidence[..., None]], dim=-1),
        out_res,
    )

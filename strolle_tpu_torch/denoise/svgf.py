"""SVGF-style denoiser: temporal accumulation + variance + à-trous
(port of strolle_tpu/denoise/svgf.py, forward pass).

* temporal reprojection with history clamp 16; the confidence the
  resolving passes write in the sample's alpha resets history at 0;
* variance from the temporal moments once history >= 4, else a 5x5
  weighted spatial estimate x4;
* 5 à-trous iterations (3x3 taps, strides 1, 2, 4, 8, 16, strength 1..5,
  blue-noise jittered), the first iteration's output kept as next
  frame's colour history;
* edge-stopping weight exp(-|sqrt-luma diff| * sigma_l) * depth leeway *
  normal^64.

The JAX package's deviations from the reference are reproduced: the
jitter moves each sampled field once per pass (each tap reads the
jitter at its own pixel), and the luma-sigma ramp saturates at var = 1.
Fixed-offset taps are clamped-index gathers here (the JAX package's
edge pad + slice). With ``rows`` (a ``parallel.rows.RowBlock``) the
per-pixel inputs and outputs are a row block's: each cross-pixel read
(the bilinear history, the 5x5 variance taps, each à-trous pass's
jittered 3x3 taps) first gathers the whole screen of the arrays it taps,
then taps them at global coordinates, clamped and masked at the image's
edge. That split is forward only. The à-trous iteration carries the JAX
package's custom VJP (``_WaveletCore``): its backward pass freezes the
edge-stopping weights and pushes the colour cotangent through the exact
adjoint of the remaining linear filter.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bluenoise, math as vm
from ..ops.hit import Surface
from ..parallel.rows import span, whole
from ..restir.primary import Reprojection, bilinear_reproject

HISTORY_CLAMP = 16.0
VARIANCE_MIN_HISTORY = 4.0
WAVELET_PASSES = 5

#: luma-sigma ramps (lerp(a, b, sqrt(var))) per channel kind
LUMA_SIGMA = {"di": (2.5, 0.5), "gi": (1.0, 0.0)}


@dataclasses.dataclass(frozen=True)
class DenoiserState:
    """Temporal history of one denoised channel."""

    prev_color: torch.Tensor  # f32[H, W, 3] post-first-wavelet colours
    prev_moments: torch.Tensor  # f32[H, W, 3] (history, m1, m2)

    @staticmethod
    def empty(shape, device) -> "DenoiserState":
        z = torch.zeros(tuple(shape) + (3,), dtype=torch.float32, device=device)
        return DenoiserState(prev_color=z, prev_moments=z.clone())


def _safe_sqrt(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x > 0.0, torch.sqrt(torch.clamp(x, min=1e-12)), 0.0)


def _sample_weight(center_luma, center_depth, center_normal, sample_luma, sample_depth,
                   sample_normal, luma_sigma, depth_sigma):
    luma_w = torch.abs(_safe_sqrt(center_luma) - _safe_sqrt(sample_luma)) * luma_sigma
    leeway = center_depth * depth_sigma
    diff = torch.abs(sample_depth - center_depth)
    depth_w = torch.where(diff >= leeway, 0.0, 1.0 - diff / torch.clamp(leeway, min=1e-20))
    normal_w = torch.clamp(vm.dot(sample_normal, center_normal), min=0.0)
    for _ in range(6):  # ^64
        normal_w = normal_w * normal_w
    return torch.exp(-luma_w) * depth_w * normal_w


def _axis(n: int, d: int, device, start: int = 0, count: int | None = None):
    """Indices i + d of the ``count`` indices from ``start`` (all ``n`` by
    default), clamped to [0, n), and their in-bounds mask."""
    i = torch.arange(n if count is None else count, device=device) + (start + d)
    return torch.clamp(i, 0, n - 1), (i >= 0) & (i < n)


def _shift(arr, dy: int, dx: int, rows=None):
    """shifted[y, x] = arr[clamp(y + dy), clamp(x + dx)] and the
    in-bounds mask, over ``arr``'s rows, or over the rows of ``rows`` (a
    ``parallel.rows.RowBlock``) where ``arr`` covers the whole screen."""
    h, w = arr.shape[0], arr.shape[1]
    y0, n = span(rows, h)
    yi, vy = _axis(h, dy, arr.device, y0, n)
    xi, vx = _axis(w, dx, arr.device)
    return arr[yi][:, xi], vy[:, None] & vx[None, :]


def temporal_reproject(samples, surf: Surface, reproj: Reprojection, state: DenoiserState,
                       history_clamp: float = HISTORY_CLAMP, prev_fetched=None, rows=None):
    """Returns (color [H, W, 3], moments [H, W, 3])."""
    sky = ~surf.is_some
    sample_rgb = samples[..., :3]
    sample_luma = vm.luma(sample_rgb)
    prev = prev_fetched
    if prev is None:
        prev = bilinear_reproject(
            reproj, whole(rows, torch.cat([state.prev_color, state.prev_moments], -1)))
    prev_color, prev_moments = prev[..., :3], prev[..., 3:]

    use_hist = reproj.is_some & (samples[..., 3] > 0.0) & ~sky
    history = torch.clamp(prev_moments[..., 0] + 1.0, max=history_clamp)
    alpha = 1.0 / torch.clamp(history, min=1.0)
    color = vm.lerp(prev_color, sample_rgb, alpha[..., None])
    m1 = vm.lerp(prev_moments[..., 1], sample_luma, alpha)
    m2 = vm.lerp(prev_moments[..., 2], sample_luma * sample_luma, alpha)
    moments = torch.stack([history, m1, m2], dim=-1)
    reset = torch.stack([torch.ones_like(history), sample_luma, sample_luma * sample_luma], -1)
    color = torch.where(use_hist[..., None], color, sample_rgb)
    moments = torch.where(use_hist[..., None], moments, reset)
    # sky: colour passes through, moments untouched
    moments = torch.where(sky[..., None], state.prev_moments, moments)
    return color, moments


def estimate_variance(color, moments, surf: Surface,
                      min_history: float = VARIANCE_MIN_HISTORY, rows=None, taps=None):
    """Per-pixel variance [H, W]: temporal where history suffices, else
    the 5x5 weighted spatial estimate x4; 0 on sky. ``taps``: the (luma,
    depth, normal, sky) planes the 5x5 taps read, over the whole screen
    where the inputs are the block of ``rows``; by default the inputs'
    own."""
    sky = ~surf.is_some
    luma = vm.luma(color)
    t_luma, t_depth, t_normal, t_sky = (luma, surf.depth, surf.normal, sky) if taps is None \
        else taps
    var_temporal = moments[..., 2] - vm.sqr(moments[..., 1])
    sum_l = torch.zeros_like(luma)
    sum_l2 = torch.zeros_like(luma)
    sum_w = torch.zeros_like(luma)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            s_luma, valid = _shift(t_luma, dy, dx, rows)
            s_depth, _ = _shift(t_depth, dy, dx, rows)
            s_normal, _ = _shift(t_normal, dy, dx, rows)
            s_sky, _ = _shift(t_sky, dy, dx, rows)
            wgt = _sample_weight(luma, surf.depth, surf.normal, s_luma, s_depth, s_normal,
                                 1.0, 0.2)
            wgt = torch.where(valid & ~s_sky, wgt, 0.0)
            sum_l = sum_l + s_luma * wgt
            sum_l2 = sum_l2 + s_luma * s_luma * wgt
            sum_w = sum_w + wgt
    ok = sum_w > 1e-10
    den = torch.where(ok, sum_w, 1.0)
    m1 = torch.where(ok, sum_l / den, 0.0)
    m2 = torch.where(ok, sum_l2 / den, 0.0)
    var_spatial = torch.abs(m2 - m1 * m1) * 4.0
    var = torch.where(moments[..., 0] >= min_history, var_temporal, var_spatial)
    return torch.where(sky, 0.0, torch.clamp(var, min=0.0))


def _jitter_coords(jy, jx):
    """Where the JAX package's two-pass jitter shift reads from: first
    along y by jy, then along x by jx, each clamped, so the y jitter is
    the one at the x-shifted column."""
    h, w = jy.shape
    dev = jy.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    xq = torch.clamp(xs + jx, 0, w - 1)
    jy_at = torch.gather(jy, 1, xq)
    yq = torch.clamp(ys + jy_at, 0, h - 1)
    return yq, xq


def _wavelet_impl(stride: int, strength: float, sigma_ab, c_lin, c_w, var, depth, normal, skyf,
                  jitter, rows=None, taps=None):
    """One à-trous iteration: 3x3 taps at ``stride`` over the jittered
    fields, edge-stopped; sky pixels pass through. ``c_lin`` is the colour
    the filter is applied to, ``c_w`` the colour its edge-stopping weights
    are computed from: the same tensor in the forward pass, while the
    backward pass applies the filter to the cotangent with ``c_w``
    frozen. Under a row split (forward only) the inputs are the block of
    ``rows``, ``taps`` the tapped fields (c_lin, var, depth, normal, skyf)
    over the whole screen and ``jitter`` the whole screen's."""
    sky = skyf > 0.5
    a, b = sigma_ab
    # the reference's ramp extrapolates above var = 1; saturated here as
    # in the JAX package, so sigma stays in [b, a]
    luma_sigma = vm.lerp(a, b, vm.saturate(torch.sqrt(torch.clamp(var, min=0.0))))
    depth_sigma = 0.33 / strength
    center_luma = vm.luma(c_w)
    same = c_w is c_lin

    sum_w = torch.ones_like(var)
    sum_c = c_lin
    sum_v = var
    fields = (c_lin, var, depth, normal, skyf) + (() if same else (c_w,))
    if taps is not None:
        fields = taps
    if jitter is not None:
        yq, xq = _jitter_coords(*jitter)
        fields = tuple(f[yq, xq] for f in fields)
    j_lin, j_var, j_depth, j_normal, j_skyf = fields[:5]
    j_w = j_lin if same else fields[5]
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            if oy == 0 and ox == 0:
                continue
            s_lin, inb = _shift(j_lin, oy * stride, ox * stride, rows)
            s_w = s_lin if same else _shift(j_w, oy * stride, ox * stride, rows)[0]
            s_var, _ = _shift(j_var, oy * stride, ox * stride, rows)
            s_depth, _ = _shift(j_depth, oy * stride, ox * stride, rows)
            s_normal, _ = _shift(j_normal, oy * stride, ox * stride, rows)
            s_skyf, _ = _shift(j_skyf, oy * stride, ox * stride, rows)
            wgt = _sample_weight(center_luma, depth, normal, vm.luma(s_w), s_depth, s_normal,
                                 luma_sigma, depth_sigma)
            wgt = torch.where(inb & (s_skyf < 0.5) & (wgt > 0.0), wgt, 0.0)
            sum_w = sum_w + wgt
            sum_c = sum_c + wgt[..., None] * s_lin
            sum_v = sum_v + wgt * wgt * s_var
    out_c = sum_c / sum_w[..., None]
    out_v = sum_v / (sum_w * sum_w)
    return torch.where(sky[..., None], c_lin, out_c), torch.where(sky, var, out_v)


class _WaveletCore(torch.autograd.Function):
    """The à-trous iteration with the JAX package's custom VJP
    (``_wavelet_core``): the forward value is ``_wavelet_impl``'s; the
    backward pass freezes the edge-stopping weights computed from the
    primal inputs and pushes the colour cotangent through the exact adjoint
    of the remaining linear filter. Variance, depth, normal and sky get
    zero cotangent, and the variance output passes none back."""

    @staticmethod
    def forward(ctx, color, var, depth, normal, skyf, stride, strength, sigma_ab, jitter, rows,
                taps):
        ctx.save_for_backward(color, var, depth, normal, skyf)
        ctx.statics = (stride, strength, sigma_ab, jitter)
        return _wavelet_impl(stride, strength, sigma_ab, color, color, var, depth, normal, skyf,
                             jitter, rows, taps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_c, g_v):
        color, var, depth, normal, skyf = ctx.saved_tensors
        stride, strength, sigma_ab, jitter = ctx.statics
        with torch.enable_grad():
            # the filter is linear in c_lin: its adjoint at any point
            c = color.detach().requires_grad_()
            out_c, _ = _wavelet_impl(stride, strength, sigma_ab, c, color, var, depth, normal,
                                     skyf, jitter)
            (g_color,) = torch.autograd.grad(out_c, c, g_c)
        return g_color, None, None, None, None, None, None, None, None, None, None


def _wavelet(stride: int, strength: float, sigma_ab, c, var, depth, normal, skyf, jitter,
             rows=None, taps=None):
    """One à-trous iteration (``_wavelet_impl``) with the frozen-weight
    adjoint as its gradient; under a row split (``rows``, ``taps``)
    forward only."""
    return _WaveletCore.apply(c, var, depth, normal, skyf, stride, strength, sigma_ab, jitter,
                              rows, taps)


def denoise_channel(samples, surf: Surface, reproj: Reprojection, state: DenoiserState,
                    frame: int, kind: str = "di", tuning=None, prev_fetched=None, rows=None,
                    surf_all: Surface | None = None):
    """The SVGF chain for one channel. Returns (rgb, new state). With
    ``rows`` (a ``parallel.rows.RowBlock``) the inputs and outputs are the
    block's (forward only): one all-gather of the variance taps' luma,
    then one of each à-trous pass's colour and variance; the taps read
    the surface of ``surf_all``, the whole screen's (gathered here where
    not given)."""
    from ..config import DEFAULT_TUNING

    tuning = tuning or DEFAULT_TUNING
    color, moments = temporal_reproject(samples, surf, reproj, state,
                                        tuning.svgf_history_clamp, prev_fetched, rows)
    taps = geometry = None
    if rows is not None and rows.split:
        surf_all = whole(rows, surf) if surf_all is None else surf_all
        sky_all = ~surf_all.is_some
        taps = (whole(rows, vm.luma(color)), surf_all.depth, surf_all.normal, sky_all)
        geometry = (surf_all.depth, surf_all.normal, sky_all.to(torch.float32))
    var = estimate_variance(color, moments, surf, tuning.svgf_variance_min_history, rows, taps)
    # the jitter of every pixel the taps read: the whole screen's under a split
    h, w = var.shape if taps is None else taps[0].shape
    _, _, bn_x, bn_y = bluenoise.sample_pair_screen(h, w, frame, var.device)
    bn_x = bn_x - 0.5
    bn_y = bn_y - 0.5
    skyf = (~surf.is_some).to(torch.float32)
    sigma_ab = LUMA_SIGMA[kind]
    new_prev_color = None
    for nth in range(tuning.svgf_wavelet_passes):
        stride = 2**nth
        amp = (stride - 1.0) * 0.5
        # int() truncates sub-pixel jitter to 0: the first three strides
        # are unjittered, as in the reference
        jitter = None
        if int(amp * 0.5) > 0:
            jitter = ((bn_y * amp).to(torch.int64), (bn_x * amp).to(torch.int64))
        pass_taps = None if geometry is None else whole(rows, (color, var)) + geometry
        color, var = _wavelet(stride, float(1 + nth), sigma_ab, color, var, surf.depth,
                              surf.normal, skyf, jitter, rows, pass_taps)
        if nth == 0:
            new_prev_color = color
    return color, DenoiserState(prev_color=new_prev_color, prev_moments=moments)


def denoise_pair(di_samples, gi_samples, surf: Surface, reproj: Reprojection,
                 di_state: DenoiserState, gi_state: DenoiserState, frame: int, tuning=None,
                 rows=None, surf_all: Surface | None = None):
    """SVGF on the DI- and GI-diffuse channels with one shared bilinear
    history fetch. Returns (di_rgb, di_state'), (gi_rgb, gi_state')."""
    prev = bilinear_reproject(
        reproj,
        whole(rows, torch.cat([di_state.prev_color, di_state.prev_moments,
                               gi_state.prev_color, gi_state.prev_moments], dim=-1)),
    )
    di = denoise_channel(di_samples, surf, reproj, di_state, frame, "di", tuning, prev[..., 0:6],
                         rows, surf_all)
    gi = denoise_channel(gi_samples, surf, reproj, gi_state, frame, "gi", tuning, prev[..., 6:12],
                         rows, surf_all)
    return di, gi

"""The realtime ReSTIR DI+GI + SVGF frame against the JAX package.

``test_realtime_stages_match_jax`` runs the JAX package's stage programs
(``_stage_prelude`` ... ``_stage_compose`` of models/restir.py) for
frames 0-6 of Cornell at 32x24 and, at every stage, hands the same
inputs (carried over as numpy) to the port's stage, and the same
denoiser inputs to the port's single-channel stage. It compiles the JAX
frame once (its DI, GI and SVGF stages side by side, in threads), with
2 spatial tries per pass in place of 8 and 4 à-trous
passes in place of 5: the unrolled tries and passes are much of the JAX
compile. Four passes reach stride 8, the first whose blue-noise jitter
is not truncated to zero, so the per-field jitter is held against the
JAX package too; the tries that are cut repeat the same code. Every
other test here runs the port alone, with the default tuning. The JAX frame on
a CPU traces through trace_closest + surface_at, so the port's stages
take ``use_pallas=False``; the fused kernel-4 route is held against that
route separately.

Tolerances. Stage by stage, with equal inputs, float fields agree
within 1e-4 + 1e-3 relative (float32 rounding of XLA:CPU's fused
multiply-adds against unfused PyTorch) on at least 99% of pixels, and
integer fields (light ids, triangle ids, masks) match on at least 99%
of pixels: a last-bit difference can flip a reservoir's ``u * w <
weight`` acceptance or a ray that meets a quad's shared diagonal. Whole
frames that carry their own state can only be compared statistically:
the image means over the 7 frames agree within 1%.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import np_tree, scene_arrays

from strolle_tpu.models import restir as jr
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu.sky.atmosphere import AtmosphereLuts as JaxLuts
from strolle_tpu_torch import convert
from strolle_tpu_torch.config import Tuning
from strolle_tpu_torch.denoise.svgf import DenoiserState
from strolle_tpu_torch.models import restir as tr
from strolle_tpu_torch.ops.hit import Surface
from strolle_tpu_torch.restir.gi import GiReservoirs
from strolle_tpu_torch.restir.primary import Reprojection
from strolle_tpu_torch.restir.reservoir import DiReservoirs
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.sky.atmosphere import luts_for

W, H = 32, 24
FRAMES = 7
ATOL, RTOL = 1e-4, 1e-3
MIN_AGREE = 0.99


def _seed(f: int) -> int:
    return 7 * f + 3


def _port(cls, jax_obj):
    return convert.dataclass_from_arrays(cls, np_tree(jax_obj), "cpu")


def _t(a):
    return convert.tensor_from_array(np.asarray(a), "cpu")


def _flat(x, prefix=""):
    """Leaves of a port or JAX result as {path: numpy array}."""
    if isinstance(x, torch.Tensor):
        return {prefix: x.numpy()}
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: v for n, a in x.items() for k, v in _flat(a, f"{prefix}.{n}").items()}
    if isinstance(x, (tuple, list)):
        return {k: v for i, a in enumerate(x) for k, v in _flat(a, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(x)}


def _agree(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per-pixel agreement [H, W] of one field."""
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        ok = got.astype(np.int64) == want.astype(np.int64)
    else:
        ok = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
        ok |= np.isnan(got) & np.isnan(want)
    return ok.reshape(H, W, -1).all(-1)


def _assert_stage(name: str, got, want, only=None):
    g, w = _flat(got, name), _flat(want, name)
    assert g.keys() == w.keys()
    for k in g:
        agree = _agree(g[k], w[k])
        if only is not None:
            agree = agree[only]
        assert agree.mean() >= MIN_AGREE, f"{k}: {agree.mean():.4f} of pixels agree"


def _compile_stages(jscene, jcam, js, jpre, jh, jluts, jtuning, seed):
    """Compiles the JAX DI, GI and SVGF-pair stage programs of frame 0 at
    once, in three threads (XLA compiles without holding the GIL), so
    that the stage loop finds them compiled: about a fifth less wall time
    than one after another. The pair stage is compiled on zero samples of
    the DI and GI stages' shape, which gives the same program."""
    jsurf, jrep, jsky, jbn1, jbn2 = jpre
    zeros = jnp.zeros((H, W, 4), jnp.float32)
    calls = (
        lambda: jr._stage_gi(jscene, jcam, jsurf, js.prev_surface, jrep, js.gi_prev, seed,
                             js.frame, jbn2, jluts, None, jtuning, None, (jh[1], jh[2])),
        lambda: jr._stage_denoise_pair(zeros, zeros, jsurf, jrep, js.di_diff_denoiser,
                                       js.gi_diff_denoiser, js.frame, jtuning),
        lambda: jr._stage_di(jscene, jcam, jsurf, js.prev_surface, jrep, js.di_prev, seed,
                             js.frame, jbn1, jsky, jtuning, None, None, (jh[0], jh[2])),
    )
    with ThreadPoolExecutor(len(calls)) as pool:
        for done in [pool.submit(lambda c=c: jax.block_until_ready(c())) for c in calls]:
            done.result()


def test_realtime_stages_match_jax():
    jscene = jax_cornell_box()
    jcam = jax_cornell_camera(W, H)
    scene = convert.scene_from_arrays(scene_arrays(jscene), device="cpu")
    cam = convert.camera_from_arrays(np_tree(jcam), device="cpu")
    # both packages take the port's LUTs (held against the JAX LUT
    # generators in test_torch_restir_ops.py): the JAX package's own take
    # about a minute of compile on a CPU
    luts = luts_for(scene.sun_altitude, "cpu")
    jluts = JaxLuts(**{k: jnp.asarray(getattr(luts, k).numpy()) for k in
                       ("transmittance", "scattering", "sky")})
    jtuning = dataclasses.replace(jr.DEFAULT_TUNING, di_spatial_samples=2, gi_spatial_samples=2,
                                  svgf_wavelet_passes=4)
    tuning = Tuning(**dataclasses.asdict(jtuning))

    js = jr.init_state(jcam)
    jax_images = []
    for f in range(FRAMES):
        seed = _seed(f)
        # the JAX state, carried over and back: every field equal
        arrays = np_tree(js)
        state = convert.render_state_from_arrays(arrays, device="cpu")
        assert state.frame == f
        back = convert.render_state_to_arrays(state)
        for k, v in _flat(arrays).items():
            bv = _flat(back)[k]
            assert bv.dtype == v.dtype, k
            np.testing.assert_array_equal(bv, v, err_msg=k)

        jpre = jr._stage_prelude(jscene, jcam, js.prev_camera, js.prev_surface, js.frame,
                                 jluts, False, None, None)
        pre = tr._stage_prelude(scene, cam, state.prev_camera, state.prev_surface, f, luts,
                                False, False)
        # rays from the port's own pixel_rays: a primary ray that meets
        # a shared diagonal may pick the other triangle
        same_tri = pre[0].tri.numpy() == np.asarray(jpre[0].tri)
        assert same_tri.mean() >= MIN_AGREE
        _assert_stage("prelude", pre, jpre, only=same_tri)

        jsurf, jrep, jsky, jbn1, jbn2 = jpre
        surf, rep = _port(Surface, jsurf), _port(Reprojection, jrep)
        jh = jr._stage_history(jcam, jrep, js.di_prev, js.gi_prev, js.prev_surface)
        if f == 0:
            _compile_stages(jscene, jcam, js, jpre, jh, jluts, jtuning, jnp.uint32(seed))
        h = tr._stage_history(cam, rep, state.di_prev, state.gi_prev, state.prev_surface)
        _assert_stage("history", h, jh)

        di_pre = (_port(DiReservoirs, jh[0]), _port(Surface, jh[2]))
        gi_pre = (_port(GiReservoirs, jh[1]), _port(Surface, jh[2]))
        jdi = jr._stage_di(jscene, jcam, jsurf, js.prev_surface, jrep, js.di_prev,
                           jnp.uint32(seed), js.frame, jbn1, jsky, jtuning, None, None,
                           (jh[0], jh[2]))
        di = tr._stage_di(scene, cam, surf, state.prev_surface, rep, state.di_prev, seed, f,
                          _t(jbn1), _t(jsky), tuning, False, di_pre)
        _assert_stage("di", di, jdi)

        jgi = jr._stage_gi(jscene, jcam, jsurf, js.prev_surface, jrep, js.gi_prev,
                           jnp.uint32(seed), js.frame, jbn2, jluts, None, jtuning, None,
                           (jh[1], jh[2]))
        gi = tr._stage_gi(scene, cam, surf, state.prev_surface, rep, state.gi_prev, seed, f,
                          _t(jbn2), luts, False, tuning, gi_pre)
        _assert_stage("gi", gi, jgi)

        jden = jr._stage_denoise_pair(jdi[0], jgi[0], jsurf, jrep, js.di_diff_denoiser,
                                      js.gi_diff_denoiser, js.frame, jtuning)
        den = tr._stage_denoise_pair(_t(jdi[0]), _t(jgi[0]), surf, rep, state.di_diff_denoiser,
                                     state.gi_diff_denoiser, f, tuning)
        _assert_stage("denoise", den, jden)
        # the single-channel stage (the other channel off) on the same
        # inputs, against the JAX package's denoiser output for that
        # channel: its pair stage runs the same denoise_channel on a
        # shared history fetch
        for i, (kind, samples, den_state) in enumerate(
                (("di", jdi[0], state.di_diff_denoiser), ("gi", jgi[0], state.gi_diff_denoiser))):
            single = tr._stage_denoise(_t(samples), surf, rep, den_state, f, kind, tuning)
            _assert_stage(f"denoise_{kind}", single, jden[i])

        jch = jr._stage_compose(jsurf, jden[0][0], jden[1][0], jdi[1], jgi[1])
        ch = tr._stage_compose(surf, _t(jden[0][0]), _t(jden[1][0]), _t(jdi[1]), _t(jgi[1]))
        _assert_stage("compose", ch, jch)
        jax_images.append(np.asarray(jch["image"]))

        js = jr.RenderState(
            frame=js.frame + 1, prev_camera=jcam, prev_surface=jsurf, di_prev=jdi[2],
            gi_prev=jgi[2], di_diff_denoiser=jden[0][1], gi_diff_denoiser=jden[1][1],
        )

    # the port's own frames, carrying their own state, on the same seeds
    state = tr.init_state(cam, device="cpu")
    images = []
    for f in range(FRAMES):
        ch, state = tr.render_frame(scene, cam, state, _seed(f),
                                    tr.RenderConfig(differentiable=True, tuning=tuning),
                                    luts=luts)
        images.append(ch["image"].numpy())
    got, want = np.mean(images), np.mean(jax_images)
    assert abs(got - want) <= 0.01 * want, (got, want)
    for a, b in zip(images, jax_images):
        assert abs(a.mean() - b.mean()) <= 0.02 * b.mean()


def test_render_state_round_trip_from_jax_init_state():
    jcam = jax_cornell_camera(8, 6)
    arrays = np_tree(jr.init_state(jcam))
    state = convert.render_state_from_arrays(arrays, device="cpu")
    mine = tr.init_state(cornell_camera(8, 6, device="cpu"), device="cpu")
    for a, b in ((convert.render_state_to_arrays(state), arrays),
                 (convert.render_state_to_arrays(mine), arrays)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fb:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    luts = convert.luts_from_arrays(
        {k: np.zeros((2, 2, 3), np.float32) for k in ("transmittance", "scattering", "sky")},
        device="cpu")
    assert luts.sky.shape == (2, 2, 3)


def _gi_sampling_frame(f: int) -> bool:
    """GI sampling runs on even tracing frames and on validation frames
    (frame % 6 in {0, 2, 4, 5}); odd tracing frames run the spatial pass."""
    return not (f % 6 < 4 and f % 2 == 1)


def test_frame_launch_schedule_and_routes(monkeypatch):
    """7 frames of the default frame (the kernel-4 route) count their
    trace calls per the GI schedule, stay finite, and agree with the
    trace_closest + surface_at route (RenderConfig(differentiable=True))."""
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk

    calls = {"trace_surface": 0, "trace_anyhit_brute": 0, "trace_closest_brute": 0}

    def counted(name):
        fn = getattr(tk, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    for name in calls:
        monkeypatch.setattr(tk, name, counted(name))
    scene = cornell_box(device="cpu")
    cam = cornell_camera(24, 16, device="cpu")
    fused = tr.init_state(cam, device="cpu")
    split = tr.init_state(cam, device="cpu")
    for f in range(FRAMES):
        before = dict(calls)
        ch, fused = tr.render_frame_fused(scene, cam, fused, _seed(f))
        sampling = _gi_sampling_frame(f)
        # kernel 4: the primaries, and the GI bounce rays on sampling frames
        assert calls["trace_surface"] - before["trace_surface"] == 1 + sampling
        # kernel B: DI sampling, 2 DI spatial, DI resolve; GI sampling's
        # shadow ray or GI spatial's 2 reconnection rays
        assert calls["trace_anyhit_brute"] - before["trace_anyhit_brute"] == 4 + (1 if sampling else 2)
        assert calls["trace_closest_brute"] == before["trace_closest_brute"]
        for k, v in ch.items():
            assert bool(torch.isfinite(v).all()), (f, k)
        ref, split = tr.render_frame(scene, cam, split, _seed(f), tr.RenderConfig(differentiable=True))
        for k in ch:
            close = (ch[k] - ref[k]).abs() <= ATOL
            assert close.float().mean() >= MIN_AGREE, (f, k)
    assert fused.frame == split.frame == FRAMES
    assert calls["trace_closest_brute"] == 7 + 5  # the split route's primaries and bounces
    assert 0.1 < float(ch["image"].mean()) < 2.0

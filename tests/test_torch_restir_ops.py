"""The realtime frame's building blocks against the JAX package:
reservoirs and MIS, blue noise, the shared offset tables and their
mirrored probe, the checkerboard compaction, contain_xy, the screen
gathers, the vector-math helpers and the atmosphere LUTs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.camera import contain_xy as jax_contain_xy
from strolle_tpu.ops import bluenoise as jax_bluenoise
from strolle_tpu.ops import checkerboard as jax_cb
from strolle_tpu.ops import gather as jax_gather
from strolle_tpu.ops import math as jax_vm
from strolle_tpu.ops import offsets as jax_offsets
from strolle_tpu.ops import rng as jax_rng
from strolle_tpu.restir import reservoir as jax_rsv
from strolle_tpu.restir.mis import mis_eval as jax_mis_eval
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu.sky import atmosphere as jax_atm
from strolle_tpu_torch.camera import contain_xy
from strolle_tpu_torch.models.restir import derive_seed
from strolle_tpu_torch.ops import bluenoise, checkerboard as cb, gather, math as vm, offsets, rng
from strolle_tpu_torch.restir import reservoir as rsv
from strolle_tpu_torch.restir.mis import mis_eval
from strolle_tpu_torch.scene.cornell import cornell_camera
from strolle_tpu_torch.sky import atmosphere as atm

RS = np.random.RandomState(11)
H, W = 12, 18


def _t(a):
    return torch.tensor(np.asarray(a))


def _u32_state(n, seed=3):
    x = np.arange(n, dtype=np.uint32)
    return jax_rng.wnoise_new(seed, jnp.asarray(x), jnp.uint32(1)), rng.wnoise_new(
        seed, torch.tensor(x.astype(np.int64)), torch.tensor(1)
    )


def test_reservoir_update_and_merge_match_jax():
    n = 500
    jstate, state = _u32_state(n)
    jres = jax_rsv.DiReservoirs.empty((n,))
    res = rsv.DiReservoirs.empty((n,), "cpu")
    for k in range(5):
        wgt = RS.uniform(0.0, 2.0, n).astype(np.float32)
        on = RS.uniform(size=n) < 0.8
        jcand = jres.replace(light_id=jnp.full((n,), k, jnp.int32))
        cand = res.replace(light_id=torch.full((n,), k, dtype=torch.int32))
        jstate, jres, jacc = jax_rsv.update(jstate, jres, jcand, jnp.asarray(wgt), jnp.asarray(on))
        state, res, acc = rsv.update(state, res, cand, _t(wgt), _t(on))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    np.testing.assert_array_equal(res.light_id.numpy(), np.asarray(jres.light_id))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jres.w), rtol=1e-6)
    np.testing.assert_array_equal(res.m.numpy(), np.asarray(jres.m))
    # merge: m accounting and the weight w * m * pdf
    pdf = RS.uniform(0.1, 1.0, n).astype(np.float32)
    jm = jax_rsv.merge(jstate, jax_rsv.DiReservoirs.empty((n,)), jres, jnp.asarray(pdf))
    m = rsv.merge(state, rsv.DiReservoirs.empty((n,), "cpu"), res, _t(pdf))
    np.testing.assert_array_equal(m[1].m.numpy(), np.asarray(jm[1].m))
    np.testing.assert_allclose(m[1].w.numpy(), np.asarray(jm[1].w), rtol=1e-6)
    np.testing.assert_array_equal(m[2].numpy(), np.asarray(jm[2]))
    got = rsv.norm_avg(m[1], _t(pdf))
    want = jax_rsv.norm_avg(jm[1], jnp.asarray(pdf))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-6)


def test_mis_eval_matches_jax():
    n = 400
    args = [RS.uniform(0.0, 3.0, n).astype(np.float32) for _ in range(7)]
    for a in args[3:]:
        a[RS.uniform(size=n) < 0.2] = 0.0  # zero pdfs take the guarded branches
    want = jax_mis_eval(*(jnp.asarray(a) for a in args))
    got = mis_eval(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=1e-7)


def test_blue_noise_matches_jax_exactly():
    np.testing.assert_array_equal(bluenoise.table_numpy(), np.asarray(jax_bluenoise.texture()))
    np.testing.assert_array_equal(bluenoise.generate()[:8], jax_bluenoise._load_or_generate()[:8])
    for frame in (0, 5, 300):
        want = jax_bluenoise.sample_pair_screen(300, 270, frame)
        got = bluenoise.sample_pair_screen(300, 270, frame, "cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_offset_tables_and_probe_match_jax_exactly():
    radii = jax_offsets.radius_levels(128.0)
    assert offsets.radius_levels(128.0) == radii
    margin = offsets.probe_margin(128.0, H, W)
    assert margin == jax_offsets.probe_margin(128.0, H, W)
    depth = RS.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    normal = RS.normal(size=(H, W, 3)).astype(np.float32)
    gate = (RS.uniform(size=(H, W)) < 0.5)
    jprobe = jax_offsets.SharedOffsetTaps(
        (jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(gate)), margin=margin)
    probe = offsets.SharedOffsetTaps((_t(depth), _t(normal), _t(gate)), margin=margin)
    for seed in (1, 0xDEADBEEF):
        for nth in range(3):
            s = (seed ^ ((0x9E3779B9 * (nth + 1)) & 0xFFFFFFFF)) & 0xFFFFFFFF
            jdy, jdx = jax_offsets.draw_offset_table(jnp.uint32(s), radii, 2, margin=margin)
            dy, dx = offsets.draw_offset_table(s, radii, 2, margin=margin)
            np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
            np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
            sel = RS.randint(0, 2 * (nth + 1), (H, W)).astype(np.int32)
            want = jprobe.take(jdy, jdx, jnp.asarray(sel), kmax=2 * (nth + 1))
            got = probe.take(dy, dx, _t(sel))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            for g, w in zip(probe.offset_of(dy, dx, _t(sel)), jprobe.offset_of(jdy, jdx, jnp.asarray(sel))):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a = RS.normal(size=(2, H, W)).astype(np.float32)
    np.testing.assert_array_equal(offsets.mirror_pad(_t(a), 5).numpy(),
                                  np.asarray(jax_offsets.mirror_pad(jnp.asarray(a), 5)))


def test_contain_xy_and_derive_seed_match_jax():
    jcam, cam = jax_cornell_camera(W, H), cornell_camera(W, H, device="cpu")
    x = RS.randint(-W + 1, 2 * W - 1, (H, W)).astype(np.int32)
    y = RS.randint(-H + 1, 2 * H - 1, (H, W)).astype(np.int32)
    for g, w in zip(contain_xy(cam, _t(x), _t(y)), jax_contain_xy(jcam, jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    from strolle_tpu.models.restir import derive_seed as jax_derive_seed

    for seed in (0, 3, 0xFFFFFFFF):
        for k in (0, 11, 15):
            assert derive_seed(seed, k) == int(jax_derive_seed(jnp.uint32(seed), k))


def test_checkerboard_compact_expand_match_jax():
    a = RS.normal(size=(H, W, 3)).astype(np.float32)
    for f in (0, 1, 4):
        jp = jax_cb.row_parity(f, H)
        p = cb.row_parity(f, H, "cpu")
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        half = cb.compact(p, _t(a))
        np.testing.assert_array_equal(half.numpy(), np.asarray(jax_cb.compact(jp, jnp.asarray(a))))
        np.testing.assert_array_equal(
            cb.expand(p, half, 0).numpy(), np.asarray(jax_cb.expand(jp, jnp.asarray(half.numpy()), 0)))


def test_gathers_match_jax():
    a = RS.normal(size=(H, W, 3)).astype(np.float32)
    b = RS.randint(-5, 40, (H, W)).astype(np.int32)
    c = RS.uniform(size=(H, W)) < 0.3
    u = (RS.randint(0, 2**32, (H, W), dtype=np.int64)).astype(np.uint32)
    py = RS.randint(0, H, (H, W)).astype(np.int32)
    px = RS.randint(0, W, (H, W)).astype(np.int32)
    want = jax_gather.gather_tree((jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(u)),
                                  jnp.asarray(py), jnp.asarray(px))
    got = gather.gather_tree((_t(a), _t(b), _t(c), _t(u.astype(np.int64))), _t(py), _t(px))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    # bilinear corner taps at fractional coords, out of bounds included
    fy = RS.uniform(-3.0, H + 2.0, (H, W)).astype(np.float32)
    fx = RS.uniform(-3.0, W + 2.0, (H, W)).astype(np.float32)
    jt, jfy, jfx = jax_gather.take_bilinear((jnp.asarray(a),), jnp.asarray(fy), jnp.asarray(fx))
    t, ty, tx = gather.take_bilinear((_t(a),), _t(fy), _t(fx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jfy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jfx))
    for corner in range(4):
        np.testing.assert_array_equal(t[corner][0].numpy(), np.asarray(jt[corner][0]))
    table = RS.normal(size=(6, 13)).astype(np.float32)
    idx = RS.randint(0, 6, (H, W)).astype(np.int32)
    np.testing.assert_array_equal(gather.gather_rows(_t(table), _t(idx)).numpy(),
                                  np.asarray(jax_gather.gather_rows(jnp.asarray(table), jnp.asarray(idx))))


def test_vector_math_matches_jax():
    n = RS.normal(size=(300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = RS.uniform(0.0, 2.0, (300, 3)).astype(np.float32)
    rgb[:5] = 0.0
    e = vm.octahedral_encode(_t(n))
    np.testing.assert_allclose(e.numpy(), np.asarray(jax_vm.octahedral_encode(jnp.asarray(n))), atol=1e-6)
    np.testing.assert_allclose(vm.octahedral_decode(e).numpy(), n, atol=1e-5)
    np.testing.assert_allclose(vm.luma(_t(rgb)).numpy(), np.asarray(jax_vm.luma(jnp.asarray(rgb))), rtol=1e-6)
    np.testing.assert_allclose(vm.perc_luma(_t(rgb)).numpy(),
                               np.asarray(jax_vm.perc_luma(jnp.asarray(rgb))), rtol=1e-6)
    jstate, state = _u32_state(64)
    jstate, jdisk = jax_rng.sample_disk(jstate)
    state, disk = rng.sample_disk(state)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    np.testing.assert_allclose(disk.numpy(), np.asarray(jdisk), atol=1e-6)


@pytest.fixture(scope="module")
def small_luts():
    """The three LUT generators at reduced step and direction counts
    (the same code paths; the full LUTs cost the JAX package ~1 min of
    compile on a CPU)."""
    jt = jax.jit(jax_atm.generate_transmittance_lut)()
    js = jax.jit(lambda t: jax_atm.generate_scattering_lut(t, steps=6, dirs_sqrt=2))(jt)
    jk = jax.jit(lambda t, s: jax_atm.generate_sky_lut(t, s, 0.3, steps=6))(jt, js)
    t = atm.generate_transmittance_lut("cpu")
    s = atm.generate_scattering_lut(t, steps=6, dirs_sqrt=2)
    k = atm.generate_sky_lut(t, s, 0.3, steps=6)
    return (jt, js, jk), (t, s, k)


def test_atmosphere_luts_match_jax(small_luts):
    # 40-step exp/sqrt marches: float32 rounding of XLA's fused form
    for g, w, name in zip(small_luts[1], small_luts[0], ("transmittance", "scattering", "sky")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=1e-5, err_msg=name)
    assert float(small_luts[1][2].max()) > 0.05  # a sun above the horizon lights the sky


def test_sample_atmosphere_matches_jax(small_luts):
    (jt, js, jk), (t, s, k) = small_luts
    jl = jax_atm.AtmosphereLuts(transmittance=jt, scattering=js, sky=jk)
    luts = atm.AtmosphereLuts(transmittance=_t(jt), scattering=_t(js), sky=_t(jk))
    d = RS.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # one compiled program each, as the JAX frame runs them (op by op
    # they cost several seconds of per-op compiles)
    jax_sample_atmosphere = jax.jit(jax_atm.sample_atmosphere)
    jax_sample_sky = jax.jit(jax_atm.sample_sky, static_argnames="steps")
    for az, alt in ((0.3, 0.3), (1.0, -1.0)):
        jsun = jax_atm.sun_direction(az, alt)
        sun = atm.sun_direction(az, alt)
        np.testing.assert_allclose(sun.numpy(), np.asarray(jsun), atol=1e-7)
        want = np.asarray(jax_sample_atmosphere(jl, jsun, jnp.asarray(d)))
        got = atm.sample_atmosphere(luts, _t(jsun), _t(d)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got = atm.sample_sky(_t(jax_atm.sun_direction(0.3, 0.3)), _t(d[:16]), steps=4)
    want = jax_sample_sky(jax_atm.sun_direction(0.3, 0.3), jnp.asarray(d[:16]), steps=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_luts_for_caches_per_altitude():
    a = atm.luts_for(-1.0, "cpu")
    assert atm.luts_for(-1.0, "cpu").sky is a.sky
    assert tuple(a.transmittance.shape) == (64, 256, 3)
    assert tuple(a.scattering.shape) == (32, 32, 3)
    assert tuple(a.sky.shape) == (256, 256, 3)
    assert bool(torch.isfinite(a.scattering).all()) and float(a.scattering.max()) > 0.0

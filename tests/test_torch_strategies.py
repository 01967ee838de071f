"""The big-scene strategies ("cluster", "packet", "jnp") in the port: the
dispatch of ops/trace.py against the JAX package's on the JAX tests'
soup (taken as a big scene on both sides by lowering
BRUTE_FORCE_MAX_TRIS, as tests/test_cluster_kernels.py does, with the
JAX kernels in interpret mode), the staged loop's routes, and the whole
slice on the dungeon: reference mode under each strategy against
"stream", and a realtime frame under "cluster" and "packet"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import soup_rays, soup_scenes, tt

import strolle_tpu.ops.trace as jtrace
from strolle_tpu_torch.models import restir as tr
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.ops import trace as ttrace
from strolle_tpu_torch.ops.kernels import bvh_kernels as bk
from strolle_tpu_torch.ops.kernels import cluster_kernels as ck
from strolle_tpu_torch.ops.kernels import stream_kernels as sk
from strolle_tpu_torch.ops.kernels import trace_kernels as tk
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.scene.demo import dungeon_camera
from tests.test_torch_dungeon import dg  # noqa: F401  (the dungeon fixture, reused)

#: The kernel wrappers each strategy's big-scene trace_surface and
#: trace_anyhit call (trace_closest takes the torch traversal under all
#: three).
STRATEGY_KERNELS = {
    "stream": ("stream_trace_surface", "stream_trace_anyhit"),
    "cluster": ("cluster_trace_surface", "cluster_trace_anyhit"),
    "packet": ("bvh_trace_surface", "bvh_trace_anyhit"),
    "jnp": ("bvh_trace_surface", "bvh_trace_anyhit"),
}
#: Rays or pixels whose triangle may differ between two routes: an exact-t
#: tie between triangles that two walks meet in another order.
MAX_TRI_FLIPS = 0.01
RTOL, ATOL = 1e-5, 1e-5


def _record_routes(monkeypatch) -> list:
    """Records, in order, every call of the port's kernel wrappers."""
    calls = []
    for mod, names in ((tk, ("trace_closest_brute", "trace_anyhit_brute", "trace_surface")),
                       (sk, STRATEGY_KERNELS["stream"]), (ck, STRATEGY_KERNELS["cluster"]),
                       (bk, STRATEGY_KERNELS["packet"])):
        for name in names:
            def wrapper(*args, _fn=getattr(mod, name), _name=name, **kwargs):
                calls.append(_name)
                return _fn(*args, **kwargs)

            monkeypatch.setattr(mod, name, wrapper)
    return calls


@pytest.mark.parametrize("strategy", ["cluster", "packet", "jnp"])
def test_dispatch_matches_jax(strategy, monkeypatch):
    """trace_surface, trace_closest and trace_anyhit of the port against the
    JAX package's under one strategy: the JAX package runs kernel 8 or 10
    and 9 or 11 in interpret mode and its traversal, the port their plain
    versions and its traversal."""
    monkeypatch.setattr(jtrace, "BRUTE_FORCE_MAX_TRIS", 64)
    monkeypatch.setattr(ttrace, "BRUTE_FORCE_MAX_TRIS", 64)
    monkeypatch.setenv("STROLLE_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jtrace, "BIG_SCENE_STRATEGY", strategy)
    monkeypatch.setattr(ttrace, "BIG_SCENE_STRATEGY", strategy)
    js, scene, _, _ = soup_scenes()
    assert scene.clusters is None  # made from the BVH by the dispatch
    calls = _record_routes(monkeypatch)
    o, d = soup_rays("inside")
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    got = ttrace.trace_surface(scene, tt(o), tt(d))
    want = jtrace.trace_surface(js, jo, jd)
    some = got.is_some.numpy()
    assert 0.05 < some.mean() < 0.95
    np.testing.assert_array_equal(some, np.asarray(want.is_some))
    same = got.tri.numpy() == np.asarray(want.tri)
    assert 1.0 - same.mean() <= MAX_TRI_FLIPS, 1.0 - same.mean()
    np.testing.assert_array_equal(got.material_id.numpy()[same],
                                  np.asarray(want.material_id)[same])
    for k in ("point", "normal", "uv", "base_color", "emissive", "metallic", "roughness",
              "reflectance", "depth"):
        np.testing.assert_allclose(getattr(got, k).numpy()[same],
                                   np.asarray(getattr(want, k))[same], rtol=RTOL, atol=ATOL,
                                   err_msg=k)

    hit = ttrace.trace_closest(scene, tt(o), tt(d))
    jhit = jtrace.trace_closest(js, jo, jd)
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(jhit.tri))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(hit, k).numpy()[some],
                                   np.asarray(getattr(jhit, k))[some], rtol=RTOL, atol=ATOL,
                                   err_msg=k)

    tm = np.full(o.shape[:-1], 2.5, np.float32)
    occ = ttrace.trace_anyhit(scene, tt(o), tt(d), tt(tm)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jtrace.trace_anyhit(js, jo, jd,
                                                                      jnp.asarray(tm))))
    assert 0.0 < occ.mean() < 1.0
    assert calls == list(STRATEGY_KERNELS[strategy])


def test_staged_loop_routes(monkeypatch):
    """The staged loop passes the caller's use_pallas on to trace_surface,
    as the JAX package's does: None takes kernel 4 (here its plain
    version) for every surface, with the sky too (the megakernel refuses
    it); False takes kernel A (trace_closest + surface_at). Both give the
    same image."""
    scene = cornell_box(device="cpu")
    cam = cornell_camera(16, 16, device="cpu")
    calls = _record_routes(monkeypatch)
    fused = trace_sample(scene, cam, 3, depth=2, include_sky=False, use_megakernel=False)
    assert calls == ["trace_surface", "trace_anyhit_brute"] * 3
    calls.clear()
    trace_sample(scene, cam, 3, depth=2, include_sky=True)
    assert calls == ["trace_surface", "trace_anyhit_brute"] * 3
    calls.clear()
    split = trace_sample(scene, cam, 3, depth=2, include_sky=False, use_pallas=False)
    assert calls == ["trace_closest_brute", "trace_anyhit_brute"] * 3
    diff = (fused - split).abs().amax(-1)
    assert (diff <= 1e-4).float().mean() >= 0.99
    with pytest.raises(ValueError, match="megakernel"):
        trace_sample(scene, cam, 3, depth=2, include_sky=False, use_megakernel=True,
                     use_pallas=False)


@pytest.fixture(scope="module")
def stream_sample(dg):  # noqa: F811
    """The dungeon's reference-mode sample (32x24, depth 1, the sky) and a
    realtime frame (16x12) under "stream", the JAX package's default."""
    _, scene, _, cam, luts, _ = dg
    assert ttrace.BIG_SCENE_STRATEGY == "stream"
    img = trace_sample(scene, cam, 5, depth=1, include_sky=True, luts=luts)
    return img, _realtime_frame(scene, luts)


def _realtime_frame(scene, luts):
    cam = dungeon_camera(16, 12, device="cpu")
    state = tr.init_state(cam, device="cpu")
    return tr.render_frame_fused(scene, cam, state, 5, tr.RenderConfig(include_sky=True), luts)


@pytest.mark.parametrize("strategy", ["cluster", "packet", "jnp"])
def test_dungeon_reference_mode_under_strategy(dg, stream_sample, strategy,  # noqa: F811
                                               monkeypatch):
    """The port's dungeon reference mode (staged loop, depth 1, the sky)
    under each strategy takes that strategy's kernels for both bounces and
    gives the "stream" image, apart from tie-flip pixels. The surfaces'
    attributes are resolved by the kernel there and by surface_at under
    "stream", which round a few last bits otherwise."""
    _, scene, _, cam, luts, _ = dg
    monkeypatch.setattr(ttrace, "BIG_SCENE_STRATEGY", strategy)
    calls = _record_routes(monkeypatch)
    got = trace_sample(scene, cam, 5, depth=1, include_sky=True, luts=luts)
    assert calls == list(STRATEGY_KERNELS[strategy]) * 2
    want = stream_sample[0]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    diff = (got - want).abs().amax(-1)
    assert (diff <= 1e-4).float().mean() >= 1.0 - MAX_TRI_FLIPS, (diff > 1e-4).float().mean()
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()


@pytest.mark.parametrize("strategy", ["cluster", "packet"])
def test_dungeon_realtime_frame_under_strategy(dg, stream_sample, strategy,  # noqa: F811
                                               monkeypatch):
    """One realtime frame (16x12, the sky) under the strategy: its kernels
    only (frame 0 samples GI: two closest-hit launches, four any-hit),
    every channel finite, and the prelude's triangles those of "stream"."""
    _, scene, _, _, luts, _ = dg
    monkeypatch.setattr(ttrace, "BIG_SCENE_STRATEGY", strategy)
    calls = _record_routes(monkeypatch)
    ch, state = _realtime_frame(scene, luts)
    surface, anyhit = STRATEGY_KERNELS[strategy]
    assert sorted(calls) == sorted([surface] * 2 + [anyhit] * 4), calls
    for k, x in ch.items():
        assert bool(torch.isfinite(x).all()), k
    tri = state.prev_surface.tri
    assert (tri == stream_sample[1][1].prev_surface.tri).float().mean() >= 1.0 - MAX_TRI_FLIPS
    assert float(ch["image"].mean()) > 1e-3

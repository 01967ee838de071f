"""The port's alpha restart loop (strolle_tpu_torch/ops/trace.py) against
the JAX package's (strolle_tpu/ops/trace.py) on the same scenes and
rays: the cases of tests/test_alpha.py (two panes, a miss behind a
transparent pane, the triangle soup on the big-scene routes),
trace_surface, and one staged reference sample. A hit on an
alpha-blended material whose sampled alpha is below 1 does not count:
closest hits skip past it and shadow rays pass through."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)
from torch_port_arrays import alpha_cornell_scenes, scene_arrays, tt

import strolle_tpu.ops.trace as jax_trace
import strolle_tpu_torch.ops.trace as trace
from strolle_tpu.models.reference import trace_sample as jax_trace_sample
from strolle_tpu.scene.build import MeshBuilder
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu.scene.types import Scene, make_lights, make_materials
from strolle_tpu_torch import convert
from strolle_tpu_torch.camera import make_camera, pixel_rays, screen_grid
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
from strolle_tpu_torch.ops.kernels import cuda_lib
from strolle_tpu_torch.scene.cornell import cornell_camera
from tests.test_alpha import _alpha_soup_scene, _soup_rays, _two_pane_scene


def _pane_scene():
    """tests/test_alpha.py's one pane on a material of alpha 0 (blend)."""
    b = MeshBuilder()
    b.add_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], 0)
    return Scene(
        geometry=b.build(),
        materials=make_materials([{"base_color": [1, 1, 1, 0.0], "alpha_blend": 1}]),
        lights=make_lights([]),
        atlas=None,
        sun_azimuth=jnp.asarray(0.0, jnp.float32),
        sun_altitude=jnp.asarray(-1.0, jnp.float32),
        has_alpha=True,
    )


def _pane_rays():
    """8x8 rays from z = 1 along -z, spread so that some pass beside the
    panes, and the single ray of tests/test_alpha.py first."""
    rs = np.random.RandomState(0)
    o = np.concatenate([[[0.0, 0.0, 1.0]], rs.uniform(-1.3, 1.3, (63, 3))], 0)
    o[:, 2] = 1.0
    d = np.concatenate([[[0.0, 0.0, -1.0]], rs.normal(0.0, 0.1, (63, 3))], 0)
    d[1:, 2] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# (scene, t_max of the shadow rays, what tests/test_alpha.py asserts of
# the first ray: closest t (None: a miss), occluded)
PANE_CASES = {
    "opaque_pane_blocks": (lambda: _two_pane_scene(1.0, 0), 10.0, 1.0, True),
    "transparent_pane_skipped": (lambda: _two_pane_scene(0.25, 1), 10.0, 3.0, True),
    "blend_with_full_alpha_hits": (lambda: _two_pane_scene(1.0, 1), 10.0, 1.0, True),
    "transparent_pane_does_not_occlude": (lambda: _two_pane_scene(0.25, 1), 2.0, 3.0, False),
    "miss_behind_transparent": (_pane_scene, 10.0, None, False),
}


@pytest.mark.parametrize("case", sorted(PANE_CASES))
def test_pane_cases_match_jax(case):
    """Closest hits and occlusion of the two-pane cases: tri and occlusion
    exact, t within 1e-4, and the first ray as tests/test_alpha.py
    asserts."""
    make, t_max, t0, occ0 = PANE_CASES[case]
    js = make()
    scene = convert.scene_from_arrays(scene_arrays(js), device="cpu")
    o, d = _pane_rays()
    tm = np.full(o.shape[0], t_max, np.float32)
    hit = trace.trace_closest(scene, tt(o), tt(d))
    want = jax_trace.trace_closest(js, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(want.tri))
    m = np.asarray(want.tri) >= 0
    assert 0 < m.sum() < len(m) or t0 is None
    np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(want.t)[m], rtol=0, atol=1e-4)
    assert np.isinf(hit.t.numpy()[~m]).all()
    occ = trace.trace_anyhit(scene, tt(o), tt(d), tt(tm))
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jax_trace.trace_anyhit(js, jnp.asarray(o), jnp.asarray(d),
                                                       jnp.asarray(tm))))
    if t0 is None:
        assert hit.tri[0] < 0
    else:
        assert abs(hit.t[0].item() - t0) < 1e-3
    assert bool(occ[0]) == occ0


def test_transparent_pane_surface_matches_jax():
    """trace_surface on an alpha scene takes trace_closest + surface_at:
    the far pane's grey behind the skipped one, as in the JAX package."""
    js = _two_pane_scene(0.25, 1)
    scene = convert.scene_from_arrays(scene_arrays(js), device="cpu")
    o, d = _pane_rays()
    for use_pallas in (None, False):
        surf = trace.trace_surface(scene, tt(o), tt(d), use_pallas=use_pallas)
        assert np.allclose(surf.base_color[0, :3].numpy(), 0.5, atol=1e-5)
    want = jax_trace.trace_surface(js, jnp.asarray(o), jnp.asarray(d))
    for k in ("tri", "is_some", "material_id"):
        np.testing.assert_array_equal(getattr(surf, k).numpy(), np.asarray(getattr(want, k)))
    for k in ("point", "normal", "uv", "depth", "base_color"):
        np.testing.assert_allclose(getattr(surf, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-4, err_msg=k)


@functools.cache
def _alpha_cornell():
    return alpha_cornell_scenes()


def test_alpha_cornell_surface_matches_jax():
    """Cornell's 16x16 primaries through a pane of alpha 0.4 across the
    box: every primary that meets the pane passes through it to the box
    behind, tri, is_some and material id exact, the rest within 1e-4,
    and no launch count moves on the CPU."""
    js, scene = _alpha_cornell()
    cam = cornell_camera(16, 16, device="cpu")
    o, d = pixel_rays(cam, screen_grid(cam))
    cuda_lib.reset_launch_counts()
    surf = trace.trace_surface(scene, o, d)
    assert not cuda_lib.LAUNCHES
    want = jax.jit(jax_trace.trace_surface)(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    for k in ("tri", "is_some", "material_id"):
        np.testing.assert_array_equal(getattr(surf, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("point", "normal", "uv", "depth", "base_color"):
        np.testing.assert_allclose(getattr(surf, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    pane = scene.geometry.num_triangles - 2
    assert (surf.tri < pane).all()
    # the pane covers the middle of the screen: without alpha those rays
    # would stop on it
    opaque = scene.replace(has_alpha=False)
    assert (trace.trace_closest(opaque, o, d).tri >= pane).float().mean() > 0.3


def test_alpha_cornell_staged_sample_matches_jax():
    """One staged reference sample (16x16, depth 1) of the alpha Cornell
    against the JAX package's, at the whole-sample tolerance of
    tests/test_torch_reference.py; the megakernel refuses the scene."""
    js, scene = _alpha_cornell()
    got = trace_sample(scene, cornell_camera(16, 16, device="cpu"), 5, depth=1,
                       include_sky=False).numpy()
    sample = jax.jit(jax_trace_sample, static_argnames=("depth", "include_sky"))
    want = np.asarray(sample(js, jax_cornell_camera(16, 16), jnp.uint32(5), depth=1,
                             include_sky=False))
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-4).mean() > 0.99, (diff > 1e-4).mean()
    assert abs(got.mean() - want.mean()) < 2e-3
    with pytest.raises(ValueError, match="megakernel"):
        trace_sample(scene, cornell_camera(4, 4, device="cpu"), 5, depth=1, include_sky=False,
                     use_megakernel=True)


@functools.cache
def _soup():
    """tests/test_alpha.py's soup at 1,536 triangles (a quarter on a
    blend material of alpha 0.3) with its BVH in both packages, its 512
    rays, and the JAX package's restart loop over its BVH traversal (the
    brute gate at 512, as that test sets it) and over all rows."""
    js = _alpha_soup_scene(n_tris=1536)
    scene = convert.scene_from_arrays(scene_arrays(js), device="cpu")
    o, d = (np.asarray(x) for x in _soup_rays())
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    tm = jnp.full(o.shape[:-1], 2.0)
    want = {}
    for name, gate in (("big", 512), ("brute", 4096)):
        saved = jax_trace.BRUTE_FORCE_MAX_TRIS
        jax_trace.BRUTE_FORCE_MAX_TRIS = gate
        try:
            hit = jax.jit(jax_trace.trace_closest)(js, jo, jd)
            occ = jax.jit(jax_trace.trace_anyhit)(js, jo, jd, tm)
        finally:
            jax_trace.BRUTE_FORCE_MAX_TRIS = saved
        want[name] = (np.asarray(hit.tri), np.asarray(hit.t), np.asarray(occ))
    return scene, o, d, want


@pytest.mark.parametrize("strategy", ["stream", "cluster", "packet", "brute"])
def test_soup_restart_loop_matches_jax(monkeypatch, strategy):
    """The restart loop on a big scene: under "stream" each restart runs
    kernel 5's plain version, under "cluster" and "packet" the torch BVH
    traversal (their closest-hit route, as in the JAX package), each with
    the brute gate at 512, against the JAX package's BVH route: tri and
    occlusion on at least 99% of the rays, t within 1e-4 where tri agrees.
    "brute" raises the gate over the soup (kernel A's plain version over
    all rows) against the JAX package's brute route: tri and occlusion
    exact (through trace_surface, which takes trace_closest + surface_at
    on an alpha scene). On each route trace_sample and render_frame take
    the loop too."""
    scene, o, d, want = _soup()
    if strategy == "brute":
        monkeypatch.setattr(trace, "BRUTE_FORCE_MAX_TRIS", 4096)
        w_tri, w_t, w_occ = want["brute"]
    else:
        monkeypatch.setattr(trace, "BRUTE_FORCE_MAX_TRIS", 512)
        monkeypatch.setattr(trace, "BIG_SCENE_STRATEGY", strategy)
        w_tri, w_t, w_occ = want["big"]
    surf = trace.trace_surface(scene, tt(o), tt(d))  # trace_closest + surface_at
    occ = trace.trace_anyhit(scene, tt(o), tt(d), torch.full((o.shape[0],), 2.0)).numpy()
    tri = surf.tri.numpy()
    same = tri == w_tri
    # skipped blend hits: the loop restarted on some rays
    blend = scene.geometry.material_id.numpy()[np.maximum(w_tri, 0)] == 1
    assert (w_tri >= 0).mean() > 0.2 and not blend[w_tri >= 0].any()
    if strategy == "brute":
        np.testing.assert_array_equal(tri, w_tri)
        np.testing.assert_array_equal(occ, w_occ)
    else:
        assert same.mean() >= 0.99, same.mean()
        assert (occ == w_occ).mean() >= 0.99
    m = same & (tri >= 0)
    np.testing.assert_allclose(surf.depth.numpy()[m], w_t[m], rtol=0, atol=1e-4)
    # a reference sample and a realtime frame on the same route
    cam = make_camera([0.0, 0.0, 8.0], [0.0, 0.0, 0.0], width=4, height=4, device="cpu")
    img = trace_sample(scene, cam, 1, depth=0, include_sky=False)
    channels, _ = render_frame(scene, cam, init_state(cam, device="cpu"), 0,
                               RenderConfig(needs_gi=False))  # GI would build the sky LUTs
    assert torch.isfinite(img).all() and torch.isfinite(channels["image"]).all()

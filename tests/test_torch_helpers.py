"""The port's small public helpers against their JAX counterparts, one
case each, on seeded numpy inputs of at most 32x32: the camera's
projections and primary rays, two vector ops, the diffuse lobe's sample,
the blue-noise pairs, the screen packing and its take, the checkerboard
compaction of a tree, the GI reconnection Jacobian and the native
library's availability."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu import camera as jcamera
from strolle_tpu import native as jnative
from strolle_tpu.ops import bluenoise as jbluenoise
from strolle_tpu.ops import brdf as jbrdf
from strolle_tpu.ops import checkerboard as jcb
from strolle_tpu.ops import gather as jgather
from strolle_tpu.ops import math as jvm
from strolle_tpu.restir import gi as jgi
from strolle_tpu_torch import camera, native
from strolle_tpu_torch.ops import bluenoise, brdf, checkerboard as cb, gather, math as vm
from strolle_tpu_torch.restir import gi

H, W = 24, 32
EYE, TARGET = (0.3, 1.1, 3.4), (0.0, 0.9, 0.0)


def _rs():
    return np.random.RandomState(16)


def _cams():
    kw = dict(width=W, height=H)
    return (jcamera.make_camera(EYE, TARGET, **kw),
            camera.make_camera(EYE, TARGET, device="cpu", **kw))


def _points():
    return _rs().uniform(-2.0, 2.0, (H, W, 3)).astype(np.float32)


def _unit(rs, shape):
    n = rs.normal(size=shape + (3,)).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _states(rs, shape):
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _screen_fields(rs):
    """Fields of each kind the realtime stages gather: f32 planes and
    vectors, i32 ids, bool flags."""
    return (rs.uniform(-1.0, 1.0, (H, W)).astype(np.float32),
            rs.uniform(-1.0, 1.0, (H, W, 3)).astype(np.float32),
            rs.randint(-1, 5000, (H, W)).astype(np.int32),
            rs.uniform(size=(H, W)) < 0.5)


def _coords(rs):
    return rs.randint(0, H, (H, W)).astype(np.int32), rs.randint(0, W, (H, W)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# Each case returns (port outputs, JAX outputs, atol): integers, flags and
# the cases with atol 0 equal, the rest within atol + 1e-6 relative: the
# float32 rounding of the same formulas (the projections' products and
# divisions, the rays' normalisation, the hemisphere's sin/cos/sqrt, the
# Jacobian's squares and quotient), 1 ulp at most here.


def _world_to_clip():
    jc, c = _cams()
    p = _points()
    return camera.world_to_clip(c, _t(p)), jcamera.world_to_clip(jc, jnp.asarray(p)), 1e-6


def _world_to_screen():
    jc, c = _cams()
    p = _points()
    return camera.world_to_screen(c, _t(p)), jcamera.world_to_screen(jc, jnp.asarray(p)), 1e-6


def _primary_rays():
    jc, c = _cams()
    return camera.primary_rays(c), jcamera.primary_rays(jc), 1e-6


def _length_squared():
    v = _rs().normal(size=(H, W, 3)).astype(np.float32)
    return vm.length_squared(_t(v)), jvm.length_squared(jnp.asarray(v)), 0.0


def _with_luma():
    rs = _rs()
    rgb = rs.uniform(0.0, 2.0, (H, W, 3)).astype(np.float32)
    rgb[::5] = 0.0
    new = rs.uniform(0.0, 3.0, (H, W)).astype(np.float32)
    return (vm.with_luma(_t(rgb), _t(new)), jvm.with_luma(jnp.asarray(rgb), jnp.asarray(new)),
            1e-6)


def _diffuse_sample():
    rs = _rs()
    states, normal = _states(rs, (H, W)), _unit(rs, (H, W))
    s, d, pdf = brdf.diffuse_sample(_t(states.astype(np.int64)), _t(normal))
    js, jd, jpdf = jbrdf.diffuse_sample(jnp.asarray(states), jnp.asarray(normal))
    return (s, d, pdf), (np.asarray(js).astype(np.int64), jd, jpdf), 1e-6


def _sample_pair():
    rs = _rs()
    grid = np.stack([rs.randint(0, 4 * W, (H, W)), rs.randint(0, 4 * H, (H, W))], -1)
    grid = grid.astype(np.int32)
    return (bluenoise.sample_pair(_t(grid), 7),
            jbluenoise.sample_pair(jnp.asarray(grid), 7), 0.0)


def _pack_screen():
    """The packed fields, column by column: the JAX package's f32 matrix
    holds each field's values (ids and flags converted by value)."""
    fields = _screen_fields(_rs())
    flat, specs = gather.pack_screen(*(_t(a) for a in fields))
    (fmat, umat), jspecs = jgather.pack_screen(*(jnp.asarray(a) for a in fields))
    assert umat is None and specs == jspecs[:2]
    cols = torch.cat([a.reshape(H * W, -1).to(torch.float32) for a in flat], dim=-1)
    return cols, fmat, 0.0


def _take_screen():
    rs = _rs()
    fields = _screen_fields(rs)
    y, x = _coords(rs)
    got = gather.take_screen(*gather.pack_screen(*(_t(a) for a in fields)), _t(y), _t(x))
    jflat, jspecs = jgather.pack_screen(*(jnp.asarray(a) for a in fields))
    want = jgather.take_screen(jflat, jspecs, jnp.asarray(y), jnp.asarray(x))
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.int32, torch.bool]
    return got, want, 0.0


def _compact_tree():
    rs = _rs()
    fields = _screen_fields(rs)
    tree = {"a": fields[0], "b": (fields[1], fields[3])}
    got = cb.compact_tree(cb.row_parity(5, H, "cpu"),
                          {"a": _t(tree["a"]), "b": tuple(_t(v) for v in tree["b"])})
    want = jcb.compact_tree(jcb.row_parity(5, H), {"a": jnp.asarray(tree["a"]),
                                                   "b": tuple(jnp.asarray(v) for v in tree["b"])})
    return (got["a"], *got["b"]), (want["a"], *want["b"]), 0.0


def _sample_jacobian():
    rs = _rs()
    shape = (H, W)
    f = rs.uniform(0.1, 2.0, shape).astype(np.float32)
    v1 = rs.uniform(-1.0, 1.0, shape + (3,)).astype(np.float32)
    v2 = (v1 + rs.uniform(-3.0, 3.0, shape + (3,))).astype(np.float32)
    v2[::4] = 0.0  # no sample there: the Jacobian is 1
    n2 = _unit(rs, shape)
    hit = rs.uniform(-1.0, 1.0, shape + (3,)).astype(np.float32)
    fields = dict(m=f, w=f, pdf=f, confidence=f, rng=_states(rs, shape), radiance=v1,
                  v1_point=v1, v2_point=v2, v2_normal=n2)
    jres = jgi.GiReservoirs(**{k: jnp.asarray(v) for k, v in fields.items()})
    res = gi.GiReservoirs(**{k: _t(v.astype(np.int64) if k == "rng" else v)
                             for k, v in fields.items()})
    got = gi.sample_jacobian(res, _t(hit))
    assert (got[::4] == 1.0).all()
    return got, jgi.sample_jacobian(jres, jnp.asarray(hit)), 1e-6


def _available():
    assert native.available()
    return torch.tensor(native.available()), np.asarray(jnative.available()), 0.0


CASES = {f.__name__[1:]: f for f in (
    _world_to_clip, _world_to_screen, _primary_rays, _length_squared, _with_luma,
    _diffuse_sample, _sample_pair, _pack_screen, _take_screen, _compact_tree, _sample_jacobian,
    _available,
)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    got, want, atol = CASES[name]()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if atol == 0.0 or g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol, err_msg=name)

"""The port's data layer against the JAX package: Cornell scene and
camera arrays, the carry-over of scenes, primary rays and the PCG."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.camera import pixel_rays as jax_pixel_rays
from strolle_tpu.camera import screen_grid as jax_screen_grid
from strolle_tpu.ops import rng as jax_rng
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu.scene.types import compute_static_flags as jax_static_flags
from strolle_tpu_torch import convert
from strolle_tpu_torch.camera import pixel_rays, screen_grid
from strolle_tpu_torch.ops import rng
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.scene.types import Geometry, compute_static_flags


def _fields(obj) -> dict:
    return {
        f.name: getattr(obj, f.name)
        if f.name == "tex_channels"
        else np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
    }


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene as the nested numpy dicts that convert.py takes."""
    return {
        "geometry": _fields(scene.geometry),
        "materials": _fields(scene.materials),
        "lights": _fields(scene.lights),
        "atlas": None if scene.atlas is None else np.asarray(scene.atlas.image),
        "sun_azimuth": np.asarray(scene.sun_azimuth),
        "sun_altitude": np.asarray(scene.sun_altitude),
        "has_alpha": scene.has_alpha,
        "flat_normals": scene.flat_normals,
        "has_metal": scene.has_metal,
    }


def _assert_same_arrays(want: dict, got: dict):
    assert want.keys() <= got.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_arrays(w, g)
        elif isinstance(w, np.ndarray):
            # exact, inf included; dtype kinds agree (float vs int)
            assert np.asarray(g).dtype.kind == w.dtype.kind, k
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("metallic", [False, True])
def test_cornell_box_equals_jax(metallic):
    want = jax_scene_arrays(jax_cornell_box(metallic_tall_box=metallic))
    got = convert.scene_to_arrays(cornell_box(metallic_tall_box=metallic, device="cpu"))
    _assert_same_arrays(want, got)
    assert got["has_metal"] == metallic
    assert got["flat_normals"] is True


def test_cornell_camera_equals_jax():
    want = jax_cornell_camera(40, 24)
    got = cornell_camera(40, 24, device="cpu")
    for k in ("projection_view", "ndc_to_world", "origin"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert (got.width, got.height) == (want.width, want.height)


def test_convert_round_trips_a_jax_scene():
    jscene = jax_cornell_box(metallic_tall_box=True)
    arrays = jax_scene_arrays(jscene)
    scene = convert.scene_from_arrays(arrays, device="cpu")
    assert scene.lights.count == int(jscene.lights.count)
    assert isinstance(scene.lights.count, int)
    _assert_same_arrays(arrays, convert.scene_to_arrays(scene))

    jcam = jax_cornell_camera(20, 12)
    cam = convert.camera_from_arrays(
        {f.name: getattr(jcam, f.name) for f in dataclasses.fields(jcam)}, device="cpu"
    )
    np.testing.assert_array_equal(cam.ndc_to_world.numpy(), np.asarray(jcam.ndc_to_world))

    rs = np.random.RandomState(5)
    acc = {
        "color": rs.rand(12, 20, 3).astype(np.float32),
        "samples": rs.rand(12, 20).astype(np.float32),
        "projection_view": rs.rand(4, 4).astype(np.float32),
    }
    back = convert.accumulator_to_arrays(convert.accumulator_from_arrays(acc, device="cpu"))
    _assert_same_arrays(acc, back)


def test_static_flags_match_jax_on_perturbed_normals():
    jscene = jax_cornell_box()
    rs = np.random.RandomState(1)
    normals = np.asarray(jscene.geometry.normals) + rs.normal(
        0.0, 0.05, jscene.geometry.normals.shape
    ).astype(np.float32)
    jgeom = jscene.geometry.replace(normals=normals)
    want = jax_static_flags(jgeom, jscene.materials)
    geom = Geometry(
        **{k: torch.as_tensor(v) for k, v in _fields(jgeom).items()}
    )
    mats = convert.scene_from_arrays(jax_scene_arrays(jscene), device="cpu").materials
    assert compute_static_flags(geom, mats) == want
    assert want["flat_normals"] is False


def test_pixel_rays_match_jax():
    jcam = jax_cornell_camera(40, 24)
    cam = cornell_camera(40, 24, device="cpu")
    grid = screen_grid(cam)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jax_screen_grid(jcam)))
    jo, jd = jax_pixel_rays(jcam, jax_screen_grid(jcam))
    o, d = pixel_rays(cam, grid)
    # float32 rounding of the unprojection and of rsqrt in normalize
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_pcg_is_bit_exact():
    rs = np.random.RandomState(7)
    # the full u32 range, values >= 2^31 included
    states = rs.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    states[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    js = jnp.asarray(states)
    ts = torch.as_tensor(states.astype(np.int64))
    assert (ts >= 2**31).any()
    for _ in range(4):
        js, jw = jax_rng.next_u32(js)
        ts, tw = rng.next_u32(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    for _ in range(4):
        js, jf = jax_rng.next_f32(js)
        ts, tf = rng.next_f32(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        # bit-exact floats
        np.testing.assert_array_equal(tf.numpy().view(np.int32), np.asarray(jf).view(np.int32))

    seeds = rs.randint(0, 2**32, size=3, dtype=np.uint64)
    x = rs.randint(0, 4096, size=512).astype(np.int32)
    y = rs.randint(0, 4096, size=512).astype(np.int32)
    for seed in seeds:
        want = jax_rng.wnoise_new(jnp.uint32(int(seed)), jnp.asarray(x), jnp.asarray(y))
        got = rng.wnoise_new(int(seed), torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sphere_and_hemisphere_samples_match_jax():
    rs = np.random.RandomState(8)
    states = rs.randint(0, 2**32, size=2048, dtype=np.uint64).astype(np.uint32)
    normal = rs.normal(size=(2048, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    js, jsph = jax_rng.sample_sphere(jnp.asarray(states))
    ts, tsph = rng.sample_sphere(torch.as_tensor(states.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    # the streams are bit-exact; sin/cos/sqrt differ by float32 ulps
    np.testing.assert_allclose(tsph.numpy(), np.asarray(jsph), rtol=0, atol=1e-6)
    js, jh = jax_rng.sample_hemisphere(jnp.asarray(states), jnp.asarray(normal))
    ts, th = rng.sample_hemisphere(torch.as_tensor(states.astype(np.int64)), torch.as_tensor(normal))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)

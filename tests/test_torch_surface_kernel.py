"""Kernel 4 (the fused surface trace) and the port's trace_surface
routes against the JAX package: ``trace_surface_plain`` against
``trace_surface_pallas`` in interpret mode, and the assembled
``trace_surface(use_pallas=True)`` against the JAX package's own, on
Cornell primary rays, random rays and smooth (perturbed) normals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import perturbed_normals, scene_arrays

from strolle_tpu.camera import pixel_rays as jax_pixel_rays
from strolle_tpu.camera import screen_grid as jax_screen_grid
from strolle_tpu.ops.pallas.trace_kernels import pack_geometry as jax_pack_geometry
from strolle_tpu.ops.pallas.trace_kernels import trace_surface_pallas
from strolle_tpu.ops.trace import trace_closest_brute as jax_closest_brute
from strolle_tpu.ops.trace import trace_surface as jax_trace_surface
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu_torch import convert
from strolle_tpu_torch.ops.kernels import trace_kernels as tk
from strolle_tpu_torch.ops.trace import packed_geom_rows, trace_surface

#: t/u/v come from the same fused-multiply-add Möller-Trumbore as the JAX
#: kernel; the normal and uv interpolation round without fusion here and
#: with XLA:CPU's fusion there: a few float32 ulps.
ATOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    """(name -> (JAX scene, port scene)) for flat and smooth normals."""
    flat = jax_cornell_box()
    g = flat.geometry
    smooth = flat.replace(geometry=g.replace(normals=jnp.asarray(perturbed_normals(g.normals))))
    return {
        name: (js, convert.scene_from_arrays(scene_arrays(js), device="cpu"))
        for name, js in (("flat", flat), ("smooth", smooth))
    }


def _rays(kind: str):
    if kind == "primary":
        cam = jax_cornell_camera(40, 30)
        o, d = jax_pixel_rays(cam, jax_screen_grid(cam))
        return np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    rs = np.random.RandomState(5)
    n = 1500
    o = np.stack([rs.uniform(-0.95, 0.95, n), rs.uniform(0.05, 1.95, n),
                  rs.uniform(-0.95, 0.95, n)], -1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _jax_rows(jscene):
    rows = jax_pack_geometry(jscene.geometry)
    return jnp.concatenate([rows, jnp.zeros(((-rows.shape[0]) % 8, 28), rows.dtype)])


def test_pack_geometry_matches_jax(scenes):
    for jscene, scene in scenes.values():
        np.testing.assert_array_equal(packed_geom_rows(scene).numpy(), np.asarray(_jax_rows(jscene)))


@pytest.mark.parametrize("kind", ["primary", "random"])
@pytest.mark.parametrize("normals", ["flat", "smooth"])
def test_surface_plain_matches_pallas_kernel(scenes, kind, normals):
    jscene, scene = scenes[normals]
    o, d = _rays(kind)
    want = trace_surface_pallas(_jax_rows(jscene), jnp.asarray(o), jnp.asarray(d), interpret=True)
    jnp_tri = np.asarray(jax_closest_brute(jscene, jnp.asarray(o), jnp.asarray(d)).tri)
    got = tk.trace_surface(packed_geom_rows(scene), torch.as_tensor(o), torch.as_tensor(d))
    assert got["tri"].dtype == torch.int32 and got["mat_id"].dtype == torch.int32
    tri = got["tri"].numpy()
    # Exact against the JAX package's tensor route, whose fused
    # multiply-adds the port reproduces. Its Pallas kernel in interpret
    # mode fuses differently: on primary rays that meet a quad's shared
    # diagonal, or the crack along it, the two JAX routes themselves
    # pick different triangles. There the port follows the tensor route.
    np.testing.assert_array_equal(tri, jnp_tri)
    same = np.asarray(want["tri"]) == jnp_tri
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(tri[same], np.asarray(want["tri"])[same])
    hit = (tri >= 0) & same
    assert 0.3 < hit.mean() <= 1.0
    assert np.isinf(got["t"].numpy()[tri < 0]).all()
    np.testing.assert_array_equal(got["mat_id"].numpy()[same], np.asarray(want["mat_id"])[same])
    for k in ("t", "u", "v", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy()[hit], np.asarray(want[k])[hit], rtol=0,
                                   atol=ATOL, err_msg=k)
    # a miss resolves to zeros, as the TPU kernel leaves it
    for k in ("normal", "uv", "mat_id"):
        assert (got[k].numpy()[tri < 0] == 0).all(), k
    n = got["normal"].numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("normals", ["flat", "smooth"])
def test_trace_surface_fused_route_matches_jax(scenes, normals, monkeypatch):
    monkeypatch.setenv("STROLLE_PALLAS_INTERPRET", "1")
    jscene, scene = scenes[normals]
    o, d = _rays("random")
    want = jax_trace_surface(jscene, jnp.asarray(o), jnp.asarray(d), regularize=True,
                             use_pallas=True)
    for use_pallas in (True, None):
        got = trace_surface(scene, torch.as_tensor(o), torch.as_tensor(d), regularize=True,
                            use_pallas=use_pallas)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_array_equal(got.is_some.numpy(), np.asarray(want.is_some))
        np.testing.assert_array_equal(got.material_id.numpy(), np.asarray(want.material_id))
        for k in ("point", "dir", "normal", "uv", "base_color", "emissive", "metallic",
                  "roughness", "reflectance", "depth"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=0, atol=ATOL, err_msg=k)
        assert got.roughness.numpy()[got.is_some.numpy()].min() >= 0.5625


def test_trace_surface_routes_agree(scenes):
    """The fused route (kernel 4) against trace_closest + surface_at
    (use_pallas=False, the differentiable route) on the same rays."""
    _, scene = scenes["smooth"]
    o, d = (torch.as_tensor(a) for a in _rays("random"))
    fused = trace_surface(scene, o, d)
    split = trace_surface(scene, o, d, use_pallas=False)
    assert torch.equal(fused.tri, split.tri)
    for k in ("point", "normal", "uv", "base_color", "depth"):
        torch.testing.assert_close(getattr(fused, k), getattr(split, k), rtol=0, atol=ATOL)


def test_surface_wrapper_rejects_bad_inputs():
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="28"):
        tk.trace_surface(torch.zeros(8, 12), o, o)
    with pytest.raises(NotImplementedError, match="1024"):
        tk.trace_surface(torch.zeros(1032, 28), o, o)
    out = tk.trace_surface(torch.zeros(8, 28), o, o)
    assert (out["tri"] == -1).all() and torch.isinf(out["t"]).all()

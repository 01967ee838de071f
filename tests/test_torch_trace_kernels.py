"""Kernels A and B (brute closest hit / any hit) and surface_at: the
port's plain versions against the JAX package's jnp path and its Pallas
kernels in interpret mode, on the ray sets of test_pallas_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.ops.hit import surface_at as jax_surface_at
from strolle_tpu.ops.pallas.trace_kernels import (
    pack_triangles as jax_pack_triangles,
    trace_anyhit_brute_pallas,
    trace_closest_brute_pallas,
)
from strolle_tpu.ops.trace import trace_anyhit_brute as jax_anyhit_brute
from strolle_tpu.ops.trace import trace_closest_brute as jax_closest_brute
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu_torch.ops.hit import surface_at
from strolle_tpu_torch.ops.kernels import trace_kernels as tk
from strolle_tpu_torch.ops.trace import (
    packed_tri_rows,
    trace_anyhit,
    trace_anyhit_brute,
    trace_closest,
    trace_closest_brute,
)
from strolle_tpu_torch.scene.cornell import cornell_box


def _rays(n, seed=0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def scenes():
    return jax_cornell_box(), cornell_box(device="cpu")


def _jax_rows(jscene):
    rows = jax_pack_triangles(jscene.geometry.positions)
    return jnp.concatenate([rows, jnp.zeros(((-rows.shape[0]) % 8, 12), rows.dtype)])


def test_pack_triangles_matches_jax(scenes):
    jscene, scene = scenes
    np.testing.assert_array_equal(packed_tri_rows(scene).numpy(), np.asarray(_jax_rows(jscene)))


def test_closest_brute_matches_jax_and_pallas(scenes):
    jscene, scene = scenes
    o, d = _rays(1200)
    ref = jax_closest_brute(jscene, jnp.asarray(o), jnp.asarray(d))
    pt, ptri, _, _ = trace_closest_brute_pallas(
        _jax_rows(jscene), jnp.asarray(o), jnp.asarray(d), interpret=True
    )
    t, tri, u, v = tk.trace_closest_brute(packed_tri_rows(scene), torch.as_tensor(o), torch.as_tensor(d))
    assert tri.dtype == torch.int32
    assert (tri.numpy() == np.asarray(ref.tri)).all()
    assert (tri.numpy() == np.asarray(ptri)).all()
    hit = tri.numpy() >= 0
    assert 0.2 < hit.mean() < 1.0
    assert np.isinf(t.numpy()[~hit]).all()
    # float32 rounding of the same Möller-Trumbore operations
    for want in (np.asarray(ref.t), np.asarray(pt)):
        np.testing.assert_allclose(t.numpy()[hit], want[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(u.numpy()[hit], np.asarray(ref.u)[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(v.numpy()[hit], np.asarray(ref.v)[hit], rtol=0, atol=1e-4)
    # the scene-level plain chunked brute force, JAX's counterpart by name
    plain = trace_closest_brute(scene, torch.as_tensor(o), torch.as_tensor(d))
    assert (plain.tri.numpy() == np.asarray(ref.tri)).all()
    torch.testing.assert_close(plain.t, t, rtol=0, atol=0)


def test_closest_brute_picks_lowest_index_on_ties():
    # two copies of one triangle: the first must win, as with strict <
    tri = torch.tensor([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    rows = tk.pack_triangles(torch.stack([tri, tri, tri]))
    o = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    _, idx, _, _ = tk.trace_closest_brute(rows, o, d)
    assert idx.tolist() == [0, 0]
    _, idx, _, _ = tk.trace_closest_brute_plain(rows, o, d, chunk=1)
    assert idx.tolist() == [0, 0]


def test_anyhit_brute_matches_jax_and_pallas(scenes):
    jscene, scene = scenes
    o, d = _rays(1200, seed=2)
    t_max = np.full((1200,), 1.3, np.float32)
    ref = np.asarray(jax_anyhit_brute(jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    pal = np.asarray(
        trace_anyhit_brute_pallas(
            _jax_rows(jscene), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True
        )
    )
    got = tk.trace_anyhit_brute(
        packed_tri_rows(scene), torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)
    )
    assert got.dtype == torch.bool
    assert 0.1 < ref.mean() < 0.9
    assert (got.numpy() == ref).all()
    assert (got.numpy() == pal).all()
    plain = trace_anyhit_brute(scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    assert (plain.numpy() == ref).all()
    via_scene = trace_anyhit(scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    assert (via_scene.numpy() == ref).all()


def test_surface_at_matches_jax(scenes):
    jscene, scene = scenes
    o, d = _rays(1200, seed=3)
    jhit = jax_closest_brute(jscene, jnp.asarray(o), jnp.asarray(d))
    want = jax_surface_at(jscene, jnp.asarray(o), jnp.asarray(d), jhit, regularize=True)
    hit = trace_closest(scene, torch.as_tensor(o), torch.as_tensor(d))
    assert (hit.tri.numpy() == np.asarray(jhit.tri)).all()
    got = surface_at(scene, torch.as_tensor(o), torch.as_tensor(d), hit, regularize=True)
    some = np.asarray(want.is_some)
    assert (got.is_some.numpy() == some).all()
    assert (got.tri.numpy() == np.asarray(want.tri)).all()
    assert (got.material_id.numpy() == np.asarray(want.material_id)).all()
    # float32 rounding: t/u/v recomputed through the winner, then
    # interpolated and normalised
    for k in ("point", "normal", "uv", "base_color", "emissive", "metallic",
              "roughness", "reflectance", "depth"):
        np.testing.assert_allclose(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=0, atol=1e-4,
            err_msg=k,
        )

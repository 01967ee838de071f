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


def _tie_rows():
    """~2,100 rows (zero rows that no ray hits) with copies of one
    triangle across plain chunk and 1024-row boundaries (rows 1023, 1024,
    1151, 1152, 2047, 2048, 2099) and, at row 3, the same triangle
    farther along the rays; the first copy must win. Returns [T, 12] rows,
    the [T, 28] rows of the same triangles, and the winning row."""
    tri = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    pos = np.zeros((2100, 3, 3), np.float32)
    pos[3] = tri + np.array([0.0, 0.0, -0.5], np.float32)
    copies = [1023, 1024, 1151, 1152, 2047, 2048, 2099]
    pos[copies] = tri
    rows = tk.pack_triangles(torch.as_tensor(pos))
    rs = np.random.RandomState(5)
    attrs = rs.uniform(-1.0, 1.0, (2100, 15)).astype(np.float32)
    attrs[:, 15 - 4] = rs.randint(0, 4, 2100)  # the material id column
    grows = torch.cat([rows[:, :9], torch.as_tensor(attrs), torch.zeros(2100, 4)], dim=1)
    return rows, grows, copies[0]


@pytest.mark.parametrize("chunk", [1, 7, 128, 1024])
@pytest.mark.parametrize("kernel", ["A", "4"])
@torch.inference_mode()  # the plain version at chunk 1 makes ~40 small ops a row
def test_closest_brute_picks_lowest_index_on_ties(kernel, chunk):
    # copies of one triangle: the first must win, as with strict < in
    # ascending order, whatever the plain version's chunk
    o = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.2, -0.3, 2.0], [0.1, 0.1, -3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    tri = torch.tensor([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    three = tk.pack_triangles(torch.stack([tri, tri, tri]))
    rows, grows, first = _tie_rows()
    if kernel == "A":
        assert tk.trace_closest_brute(three, o, d)[1].tolist() == [0, 0, 0, 0]
        assert tk.trace_closest_brute_plain(three, o, d, chunk=chunk)[1].tolist() == [0, 0, 0, 0]
        t, idx, u, v = tk.trace_closest_brute_plain(rows, o, d, chunk=chunk)
        want = tk.trace_closest_brute(rows, o, d)
    else:
        g3 = torch.cat([three[:, :9], torch.ones(3, 19)], dim=1)
        assert tk.trace_surface(g3, o, d)["tri"].tolist() == [0, 0, 0, 0]
        assert tk.trace_surface_plain(g3, o, d, chunk=chunk)["tri"].tolist() == [0, 0, 0, 0]
        out = tk.trace_surface_plain(grows, o, d, chunk=chunk)
        t, idx, u, v = (out[k] for k in ("t", "tri", "u", "v"))
        # (the wrapper takes at most MAX_TRIS rows: the default chunk)
        want = tk.trace_surface_plain(grows, o, d)
        for k in ("normal", "uv", "mat_id"):
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)
        assert out["mat_id"].tolist() == [int(grows[first, 24])] * 4
    # rays from +z meet the copies first (t 1, 2), rays from -z row 3 (t 0.5, 2.5)
    assert idx.tolist() == [first, 3, first, 3]
    torch.testing.assert_close(t, torch.tensor([1.0, 0.5, 2.0, 2.5]), rtol=0, atol=0)
    for got, w in zip((t, idx, u, v), want if kernel == "A" else
                      (want[k] for k in ("t", "tri", "u", "v"))):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_closest_brute_ties_match_pallas(scenes):
    # Cornell's rows twice over: every hit ties with its copy, and the
    # lower copy must win in the JAX kernel and in the port alike
    jscene, scene = scenes
    o, d = _rays(64, seed=4)
    jrows = _jax_rows(jscene)
    pt, ptri, pu, pv = trace_closest_brute_pallas(
        jnp.concatenate([jrows, jrows]), jnp.asarray(o), jnp.asarray(d), interpret=True
    )
    rows = packed_tri_rows(scene)
    t, tri, u, v = tk.trace_closest_brute(torch.cat([rows, rows]), torch.as_tensor(o),
                                          torch.as_tensor(d))
    assert (tri.numpy() == np.asarray(ptri)).all()
    hit = tri.numpy() >= 0
    assert 0.2 < hit.mean() < 1.0
    assert (tri.numpy()[hit] < rows.shape[0]).all()
    for got, want in ((t, pt), (u, pu), (v, pv)):
        np.testing.assert_allclose(got.numpy()[hit], np.asarray(want)[hit], rtol=0, atol=1e-4)


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

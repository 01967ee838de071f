"""Kernels 5 and 6 (ops/kernels/stream_kernels.py): the cluster host code
and the plain versions against the JAX package's stream kernels in
interpret mode and its brute-force trace, on a soup of
CLUSTER_TRIS*3+57 triangles (four clusters, the last one ragged); the
warps' front-to-back walk against the index-order walk (a list cap of
0), its tie rule and its stop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import coherent_rays, tie_scene

from strolle_tpu.ops.pallas import stream_kernels as jsk
from strolle_tpu.ops.pallas.cluster_kernels import CLUSTER_TRIS, clusterize_bvh
from strolle_tpu.ops.trace import trace_anyhit_brute, trace_closest_brute
from strolle_tpu_torch.ops.intersect import ray_triangle_edges, safe_inv_dir, slab
from strolle_tpu_torch.ops.kernels import cuda_lib
from strolle_tpu_torch.ops.kernels import stream_kernels as sk
from tests.test_bvh_kernels import _packed, _rays, _soup_scene

#: Rays whose tri may differ from the JAX package's: an exact-t tie between
#: two triangles (a shared edge) goes to the lowest row here and to the
#: first row the TPU's front-to-back walk meets there.
MAX_TRI_FLIPS = 0.01
ATOL = 1e-5


@pytest.fixture(scope="module")
def soup():
    js = _soup_scene(n_tris=CLUSTER_TRIS * 3 + 57)
    _, rows = _packed(js)
    n = js.geometry.num_triangles
    jclus = clusterize_bvh(js.bvh, n, jnp.asarray(js.geometry.positions))
    clus = sk.clusterize_bvh(None, n, torch.tensor(np.asarray(js.geometry.positions)))
    return js, jclus, rows, clus, torch.tensor(np.asarray(rows))


def _ray_set(name):
    """Seeded rays: from all around the soup, or from inside it (most hit)."""
    if name == "around":
        return _rays(640, seed=1)
    o, d = _rays(640, seed=2, spread=3.0)
    return o.reshape(20, 32, 3), d.reshape(20, 32, 3)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_cluster_host_code_matches_jax(soup):
    js, jclus, rows, clus, trows = soup
    assert clus.shape == (4, 8)
    np.testing.assert_array_equal(clus.numpy(), np.asarray(jclus))
    np.testing.assert_array_equal(sk.sub_aabbs(clus, trows).numpy(),
                                  np.asarray(jsk.sub_aabbs(jclus, rows)))
    for name in ("around", "inside"):
        o, d = (x.reshape(-1, 3) for x in _ray_set(name))
        # jitted, as inside the JAX package's kernel wrappers, where XLA
        # fuses the cap's scale and offset into one multiply-add
        want = jax.jit(jsk.scene_tcap)(jclus, tuple(o[:, i] for i in range(3)),
                                       tuple(d[:, i] for i in range(3)))
        np.testing.assert_array_equal(sk.scene_tcap(clus, _t(o), _t(d)).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("rays", ["around", "inside"])
def test_closest_plain_matches_jax(soup, rays):
    js, jclus, rows, clus, trows = soup
    o, d = _ray_set(rays)
    work = torch.zeros((o.size // 3, 2), dtype=torch.int32)
    got = sk.stream_trace_surface(clus, trows, _t(o), _t(d), work=work)
    want = jsk.stream_trace_surface_pallas(jclus, rows, o, d, interpret=True)
    brute = trace_closest_brute(js, o.reshape(-1, 3), d.reshape(-1, 3))
    hit = got["hit"].numpy()
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, np.asarray(want["hit"]))
    np.testing.assert_array_equal(hit.reshape(-1), np.asarray(brute.is_some))
    tri = got["tri"].numpy()
    for other in (np.asarray(want["tri"]), np.asarray(brute.tri).reshape(tri.shape)):
        same = tri == other
        assert 1.0 - same.mean() <= MAX_TRI_FLIPS, 1.0 - same.mean()
    # t/u/v where tri agrees; t on a miss is the scene-box cap in both
    same = tri == np.asarray(want["tri"])
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=1e-5, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(brute.t).reshape(hit.shape)[hit],
                               rtol=1e-5, atol=ATOL)
    # a ray inside the scene box tests all 4 cluster boxes for its warp's
    # list, re-tests each cluster its warp walks (at most 4) and adds 8
    # sub-block tests for each it enters (at most those it re-tested) and
    # up to 32 triangle tests for each sub-block it enters; a ray that
    # misses the box tests nothing
    w = work.numpy()
    live = sk.scene_tcap(clus, _t(o), _t(d)).numpy().reshape(-1) > 0
    assert (w[~live] == 0).all() and (w[live, 0] >= 4).all()
    retests, entered = (w[live, 0] - 4) % 8, (w[live, 0] - 4) // 8
    assert (retests <= 4).all() and (entered <= retests).all()
    assert (w[live, 1] <= entered * 8 * 32).all()


@pytest.mark.parametrize("t_max", [2.5, 0.0, np.inf])
@pytest.mark.parametrize("rays", ["around", "inside"])
def test_anyhit_plain_matches_jax(soup, rays, t_max):
    js, jclus, rows, clus, trows = soup
    o, d = _ray_set(rays)
    tm = np.full(o.shape[:-1], t_max, np.float32)
    got = sk.stream_trace_anyhit(clus, trows, _t(o), _t(d), _t(tm)).numpy()
    want = np.asarray(jsk.stream_trace_anyhit_pallas(jclus, rows, o, d, jnp.asarray(tm),
                                                     interpret=True))
    np.testing.assert_array_equal(got, want)
    brute = np.asarray(trace_anyhit_brute(js, o.reshape(-1, 3), d.reshape(-1, 3),
                                          jnp.asarray(tm.reshape(-1))))
    np.testing.assert_array_equal(got.reshape(-1), brute)
    if t_max == 0.0:
        assert not got.any()
    else:
        assert 0.0 < got.mean() < 1.0


def test_kernel_paths_take_only_cuda_tensors(soup, monkeypatch):
    """The wrappers run the plain versions on CPU tensors without touching
    the CUDA library or the launch counts; the launch path refuses CPU
    tensors."""
    _, _, _, clus, trows = soup
    o, d = (_t(x) for x in _rays(8, seed=3))

    def no_library():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    cuda_lib.reset_launch_counts()
    sk.stream_trace_surface(clus, trows, o, d)
    sk.stream_trace_anyhit(clus, trows, o, d, torch.full((8,), 2.0))
    assert cuda_lib.LAUNCHES == {}
    subs = sk.sub_aabbs(clus, trows)
    for entry, ray_arg, outs in (
        ("strolle_stream_trace_surface", sk.scene_tcap(clus, o, d),
         (torch.empty(8), torch.empty(8, dtype=torch.int32), torch.empty(8), torch.empty(8))),
        ("strolle_stream_trace_anyhit", torch.full((8,), 2.0),
         (torch.empty(8, dtype=torch.bool),)),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.launch_walk(entry, sk.launch_head(clus, subs, trows), o, d, ray_arg, outs,
                                 None)
    with pytest.raises(ValueError, match=r"\[N, 8\]"):
        sk.stream_trace_surface(torch.zeros(4, 6), trows, o, d)
    with pytest.raises(ValueError, match="clusters"):
        sk.stream_trace_surface(clus[:2], trows, o, d)
    with pytest.raises(NotImplementedError):
        sk.clusterize_bvh(None, 10)


def _plain_pair(clus, trows, o, d, list_cap, t_max=None):
    """Kernel 5's or 6's plain version (with t_max) under ``list_cap``,
    with its per-ray work."""
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    subs = sk.sub_aabbs(clus, trows)
    work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
    if t_max is None:
        out = sk.stream_trace_surface_plain(clus, subs, trows, o, d, sk.scene_tcap(clus, o, d),
                                            work, list_cap=list_cap)
    else:
        tm = sk.clipped_t_max(clus, o, d, torch.full((o.shape[0],), t_max))
        out = (sk.stream_trace_anyhit_plain(clus, subs, trows, o, d, tm, work,
                                            list_cap=list_cap),)
    return out, work


@pytest.mark.parametrize("rays", ["around", "inside", "coherent"])
def test_warp_walk_equals_index_order_walk(soup, rays):
    """Front to back by warps (the default list cap) and in index order (a
    cap of 0: every warp overflows) give the same t, tri, u, v and flags,
    bit for bit; the index-order walk re-tests every cluster (4 list tests,
    4 re-tests and 8 for each entered cluster)."""
    _, _, _, clus, trows = soup
    o, d = (_t(x) for x in (_ray_set(rays) if rays != "coherent" else coherent_rays(trows)))
    for t_max in (None, 2.5, np.inf):
        got, _ = _plain_pair(clus, trows, o, d, sk.LIST_CAP, t_max)
        want, iwork = _plain_pair(clus, trows, o, d, 0, t_max)
        for a, b in zip(got, want):
            assert torch.equal(a, b), t_max
        live = iwork[:, 0] > 0
        if t_max is None:
            assert ((iwork[live, 0] - 8) % 8 == 0).all()


def test_exact_tie_goes_to_the_lowest_row_in_either_order():
    clus, rows, o, d = tie_scene()
    ids, _, count = sk.warp_lists(clus, o, d, sk.scene_tcap(clus, o, d))
    # the front-to-back walk meets row 263's cluster first
    assert (count == 2).all() and (ids[:, 0] == 1).all()
    for cap in (sk.LIST_CAP, 0):
        (t, tri, _, _), _ = _plain_pair(clus, rows, o, d, cap)
        assert (tri == 5).all(), cap
    for cap in (sk.LIST_CAP, 0):
        (occ,), _ = _plain_pair(clus, rows, o, d, cap, t_max=np.inf)
        assert occ.all()


def test_warp_lists_sorted_and_stop_skips_no_closer_hit(soup):
    _, _, _, clus, trows = soup
    o, d = (_t(x) for x in coherent_rays(trows))
    tcap = sk.scene_tcap(clus, o, d)
    ids, keys, count = sk.warp_lists(clus, o, d, tcap)
    # the entered clusters, sorted by (key, id); the rest after them
    inside, _ = slab(clus[:, 0:3], clus[:, 3:6], o[:, None], safe_inv_dir(d)[:, None],
                     tcap[:, None])
    entered = (inside & sk.live_rays(d, tcap)[:, None]).reshape(-1, sk.TILE_RAYS, 4).any(1)
    for w in range(ids.shape[0]):
        n = int(count[w])
        assert set(ids[w, :n].tolist()) == set(entered[w].nonzero()[:, 0].tolist())
        assert (keys[w, :n].diff() >= 0).all() and torch.isinf(keys[w, n:]).all()
    t, _, _, _ = sk.stream_trace_surface_plain(clus, sk.sub_aabbs(clus, trows), trows, o, d, tcap)
    # best t only falls during the walk, so a warp stops at or before its
    # first entry keyed past the largest of its rays' results
    last = t.reshape(-1, sk.TILE_RAYS).amax(dim=1)
    skipped = [(w, k) for w in range(ids.shape[0])
               for k, key in zip(ids[w, :int(count[w])].tolist(), keys[w].tolist())
               if key > last[w]]
    assert skipped
    for w, k in skipped:
        rays = slice(w * sk.TILE_RAYS, (w + 1) * sk.TILE_RAYS)
        r = trows[k * sk.CLUSTER_TRIS:(k + 1) * sk.CLUSTER_TRIS]
        th = ray_triangle_edges(o[rays, None], d[rays, None], r[:, 0:3], r[:, 3:6], r[:, 6:9])[0]
        # no hit in a skipped cluster comes before the ray's result
        assert (th >= t[rays, None]).all(), (w, k)

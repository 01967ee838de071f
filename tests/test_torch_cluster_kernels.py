"""Kernels 8 and 9 (ops/kernels/cluster_kernels.py): the plain versions
against the JAX package's cluster kernels in interpret mode, on the JAX
tests' soup of CLUSTER_TRIS*3+57 triangles (four clusters, the last one
ragged), 256 rays per set; the warps' front-to-back walk against the
index-order walk (a list cap of 0), its tie rule and its stop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import (
    coherent_rays, soup_rays, soup_scenes, tie_scene, tie_scene_on_entry_face, tt,
)

from strolle_tpu.ops.pallas import cluster_kernels as jck
from strolle_tpu_torch.ops.intersect import front_passes, ray_triangle_edges, safe_inv_dir, slab
from strolle_tpu_torch.ops.kernels import cuda_lib
from strolle_tpu_torch.ops.kernels import cluster_kernels as ck

#: Rays whose tri may differ from the JAX kernel's: an exact-t tie between
#: two triangles goes to the lowest row in both, but the TPU kernel's
#: multiply-adds fuse otherwise than the port's, which can split a tie.
#: Measured: none on these sets.
MAX_TRI_FLIPS = 0.01
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def soup():
    js, scene, _, rows = soup_scenes()
    n = js.geometry.num_triangles
    jclus = jck.clusterize_bvh(js.bvh, n, jnp.asarray(js.geometry.positions))
    clus = ck.clusterize_bvh(scene.bvh, n, scene.geometry.positions)
    return jclus, rows, clus, tt(rows)


def test_cluster_host_code_matches_jax(soup):
    jclus, rows, clus, trows = soup
    assert clus.shape == (4, 8)
    np.testing.assert_array_equal(clus.numpy(), np.asarray(jclus))
    # the port clamps each cluster's rows to T' where the JAX package pads
    # them with zero rows (a zero row never hits): both give the same hits
    padded = tt(np.asarray(jck._pad_geom(jclus, rows)))
    assert padded.shape[0] == 4 * ck.CLUSTER_TRIS > trows.shape[0]
    o, d = (tt(x) for x in soup_rays("inside"))
    want = ck.cluster_trace_surface(clus, padded, o, d)
    got = ck.cluster_trace_surface(clus, trows, o, d)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clusters_from_leaf_boxes_match_jax():
    """Without positions the clusters are the union of the BVH's leaf
    boxes per bin, as the JAX package's: equal rows, each box holding its
    tight box."""
    js, scene, _, _ = soup_scenes()
    n = js.geometry.num_triangles
    got = ck.clusterize_bvh(scene.bvh, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jck.clusterize_bvh(js.bvh, n)))
    tight = ck.clusterize_bvh(scene.bvh, n, scene.geometry.positions)
    assert (got[:, 0:3] <= tight[:, 0:3]).all() and (got[:, 3:6] >= tight[:, 3:6]).all()
    assert torch.equal(got[:, 6:], tight[:, 6:])


@pytest.mark.parametrize("rays", ["around", "inside"])
def test_closest_plain_matches_jax(soup, rays):
    jclus, rows, clus, trows = soup
    o, d = soup_rays(rays)
    work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
    got = ck.cluster_trace_surface(clus, trows, tt(o), tt(d), work=work)
    want = jck.cluster_trace_surface_pallas(jclus, rows, jnp.asarray(o), jnp.asarray(d),
                                            interpret=True)
    hit = got["hit"].numpy()
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, np.asarray(want["hit"]))
    tri = got["tri"].numpy()
    same = tri == np.asarray(want["tri"])
    assert 1.0 - same.mean() <= MAX_TRI_FLIPS, 1.0 - same.mean()
    np.testing.assert_array_equal(got["mat_id"].numpy()[same], np.asarray(want["mat_id"])[same])
    for k in ("t", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.isinf(got["t"].numpy()[~hit]).all()
    assert (got["normal"].numpy()[~hit] == 0).all() and (got["mat_id"].numpy()[~hit] == 0).all()
    # the warp walk: every ray tests all 4 cluster boxes for its warp's
    # list and re-tests each cluster its warp walks (at most 4); it enters
    # no more clusters than it re-tests, and each one it enters adds its
    # rows (256, or the ragged last cluster's 57)
    w = work.numpy()
    retests = w[:, 0] - 4
    assert (retests >= 0).all() and (retests <= 4).all()
    tris = w[:, 1]
    assert np.isin(tris % 256, (0, 57)).all()
    entered = tris // 256 + (tris % 256 == 57)
    assert (entered <= retests).all() and (tris <= 256 * entered).all()
    assert (tris[hit] > 0).all()


@pytest.mark.parametrize("t_max", [2.5, 0.0, np.inf])
def test_anyhit_plain_matches_jax(soup, t_max):
    jclus, rows, clus, trows = soup
    for name in ("around", "inside"):
        o, d = soup_rays(name)
        tm = np.full(o.shape[:-1], t_max, np.float32)
        work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
        got = ck.cluster_trace_anyhit(clus, trows, tt(o), tt(d), tt(tm), work=work).numpy()
        want = np.asarray(jck.cluster_trace_anyhit_pallas(
            jclus, rows, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), interpret=True))
        np.testing.assert_array_equal(got, want)
        if t_max == 0.0:
            assert not got.any() and not work.numpy().any()
        else:
            assert 0.0 < got.mean() < 1.0


def test_kernel_paths_take_only_cuda_tensors(soup, monkeypatch):
    """The wrappers run the plain versions on CPU tensors without touching
    the CUDA library or the launch counts; the launch path refuses CPU
    tensors."""
    _, _, clus, trows = soup
    o, d = (tt(x[:8]) for x in soup_rays("inside"))

    def no_library():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    cuda_lib.reset_launch_counts()
    ck.cluster_trace_surface(clus, trows, o, d)
    ck.cluster_trace_anyhit(clus, trows, o, d, torch.full((8,), 2.0))
    assert cuda_lib.LAUNCHES == {}
    for entry, ray_arg, outs in (
        ("strolle_cluster_trace_surface", None, cuda_lib.surface_outputs((8,), o.device)),
        ("strolle_cluster_trace_anyhit", torch.full((8,), 2.0),
         (torch.empty(8, dtype=torch.bool),)),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.launch_walk(entry, ck.launch_head(clus, trows), o, d, ray_arg, outs, None)
    with pytest.raises(ValueError, match=r"\[N, 8\]"):
        ck.cluster_trace_surface(torch.zeros(4, 6), trows, o, d)
    with pytest.raises(ValueError, match="clusters"):
        ck.cluster_trace_anyhit(clus[:2], trows, o, d, 1.0)
    # kernels 8 and 9 stage the whole cluster table in shared memory
    too_many = torch.zeros((ck.MAX_SMEM_BYTES // 32 + 1, 8))
    with pytest.raises(ValueError, match="shared memory"):
        ck.cluster_trace_surface(too_many, trows, o, d)
    with pytest.raises(TypeError):
        ck.cluster_trace_surface(clus.double(), trows, o, d)
    with pytest.raises(ValueError, match="positions or a BVH"):
        ck.clusterize_bvh(None, 10)


def _plain_pair(clus, trows, o, d, list_cap, t_max=None):
    """Kernel 8's or 9's plain version (with t_max) under ``list_cap``,
    with its per-ray work."""
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
    if t_max is None:
        out = ck.cluster_trace_surface_plain(clus, trows, o, d, work, list_cap=list_cap)
    else:
        tm = torch.full((o.shape[0],), t_max)
        out = (ck.cluster_trace_anyhit_plain(clus, trows, o, d, tm, work, list_cap=list_cap),)
    return out, work


@pytest.mark.parametrize("rays", ["around", "inside", "coherent"])
def test_warp_walk_equals_index_order_walk(soup, rays):
    """Front to back by warps (the default list cap) and in index order (a
    cap of 0: every warp overflows) give the same t, tri, u, v, normal,
    uv, mat_id and flags, bit for bit; kernel 8's index-order walk
    re-tests every cluster (4 list tests, 4 re-tests)."""
    _, _, clus, trows = soup
    o, d = (tt(x) for x in (soup_rays(rays) if rays != "coherent" else coherent_rays(trows)))
    for t_max in (None, 2.5, np.inf):
        got, _ = _plain_pair(clus, trows, o, d, ck.LIST_CAP, t_max)
        want, iwork = _plain_pair(clus, trows, o, d, 0, t_max)
        for a, b in zip(got, want):
            assert torch.equal(a, b), t_max
        if t_max is None:
            assert (iwork[:, 0] == 8).all()


def test_exact_tie_goes_to_the_lowest_row_in_either_order():
    clus, rows, o, d = tie_scene()
    ids, _, count = ck.warp_lists(clus, o, d, torch.full((o.shape[0],), np.inf))
    # the front-to-back walk meets row 263's cluster first
    assert (count == 2).all() and (ids[:, 0] == 1).all()
    for cap in (ck.LIST_CAP, 0):
        (t, tri, *_), _ = _plain_pair(clus, rows, o, d, cap)
        assert (tri == 5).all(), cap
        (occ,), _ = _plain_pair(clus, rows, o, d, cap, t_max=np.inf)
        assert occ.all(), cap


def test_exact_tie_on_the_entry_face_goes_to_the_lowest_row(monkeypatch):
    """The lower copy lies on the face of its cluster's box that the rays
    enter by, and that cluster is walked after the higher copy's: its
    re-test against best t times TIE_REACH enters it, so row 5 wins on
    every ray, as in index order. Without the reach the slab's t_near
    rounds past the hit's t on some rays, which then keep row 263."""
    clus, rows, o, d = tie_scene_on_entry_face()
    assert clus[0, 0] == rows[5, 0]
    ids, _, count = ck.warp_lists(clus, o, d, torch.full((o.shape[0],), np.inf))
    assert (count == 2).all() and (ids[:, 0] == 1).all()
    for cap in (ck.LIST_CAP, 0):
        (t, tri, *_), _ = _plain_pair(clus, rows, o, d, cap)
        assert (tri == 5).all(), cap
    monkeypatch.setattr(ck, "TIE_REACH", 1.0)
    (t, tri, *_), _ = _plain_pair(clus, rows, o, d, ck.LIST_CAP)
    assert (tri == 263).any() and (tri >= 0).all()


def test_front_counts(soup):
    """The plain versions' third work column: the triangle tests whose
    first half passes (|det| >= eps, 0 <= u <= 1), counted here over one
    cluster's rows directly (kernel 9: up to each ray's first hit)."""
    _, _, _, trows = soup
    rows = trows[:ck.CLUSTER_TRIS]
    v0 = rows[:, 0:3]
    clus = ck.clusterize_bvh(None, rows.shape[0], torch.stack(
        [v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]], dim=1))
    o, d = (tt(x) for x in soup_rays("inside"))
    t, u, _, det = ray_triangle_edges(o[:, None], d[:, None], rows[:, 0:3], rows[:, 3:6],
                                      rows[:, 6:9])
    front = front_passes(u, det)
    tm = torch.full((o.shape[0],), 2.5)
    hit = t < tm[:, None]
    tested = torch.where(hit.any(-1), hit.int().argmax(-1) + 1, rows.shape[0])
    upto = torch.arange(rows.shape[0]) < tested[:, None]
    for any_hit, want in ((False, front.sum(-1)), (True, (front & upto).sum(-1))):
        work = torch.zeros((o.shape[0], 3), dtype=torch.int32)
        if any_hit:
            ck.cluster_trace_anyhit_plain(clus, rows, o, d, tm, work)
        else:
            ck.cluster_trace_surface_plain(clus, rows, o, d, work)
        entered = work[:, 1] > 0
        assert entered.float().mean() > 0.5
        assert torch.equal(work[entered, 2], want[entered].int()), any_hit
        assert (work[:, 2] <= work[:, 1]).all() and (work[~entered, 2] == 0).all()


def test_warp_lists_sorted_and_stop_skips_no_closer_hit(soup):
    _, _, clus, trows = soup
    o, d = (tt(x) for x in coherent_rays(trows))
    inf = torch.full((o.shape[0],), np.inf)
    ids, keys, count = ck.warp_lists(clus, o, d, inf)
    # the entered clusters, sorted by (key, id); the rest after them
    inside, _ = slab(clus[:, 0:3], clus[:, 3:6], o[:, None], safe_inv_dir(d)[:, None],
                     inf[:, None])
    entered = inside.reshape(-1, ck.TILE_RAYS, 4).any(1)
    for w in range(ids.shape[0]):
        n = int(count[w])
        assert set(ids[w, :n].tolist()) == set(entered[w].nonzero()[:, 0].tolist())
        assert (keys[w, :n].diff() >= 0).all() and torch.isinf(keys[w, n:]).all()
    t = ck.cluster_trace_surface_plain(clus, trows, o, d)[0]
    # best t only falls during the walk, so a warp stops at or before its
    # first entry keyed past the largest of its rays' results
    last = t.reshape(-1, ck.TILE_RAYS).amax(dim=1)
    skipped = [(w, k) for w in range(ids.shape[0])
               for k, key in zip(ids[w, :int(count[w])].tolist(), keys[w].tolist())
               if key > last[w]]
    assert skipped
    for w, k in skipped:
        rays = slice(w * ck.TILE_RAYS, (w + 1) * ck.TILE_RAYS)
        r = trows[k * ck.CLUSTER_TRIS:(k + 1) * ck.CLUSTER_TRIS]
        th = ray_triangle_edges(o[rays, None], d[rays, None], r[:, 0:3], r[:, 3:6], r[:, 6:9])[0]
        # no hit in a skipped cluster comes before the ray's result
        assert (th >= t[rays, None]).all(), (w, k)

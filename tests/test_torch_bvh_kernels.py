"""Kernels 10 and 11 (ops/kernels/bvh_kernels.py) and the torch BVH
traversal (bvh/traverse.py): the plain versions against the JAX
package's packet-BVH kernels in interpret mode, the traversal against
the JAX package's, and kernel 10 against the traversal, on the JAX
tests' soup (825 triangles, a BVH from the JAX package's numpy builder),
256 rays per set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import soup_rays, soup_scenes, tt

from strolle_tpu.bvh import traverse as jtv
from strolle_tpu.ops.pallas import bvh_kernels as jbk
from strolle_tpu_torch.bvh import traverse as tv
from strolle_tpu_torch.ops.kernels import bvh_kernels as bk
from strolle_tpu_torch.ops.kernels import cuda_lib

#: Rays whose tri may differ from the JAX kernel's: the TPU kernel orders
#: a node's children by the nearest entry over its 32x128 ray tile, the
#: port by each ray's own entry, so an exact-t tie between triangles of
#: two leaves can go either way. Measured: none on these sets.
MAX_TRI_FLIPS = 0.01
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def soup():
    js, scene, nodes, rows = soup_scenes()
    return js, scene, nodes, rows, bk.pack_nodes(scene.bvh), tt(rows)


def test_pack_nodes_matches_jax(soup):
    _, scene, nodes, _, tnodes, _ = soup
    np.testing.assert_array_equal(tnodes.numpy(), np.asarray(nodes))
    assert scene.bvh.max_depth <= bk.MAX_STACK


@pytest.mark.parametrize("rays", ["around", "inside"])
def test_closest_plain_matches_jax_and_the_traversal(soup, rays):
    _, scene, nodes, rows, tnodes, trows = soup
    o, d = soup_rays(rays)
    work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
    got = bk.bvh_trace_surface(tnodes, trows, tt(o), tt(d), work=work)
    want = jbk.bvh_trace_surface_pallas(nodes, rows, jnp.asarray(o), jnp.asarray(d),
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
    # the same per-ray walk as the traversal: the same triangle everywhere
    np.testing.assert_array_equal(tri, tv.trace_closest_bvh(scene, tt(o), tt(d)).tri.numpy())
    # two box tests per node visited; a hit needs a tested triangle
    w = work.numpy()
    assert (w[:, 0] >= 2).all() and (w[:, 0] % 2 == 0).all() and (w[hit, 1] > 0).all()


@pytest.mark.parametrize("t_max", [2.5, 0.0, np.inf])
def test_anyhit_plain_matches_jax(soup, t_max):
    _, _, nodes, rows, tnodes, trows = soup
    for name in ("around", "inside"):
        o, d = soup_rays(name)
        tm = np.full(o.shape[:-1], t_max, np.float32)
        work = torch.zeros((o.shape[0], 2), dtype=torch.int32)
        got = bk.bvh_trace_anyhit(tnodes, trows, tt(o), tt(d), tt(tm), work=work).numpy()
        want = np.asarray(jbk.bvh_trace_anyhit_pallas(
            nodes, rows, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), interpret=True))
        np.testing.assert_array_equal(got, want)
        if t_max == 0.0:
            assert not got.any() and not work.numpy().any()
        else:
            assert 0.0 < got.mean() < 1.0


def test_traversal_matches_jax(soup):
    """bvh/traverse.py against strolle_tpu/bvh/traverse.py: tri exact, t/u/v
    close, occlusion and the per-ray byte counts exact."""
    js, scene, *_ = soup
    o, d = soup_rays("inside")
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    got = tv.trace_closest_bvh(scene, tt(o), tt(d))
    want = jtv.trace_closest_bvh(js, jo, jd)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = got.tri.numpy() >= 0
    assert 0.05 < hit.mean() < 0.95
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit], np.asarray(getattr(want, k))[hit],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.isinf(got.t.numpy()[~hit]).all()
    tm = np.full(o.shape[:-1], 2.5, np.float32)
    occ = tv.trace_anyhit_bvh(scene, tt(o), tt(d), tt(tm)).numpy()
    want_occ = jtv.trace_anyhit_bvh(js, jo, jd, jnp.asarray(tm))
    np.testing.assert_array_equal(occ, np.asarray(want_occ))
    assert 0.0 < occ.mean() < 1.0
    cost = tv.trace_cost_bvh(scene, tt(o), tt(d)).numpy()
    np.testing.assert_array_equal(cost, np.asarray(jtv.trace_cost_bvh(js, jo, jd)))
    assert (cost >= tv.NODE_BYTES).all()


def test_kernel_paths_take_only_cuda_tensors(soup, monkeypatch):
    """The wrappers run the plain versions on CPU tensors without touching
    the CUDA library or the launch counts; the launch path refuses CPU
    tensors."""
    *_, tnodes, trows = soup
    o, d = (tt(x[:8]) for x in soup_rays("inside"))

    def no_library():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    cuda_lib.reset_launch_counts()
    bk.bvh_trace_surface(tnodes, trows, o, d)
    bk.bvh_trace_anyhit(tnodes, trows, o, d, torch.full((8,), 2.0))
    assert cuda_lib.LAUNCHES == {}
    for entry, ray_arg, outs in (
        ("strolle_bvh_trace_surface", None, cuda_lib.surface_outputs((8,), o.device)),
        ("strolle_bvh_trace_anyhit", torch.full((8,), 2.0), (torch.empty(8, dtype=torch.bool),)),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_lib.launch_walk(entry, (tnodes, trows), o, d, ray_arg, outs, None)
    with pytest.raises(ValueError, match=r"\[N, 16\]"):
        bk.bvh_trace_surface(tnodes[:, :8], trows, o, d)
    with pytest.raises(ValueError, match=r"\[T, 28\]"):
        bk.bvh_trace_anyhit(tnodes, trows[:, :12], o, d, 1.0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_walk_is_per_ray_under_any_ray_order(soup):
    """Kernels 10 and 11 walk each ray alone, in whatever grouping and
    order the card runs their threads, so a ray's walk must not depend on
    which rays are walked with it. Both plain versions, on 64 seeded rays
    of each soup set permuted and walked in chunks of 32 and of 7, then put
    back in order: every output and every ray's box, triangle and
    first-half counts bit-equal to one walk of all 128 rays in order."""
    *_, tnodes, trows = soup
    rs = np.random.RandomState(5)
    picked = [(o[k], d[k]) for o, d in map(soup_rays, ("around", "inside"))
              for k in [rs.choice(o.shape[0], 64, replace=False)]]
    o, d = (tt(np.concatenate(x)) for x in zip(*picked))
    n = o.shape[0]
    # t_max <= 0 on some rays: those never occlude and do not walk
    tm = tt(rs.uniform(-0.5, 4.0, n).astype(np.float32))
    walks = {
        "surface": lambda idx, w: bk.bvh_trace_surface_plain(tnodes, trows, o[idx], d[idx], w),
        "anyhit": lambda idx, w: (
            bk.bvh_trace_anyhit_plain(tnodes, trows, o[idx], d[idx], tm[idx], w),),
    }
    for kernel, walk in walks.items():
        work = torch.zeros((n, 3), dtype=torch.int32)
        want = walk(torch.arange(n), work)
        assert work[:, 0].any() and work[:, 1].any() and work[:, 2].any()
        perm = torch.as_tensor(rs.permutation(n))
        for chunk in (32, 7):
            got = [torch.empty_like(x) for x in want]
            gwork = torch.zeros_like(work)
            for c0 in range(0, n, chunk):
                idx = perm[c0:c0 + chunk]
                w = torch.zeros((idx.numel(), 3), dtype=torch.int32)
                for g, x in zip(got, walk(idx, w)):
                    g[idx] = x
                gwork[idx] = w
            what = f"{kernel}, chunks of {chunk}"
            for g, x in zip(got, want):
                assert torch.equal(_bits(g), _bits(x)), what
            assert torch.equal(gwork, work), what

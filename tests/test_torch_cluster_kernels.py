"""Kernels 8 and 9 (ops/kernels/cluster_kernels.py): the plain versions
against the JAX package's cluster kernels in interpret mode, on the JAX
tests' soup of CLUSTER_TRIS*3+57 triangles (four clusters, the last one
ragged), 256 rays per set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import soup_rays, soup_scenes, tt

from strolle_tpu.ops.pallas import cluster_kernels as jck
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
    # every ray tests all 4 cluster boxes; an entered cluster adds its rows
    w = work.numpy()
    assert (w[:, 0] == 4).all()
    assert (w[:, 1] <= 3 * 256 + 57).all() and (w[hit, 1] > 0).all()


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
    with pytest.raises(NotImplementedError):
        ck.clusterize_bvh(None, 10)

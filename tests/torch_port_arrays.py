"""Helpers of the port's tests: JAX package objects as the nested numpy
dicts that strolle_tpu_torch.convert takes, a smooth-normal Cornell
built the same way in both packages, the JAX tests' triangle soup in
both packages, the warp walks' coherent rays and exact-tie scene, and
one torch thread per test process."""

import dataclasses
import functools

import numpy as np
import torch

# The port's tests run many small torch ops while, in a parallel run, the
# JAX tests keep every core busy; torch's intra-op thread pool then
# oversubscribes the cores, and a test that takes 2 s alone took over
# 80 s. One torch thread per test process keeps them cheap. Every
# tests/test_torch_*.py imports this module.
torch.set_num_threads(1)


def np_tree(x):
    """A JAX dataclass / tuple / dict of arrays as nested numpy dicts."""
    if dataclasses.is_dataclass(x):
        return {f.name: np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(np_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return np.asarray(x)


def scene_arrays(jscene) -> dict:
    """A JAX Scene as convert.scene_from_arrays takes it."""
    out = {k: np_tree(getattr(jscene, k)) for k in ("geometry", "materials", "lights")}
    out["materials"]["tex_channels"] = jscene.materials.tex_channels
    out["atlas"] = None if jscene.atlas is None else np.asarray(jscene.atlas.image)
    out["bvh"] = None if jscene.bvh is None else np_tree(jscene.bvh)
    out["clusters"] = None if jscene.clusters is None else np.asarray(jscene.clusters)
    for k in ("sun_azimuth", "sun_altitude", "has_alpha", "flat_normals", "has_metal"):
        out[k] = getattr(jscene, k)
    return out


def perturbed_normals(normals, seed: int = 4) -> np.ndarray:
    """Jittered unit vertex normals: interpolation is no longer trivial."""
    rs = np.random.RandomState(seed)
    n = np.asarray(normals) + rs.normal(0.0, 0.08, np.shape(normals)).astype(np.float32)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def soup_scenes(n_tris: int = 256 * 3 + 57):
    """The JAX tests' triangle soup (tests/test_bvh_kernels.py::_soup_scene:
    four clusters, the last one ragged, and a BVH from the JAX package's
    numpy builder) and the port's copy of it, with the kernels' rows
    packed by the JAX package: (JAX scene, port scene, JAX node rows, JAX
    [T', 28] rows). Built once per test process."""
    return _soup_scenes(n_tris)


@functools.cache
def _soup_scenes(n_tris: int):
    from strolle_tpu_torch import convert
    from tests.test_bvh_kernels import _packed, _soup_scene

    js = _soup_scene(n_tris=n_tris)
    nodes, rows = _packed(js)
    return js, convert.scene_from_arrays(scene_arrays(js), device="cpu"), nodes, rows


def soup_rays(name: str):
    """Seeded rays of the soup tests (numpy): from all around the soup
    (most miss) or from inside it (most hit), 256 of each."""
    from tests.test_bvh_kernels import _rays

    o, d = _rays(256, seed=1) if name == "around" else _rays(256, seed=2, spread=3.0)
    return np.asarray(o), np.asarray(d)


def tt(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor."""
    return torch.tensor(np.asarray(a))


def coherent_rays(rows):
    """8 warps of 32 rays, each warp from one origin 9 units off a soup
    triangle's face ([T', 28] ``rows``) in a narrow cone toward its
    centroid: every ray hits near there, so the front-to-back walk's stop
    fires."""
    from strolle_tpu_torch.ops.kernels.cluster_kernels import TILE_RAYS

    rs = np.random.RandomState(5)
    rows = rows.numpy()
    o, d = [], []
    for j in rs.choice(rows.shape[0] // 2, 8, replace=False):
        v0, e1, e2 = rows[j, 0:3], rows[j, 3:6], rows[j, 6:9]
        n = np.cross(e1, e2)
        n /= np.linalg.norm(n)
        c = v0 + (e1 + e2) / 3.0
        origin = c + 9.0 * n
        aim = c + 0.02 * rs.uniform(-1.0, 1.0, (TILE_RAYS, 1)) * (e1 + e2) - origin
        o.append(np.repeat(origin[None], TILE_RAYS, axis=0))
        d.append(aim / np.linalg.norm(aim, axis=-1, keepdims=True))
    return np.concatenate(o).astype(np.float32), np.concatenate(d).astype(np.float32)


def tie_scene():
    """Two clusters that both hold one triangle T (rows 5 and 263), in the
    plane x = 0, as (cluster rows, [T', 28] rows), and 2 warps of rays from
    x = -3 toward T. The rest lies off the rays' paths or behind T:
    cluster 0 reaches to x = -1 (row 0, far above) and x = 12, cluster 1
    spans x = -2.5 .. 0, so the rays meet cluster 1's box first."""
    return _tie_scene(np.float32(0.0), -1.0, None)


def tie_scene_on_entry_face():
    """As ``tie_scene``, T in the plane x = c (c and T's other coordinates
    not round numbers) and cluster 0's box beginning at x = c: T lies on
    the face through which the rays enter the lower copy's cluster, and
    the slab's t_near there rounds past T's t on some of the rays."""
    rs = np.random.RandomState(6)
    c = np.float32(rs.uniform(0.2, 0.6))
    yz = rs.uniform(-0.6, 0.6, (3, 2)).astype(np.float32)
    return _tie_scene(c, float(c), yz)


def _tie_scene(c, row0_x, yz):
    from strolle_tpu_torch.ops.kernels.cluster_kernels import (
        CLUSTER_TRIS, TILE_RAYS, clusterize_bvh,
    )

    rs = np.random.RandomState(3)
    if yz is None:
        tri = np.array([[0.0, -0.5, -0.5], [0.0, 0.5, -0.5], [0.0, 0.0, 0.5]], np.float32)
    else:
        tri = np.concatenate([np.full((3, 1), c, np.float32), yz], axis=1)
    small = rs.uniform(0.0, 0.2, (2 * CLUSTER_TRIS, 3, 3)).astype(np.float32)
    pos = np.empty_like(small)
    pos[:256] = small[:256] + rs.uniform([10, -1, -1], [12, 1, 1], (256, 1, 3))
    pos[256:] = small[256:] + rs.uniform([-2.5, 3, -1], [-0.7, 5, 1], (256, 1, 3))
    pos[0] = small[0] + np.array([row0_x, 5.0, 0.0], np.float32)
    pos[5] = pos[263] = tri
    positions = torch.tensor(pos)
    rows = torch.cat([positions[:, 0], positions[:, 1] - positions[:, 0],
                      positions[:, 2] - positions[:, 0], torch.zeros(pos.shape[0], 19)], dim=-1)
    rs = np.random.RandomState(4)
    n = 2 * TILE_RAYS
    o = np.stack([np.full(n, -3.0), rs.uniform(-0.2, 0.2, n), rs.uniform(-0.2, 0.2, n)], -1)
    if yz is None:
        aim = np.stack([np.zeros(n), rs.uniform(-0.2, 0.2, n), rs.uniform(-0.3, 0.1, n)], -1) - o
    else:
        # points inside T, by barycentric weights
        aim = rs.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32) @ tri - o
    d = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    return (clusterize_bvh(None, pos.shape[0], positions), rows,
            torch.tensor(o.astype(np.float32)), torch.tensor(d.astype(np.float32)))


#: The alpha-blended pane that ``alpha_cornell_scenes`` adds: across the
#: front of the box, between the camera and both boxes.
ALPHA_PANE = ([-0.7, 0.1, 0.7], [0.7, 0.1, 0.7], [0.7, 1.7, 0.7], [-0.7, 1.7, 0.7])


def alpha_cornell_scenes(alpha: float = 0.4):
    """Cornell with one pane on an alpha-blended material of base alpha
    ``alpha`` (below 1: every ray passes through it) in both packages:
    (JAX scene, port scene), built by the JAX package and carried over."""
    import jax.numpy as jnp
    from strolle_tpu.scene.build import MeshBuilder
    from strolle_tpu.scene.cornell import cornell_box
    from strolle_tpu.scene.types import make_materials
    from strolle_tpu_torch import convert

    js = cornell_box()
    b = MeshBuilder()
    b.add_quad(*ALPHA_PANE, js.materials.num_materials)
    pane = b.build()
    g = js.geometry
    geom = g.replace(**{
        f: jnp.concatenate([jnp.asarray(getattr(g, f)), jnp.asarray(getattr(pane, f))])
        for f in ("positions", "normals", "uvs", "tangents", "material_id")
    })
    m = make_materials([{"base_color": [0.9, 0.5, 0.2, alpha], "alpha_blend": 1}])
    mats = js.materials.replace(**{
        f.name: jnp.concatenate([jnp.asarray(getattr(js.materials, f.name)),
                                 jnp.asarray(getattr(m, f.name))])
        for f in dataclasses.fields(m) if f.name != "tex_channels"
    })
    jscene = js.replace(geometry=geom, materials=mats, has_alpha=True)
    return jscene, convert.scene_from_arrays(scene_arrays(jscene), device="cpu")


# -- spawned gloo ranks (plain subprocesses that never import JAX) ----------

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
#: Seconds after which a spawned rank is killed.
CHILD_TIMEOUT = 120

#: The head of a spawned rank's code: argv is (rank, world, store, output).
CHILD_PRELUDE = """
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
"""


def spawn_ranks(code: str, world: int, tmp_path) -> list:
    """``world`` ranks of ``code`` as plain subprocesses (argv: rank,
    world, store, output), with the repository and this directory on
    their path."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    store = str(tmp_path / "store")
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), store,
                              str(tmp_path / f"rank{r}.pt")],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs, tmp_path):
    """Rank 0's saved results, once every rank exited 0; every child is
    killed after CHILD_TIMEOUT s."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n{err[-3000:]}"
    return torch.load(tmp_path / "rank0.pt", weights_only=False)


def blocks_scene(w: int, h: int):
    """A port scene over 1,024 triangles with a BVH and the sun up (so
    the realtime frame compacts its checkerboarded rays and its misses
    see the sky): a 10x10 slab of boxes on two materials under one
    light, built by the port's SceneEditor on the CPU; with its camera
    at ``w`` x ``h``."""
    from strolle_tpu_torch.camera import make_camera
    from strolle_tpu_torch.examples.minecraft import box_triangles
    from strolle_tpu_torch.scene.dynamics import SceneEditor

    ed = SceneEditor(materials=[{"base_color": [0.7, 0.7, 0.7, 1.0], "roughness": 0.6},
                                {"base_color": [0.3, 0.6, 0.3, 1.0], "roughness": 1.0}],
                     light_capacity=4, sun_altitude=0.5, sun_azimuth=0.7, device="cpu")
    ed.insert_light("lamp", pos=[0.0, 3.0, 2.0], radius=0.1, color=[10.0, 9.0, 7.0])
    for x in range(-5, 5):
        for z in range(-5, 5):
            ed.insert_instance((x, z), box_triangles((x + 0.5, 0.15 * ((x * z) % 3) - 0.5,
                                                      z + 0.5)), material_id=(x + z) % 2)
    cam = make_camera(eye=[6.0, 4.0, 7.0], target=[0.0, 0.5, 0.0], fov_y=np.deg2rad(55.0),
                      width=w, height=h, device="cpu")
    return ed.tick(), cam

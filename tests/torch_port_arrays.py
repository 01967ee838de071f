"""Helpers of the port's tests: JAX package objects as the nested numpy
dicts that strolle_tpu_torch.convert takes, a smooth-normal Cornell
built the same way in both packages, the JAX tests' triangle soup in
both packages, and one torch thread per test process."""

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

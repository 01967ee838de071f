"""Helpers of the port's tests: JAX package objects as the nested numpy
dicts that strolle_tpu_torch.convert takes, a smooth-normal Cornell
built the same way in both packages, and one torch thread per test
process."""

import dataclasses

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
    out["atlas"] = None
    for k in ("sun_azimuth", "sun_altitude", "has_alpha", "flat_normals", "has_metal"):
        out[k] = getattr(jscene, k)
    return out


def perturbed_normals(normals, seed: int = 4) -> np.ndarray:
    """Jittered unit vertex normals: interpolation is no longer trivial."""
    rs = np.random.RandomState(seed)
    n = np.asarray(normals) + rs.normal(0.0, 0.08, np.shape(normals)).astype(np.float32)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)

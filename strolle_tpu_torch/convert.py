"""Carry-over between the JAX package's data and the port's.

The JAX package's Scene, Camera and RefAccumulator travel as nested
dicts of numpy arrays (field name -> array, or a dict for a nested
dataclass), so this module never imports JAX. ``*_to_arrays`` go the
other way, for round trips.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .device import resolve_device
from .models.reference import RefAccumulator
from .scene.types import Geometry, Lights, Materials, Scene

_INT_FIELDS = {"material_id", "alpha_blend", "kind", "prev_kind", "remap", "killed"}


def _tensors(cls, arrays: dict, device, skip=()) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        dtype = torch.int32 if f.name in _INT_FIELDS else torch.float32
        out[f.name] = torch.tensor(
            np.asarray(arrays[f.name]), dtype=dtype, device=device
        )
    return out


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """The port's Scene from a JAX Scene given as nested numpy dicts
    (``geometry``, ``materials``, ``lights`` sub-dicts; ``atlas`` None
    or an array; scalars and flags as they are)."""
    device = resolve_device(device)
    mats = arrays["materials"]
    lights = arrays["lights"]
    atlas = arrays.get("atlas")
    return Scene(
        geometry=Geometry(**_tensors(Geometry, arrays["geometry"], device)),
        materials=Materials(
            **_tensors(Materials, mats, device, skip=("tex_channels",)),
            tex_channels=tuple(bool(x) for x in mats["tex_channels"]),
        ),
        lights=Lights(
            **_tensors(Lights, lights, device, skip=("count",)),
            count=int(np.asarray(lights["count"])),
        ),
        atlas=None
        if atlas is None
        else torch.tensor(np.asarray(atlas), dtype=torch.float32, device=device),
        sun_azimuth=float(np.asarray(arrays["sun_azimuth"])),
        sun_altitude=float(np.asarray(arrays["sun_altitude"])),
        has_alpha=bool(arrays.get("has_alpha", False)),
        flat_normals=bool(arrays.get("flat_normals", False)),
        has_metal=bool(arrays.get("has_metal", True)),
    )


def _numpy(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[f.name] = v
    return out


def scene_to_arrays(scene: Scene) -> dict:
    """The inverse of ``scene_from_arrays``."""
    out = {
        "geometry": _numpy(scene.geometry),
        "materials": _numpy(scene.materials),
        "lights": _numpy(scene.lights),
        "atlas": None if scene.atlas is None else scene.atlas.detach().cpu().numpy(),
    }
    for k in ("sun_azimuth", "sun_altitude", "has_alpha", "flat_normals", "has_metal"):
        out[k] = getattr(scene, k)
    return out


def camera_from_arrays(arrays: dict, device=None) -> Camera:
    """The port's Camera from a JAX Camera's fields (projection_view,
    ndc_to_world, origin, width, height)."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    return Camera(
        projection_view=t(arrays["projection_view"]),
        ndc_to_world=t(arrays["ndc_to_world"]),
        origin=t(arrays["origin"]),
        width=int(arrays["width"]),
        height=int(arrays["height"]),
    )


def accumulator_from_arrays(arrays: dict, device=None) -> RefAccumulator:
    """The port's RefAccumulator from a JAX one's fields."""
    device = resolve_device(device)
    return RefAccumulator(
        **{
            f.name: torch.tensor(
                np.asarray(arrays[f.name]), dtype=torch.float32, device=device
            )
            for f in dataclasses.fields(RefAccumulator)
        }
    )


def accumulator_to_arrays(accum: RefAccumulator) -> dict:
    return _numpy(accum)

"""Carry-over between the JAX package's data and the port's.

The JAX package's Scene (with its atlas image, BvhArrays and cluster
rows), Camera, RefAccumulator, the realtime frame's
RenderState (with its reservoirs, denoiser states, previous Surface and
Camera) and AtmosphereLuts travel as nested dicts of numpy arrays
(field name -> array, or a dict for a nested dataclass), so this module
never imports JAX. ``*_to_arrays`` go the other way, for round trips.

Dtypes: float32 and int32 stay; bool stays; the JAX package's uint32
RNG states become int64 tensors holding the same value (the port's u32
convention, ops/rng.py) and go back as uint32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh.builder import BvhArrays
from .camera import Camera
from .denoise.svgf import DenoiserState
from .device import resolve_device
from .models.reference import RefAccumulator
from .models.restir import RenderState
from .ops.hit import Surface
from .restir.gi import GiReservoirs
from .restir.reservoir import DiReservoirs
from .scene.types import Geometry, Lights, Materials, Scene, make_atlas
from .sky.atmosphere import AtmosphereLuts

_INT_FIELDS = {
    "material_id", "alpha_blend", "kind", "prev_kind", "remap", "killed", "child",
    "child_count",
}


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
    or the atlas image; ``bvh`` None or a dict of the BvhArrays fields;
    ``clusters`` None or the [K, 8] rows; scalars and flags as they are)."""
    device = resolve_device(device)
    mats = arrays["materials"]
    lights = arrays["lights"]
    atlas = arrays.get("atlas")
    bvh = arrays.get("bvh")
    clusters = arrays.get("clusters")
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
        else make_atlas(torch.tensor(np.asarray(atlas), dtype=torch.float32, device=device)),
        sun_azimuth=float(np.asarray(arrays["sun_azimuth"])),
        sun_altitude=float(np.asarray(arrays["sun_altitude"])),
        bvh=None
        if bvh is None
        else BvhArrays(
            **_tensors(BvhArrays, bvh, device, skip=("max_depth",)),
            max_depth=int(bvh["max_depth"]),
        ),
        clusters=None
        if clusters is None
        else torch.tensor(np.asarray(clusters), dtype=torch.float32, device=device),
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
        "atlas": None if scene.atlas is None else scene.atlas.image.detach().cpu().numpy(),
        "bvh": None if scene.bvh is None else _numpy(scene.bvh),
        "clusters": None if scene.clusters is None else scene.clusters.detach().cpu().numpy(),
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


def tensor_from_array(a, device) -> torch.Tensor:
    """One array as a tensor: uint32 -> int64 of the same value, other
    dtypes kept."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def array_from_tensor(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if u32 else a


def dataclass_from_arrays(cls, arrays: dict, device=None):
    """A dataclass of tensors (Surface, Reprojection, reservoirs,
    DenoiserState, AtmosphereLuts) from a dict of its fields' arrays."""
    device = resolve_device(device)
    return cls(**{
        f.name: tensor_from_array(arrays[f.name], device) for f in dataclasses.fields(cls)
    })


def dataclass_to_arrays(obj, u32_fields=()) -> dict:
    return {
        f.name: array_from_tensor(getattr(obj, f.name), f.name in u32_fields)
        for f in dataclasses.fields(obj)
    }


def render_state_from_arrays(arrays: dict, device=None) -> RenderState:
    """The port's RenderState from a JAX RenderState's fields (each
    nested dataclass a dict; ``frame`` a scalar)."""
    device = resolve_device(device)
    return RenderState(
        frame=int(np.asarray(arrays["frame"])),
        prev_camera=camera_from_arrays(arrays["prev_camera"], device),
        prev_surface=dataclass_from_arrays(Surface, arrays["prev_surface"], device),
        di_prev=dataclass_from_arrays(DiReservoirs, arrays["di_prev"], device),
        gi_prev=dataclass_from_arrays(GiReservoirs, arrays["gi_prev"], device),
        di_diff_denoiser=dataclass_from_arrays(DenoiserState, arrays["di_diff_denoiser"], device),
        gi_diff_denoiser=dataclass_from_arrays(DenoiserState, arrays["gi_diff_denoiser"], device),
    )


def render_state_to_arrays(state: RenderState) -> dict:
    """The inverse of ``render_state_from_arrays``: the JAX package's
    dtypes (``frame`` int32, GI RNG states uint32)."""
    cam = state.prev_camera
    return {
        "frame": np.int32(state.frame),
        "prev_camera": {
            "projection_view": array_from_tensor(cam.projection_view),
            "ndc_to_world": array_from_tensor(cam.ndc_to_world),
            "origin": array_from_tensor(cam.origin),
            "width": cam.width,
            "height": cam.height,
        },
        "prev_surface": dataclass_to_arrays(state.prev_surface),
        "di_prev": dataclass_to_arrays(state.di_prev),
        "gi_prev": dataclass_to_arrays(state.gi_prev, u32_fields=("rng",)),
        "di_diff_denoiser": dataclass_to_arrays(state.di_diff_denoiser),
        "gi_diff_denoiser": dataclass_to_arrays(state.gi_diff_denoiser),
    }


def luts_from_arrays(arrays: dict, device=None) -> AtmosphereLuts:
    """The port's AtmosphereLuts from a JAX AtmosphereLuts' fields."""
    return dataclass_from_arrays(AtmosphereLuts, arrays, device)

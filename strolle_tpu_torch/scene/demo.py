"""Demo scenes from the bundled assets (port of strolle_tpu/scene/demo.py):
the dungeon level (``assets/demo.zip``: ``demo/level.glb``) with its point
lights, and the Cornell glTF (``assets/cornell.zip``). Files are read
straight out of the zips; nothing is extracted or written.
"""

from __future__ import annotations

import posixpath
import zipfile
from pathlib import Path

import numpy as np

from .gltf import load_gltf
from .types import LIGHT_POINT, Scene

ASSETS = Path(__file__).resolve().parents[2] / "assets"


def _load_from_zip(zip_name: str, member: str, **kwargs) -> Scene:
    with zipfile.ZipFile(ASSETS / zip_name) as z:
        base = posixpath.dirname(member)
        return load_gltf(
            z.read(member),
            read_uri=lambda uri: z.read(posixpath.join(base, uri)),
            **kwargs,
        )


def dungeon(light_intensity: float = 8.0, **kwargs) -> Scene:
    """The demo dungeon level (8,393 textured triangles) with a handful of
    point lights along its corridors. ``kwargs`` go to ``load_gltf``
    (``device=...`` among them)."""
    c = light_intensity
    warm = [c * 0.9, c * 0.75, c * 0.5]
    cold = [c * 0.7, c * 0.8, c]
    lights = [
        {"pos": [-3.0, 0.75, -0.75], "radius": 0.05, "color": warm, "kind": LIGHT_POINT, "range": 20.0},
        {"pos": [0.25, 0.75, 0.0], "radius": 0.05, "color": warm, "kind": LIGHT_POINT, "range": 20.0},
        {"pos": [3.0, 0.75, -0.75], "radius": 0.05, "color": warm, "kind": LIGHT_POINT, "range": 20.0},
        {"pos": [6.0, 0.75, 0.0], "radius": 0.05, "color": cold, "kind": LIGHT_POINT, "range": 20.0},
        {"pos": [-6.0, 0.75, 0.0], "radius": 0.05, "color": cold, "kind": LIGHT_POINT, "range": 20.0},
        {"pos": [0.0, 2.0, 3.0], "radius": 0.08, "color": [c, c, c], "kind": LIGHT_POINT, "range": 30.0},
    ]
    return _load_from_zip("demo.zip", "demo/level.glb", lights=lights, **kwargs)


def dungeon_camera(width: int = 640, height: int = 480, device=None):
    from ..camera import make_camera

    return make_camera(
        eye=[0.0, 2.2, 7.0],
        target=[0.0, 0.8, 0.0],
        fov_y=np.deg2rad(55.0),
        width=width,
        height=height,
        device=device,
    )


def cornell_gltf(**kwargs) -> Scene:
    """The Cornell glTF asset (t-ly, CC-BY-4.0; see the asset's license)."""
    lights = [
        {"pos": [0.0, 1.5, 0.0], "radius": 0.05, "color": [2.5, 2.5, 2.5], "kind": LIGHT_POINT,
         "range": np.inf}
    ]
    return _load_from_zip("cornell.zip", "cornell/scene.gltf", lights=lights, **kwargs)

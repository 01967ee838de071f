"""Procedural Cornell box, the port's first test scene (port of
strolle_tpu/scene/cornell.py; the same triangles in the same order)."""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .build import MeshBuilder
from .types import (
    LIGHT_POINT,
    Scene,
    compute_static_flags,
    make_lights,
    make_materials,
)

# material slots
MAT_WHITE = 0
MAT_RED = 1
MAT_GREEN = 2
MAT_LAMP = 3
MAT_METAL = 4


def cornell_box(
    light_intensity: float = 6.0,
    emissive_lamp: bool = False,
    metallic_tall_box: bool = False,
    light_capacity: int = 4,
    boxes: bool = True,
    device=None,
) -> Scene:
    """Box spanning x,z in [-1, 1], y in [0, 2], open toward the +z camera."""
    device = resolve_device(device)
    b = MeshBuilder()

    # floor (y=0), ceiling (y=2), back wall (z=-1), red left, green right
    b.add_quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], MAT_WHITE)
    b.add_quad([-1, 2, 1], [1, 2, 1], [1, 2, -1], [-1, 2, -1], MAT_WHITE)
    b.add_quad([-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1], MAT_WHITE)
    b.add_quad([-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1], MAT_RED)
    b.add_quad([1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1], MAT_GREEN)

    # lamp panel just below the ceiling (facing down)
    s = 0.35
    y = 1.995
    b.add_quad([-s, y, s], [s, y, s], [s, y, -s], [-s, y, -s], MAT_LAMP)

    def add_box(center, size, rot_y, mat):
        cx, cy, cz = center
        sx, sy, sz = size
        c, sn = np.cos(rot_y), np.sin(rot_y)

        def pt(dx, dy, dz):
            x, z = dx * sx * 0.5, dz * sz * 0.5
            xr = c * x + sn * z
            zr = -sn * x + c * z
            return [cx + xr, cy + dy * sy * 0.5, cz + zr]

        quads = [
            ([-1, 1, 1], [1, 1, 1], [1, 1, -1], [-1, 1, -1]),  # top
            ([-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]),  # bottom
            ([-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]),  # +z
            ([1, -1, -1], [-1, -1, -1], [-1, 1, -1], [1, 1, -1]),  # -z
            ([1, -1, 1], [1, -1, -1], [1, 1, -1], [1, 1, 1]),  # +x
            ([-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]),  # -x
        ]
        for q in quads:
            b.add_quad(*(pt(*d) for d in q), mat)

    if boxes:
        add_box(
            center=[-0.37, 0.6, -0.35],
            size=[0.57, 1.2, 0.57],
            rot_y=np.deg2rad(17.0),
            mat=MAT_METAL if metallic_tall_box else MAT_WHITE,
        )
        add_box(
            center=[0.38, 0.3, 0.38],
            size=[0.58, 0.6, 0.58],
            rot_y=np.deg2rad(-18.0),
            mat=MAT_WHITE,
        )

    lamp_emissive = light_intensity if emissive_lamp else 0.0
    materials = make_materials(
        [
            {"base_color": [0.73, 0.73, 0.73, 1.0], "roughness": 1.0},
            {"base_color": [0.61, 0.06, 0.06, 1.0], "roughness": 1.0},
            {"base_color": [0.12, 0.45, 0.12, 1.0], "roughness": 1.0},
            {
                "base_color": [1.0, 1.0, 1.0, 1.0],
                "emissive": [lamp_emissive] * 3 + [1.0],
                "roughness": 1.0,
            },
            {
                "base_color": [0.95, 0.95, 0.95, 1.0],
                "roughness": 0.05,
                "metallic": 1.0,
            },
        ],
        device=device,
    )
    lights = make_lights(
        [
            {
                "pos": [0.0, 1.85, 0.0],
                "radius": 0.05,
                "color": [light_intensity] * 3,
                "range": np.inf,
                "kind": LIGHT_POINT,
            }
        ],
        capacity=light_capacity,
        device=device,
    )
    geometry = b.build(device)
    return Scene(
        geometry=geometry,
        materials=materials,
        lights=lights,
        atlas=None,
        sun_azimuth=0.0,
        sun_altitude=-1.0,  # sun below the horizon
        **compute_static_flags(geometry, materials),
    )


def cornell_camera(width: int = 512, height: int = 512, device=None):
    from ..camera import make_camera

    return make_camera(
        eye=[0.0, 1.0, 3.2],
        target=[0.0, 1.0, 0.0],
        fov_y=np.deg2rad(45.0),
        width=width,
        height=height,
        device=device,
    )

"""Dynamic block building on a voxel grid (port of examples/minecraft.py).

Every few frames a block is inserted through the SceneEditor (and one is
removed every seventh frame), forcing a geometry and BVH refresh: the
dynamic-scene path.

Run: python -m strolle_tpu_torch.examples.minecraft [--frames 48] [--cpu]
"""

from __future__ import annotations

import numpy as np

from ._common import FrameTimer, Saved, device_of, frame_done, parse_args, should_save

GRASS, DIRT, STONE, LAMP = 1, 2, 3, 4


def box_triangles(center, size=1.0) -> np.ndarray:
    """Axis-aligned cube as a [12, 3, 3] triangle soup with outward CCW
    winding."""
    cx, cy, cz = center
    h = size / 2.0
    v = np.asarray(
        [
            [cx - h, cy - h, cz - h], [cx + h, cy - h, cz - h],
            [cx + h, cy + h, cz - h], [cx - h, cy + h, cz - h],
            [cx - h, cy - h, cz + h], [cx + h, cy - h, cz + h],
            [cx + h, cy + h, cz + h], [cx - h, cy + h, cz + h],
        ],
        np.float32,
    )
    quads = [
        (4, 5, 6, 7),  # +z
        (1, 0, 3, 2),  # -z
        (5, 1, 2, 6),  # +x
        (0, 4, 7, 3),  # -x
        (7, 6, 2, 3),  # +y
        (0, 1, 5, 4),  # -y
    ]
    tris = []
    for a, b, c, d in quads:
        tris.append([v[a], v[b], v[c]])
        tris.append([v[a], v[c], v[d]])
    return np.asarray(tris, np.float32)


def main(argv=None) -> dict:
    args = parse_args("minecraft", frames=48, width=512, height=384, argv=argv)
    device = device_of(args.cpu)

    from ..camera import make_camera
    from ..models.restir import RenderConfig, init_state, render_frame
    from ..scene.dynamics import SceneEditor
    from ..sky.atmosphere import luts_for

    materials = [
        {"base_color": [0.8, 0.8, 0.8, 1.0], "roughness": 1.0},  # 0 unused
        {"base_color": [0.30, 0.65, 0.25, 1.0], "roughness": 1.0},  # grass
        {"base_color": [0.45, 0.30, 0.18, 1.0], "roughness": 1.0},  # dirt
        {"base_color": [0.55, 0.55, 0.58, 1.0], "roughness": 0.8},  # stone
        {
            "base_color": [1.0, 0.9, 0.6, 1.0],
            "emissive": [4.0, 3.5, 2.0, 1.0],
        },  # lamp
    ]
    editor = SceneEditor(
        materials=materials, light_capacity=8, sun_altitude=0.5, sun_azimuth=0.7,
        device=device,
    )
    editor.insert_light(
        "torch", pos=[0.0, 4.0, 4.0], radius=0.1, color=[12.0, 10.0, 7.0]
    )

    # ground slab 8x8
    rng = np.random.default_rng(7)
    for x in range(-4, 4):
        for z in range(-4, 4):
            editor.insert_instance(
                ("ground", x, z), box_triangles((x + 0.5, -0.5, z + 0.5)),
                material_id=GRASS if rng.random() < 0.8 else DIRT,
            )

    camera = make_camera(
        eye=[7.0, 6.0, 9.0],
        target=[0.0, 1.0, 0.0],
        fov_y=np.deg2rad(50.0),
        width=args.width,
        height=args.height,
        device=device,
    )

    # a little tower gets built one block per 2 frames, then torn down
    plan = [(0, y, 0) for y in range(5)] + [(1, 0, 0), (0, 0, 1), (1, 4, 0)]
    config = RenderConfig(denoise=not args.no_denoise, include_sky=True)
    state = init_state(camera, device=camera.device)
    timer = FrameTimer()
    saved = Saved(args.out)

    placed: list[tuple] = []
    for f in range(args.frames):
        if f % 2 == 0 and f // 2 < len(plan):
            x, y, z = plan[f // 2]
            handle = ("block", x, y, z)
            mat = LAMP if y == 4 else STONE
            editor.insert_instance(
                handle, box_triangles((x + 0.5, y + 0.5, z + 0.5)),
                material_id=mat,
            )
            placed.append(handle)
        elif f % 7 == 6 and placed:
            editor.remove_instance(placed.pop(0))

        scene = editor.tick()
        luts = luts_for(scene.sun_altitude, camera.device)
        channels, state = render_frame(scene, camera, state, f, config, luts=luts)
        img = channels[args.mode]
        frame_done(img)
        timer.lap()
        if should_save(f, args.frames, args.save_every):
            saved.save(f"frame_{f:04d}.png", img)

    print(timer.report())
    print(f"wrote {args.out}/frame_*.png")
    return saved.result(ms_per_frame=timer.times, triangles=scene.geometry.num_triangles)


if __name__ == "__main__":
    main()

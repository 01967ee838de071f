"""Light-churn stress test: many moving lights and slot add/remove (port
of examples/stress_lights.py).

A swarm of coloured point lights orbits a reflective floor, and every few
frames one light is removed and a new one inserted: the slot kill/remap
protocol that keeps in-flight DI reservoirs valid.

Run: python -m strolle_tpu_torch.examples.stress_lights [--frames 48] [--cpu]
"""

from __future__ import annotations

import colorsys

import numpy as np

from ._common import FrameTimer, Saved, device_of, frame_done, parse_args, should_save
from .minecraft import box_triangles

N_LIGHTS = 14


def main(argv=None) -> dict:
    args = parse_args("stress_lights", frames=48, width=384, height=288, argv=argv)
    device = device_of(args.cpu)

    from ..camera import make_camera
    from ..models.restir import RenderConfig, init_state, render_frame
    from ..scene.dynamics import SceneEditor

    materials = [
        {"base_color": [0.85, 0.85, 0.85, 1.0], "roughness": 0.25},  # floor
        {"base_color": [0.6, 0.6, 0.65, 1.0], "roughness": 0.9},  # pillars
    ]
    editor = SceneEditor(
        materials=materials, light_capacity=N_LIGHTS + 2, sun_altitude=-1.0, device=device
    )

    floor = np.asarray(
        [
            [[-10, 0, -10], [10, 0, -10], [10, 0, 10]],
            [[-10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    editor.insert_instance("floor", floor, material_id=0)
    for i, (x, z) in enumerate([(-4, -4), (4, -4), (-4, 4), (4, 4)]):
        editor.insert_instance(
            ("pillar", i),
            np.concatenate(
                [box_triangles((x, y + 0.5, z)) for y in range(3)]
            ),
            material_id=1,
        )

    def light_color(i: int) -> list[float]:
        r, g, b = colorsys.hsv_to_rgb((i * 0.37) % 1.0, 0.85, 1.0)
        return [14.0 * r, 14.0 * g, 14.0 * b]

    def light_pos(i: int, frame: int) -> list[float]:
        a = frame * 0.06 + i * (2 * np.pi / N_LIGHTS)
        r = 3.0 + 2.5 * ((i * 7) % 3) / 2.0
        return [
            float(r * np.cos(a)),
            1.0 + 0.8 * float(np.sin(frame * 0.11 + i)),
            float(r * np.sin(a)),
        ]

    next_id = 0
    live: list[int] = []
    for i in range(N_LIGHTS):
        editor.insert_light(
            ("orb", next_id),
            pos=light_pos(i, 0),
            radius=0.12,
            color=light_color(i),
        )
        live.append(next_id)
        next_id += 1

    camera = make_camera(
        eye=[0.0, 6.5, 13.0],
        target=[0.0, 1.0, 0.0],
        fov_y=np.deg2rad(55.0),
        width=args.width,
        height=args.height,
        device=device,
    )

    config = RenderConfig(denoise=not args.no_denoise)
    state = init_state(camera, device=camera.device)
    timer = FrameTimer()
    saved = Saved(args.out)

    for f in range(args.frames):
        # move every light (updates prev copies for temporal reuse)
        for k, lid in enumerate(live):
            editor.insert_light(
                ("orb", lid),
                pos=light_pos(k, f),
                radius=0.12,
                color=light_color(lid),
            )
        # churn: kill the oldest light, insert a fresh one
        if f % 6 == 5:
            editor.remove_light(("orb", live.pop(0)))
            editor.insert_light(
                ("orb", next_id),
                pos=light_pos(len(live), f),
                radius=0.12,
                color=light_color(next_id),
            )
            live.append(next_id)
            next_id += 1

        scene = editor.tick()
        channels, state = render_frame(scene, camera, state, f, config)
        img = channels[args.mode]
        frame_done(img)
        timer.lap()
        if should_save(f, args.frames, args.save_every):
            saved.save(f"frame_{f:04d}.png", img)

    print(timer.report())
    print(f"wrote {args.out}/frame_*.png")
    return saved.result(ms_per_frame=timer.times, lights=scene.lights.count)


if __name__ == "__main__":
    main()

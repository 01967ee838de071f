"""BVH stress test: falling boxes (port of examples/stress_bvh.py).

A gravity and ground-bounce integrator moves dozens of cubes every
frame. The boxes are instances of one mesh moved by their transforms, so
the SceneEditor refits the BVH each tick (a rebuild after a streak of
refits) and gives them object-motion velocity. Reports the scene and BVH
update ms/frame separately from render ms/frame. STRESS_BOXES sets the
number of boxes (48).

Run: python -m strolle_tpu_torch.examples.stress_bvh [--frames 32] [--cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np

from ._common import FrameTimer, Saved, device_of, frame_done, parse_args, should_save
from .minecraft import box_triangles


def main(argv=None) -> dict:
    args = parse_args("stress_bvh", frames=32, width=384, height=288, argv=argv)
    n_boxes = int(os.environ.get("STRESS_BOXES", "48"))
    device = device_of(args.cpu)

    from ..camera import make_camera
    from ..models.restir import RenderConfig, init_state, render_frame
    from ..scene.dynamics import SceneEditor
    from ..sky.atmosphere import luts_for

    materials = [
        {"base_color": [0.75, 0.75, 0.75, 1.0], "roughness": 1.0},  # floor
        {"base_color": [0.8, 0.3, 0.2, 1.0], "roughness": 0.6},
        {"base_color": [0.2, 0.5, 0.8, 1.0], "roughness": 0.6},
        {"base_color": [0.9, 0.8, 0.2, 1.0], "roughness": 0.6},
    ]
    editor = SceneEditor(materials=materials, sun_altitude=0.6, sun_azimuth=0.3, device=device)
    editor.insert_light(
        "key", pos=[6.0, 10.0, 6.0], radius=0.3, color=[60.0, 58.0, 52.0]
    )

    # static floor
    floor = np.asarray(
        [
            [[-12, 0, -12], [12, 0, -12], [12, 0, 12]],
            [[-12, 0, -12], [12, 0, 12], [-12, 0, 12]],
        ],
        np.float32,
    )
    editor.insert_instance("floor", floor, material_id=0)

    # boxes are mesh instances moved by transform: transform-only edits
    # take the BVH refit instead of a full rebuild, and get object-motion
    # velocity from their previous transforms
    editor.insert_mesh("unit_box", box_triangles((0.0, 0.0, 0.0)))

    rng = np.random.default_rng(3)
    pos = rng.uniform([-6, 6, -6], [6, 16, 6], (n_boxes, 3)).astype(np.float32)
    vel = np.zeros((n_boxes, 3), np.float32)
    vel[:, 0] = rng.uniform(-1, 1, n_boxes)
    vel[:, 2] = rng.uniform(-1, 1, n_boxes)

    camera = make_camera(
        eye=[0.0, 7.0, 18.0],
        target=[0.0, 3.0, 0.0],
        fov_y=np.deg2rad(55.0),
        width=args.width,
        height=args.height,
        device=device,
    )

    config = RenderConfig(denoise=not args.no_denoise, include_sky=True)
    state = init_state(camera, device=camera.device)
    timer = FrameTimer()
    saved = Saved(args.out)
    build_ms: list[float] = []
    dt = 1.0 / 30.0

    for f in range(args.frames):
        # integrate
        vel[:, 1] -= 9.8 * dt
        pos += vel * dt
        grounded = pos[:, 1] < 0.5
        pos[grounded, 1] = 0.5
        vel[grounded, 1] = np.abs(vel[grounded, 1]) * 0.55  # bounce

        t0 = time.perf_counter()
        for i in range(n_boxes):
            xf = np.eye(4, dtype=np.float32)
            xf[:3, 3] = pos[i]
            editor.insert_instance(
                ("box", i), mesh="unit_box", material=1 + i % 3, transform=xf
            )
        scene = editor.tick()
        build_ms.append((time.perf_counter() - t0) * 1e3)

        luts = luts_for(scene.sun_altitude, camera.device)
        channels, state = render_frame(scene, camera, state, f, config, luts=luts)
        img = channels[args.mode]
        frame_done(img)
        timer.lap()
        if should_save(f, args.frames, args.save_every):
            saved.save(f"frame_{f:04d}.png", img)

    print(timer.report())
    bm = build_ms[1:] or build_ms
    print(
        f"scene+BVH update: {sum(bm) / len(bm):.1f} ms/frame "
        f"({n_boxes} dynamic boxes, {scene.geometry.num_triangles} tris; "
        f"{editor.stats['bvh_refits']} refits / "
        f"{editor.stats['bvh_rebuilds']} rebuilds)"
    )
    print(f"wrote {args.out}/frame_*.png")
    return saved.result(ms_per_frame=timer.times, build_ms=build_ms,
                        triangles=scene.geometry.num_triangles, stats=dict(editor.stats))


if __name__ == "__main__":
    main()

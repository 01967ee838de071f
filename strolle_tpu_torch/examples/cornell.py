"""Cornell box with an orbiting point light (port of examples/cornell.py).

The Cornell scene, sun disabled, one point light orbiting on a circle.
Renders with the realtime ReSTIR model by default; --mode reference
uses the path-traced accumulator instead.

Run: python -m strolle_tpu_torch.examples.cornell [--frames 64] [--mode image] [--cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._common import FrameTimer, Saved, device_of, frame_done, parse_args, should_save


def main(argv=None) -> dict:
    args = parse_args("cornell", frames=64, width=512, height=512, argv=argv)
    device = device_of(args.cpu)

    from ..bvh import scene_with_bvh
    from ..scene.cornell import cornell_box, cornell_camera

    scene = scene_with_bvh(cornell_box(device=device))
    camera = cornell_camera(args.width, args.height, device=device)

    def light_pos(frame: int) -> torch.Tensor:
        # the light orbits around the box center
        a = frame * 0.05
        return torch.tensor([0.6 * np.cos(a), 1.7, 0.6 * np.sin(a)], dtype=torch.float32,
                            device=camera.device)

    timer = FrameTimer()
    saved = Saved(args.out)

    if args.mode == "reference":
        from ..models.reference import init_accumulator, render_reference

        acc = init_accumulator(camera)
        for f in range(args.frames):
            img, acc = render_reference(scene, camera, acc, f, depth=4, include_sky=False)
            frame_done(img)
            timer.lap()
            if should_save(f, args.frames, args.save_every):
                saved.save(f"frame_{f:04d}.png", img)
    else:
        from ..models.restir import RenderConfig, init_state, render_frame

        config = RenderConfig(denoise=not args.no_denoise)
        state = init_state(camera, device=camera.device)
        for f in range(args.frames):
            pos = scene.lights.pos.clone()
            prev = scene.lights.prev_pos.clone()
            pos[0], prev[0] = light_pos(f), light_pos(f - 1)
            frame_scene = scene.replace(
                lights=dataclasses.replace(scene.lights, pos=pos, prev_pos=prev))
            channels, state = render_frame(frame_scene, camera, state, f, config)
            img = channels[args.mode]
            frame_done(img)
            timer.lap()
            if should_save(f, args.frames, args.save_every):
                saved.save(f"frame_{f:04d}.png", img)

    print(timer.report())
    print(f"wrote {args.out}/frame_*.png")
    return saved.result(ms_per_frame=timer.times)


if __name__ == "__main__":
    main()

"""The dungeon demo scene (port of examples/demo.py).

The glb dungeon level with its point lights, rendered through the
realtime ReSTIR pipeline at 640x480. --mode switches the output channel.

Run: python -m strolle_tpu_torch.examples.demo [--frames 48] [--mode gi_diffuse] [--cpu]
"""

from __future__ import annotations

from ._common import FrameTimer, Saved, device_of, frame_done, parse_args, should_save


def main(argv=None) -> dict:
    args = parse_args("demo", frames=48, width=640, height=480, argv=argv)
    device = device_of(args.cpu)

    from ..bvh import scene_with_bvh
    from ..scene.demo import dungeon, dungeon_camera

    scene = scene_with_bvh(dungeon(device=device))
    camera = dungeon_camera(args.width, args.height, device=device)

    timer = FrameTimer()
    saved = Saved(args.out)

    if args.mode == "reference":
        from ..models.reference import init_accumulator, render_reference

        acc = init_accumulator(camera)
        for f in range(args.frames):
            img, acc = render_reference(scene, camera, acc, f, depth=3)
            frame_done(img)
            timer.lap()
            if should_save(f, args.frames, args.save_every):
                saved.save(f"frame_{f:04d}.png", img)
    else:
        from ..models.restir import RenderConfig, init_state, render_frame

        config = RenderConfig(denoise=not args.no_denoise)
        state = init_state(camera, device=camera.device)
        for f in range(args.frames):
            channels, state = render_frame(scene, camera, state, f, config)
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

"""Interactive viewer: the live render loop and the browser UI (port of
examples/viewer.py).

Run:  python -m strolle_tpu_torch.examples.viewer [--scene cornell|dungeon] [--port 8000]
then open http://127.0.0.1:8000/ (keys 0-8 switch channels, drag to
orbit, wheel to dolly; sliders drive the sun and the light intensity).
With --frames N it stops after N frames: it then fetches /frame.jpg from
its own server once, writes it under --out and returns (a headless run;
--port 0 takes a free port).
"""

from __future__ import annotations

import argparse
import os
import urllib.request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="strolle_tpu_torch interactive viewer")
    ap.add_argument("--scene", choices=["cornell", "dungeon"], default="cornell")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--mode", default="image")
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run forever)")
    ap.add_argument("--out", default=os.path.join("out", "viewer"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    import numpy as np

    from ..bvh import scene_with_bvh
    from ..viewer import Viewer

    if args.scene == "cornell":
        from ..scene.cornell import cornell_box, cornell_camera

        scene = scene_with_bvh(cornell_box(device=device))
        camera = cornell_camera(args.width, args.height, device=device)
        target, fov = (0.0, 1.0, 0.0), np.deg2rad(45.0)
        include_sky = False
    else:
        from ..scene.demo import dungeon, dungeon_camera

        scene = scene_with_bvh(dungeon(device=device))
        camera = dungeon_camera(args.width, args.height, device=device)
        target, fov = (0.0, 0.8, 0.0), np.deg2rad(55.0)
        include_sky = True

    viewer = Viewer(
        scene, camera, mode=args.mode, target=target, fov_y=fov,
        include_sky=include_sky,
    )
    port = viewer.start_server(host=args.host, port=args.port)
    print(f"viewer: http://{args.host}:{port}/  (Ctrl-C to stop)", flush=True)
    result = {"port": port}
    try:
        viewer.run(max_frames=args.frames)
        if args.frames is not None:
            with urllib.request.urlopen(f"http://{args.host}:{port}/frame.jpg", timeout=30) as r:
                jpg = r.read()
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, "frame.jpg")
            with open(path, "wb") as f:
                f.write(jpg)
            result.update(jpg=path, jpg_bytes=len(jpg), frames=viewer.state()["frame"])
    finally:
        viewer.stop_server()
    return result


if __name__ == "__main__":
    main()

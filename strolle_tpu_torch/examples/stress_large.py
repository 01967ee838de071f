"""Large-scene stress: the whole realtime pipeline on a 262,144-triangle
scene through the big-scene stream kernels (port of
examples/stress_large.py).

A random architectural soup, 30 times the dungeon, with its BVH from the
native builder: 1,024 clusters, traced by kernels 5 and 6 ("stream"),
with ReSTIR DI + GI and SVGF on top.

Run: python -m strolle_tpu_torch.examples.stress_large [--tris 262144] [--frames 16] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from ._common import FrameTimer, Saved, device_of, frame_done


def soup(n: int):
    """The example's triangle soup: boxes' worth of small triangles
    scattered over a 40 x 40 city block (seeded), with face normals."""
    import numpy as np

    rs = np.random.RandomState(3)
    centers = rs.uniform([-20, 0, -20], [20, 8, 20], (n, 1, 3))
    verts = (centers + rs.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return verts, nrm


def scene_and_camera(n: int, width: int, height: int, device):
    """The soup of ``n`` triangles as a Scene in BVH order (the native
    builder's BVH and its clusters), two lights, no sky, and the example's
    camera: (scene, camera, BVH build seconds)."""
    import numpy as np
    import torch

    from ..bvh import build_clusters
    from ..bvh.builder import build_bvh
    from ..camera import make_camera
    from ..scene.types import (Geometry, Scene, compute_static_flags, make_lights,
                               make_materials)

    verts, nrm = soup(n)
    t0 = time.perf_counter()
    arrays, order = build_bvh(verts, device)
    bvh_s = time.perf_counter() - t0

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    geom = Geometry(
        positions=t(verts[order]),
        normals=t(np.repeat(nrm[:, None, :], 3, axis=1)[order]),
        uvs=t(np.zeros((n, 3, 2), np.float32)),
        tangents=t(np.zeros((n, 3, 4), np.float32)),
        material_id=t((np.arange(n) % 3)[order], torch.int32),
    )
    materials = make_materials(
        [
            {"base_color": [0.8, 0.8, 0.8, 1]},
            {"base_color": [0.8, 0.3, 0.2, 1]},
            {"base_color": [0.2, 0.5, 0.8, 1]},
        ],
        device=device,
    )
    scene = Scene(
        geometry=geom,
        materials=materials,
        lights=make_lights(
            [
                {"pos": [0, 30, 0], "color": [900, 900, 900], "radius": 2.0},
                {"pos": [15, 12, 15], "color": [400, 350, 250], "radius": 1.0},
            ],
            device=device,
        ),
        atlas=None,
        sun_azimuth=0.0,
        sun_altitude=-1.0,
        bvh=arrays,
        **compute_static_flags(geom, materials),
    )
    scene = scene.replace(clusters=build_clusters(scene))
    camera = make_camera(eye=[28, 14, 28], target=[0, 2, 0], width=width, height=height,
                         device=device)
    return scene, camera, bvh_s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="strolle_tpu_torch example: stress_large")
    ap.add_argument("--tris", type=int, default=262144)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--out", default=os.path.join("out", "stress_large"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)

    from ..device import resolve_device
    from ..models.restir import RenderConfig, init_state, render_frame
    from ..ops import trace

    dev = resolve_device(device)
    n = args.tris
    scene, camera, bvh_s = scene_and_camera(n, args.width, args.height, dev)

    stream = trace.is_big(scene) and trace.BIG_SCENE_STRATEGY == "stream"
    clusters = 0 if scene.clusters is None else scene.clusters.shape[0]
    print(f"{n} triangles, {clusters} clusters, BVH built in {bvh_s:.2f} s; "
          f"stream kernels engaged: {stream}", flush=True)
    state = init_state(camera, device=dev)
    cfg = RenderConfig()
    timer = FrameTimer()
    saved = Saved(args.out)
    for f in range(args.frames):
        ch, state = render_frame(scene, camera, state, f, cfg)
        frame_done(ch["image"])
        timer.lap()
        if (f + 1) % 8 == 0 or f == args.frames - 1:
            saved.save(f"frame_{f:04d}.png", ch["image"])
    print(timer.report(), flush=True)
    return saved.result(ms_per_frame=timer.times, triangles=n, clusters=clusters,
                        bvh_build_s=bvh_s, stream=stream, scene=scene, camera=camera)


if __name__ == "__main__":
    main()

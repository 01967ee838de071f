"""The port's entry points: the main path's call and a multi-rank dry run
(counterpart of the repository's ``__graft_entry__.py``).

    python -m strolle_tpu_torch.entry 4 --cpu     # dryrun_multichip(4) on 4 gloo ranks
    torchrun --nproc_per_node=N -m strolle_tpu_torch.entry N   # N ranks, one card each
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def entry(device=None):
    """(fn, args): the main path, one reference sample of the Cornell box
    at 256x256, depth 3, no sky (``trace_sample``, the megakernel)."""
    from .models.reference import trace_sample
    from .scene.cornell import cornell_box, cornell_camera

    scene = cornell_box(device=device)
    camera = cornell_camera(256, 256, device=device)

    def fn(scene, camera, seed):
        return trace_sample(scene, camera, seed, depth=3, include_sky=False)

    return fn, (scene, camera, 1)


def _dryrun(mesh, device) -> str:
    """One training step with the rows split over ``mesh`` and one realtime
    frame with its rows split (each rank holding its block of the state),
    at the JAX dry run's shapes; both results must be finite, and the
    frame's gathered image whole."""
    from .bvh import scene_with_bvh
    from .models.restir import RenderConfig
    from .models.train import FIELDS, params_from_scene, train_step_sharded
    from .parallel.frame_sharding import (gather_frame, init_state_sharded,
                                          render_frame_sharded, replicate_scene)
    from .scene.cornell import cornell_box, cornell_camera

    n = mesh.size()
    scene = cornell_box(device=device)
    camera = cornell_camera(16, 2 * n, device=device)
    params = params_from_scene(scene)
    target = torch.zeros((camera.height, camera.width, 3), device=camera.device)
    loss, _, grads = train_step_sharded(mesh, params, scene, camera, target, 7, depth=1)
    gnorm = math.sqrt(sum(float((getattr(grads, f) ** 2).sum()) for f in FIELDS))
    if not (math.isfinite(float(loss)) and math.isfinite(gnorm)):
        raise RuntimeError(f"dryrun: loss {float(loss)} or gradient norm {gnorm} not finite")

    rt_cam = cornell_camera(16, 8 * n, device=device)
    rt_scene = replicate_scene(mesh, scene_with_bvh(cornell_box(device=device)))
    state = init_state_sharded(mesh, rt_cam)
    channels, _ = render_frame_sharded(mesh, rt_scene, rt_cam, state, 1, RenderConfig())
    image = gather_frame(channels)["image"]
    if image.shape != (rt_cam.height, rt_cam.width, 3) or not bool(torch.isfinite(image).all()):
        raise RuntimeError(f"dryrun: the realtime frame {tuple(image.shape)} is not whole and "
                           "finite")
    return (f"dryrun_multichip({n}): loss={float(loss):.6f} grad_norm={gnorm:.6f} "
            "realtime_frame_sharded=ok ok")


def dryrun_multichip(n: int, device=None, timeout: float = 300.0) -> None:
    """Runs ``train_step_sharded`` and one ``render_frame_sharded`` on the
    Cornell box over ``n`` ranks and checks that both are finite. With
    ``device="cpu"``, ``n > 1`` and no process group, it starts ``n``
    gloo ranks as subprocesses (each killed after ``timeout`` seconds);
    otherwise it runs on this process's group, which must have ``n``
    ranks (``torchrun`` starts them on the card)."""
    import torch.distributed as dist

    from .device import resolve_device
    from .parallel.sharding import make_mesh

    dev = resolve_device(device)
    if dev.type == "cpu" and n > 1 and not dist.is_initialized():
        _spawn_cpu_ranks(n, timeout)
        return
    line = _dryrun(make_mesh(n, device=dev), dev)
    if dist.get_rank() == 0:
        print(line, flush=True)


def _spawn_cpu_ranks(n: int, timeout: float) -> None:
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as store:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "strolle_tpu_torch.entry", str(n), "--cpu",
             "--rank", str(r), "--store", os.path.join(store, "store")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} failed (rc {p.returncode}):\n{err[-3000:]}")
    print(outs[0][0].strip(), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="strolle_tpu_torch multi-rank dry run")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: torchrun's WORLD_SIZE, else 1)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    n = args.n or int(os.environ.get("WORLD_SIZE", 1))
    if args.rank is not None:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(args.store, n), rank=args.rank,
                                world_size=n)
        try:
            dryrun_multichip(n, device)
        finally:
            dist.destroy_process_group()
        return
    from .parallel.distributed import initialize

    initialize(device=device)
    dryrun_multichip(n, device)


if __name__ == "__main__":
    main()

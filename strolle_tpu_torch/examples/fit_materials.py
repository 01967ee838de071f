"""Differentiable rendering demo: recover the Cornell wall albedos (port
of examples/fit_materials.py).

Renders a ground-truth Cornell image, perturbs the wall colours and the
light intensity, and descends the photometric loss back toward the truth
with Adam (``torch.optim.Adam``: optax.adam's betas and eps, eps outside
the square root in both). Only the albedos and the light colour are fit:
the position, light-position and emissive gradients are zeroed.

Run: python -m strolle_tpu_torch.examples.fit_materials [--steps 60] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ._common import Saved, device_of, frame_done


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="strolle_tpu_torch example: fit_materials")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default=os.path.join("out", "fit_materials"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)

    from ..bvh import scene_with_bvh
    from ..models.reference import init_accumulator, render_reference
    from ..models.train import FIELDS, TrainableParams, apply_params, params_from_scene, render_loss
    from ..scene.cornell import cornell_box, cornell_camera

    scene = scene_with_bvh(cornell_box(device=device))
    camera = cornell_camera(args.size, args.size, device=device)
    saved = Saved(args.out)

    # ground truth: a converged-ish reference render
    acc = init_accumulator(camera)
    for s in range(24):
        target, acc = render_reference(scene, camera, acc, s, depth=3, include_sky=False)
    saved.save("target.png", target)

    # perturb: wrong wall colours, wrong light intensity
    truth = params_from_scene(scene)
    base = truth.base_color.clone()
    base[1, :3] = torch.tensor([0.3, 0.3, 0.5])
    base[2, :3] = torch.tensor([0.5, 0.2, 0.4])
    params = truth.replace(base_color=base, light_color=truth.light_color * 0.4)
    leaves = [getattr(params, f).detach().clone().requires_grad_() for f in FIELDS]
    params = TrainableParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    def wall_err(i: int) -> float:
        return float((params.base_color[i, :3].detach() - truth.base_color[i, :3]).abs().max())

    err_red, err_green, losses, step_ms = [wall_err(1)], [wall_err(2)], [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = render_loss(params, scene, camera, target, 100 + i)
        loss.backward()
        # this demo fits albedos + light colour only; zero the rest so that
        # noisy 1-spp gradients do not walk the geometry around
        for p, f in zip(leaves, FIELDS):
            if f in ("positions", "light_pos", "emissive") or p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        frame_done(leaves[0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        err_red.append(wall_err(1))
        err_green.append(wall_err(2))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.5f}  "
                  f"wall-color err red {err_red[-1]:.3f} green {err_green[-1]:.3f}")

    with torch.no_grad():
        fitted = apply_params(scene, TrainableParams(*(x.detach() for x in leaves)))
        acc = init_accumulator(camera)
        for s in range(24):
            img, acc = render_reference(fitted, camera, acc, s, depth=3, include_sky=False)
    saved.save("fitted.png", img)
    print(f"wrote {args.out}/{{target,fitted}}.png")
    return saved.result(losses=losses, err_red=err_red, err_green=err_green, ms_per_step=step_ms)


if __name__ == "__main__":
    main()

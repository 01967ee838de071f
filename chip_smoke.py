"""Smoke test of strolle_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the root of the repository:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   strolle_tpu_torch/csrc with one nvcc command.
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes: kernels A and B (brute closest hit / any hit)
   on 800x608 Cornell primary rays and on seeded random rays, kernel C
   (the reference-mode megakernel) in all four (flat, no_metal) variants.
3. Drives the main path with every launch count set to 0: trace_sample
   on Cornell at 800x608 depth 4 and at 256x256 depth 3 (megakernel),
   render_reference for 8 frames, and the staged loop (kernels A and B),
   held against the megakernel; then reads the counts.
4. Times each kernel and its plain version with CUDA events, and the
   main path in ms/frame and Mrays/s.

Prints a "kernels" JSON line and, last, {"ok": true, "device": ...}.
Any failed check raises: the script then exits non-zero and prints no
result. It exits non-zero without a CUDA device, or when the package is
not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, DEPTH = 800, 608, 4  # the repo's headline configuration
ENTRY_SIZE, ENTRY_DEPTH = 256, 3  # the call of __graft_entry__.entry()
FRAMES = 8
SEED = 7
DEVICE = "cuda"

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: fp32 operations of one ray-triangle test as compiled (an fma counts
#: 2): Möller-Trumbore 46, Baldwin-Weber 31. Shading of one ray-bounce
#: in the megakernel, counted from csrc/ref_megakernel.cu with each
#: sqrt/sin/cos/rsqrt/div as 1: ~190 without the metal lobe, ~420 with.
FLOPS_MT, FLOPS_BW = 46, 31
FLOPS_SHADE = {False: 420, True: 190}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_frames(fn, frames: int = 5) -> dict | None:
    """Device busy time per frame from a torch.profiler trace of
    ``frames`` calls, beside their CUDA-event wall time; the kernels
    that took the most device time. None when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            fn()
        end.record()
        end.synchronize()
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    if not by_name:
        return None
    wall_ms = start.elapsed_time(end) / frames
    busy_ms = sum(by_name.values()) / 1e3 / frames
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ops_per_frame": n_kernels / frames,
        "top_device_ms": {k[:60]: v / 1e3 / frames for k, v in top},
    }


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_rays(n: int, device, seed: int):
    """Seeded rays from inside the box in uniform random directions (the
    incoherent bounce rays of the path tracer)."""
    rs = np.random.RandomState(seed)
    o = np.stack(
        [rs.uniform(-0.95, 0.95, n), rs.uniform(0.05, 1.95, n), rs.uniform(-0.95, 0.95, n)],
        axis=-1,
    ).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rs.uniform(0.05, 3.0, n).astype(np.float32)
    return (
        torch.tensor(o, device=device),
        torch.tensor(d, device=device),
        torch.tensor(t_max, device=device),
    )


def perturbed(scene, seed: int = 4):
    """Cornell with jittered unit vertex normals: the flat=False variant."""
    from strolle_tpu_torch.scene.types import compute_static_flags

    g = scene.geometry
    rs = np.random.RandomState(seed)
    n = g.normals.cpu().numpy() + rs.normal(0.0, 0.08, g.normals.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    geom = dataclasses.replace(g, normals=torch.tensor(n, device=g.positions.device))
    return scene.replace(geometry=geom, **compute_static_flags(geom, scene.materials))


def anyhit_tests(rows, o, d, t_max) -> int:
    """Ray-triangle tests kernel B makes: up to the first occluder."""
    from strolle_tpu_torch.ops.kernels.trace_kernels import _row_isect

    t = _row_isect(rows, o.reshape(-1, 1, 3), d.reshape(-1, 1, 3))[0]
    hits = t < t_max.reshape(-1, 1)
    first = torch.where(hits.any(-1), hits.int().argmax(-1) + 1, hits.shape[1])
    return int(first.sum())


def bounce0_shadow_rays(scene, cam, seed):
    """The staged loop's first-bounce shadow rays (kernel B's input)."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops import rng
    from strolle_tpu_torch.ops.lights import gather_light, shadow_ray_wnoise
    from strolle_tpu_torch.ops.trace import trace_surface

    grid = screen_grid(cam)
    o, d = pixel_rays(cam, grid)
    state = rng.wnoise_new(seed, grid[..., 0], grid[..., 1])
    surf = trace_surface(scene, o, d, use_pallas=False)
    state, word = rng.next_u32(state)
    light = gather_light(scene.lights, word % max(scene.lights.count, 1))
    _, sr_o, sr_d, sr_len = shadow_ray_wnoise(state, light, surf.point)
    return o, d, sr_o.contiguous(), sr_d.contiguous(), sr_len.contiguous()


def compare_trace_kernels(scene, cam, device) -> dict:
    """Kernels A and B against their plain versions; returns each one's
    max abs error (A: t/u/v where tri agrees; B: the flags as 0/1)."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk
    from strolle_tpu_torch.ops.trace import packed_tri_rows

    rows = packed_tri_rows(scene)
    po, pd = pixel_rays(cam, screen_grid(cam))
    ro, rd, rt = random_rays(cam.width * cam.height, device, seed=1)
    err = {"A": 0.0, "B": 0.0}
    for name, (o, d, t_max) in {
        "primary": (po, pd, torch.full(po.shape[:-1], 2.5, device=device)),
        "random": (ro, rd, rt),
    }.items():
        t, tri, u, v = tk.trace_closest_brute(rows, o, d)
        pt, ptri, pu, pv = tk.trace_closest_brute_plain(rows, o, d)
        torch.cuda.synchronize()
        # Same operations in the same order with the same fused
        # multiply-adds: tri must be equal and t, u, v bit-equal; allow
        # 1e-5 of rays for the plain version's float64 emulation of fma
        # (double rounding lands within 2^-29 of a float32 midpoint).
        mism = (tri != ptri).float().mean().item()
        check(mism <= 1e-5, f"kernel A ({name}): tri differs on {mism:.2e} of rays")
        same = (tri == ptri) & (tri >= 0)
        check(bool(torch.isinf(t[tri < 0]).all()), f"kernel A ({name}): miss with finite t")
        e = max((t - pt)[same].abs().max().item(), (u - pu)[same].abs().max().item(),
                (v - pv)[same].abs().max().item())
        check(e <= 1e-5, f"kernel A ({name}): t/u/v differ by {e}")
        err["A"] = max(err["A"], e)
        occ = tk.trace_anyhit_brute(rows, o, d, t_max)
        pocc = tk.trace_anyhit_brute_plain(rows, o, d, t_max)
        mism = (occ != pocc).float().mean().item()
        check(mism <= 1e-5, f"kernel B ({name}): occlusion differs on {mism:.2e} of rays")
        check(0.0 < occ.float().mean().item() < 1.0, f"kernel B ({name}): degenerate")
        err["B"] = max(err["B"], (occ != pocc).float().max().item())
        print(f"kernel A/B vs plain ({name}, {o.numel() // 3} rays): tri mismatch "
              f"{(tri != ptri).sum().item()}, t/u/v max err {e:.3g}, "
              f"occlusion mismatch {(occ != pocc).sum().item()}, hit rate "
              f"{(tri >= 0).float().mean().item():.3f}", flush=True)
    return err


def megakernel_inputs(scene, cam, seed):
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops import rng
    from strolle_tpu_torch.ops.kernels import ref_kernel as rk

    grid = screen_grid(cam)
    o, d = pixel_rays(cam, grid)
    rows = rk.pack_geometry_bw(scene.geometry)
    rows = torch.cat([rows, rows.new_zeros(((-rows.shape[0]) % 8, 24))])
    return dict(
        tri_rows=rows.contiguous(),
        mat_rows=rk.pack_materials(scene.materials).contiguous(),
        light_rows=rk.pack_lights(scene.lights).contiguous(),
        lcount=scene.lights.count,
        o=o.contiguous(), d=d.contiguous(),
        state0=rng.wnoise_new(seed, grid[..., 0], grid[..., 1]).contiguous(),
        flat=scene.flat_normals, no_metal=not scene.has_metal,
    )


def compare_megakernel(variants: dict, cam, device) -> float:
    from strolle_tpu_torch.ops.kernels import ref_kernel as rk

    worst = 0.0
    for name, scene in variants.items():
        args = megakernel_inputs(scene, cam, SEED)
        got = rk.trace_sample_megakernel(**args, depth=DEPTH)
        want = rk.trace_sample_megakernel_plain(**args, depth=DEPTH)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"kernel C ({name}): non-finite output")
        diff = (got - want).abs().amax(-1)
        # Same math without fused multiply-adds on both sides; PyTorch
        # divides by a scalar as a multiply by its reciprocal, so a few
        # last bits differ and may flip a rare edge or shadow decision
        # over 5 bounces: at most 0.1% of pixels off by more than 1e-3,
        # and the image means within 1e-4.
        frac = (diff > 1e-3).float().mean().item()
        dmean = abs(got.mean().item() - want.mean().item())
        print(f"kernel C vs plain ({name}: flat={args['flat']}, "
              f"no_metal={args['no_metal']}): max err {diff.max().item():.3g}, "
              f"pixels > 1e-3: {frac:.2e}, mean {got.mean().item():.5f} vs "
              f"{want.mean().item():.5f}", flush=True)
        check(frac <= 1e-3, f"kernel C ({name}): {frac:.2e} of pixels differ > 1e-3")
        check(dmean <= 1e-4, f"kernel C ({name}): image means differ by {dmean}")
        check(want.mean().item() > 0.05, f"kernel C ({name}): image is black")
        worst = max(worst, diff.max().item())
    return worst


def hold_against_megakernel(staged, mega, what: str) -> None:
    # Möller-Trumbore (staged) and Baldwin-Weber (megakernel) round
    # triangle edges differently; the JAX package's megakernel tolerance.
    diff = (staged - mega).abs().amax(-1)
    frac_ok = (diff <= 2e-3).float().mean().item()
    dmean = abs(staged.mean().item() - mega.mean().item())
    print(f"{what}: staged vs megakernel: {frac_ok:.5f} of pixels within 2e-3, "
          f"means differ by {dmean:.2e}", flush=True)
    check(frac_ok > 0.99, f"{what}: staged loop disagrees with the megakernel")
    check(dmean < 5e-3, f"{what}: staged mean differs from the megakernel's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from strolle_tpu_torch.camera import pixel_rays, screen_grid
        from strolle_tpu_torch.models.reference import (
            init_accumulator, render_reference, trace_sample,
        )
        from strolle_tpu_torch.ops.kernels import cuda_lib
        from strolle_tpu_torch.ops.kernels import ref_kernel as rk
        from strolle_tpu_torch.ops.kernels import trace_kernels as tk
        from strolle_tpu_torch.ops.trace import packed_tri_rows
        from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
    except ImportError as e:
        print(f"chip_smoke: strolle_tpu_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2

    device = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log = (cuda_lib.BUILD_DIR / "nvcc.log").read_text() if (
        cuda_lib.BUILD_DIR / "nvcc.log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    print(f"build: {build_s:.1f} s ({len(cuda_lib.sources())} sources, one nvcc)", flush=True)

    # --- 2. each kernel against its plain version -------------------------
    scene = cornell_box(device=device)
    metal = cornell_box(metallic_tall_box=True, device=device)
    cam = cornell_camera(WIDTH, HEIGHT, device=device)
    err = compare_trace_kernels(scene, cam, device)
    variants = {
        "cornell": scene,
        "metallic_tall_box": metal,
        "perturbed_normals": perturbed(scene),
        "perturbed_normals_metallic": perturbed(metal),
    }
    check(
        {(s.flat_normals, s.has_metal) for s in variants.values()}
        == {(True, False), (True, True), (False, False), (False, True)},
        "the four megakernel variants are not all covered",
    )
    err["C"] = compare_megakernel(variants, cam, device)

    # --- 3. the main path, counted --------------------------------------
    entry_cam = cornell_camera(ENTRY_SIZE, ENTRY_SIZE, device=device)
    cuda_lib.reset_launch_counts()
    img = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False)
    entry = trace_sample(scene, entry_cam, SEED, depth=ENTRY_DEPTH, include_sky=False)
    acc = init_accumulator(cam)
    for f in range(FRAMES):
        avg, acc = render_reference(scene, cam, acc, 100 + f, depth=DEPTH, include_sky=False)
    staged = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                          use_megakernel=False)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    for k in ("trace_sample_megakernel", "trace_closest_brute", "trace_anyhit_brute"):
        check(launches.get(k, 0) > 0, f"main path never launched {k}")
    check(launches["trace_sample_megakernel"] == 2 + FRAMES, "megakernel launch count")
    check(launches["trace_closest_brute"] == DEPTH + 1, "kernel A launch count")
    check(launches["trace_anyhit_brute"] == DEPTH + 1, "kernel B launch count")

    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(img.shape)}")
    check(tuple(entry.shape) == (ENTRY_SIZE, ENTRY_SIZE, 3), "entry image shape")
    for what, x in (("image", img), ("entry image", entry), ("accumulated", avg),
                    ("staged", staged)):
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite values")
        check(0.05 < x.mean().item() < 5.0, f"{what}: implausible mean {x.mean().item()}")
    check(bool((acc.samples == FRAMES).all()), "render_reference did not accumulate")
    hold_against_megakernel(staged, img, f"{WIDTH}x{HEIGHT} depth {DEPTH}")
    # the 8-frame average is a smoother estimate of the same image
    check(abs(avg.mean().item() - img.mean().item()) < 0.02, "accumulated mean drifted")

    # --- 4. timings -----------------------------------------------------
    rays = WIDTH * HEIGHT * (DEPTH + 1) * 2
    ms_mega = time_ms(lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False))
    ms_staged = time_ms(
        lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                             use_megakernel=False),
        warmup=1, iters=5,
    )
    ms_entry = time_ms(
        lambda: trace_sample(scene, entry_cam, SEED, depth=ENTRY_DEPTH, include_sky=False)
    )
    acc_t = init_accumulator(cam)
    ms_render = time_ms(
        lambda: render_reference(scene, cam, acc_t, 3, depth=DEPTH, include_sky=False)
    )

    # kernel C alone, default variant, at the main path's shapes
    args = megakernel_inputs(scene, cam, SEED)
    r = WIDTH * HEIGHT
    ms_c = time_ms(lambda: rk.trace_sample_megakernel(**args, depth=DEPTH))
    plain_c = time_ms(lambda: rk.trace_sample_megakernel_plain(**args, depth=DEPTH),
                      warmup=1, iters=3)
    work = {}
    rk.trace_sample_megakernel_plain(**args, depth=DEPTH, counts=work)
    flops_c = ((work["closest_tests"] + work["anyhit_tests"]) * FLOPS_BW
               + work["ray_bounces"] * FLOPS_SHADE[args["no_metal"]])
    bytes_c = (4 * (args["tri_rows"].numel() + args["mat_rows"].numel()
                    + args["light_rows"].numel()) + r * (24 + 8) + r * 12)
    bound_c, by_c = bound(flops_c, bytes_c)

    # kernels A and B alone on the staged loop's first-bounce rays
    rows = packed_tri_rows(scene)
    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    ms_a = time_ms(lambda: tk.trace_closest_brute(rows, po, pd))
    plain_a = time_ms(lambda: tk.trace_closest_brute_plain(rows, po, pd), warmup=1, iters=5)
    bound_a, by_a = bound(r * rows.shape[0] * FLOPS_MT,
                          4 * rows.numel() + r * 24 + r * 16)
    ms_b = time_ms(lambda: tk.trace_anyhit_brute(rows, so, sd, slen))
    plain_b = time_ms(lambda: tk.trace_anyhit_brute_plain(rows, so, sd, slen),
                      warmup=1, iters=5)
    bound_b, by_b = bound(anyhit_tests(rows, so, sd, slen) * FLOPS_MT,
                          4 * rows.numel() + r * 28 + r)

    timings = {
        "card": card,
        "mega_ms_per_frame": ms_mega,
        "mega_mrays_per_s": rays / (ms_mega * 1e-3) / 1e6,
        "staged_ms_per_frame": ms_staged,
        "staged_mrays_per_s": rays / (ms_staged * 1e-3) / 1e6,
        "entry_256_depth3_ms": ms_entry,
        "render_reference_ms_per_frame": ms_render,
        "rays_per_frame": rays,
        "megakernel_work": work,
        "build_s": build_s,
        "profile_mega": profile_frames(
            lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False)),
        "profile_staged": profile_frames(
            lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                                 use_megakernel=False), frames=2),
    }
    print("timings: " + json.dumps(timings), flush=True)

    kernels = [
        {
            "name": "trace_sample_megakernel", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/ref_megakernel.cu",
            "replaces": "strolle_tpu/ops/pallas/ref_kernel.py:617",
            "launches": launches["trace_sample_megakernel"],
            "max_abs_err": err["C"], "ms": ms_c, "plain_ms": plain_c,
            "bound_ms": bound_c, "bound_by": by_c, "library_ms": None,
        },
        {
            "name": "trace_closest_brute", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:280",
            "launches": launches["trace_closest_brute"],
            "max_abs_err": err["A"], "ms": ms_a, "plain_ms": plain_a,
            "bound_ms": bound_a, "bound_by": by_a, "library_ms": None,
        },
        {
            "name": "trace_anyhit_brute", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:378",
            "launches": launches["trace_anyhit_brute"],
            "max_abs_err": err["B"], "ms": ms_b, "plain_ms": plain_b,
            "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
        },
    ]
    for k in kernels:
        check(all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms")),
              f"{k['name']}: non-finite timing")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

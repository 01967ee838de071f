"""Smoke test of strolle_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the root of the repository:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   strolle_tpu_torch/csrc with one nvcc command.
2. Holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: kernels A and B (brute closest hit / any hit)
   on 800x608 Cornell primary rays and on seeded random rays, kernel C
   (the reference-mode megakernel) in all four (flat, no_metal)
   variants, kernel 4 (the fused surface trace) on primary and random
   rays of Cornell and of smooth-normal Cornell.
3. Drives the reference-mode path with every launch count set to 0:
   trace_sample on Cornell at 800x608 depth 4 and at 256x256 depth 3
   (megakernel), render_reference for 8 frames, and the staged loop
   (kernels A and B), held against the megakernel; then reads the counts.
4. Drives the realtime ReSTIR DI+GI + SVGF frame (render_frame_fused,
   RenderConfig()) on Cornell at 800x608 for three 6-frame GI cycles,
   with the counts set to 0 before and read after: kernel 4 and kernel B
   launch as the GI schedule says, kernel A never; every channel stays
   finite, and the mean image of frames 6-17 is within 10% of a
   64-sample reference-mode depth-1 image.
5. Times each kernel and its plain version with CUDA events, the
   reference-mode path in ms/frame and Mrays/s, and the realtime frame in
   ms/frame, per stage, and under the profiler.

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
#: The realtime frame: three 6-frame GI cycles; frames 6-17 are held
#: against a REF_SAMPLES-sample reference-mode depth-1 image.
RT_FRAMES = 18
RT_TIMING_CYCLES = 3
REF_SAMPLES = 64

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: fp32 operations of one ray-triangle test as compiled (an fma counts
#: 2): Möller-Trumbore 46, Baldwin-Weber 31. Shading of one ray-bounce
#: in the megakernel, counted from csrc/ref_megakernel.cu with each
#: sqrt/sin/cos/rsqrt/div as 1: ~190 without the metal lobe, ~420 with.
FLOPS_MT, FLOPS_BW = 46, 31
#: Kernel 4's resolve of a hit ray's winner, counted from
#: csrc/trace_kernels.cu with an fma as 2 and fmax/sqrt/div/compare/cvt
#: as 1: pvec 9, det 5, sign 1, barycentric w 2, normal 15, |n|^2 5,
#: fmax + sqrt + div 3, flip 4, uv 10, material id 1. A miss skips it.
FLOPS_RESOLVE = 55
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


def compare_surface_kernel(variants: dict, cam, device) -> float:
    """Kernel 4 against its plain version on primary and random rays;
    returns the max abs error of t, u, v, normal, uv on agreeing rays."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk
    from strolle_tpu_torch.ops.trace import packed_geom_rows

    po, pd = pixel_rays(cam, screen_grid(cam))
    ro, rd, _ = random_rays(cam.width * cam.height, device, seed=2)
    worst = 0.0
    for sname, scene in variants.items():
        rows = packed_geom_rows(scene)
        for rname, (o, d) in {"primary": (po, pd), "random": (ro, rd)}.items():
            got = tk.trace_surface(rows, o, d)
            want = tk.trace_surface_plain(rows, o, d)
            torch.cuda.synchronize()
            what = f"kernel 4 ({sname}, {rname})"
            # the same operations in the same order (fmaf where the plain
            # version emulates a fused multiply-add); allow 1e-5 of rays
            # for the float64 emulation's double rounding
            tri, ptri = got["tri"], want["tri"]
            mism = (tri != ptri).float().mean().item()
            check(mism <= 1e-5, f"{what}: tri differs on {mism:.2e} of rays")
            check(bool(torch.isinf(got["t"][tri < 0]).all()), f"{what}: miss with finite t")
            same = (tri == ptri) & (tri >= 0)
            check(bool((got["mat_id"][same] == want["mat_id"][same]).all()),
                  f"{what}: material ids differ")
            e = max((got[k] - want[k])[same].abs().max().item()
                    for k in ("t", "u", "v", "normal", "uv"))
            check(e <= 1e-5, f"{what}: fields differ by {e}")
            worst = max(worst, e)
            print(f"{what} vs plain ({o.numel() // 3} rays): tri mismatch "
                  f"{(tri != ptri).sum().item()}, max err {e:.3g}, hit rate "
                  f"{(tri >= 0).float().mean().item():.3f}", flush=True)
    return worst


def gi_sampling_frame(f: int) -> bool:
    """GI sampling (kernel 4's bounce rays and one kernel-B shadow ray)
    runs on frames 0, 2, 4, 5 of each 6-frame cycle; frames 1 and 3 run
    the GI spatial pass (two kernel-B reconnection rays) instead."""
    return not (f % 6 < 4 and f % 2 == 1)


def realtime_launches(frames: int) -> dict:
    """The launches the realtime frame makes over ``frames`` frames from
    frame 0: kernel 4 once for the primaries and once on GI-sampling
    frames; kernel B four times for DI (sampling, two spatial
    cross-visibility rays, resolve) and once or twice for GI."""
    sampling = sum(gi_sampling_frame(f) for f in range(frames))
    return {
        "trace_surface": frames + sampling,
        "trace_anyhit_brute": 4 * frames + sampling + 2 * (frames - sampling),
    }


def drive_realtime(scene, cam, seed0: int):
    """RT_FRAMES frames of render_frame_fused from a fresh state; checks
    every channel of every frame. Returns (mean image of frames 6 on,
    final state)."""
    from strolle_tpu_torch.models.restir import init_state, render_frame_fused

    state = init_state(cam, device=cam.device)
    acc = None
    for f in range(RT_FRAMES):
        ch, state = render_frame_fused(scene, cam, state, seed0 + f)
        for k, v in ch.items():
            check(bool(torch.isfinite(v).all()), f"realtime frame {f}: {k} not finite")
        check(tuple(ch["image"].shape) == (cam.height, cam.width, 3), "realtime image shape")
        if f >= 6:
            acc = ch["image"] if acc is None else acc + ch["image"]
    return acc / (RT_FRAMES - 6), state


def reference_depth1(scene, cam) -> torch.Tensor:
    from strolle_tpu_torch.models.reference import trace_sample

    acc = None
    for s in range(REF_SAMPLES):
        img = trace_sample(scene, cam, s, depth=1, include_sky=False)
        acc = img if acc is None else acc + img
    return acc / REF_SAMPLES


def time_realtime(scene, cam, state, seed0: int) -> tuple[float, list, object]:
    """ms/frame of render_frame_fused: the median over RT_TIMING_CYCLES
    whole cycles of (cycle time / 6), CUDA events. ``state`` starts at a
    cycle boundary."""
    from strolle_tpu_torch.models.restir import render_frame_fused

    check(state.frame % 6 == 0, "timing must start at a GI cycle boundary")
    per_frame = []
    for c in range(RT_TIMING_CYCLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in range(6):
            _, state = render_frame_fused(scene, cam, state, seed0 + 6 * c + f)
        end.record()
        end.synchronize()
        per_frame.append(start.elapsed_time(end) / 6)
    return statistics.median(per_frame), per_frame, state


def time_stages(scene, cam, state, seed0: int) -> tuple[dict, object]:
    """Per-frame ms of each stage of render_frame, averaged over one GI
    cycle: CUDA events between the stage calls of the default config."""
    from strolle_tpu_torch.models import restir as rt
    from strolle_tpu_torch.sky.atmosphere import luts_for

    cfg = rt.RenderConfig()
    luts = luts_for(scene.sun_altitude, cam.device)
    names = ("prelude", "history", "di", "gi", "denoise_pair", "compose")
    total = dict.fromkeys(names, 0.0)
    for f in range(6):
        seed = seed0 + f
        frame = state.frame
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        surf, reproj, sky, bn1, bn2 = rt._stage_prelude(
            scene, cam, state.prev_camera, state.prev_surface, frame, None)
        ev[1].record()
        di_rhs, gi_rep, rhs_surf = rt._stage_history(
            cam, reproj, state.di_prev, state.gi_prev, state.prev_surface)
        ev[2].record()
        di_diff, di_spec, di_prev = rt._stage_di(
            scene, cam, surf, state.prev_surface, reproj, state.di_prev, seed, frame, bn1,
            sky, cfg.tuning, None, (di_rhs, rhs_surf))
        ev[3].record()
        gi_diff, gi_spec, gi_prev = rt._stage_gi(
            scene, cam, surf, state.prev_surface, reproj, state.gi_prev, seed, frame, bn2,
            luts, None, cfg.tuning, (gi_rep, rhs_surf))
        ev[4].record()
        (di_rgb, di_den), (gi_rgb, gi_den) = rt._stage_denoise_pair(
            di_diff, gi_diff, surf, reproj, state.di_diff_denoiser, state.gi_diff_denoiser,
            frame, cfg.tuning)
        ev[5].record()
        rt._stage_compose(surf, di_rgb, gi_rgb, di_spec, gi_spec)
        ev[6].record()
        ev[6].synchronize()
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1]) / 6
        state = rt.RenderState(frame + 1, cam, surf, di_prev, gi_prev, di_den, gi_den)
    return total, state


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
        from strolle_tpu_torch.ops.trace import packed_geom_rows, packed_tri_rows
        from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
        from strolle_tpu_torch.sky.atmosphere import luts_for
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
    err["4"] = compare_surface_kernel(
        {"cornell": scene, "perturbed_normals": variants["perturbed_normals"]}, cam, device)

    # --- 3. the reference-mode path, counted ------------------------------
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
    print(f"reference-mode path launches: {launches}", flush=True)
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

    # --- 4. the realtime frame, counted -------------------------------------
    luts_for(scene.sun_altitude, device)  # the LUTs are made once, like the kernels
    cuda_lib.reset_launch_counts()
    rt_mean, rt_state = drive_realtime(scene, cam, 1000)
    torch.cuda.synchronize()
    rt_launches = dict(cuda_lib.LAUNCHES)
    print(f"realtime path launches ({RT_FRAMES} frames): {rt_launches}", flush=True)
    want = realtime_launches(RT_FRAMES)
    check(rt_launches.get("trace_surface", 0) == want["trace_surface"],
          f"kernel 4 launches {rt_launches.get('trace_surface')} != {want['trace_surface']}")
    check(rt_launches.get("trace_anyhit_brute", 0) == want["trace_anyhit_brute"],
          f"kernel B launches {rt_launches.get('trace_anyhit_brute')} != "
          f"{want['trace_anyhit_brute']}")
    check(rt_launches.get("trace_closest_brute", 0) == 0, "kernel A ran in the realtime frame")
    check(rt_launches.get("trace_sample_megakernel", 0) == 0, "kernel C ran in the realtime frame")
    ref1 = reference_depth1(scene, cam)
    rel = abs(rt_mean.mean().item() - ref1.mean().item()) / ref1.mean().item()
    print(f"realtime mean image (frames 6-{RT_FRAMES - 1}) {rt_mean.mean().item():.5f} vs "
          f"{REF_SAMPLES}-sample reference depth 1 {ref1.mean().item():.5f}: "
          f"relative difference {rel:.4f}", flush=True)
    check(rel < 0.10, f"realtime mean off the reference by {rel:.3f}")

    # --- 5. timings -----------------------------------------------------
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

    # kernel 4 alone on the realtime frame's primary rays
    grows = packed_geom_rows(scene)
    ms_4 = time_ms(lambda: tk.trace_surface(grows, po, pd))
    plain_4 = time_ms(lambda: tk.trace_surface_plain(grows, po, pd), warmup=1, iters=5)
    hits_4 = int((tk.trace_surface_plain(grows, po, pd)["tri"] >= 0).sum())
    # out: t, u, v, tri, normal [3], uv [2], mat_id = 40 B per ray
    bound_4, by_4 = bound(r * grows.shape[0] * FLOPS_MT + hits_4 * FLOPS_RESOLVE,
                          4 * grows.numel() + r * 24 + r * 40)

    # the realtime frame: whole cycles, per stage, under the profiler
    rt_ms, rt_cycles, rt_state = time_realtime(scene, cam, rt_state, 2000)
    rt_stages, rt_state = time_stages(scene, cam, rt_state, 3000)
    from strolle_tpu_torch.models.restir import render_frame_fused

    holder = {"state": rt_state, "seed": 4000}

    def rt_frame():
        _, holder["state"] = render_frame_fused(scene, cam, holder["state"], holder["seed"])
        holder["seed"] += 1

    rt_profile = profile_frames(rt_frame, frames=6)

    timings = {
        "card": card,
        "realtime_ms_per_frame": rt_ms,
        "realtime_cycle_ms_per_frame": rt_cycles,
        "realtime_stage_ms_per_frame": rt_stages,
        "profile_realtime": rt_profile,
        "realtime_mean_vs_reference": rel,
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
            "launches": launches["trace_anyhit_brute"] + rt_launches["trace_anyhit_brute"],
            "max_abs_err": err["B"], "ms": ms_b, "plain_ms": plain_b,
            "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
        },
    ]
    kernels.append({
        "name": "trace_surface", "route": "cuda",
        "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
        "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:328",
        "launches": rt_launches["trace_surface"],
        "max_abs_err": err["4"], "ms": ms_4, "plain_ms": plain_4,
        "bound_ms": bound_4, "bound_by": by_4, "library_ms": None,
    })
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

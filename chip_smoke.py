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
   (megakernel), render_reference for 8 frames, and the staged loop's
   gradient route (use_pallas=False: kernels A and B), held against the
   megakernel; then reads the counts. Then, counted anew, the staged
   loop's default route (use_pallas=None, as the JAX package's loop):
   kernel 4 for every surface, kernel A never, with use_megakernel=False
   and with the sky.
4. Drives the realtime ReSTIR DI+GI + SVGF frame (render_frame_fused,
   RenderConfig()) on Cornell at 800x608 for three 6-frame GI cycles,
   with the counts set to 0 before and read after: kernel 4 and kernel B
   launch as the GI schedule says, kernel A never; every channel stays
   finite, and the mean image of frames 6-17 is within 10% of a
   64-sample reference-mode depth-1 image.
5. The textured dungeon (8,393 triangles, 2048x2048 atlas) at 800x608
   with the sun at altitude 0.35 and its sky LUTs: holds kernels 5 and 6
   (the big-scene stream kernels) against their plain versions on the
   primary rays, the bounce-0 shadow rays toward the lights, rays toward
   the sun with t_max = inf and 65,536 seeded rays from inside the
   level, with their counts of box and triangle tests; drives reference
   mode (trace_sample depth 4 with the sky, render_reference for 8
   frames) and 18 realtime frames (RenderConfig(include_sky=True)), each
   with the counts set to 0 before and read after: kernels 5 and 6
   launch as the bounce loop, the GI schedule and the checkerboard
   compaction say, kernels A, B, C and 4 never; the realtime mean image
   of frames 6-17 is within 15% of a 64-sample depth-1 sky reference.
   Then holds kernels 8-11 (the cluster and BVH kernels) against their
   plain versions on the same ray sets, with their test counts, and
   kernel 10's triangles against the torch BVH traversal; drives both
   modes again under BIG_SCENE_STRATEGY "cluster" (kernels 8 and 9 only)
   and "packet" (kernels 10 and 11 only), counted the same way, with the
   same realtime check and the share of primary triangles that differ
   from the "stream" route's; times trace_closest under "packet" (the
   torch BVH traversal).
6. Times each kernel and its plain version with CUDA events, the
   reference-mode paths in ms/frame and Mrays/s, and the realtime frames
   in ms/frame, per stage, and under the profiler. A walking kernel's
   bound (5, 6, 8-11) counts the fewest box and triangle tests that any
   of the walks counted here makes on the same rays; its own walk's
   count gives walk_bound_ms beside it.

Prints a "kernels" JSON line and, last, {"ok": true, "device": ...}.
Any failed check raises: the script then exits non-zero and prints no
result. It exits non-zero without a CUDA device, or when the package is
not beside it.
"""

from __future__ import annotations

import contextlib
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
#: The dungeon: the sun altitude bench.py sets, the seeded random rays
#: of the stream kernels' comparison, and its realtime tolerance (the
#: bound the JAX package's dungeon oracles hold, tests/test_dungeon_oracle.py).
DG_SUN = 0.35
STREAM_RANDOM_RAYS = 65536
DG_RT_TOLERANCE = 0.15

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
#: A slab test of kernels 5 and 6 (csrc/stream_kernels.cu): 6 subtracts,
#: 6 multiplies, 10 min/max, 3 compares.
FLOPS_SLAB = 25
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


def dungeon_scene(device):
    """The dungeon with its BVH and clusters (the native builder, built
    here with one g++), the sun at DG_SUN, and its LUTs."""
    from strolle_tpu_torch.bvh import scene_with_bvh
    from strolle_tpu_torch.scene.demo import dungeon
    from strolle_tpu_torch.sky.atmosphere import luts_for

    scene = scene_with_bvh(dungeon(device=device)).replace(sun_altitude=DG_SUN)
    return scene, luts_for(DG_SUN, device)


def stream_ray_sets(scene, cam, device) -> dict:
    """The ray sets kernels 5 and 6 are held on: name -> (o, d, t_max)
    (t_max None: a closest-hit set only)."""
    from strolle_tpu_torch.ops.trace import trace_surface
    from strolle_tpu_torch.sky.atmosphere import sun_direction

    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    surf = trace_surface(scene, po, pd)
    sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=device)
    lo = scene.clusters[:, 0:3].amin(0).cpu().numpy()
    hi = scene.clusters[:, 3:6].amax(0).cpu().numpy()
    rs = np.random.RandomState(11)
    n = STREAM_RANDOM_RAYS
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rt = rs.uniform(0.05, 5.0, n).astype(np.float32)
    return {
        "primary": (po.contiguous(), pd.contiguous(), None),
        "lights": (so, sd, slen),
        "sun": (surf.point.contiguous(), sun.expand_as(surf.point).contiguous(),
                torch.full(po.shape[:-1], math.inf, device=device)),
        "random": tuple(torch.tensor(x, device=device) for x in (ro, rd, rt)),
    }


def stream_inputs(scene, o, d, t_max=None) -> dict:
    """The prepared inputs of one stream launch: boxes, rows, rays and the
    scene-box cap (kernel 5) or the clipped t_max (kernel 6)."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk
    from strolle_tpu_torch.ops.trace import packed_geom_rows

    clus = scene.clusters.contiguous()
    rows = packed_geom_rows(scene)
    cap = (sk.scene_tcap(clus, o, d) if t_max is None
           else sk.clipped_t_max(clus, o, d, t_max)).contiguous()
    return dict(clus=clus, subs=sk.sub_aabbs(clus, rows).contiguous(), rows=rows, o=o, d=d,
                cap=cap)


def stream_launch(x: dict, anyhit: bool, work=None):
    """One launch of kernel 5 or 6 (the counting variant when ``work`` is
    given) on prepared inputs; returns its outputs."""
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    batch = x["o"].shape[:-1]
    dev = x["o"].device
    if anyhit:
        outs = (torch.empty(batch, dtype=torch.bool, device=dev),)
        entry = "strolle_stream_trace_anyhit"
    else:
        outs = (torch.empty(batch, device=dev), torch.empty(batch, dtype=torch.int32, device=dev),
                torch.empty(batch, device=dev), torch.empty(batch, device=dev))
        entry = "strolle_stream_trace_surface"
    cuda_lib.launch_walk(entry, sk.launch_head(x["clus"], x["subs"], x["rows"]), x["o"], x["d"],
                         x["cap"], outs, work)
    return outs


def stream_plain(x: dict, anyhit: bool, work=None):
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    fn = sk.stream_trace_anyhit_plain if anyhit else sk.stream_trace_surface_plain
    out = fn(x["clus"], x["subs"], x["rows"], x["o"], x["d"], x["cap"], work)
    return (out,) if anyhit else out


def compare_stream_kernels(scene, cam, device) -> tuple[dict, dict]:
    """Kernels 5 and 6 against their plain versions on the dungeon's ray
    sets, launched through their wrappers, and their counting variants'
    box and triangle tests against the plain versions'. Returns (max abs
    error per kernel, the ray sets)."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    sets = stream_ray_sets(scene, cam, device)
    err = {"5": 0.0, "6": 0.0}
    for name, (o, d, t_max) in sets.items():
        n = o.numel() // 3
        for anyhit in ((False, True) if name in ("primary", "random") else (True,)):
            if anyhit and t_max is None:
                continue
            x = stream_inputs(scene, o, d, t_max if anyhit else None)
            if anyhit:
                got = (sk.stream_trace_anyhit(x["clus"], x["rows"], o, d, t_max),)
            else:
                g = sk.stream_trace_surface(x["clus"], x["rows"], o, d)
                got = (g["t"], torch.where(g["hit"], g["tri"], -1), g["u"], g["v"])
            want = stream_plain(x, anyhit)
            work = torch.zeros((n, 2), dtype=torch.int32, device=device)
            pwork = torch.zeros_like(work)
            stream_launch(x, anyhit, work)
            stream_plain(x, anyhit, pwork)
            torch.cuda.synchronize()
            k = "6" if anyhit else "5"
            what = f"kernel {k} ({name}, {n} rays)"
            # The same walk, slab tests and fused multiply-adds: everything
            # bit-equal; allow 1e-5 of rays for the plain version's float64
            # emulation of fma (double rounding near a float32 midpoint).
            if anyhit:
                mism = int((got[0] != want[0]).sum())
                e = float((got[0] != want[0]).float().max())
                rate = got[0].float().mean().item()
            else:
                tri, ptri = got[1], want[1]
                mism = int((tri != ptri).sum())
                same = tri == ptri
                e = max(float((a - b)[same].abs().max()) for a, b in zip(got, want)
                        if a.dtype == torch.float32)
                rate = (tri >= 0).float().mean().item()
                check(e <= 1e-5, f"{what}: t/u/v differ by {e}")
            wmism = int((work != pwork).any(-1).sum())
            print(f"{what} vs plain: mismatches {mism}, max err {e:.3g}, work mismatches "
                  f"{wmism}, box tests {int(work[:, 0].sum())}, triangle tests "
                  f"{int(work[:, 1].sum())}, {'occluded' if anyhit else 'hit'} rate {rate:.3f}",
                  flush=True)
            check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
            check(wmism <= 1e-5 * n, f"{what}: test counts differ on {wmism} rays")
            # primaries may all hit, and the sun may be hidden from every
            # visible surface of the closed level
            check(rate > 0.0 and (rate < 1.0 or name in ("primary", "sun")),
                  f"{what}: degenerate")
            err[k] = max(err[k], e)
    return err, sets


def stream_cost(x: dict, anyhit: bool) -> dict:
    """Kernel 5 or 6's walk on these inputs (the counting variant's box and
    triangle tests) and the bytes it must move (rows and boxes read once,
    rays in and results out); ``least_work_bounds`` makes the bounds."""
    n = x["o"].numel() // 3
    work = torch.zeros((n, 2), dtype=torch.int32, device=x["o"].device)
    stream_launch(x, anyhit, work)
    box, tri = (int(v) for v in work.sum(0, dtype=torch.int64))
    nbytes = (4 * (x["rows"].numel() + x["clus"].numel() + x["subs"].numel())
              + n * (24 + 4) + n * (1 if anyhit else 16))
    return {"work": {"rays": n, "box_tests": box, "triangle_tests": tri}, "bytes": nbytes}


def walk_ops(work: dict) -> int:
    """fp32 operations of a walk's box and triangle tests."""
    return work["box_tests"] * FLOPS_SLAB + work["triangle_tests"] * FLOPS_MT


def least_work_bounds(costs: dict) -> None:
    """Sets each walking kernel's bound_ms from the work its function
    needs on its rays: the fewest box and triangle test operations of the
    walks counted here on the same rays (closest hit: kernels 5, 8, 10 on
    the primaries; any hit: 6, 9, 11 on the light shadow rays), plus the
    resolve of each hit ray for 8 and 10, against the kernel's own bytes.
    walk_bound_ms is the same with the kernel's own walk's tests, which
    is no bound of the function: another walk needs fewer."""
    for group in (("5", "8", "10"), ("6", "9", "11")):
        rays = {costs[k]["work"]["rays"] for k in group}
        check(len(rays) == 1, f"kernels {group} counted on different ray sets")
        least = min(walk_ops(costs[k]["work"]) for k in group)
        for k in group:
            c = costs[k]
            resolve = c["work"].get("hits", 0) * FLOPS_RESOLVE
            c["bound_ms"], c["bound_by"] = bound(least + resolve, c["bytes"])
            c["walk_bound_ms"] = bound(walk_ops(c["work"]) + resolve, c["bytes"])[0]


#: Kernels 8-11: (name, module, closest-hit or any-hit, the JAX kernel it
#: replaces, the big-scene strategy that takes it).
WALK_KERNELS = {
    "8": ("cluster_trace_surface", "cluster", False, "cluster_kernels.py:378", "cluster"),
    "9": ("cluster_trace_anyhit", "cluster", True, "cluster_kernels.py:427", "cluster"),
    "10": ("bvh_trace_surface", "bvh", False, "bvh_kernels.py:354", "packet"),
    "11": ("bvh_trace_anyhit", "bvh", True, "bvh_kernels.py:408", "packet"),
}


def walk_inputs(scene, key: str, o, d, t_max=None) -> dict:
    """The prepared inputs of one launch of kernel 8, 9, 10 or 11: the
    cluster rows or the packed nodes, the rows, the rays and t_max (any
    hit)."""
    from strolle_tpu_torch.ops.trace import packed_geom_rows

    _, mod, anyhit, _, _ = WALK_KERNELS[key]
    rows = packed_geom_rows(scene)
    table = scene.clusters.contiguous() if mod == "cluster" else scene.bvh.node_rows
    tm = None if not anyhit else torch.broadcast_to(t_max, o.shape[:-1]).contiguous()
    return dict(key=key, table=table, rows=rows, o=o, d=d, t_max=tm)


def walk_launch(x: dict, work=None):
    """One launch of kernel 8, 9, 10 or 11 (the counting variant when
    ``work`` is given) on prepared inputs, past the wrapper and its launch
    count; returns its outputs."""
    from strolle_tpu_torch.ops.kernels import cluster_kernels as ck
    from strolle_tpu_torch.ops.kernels import cuda_lib

    name, mod, anyhit, _, _ = WALK_KERNELS[x["key"]]
    batch = x["o"].shape[:-1]
    if anyhit:
        outs = (torch.empty(batch, dtype=torch.bool, device=x["o"].device),)
    else:
        outs = cuda_lib.surface_outputs(batch, x["o"].device)
    head = (ck.launch_head(x["table"], x["rows"]) if mod == "cluster"
            else (x["table"], x["rows"]))
    cuda_lib.launch_walk("strolle_" + name, head, x["o"], x["d"], x["t_max"], outs, work)
    return outs


def walk_module(key: str):
    """The module of kernel 8, 9, 10 or 11 (its wrapper and plain version)."""
    from strolle_tpu_torch.ops.kernels import bvh_kernels, cluster_kernels

    return cluster_kernels if WALK_KERNELS[key][1] == "cluster" else bvh_kernels


def walk_plain(x: dict, work=None):
    """The plain version of kernel 8, 9, 10 or 11 on the same inputs, its
    outputs in the order ``walk_launch`` returns them."""
    name, _, anyhit, _, _ = WALK_KERNELS[x["key"]]
    fn = getattr(walk_module(x["key"]), name + "_plain")
    if anyhit:
        return (fn(x["table"], x["rows"], x["o"], x["d"], x["t_max"], work),)
    t, tri, _, _, normal, uv, mat = fn(x["table"], x["rows"], x["o"], x["d"], work)
    return t, tri, normal, uv, mat


def compare_walk_kernels(scene, sets: dict, device) -> dict:
    """Kernels 8-11 against their plain versions on the dungeon's ray sets
    (the ones kernels 5 and 6 are held on), launched through their
    wrappers, and their counting variants' box and triangle tests against
    the plain versions'; kernel 10's tri against the torch BVH traversal
    on the primaries. Returns the max abs error per kernel."""
    from strolle_tpu_torch.bvh.traverse import trace_closest_bvh

    err = {}
    for name, (o, d, t_max) in sets.items():
        n = o.numel() // 3
        for key, (kname, _, anyhit, _, _) in WALK_KERNELS.items():
            if (anyhit and t_max is None) or (not anyhit and name not in ("primary", "random")):
                continue
            x = walk_inputs(scene, key, o, d, t_max)
            wrapper = getattr(walk_module(key), kname)
            if anyhit:
                got = (wrapper(x["table"], x["rows"], o, d, t_max),)
            else:
                g = wrapper(x["table"], x["rows"], o, d)
                got = (g["t"], g["tri"], g["normal"], g["uv"], g["mat_id"])
            work = torch.zeros((n, 2), dtype=torch.int32, device=device)
            pwork = torch.zeros_like(work)
            walk_launch(x, work)
            want = walk_plain(x, pwork)
            torch.cuda.synchronize()
            what = f"kernel {key} ({name}, {n} rays)"
            # The same walk, slab tests, fused multiply-adds and resolve:
            # every output bit-equal, normals included (a correctly rounded
            # sqrt and divide on both sides); allow 1e-5 of rays for the
            # plain version's float64 emulation of fma (double rounding
            # near a float32 midpoint).
            differ = torch.zeros(n, dtype=torch.bool, device=device)
            for a, b in zip(got, want):
                differ |= (a != b).reshape(n, -1).any(-1)
            if anyhit:
                e = float(differ.float().max())
                rate = got[0].float().mean().item()
            else:
                agree = got[1] == want[1]
                e = max(float((a - b)[agree].abs().nan_to_num(0.0).max())
                        for a, b in zip(got, want) if a.is_floating_point())
                rate = (got[1] >= 0).float().mean().item()
            mism = int(differ.sum())
            wmism = int((work != pwork).any(-1).sum())
            print(f"{what} vs plain: rays differing {mism}, max err {e:.3g}, work mismatches "
                  f"{wmism}, box tests {int(work[:, 0].sum())}, triangle tests "
                  f"{int(work[:, 1].sum())}, {'occluded' if anyhit else 'hit'} rate {rate:.3f}",
                  flush=True)
            check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
            check(wmism <= 1e-5 * n, f"{what}: test counts differ on {wmism} rays")
            check(anyhit or e <= 1e-5, f"{what}: fields differ by {e}")
            check(rate > 0.0 and (rate < 1.0 or name in ("primary", "sun")),
                  f"{what}: degenerate")
            if key == "10" and name == "primary":
                tri_bvh = trace_closest_bvh(scene, o, d).tri
                flips = int((tri_bvh != got[1]).sum())
                print(f"kernel 10 vs the torch BVH traversal on the primaries: tri differs on "
                      f"{flips} rays", flush=True)
                check(flips <= 1e-5 * n, f"kernel 10: tri differs from the traversal on {flips}")
            err[key] = max(err.get(key, 0.0), e)
    return err


def walk_cost(x: dict) -> dict:
    """Kernel 8, 9, 10 or 11's walk on these inputs (the counting
    variant's box and triangle tests, and its hit rays, each resolved
    once) and the bytes it must move (the table and rows read once, rays
    in and results out); ``least_work_bounds`` makes the bounds."""
    anyhit = x["t_max"] is not None
    n = x["o"].numel() // 3
    work = torch.zeros((n, 2), dtype=torch.int32, device=x["o"].device)
    outs = walk_launch(x, work)
    box, tri = (int(v) for v in work.sum(0, dtype=torch.int64))
    hits = 0 if anyhit else int((outs[1] >= 0).sum())
    # out: t, tri, normal [3], uv [2], mat_id = 32 B per ray; or the flag
    nbytes = (4 * (x["rows"].numel() + x["table"].numel()) + n * (24 + (4 if anyhit else 0))
              + n * (1 if anyhit else 32))
    return {"work": {"rays": n, "box_tests": box, "triangle_tests": tri, "hits": hits},
            "bytes": nbytes}


def gi_sampling_frame(f: int) -> bool:
    """GI sampling (kernel 4's bounce rays and one kernel-B shadow ray)
    runs on frames 0, 2, 4, 5 of each 6-frame cycle; frames 1 and 3 run
    the GI spatial pass (two kernel-B reconnection rays) instead."""
    return not (f % 6 < 4 and f % 2 == 1)


def realtime_launches(frames: int, big: tuple | None = None) -> dict:
    """The launches the realtime frame makes over ``frames`` frames from
    frame 0. Cornell: kernel 4 once for the primaries and once on
    GI-sampling frames; kernel B four times for DI (sampling, two spatial
    cross-visibility rays, resolve) and once or twice for GI. A big scene
    (the dungeon) takes the strategy's kernels ``big`` = (closest hit,
    any hit) instead, with the checkerboard compaction: the closest hit as
    kernel 4; the any hit four times a frame (DI's two spatial rays and GI
    spatial's two go as one paired launch)."""
    sampling = sum(gi_sampling_frame(f) for f in range(frames))
    if big:
        return {big[0]: frames + sampling, big[1]: 4 * frames}
    return {
        "trace_surface": frames + sampling,
        "trace_anyhit_brute": 4 * frames + sampling + 2 * (frames - sampling),
    }


@contextlib.contextmanager
def strategy(name: str):
    """Runs the block under BIG_SCENE_STRATEGY = ``name``; restores the
    previous strategy after it, also when a check fails."""
    from strolle_tpu_torch.ops import trace

    old = trace.BIG_SCENE_STRATEGY
    trace.BIG_SCENE_STRATEGY = name
    try:
        yield
    finally:
        trace.BIG_SCENE_STRATEGY = old


#: The kernels each big-scene strategy launches: (closest hit, any hit).
STRATEGY_KERNELS = {
    "stream": ("stream_trace_surface", "stream_trace_anyhit"),
    "cluster": ("cluster_trace_surface", "cluster_trace_anyhit"),
    "packet": ("bvh_trace_surface", "bvh_trace_anyhit"),
}
ALL_KERNELS = ("trace_sample_megakernel", "trace_closest_brute", "trace_anyhit_brute",
               "trace_surface") + tuple(k for ks in STRATEGY_KERNELS.values() for k in ks)


def drive_strategy(name: str, scene, cam, luts, cfg, ref1, stream_tri) -> dict:
    """Reference mode (1 trace_sample + FRAMES render_reference, depth
    DEPTH, the sky) and RT_FRAMES realtime frames of the dungeon under one
    big-scene strategy, each with the counts set to 0 before and read
    after: the strategy's two kernels launch as the bounce loop and the GI
    schedule say, no other kernel; images finite; the realtime mean of
    frames 6 on within DG_RT_TOLERANCE of ``ref1``. Then the share of
    primary rays whose tri differs from the stream route's
    (``stream_tri``). Returns the launches, the realtime state (at a GI
    cycle boundary) and the checks' numbers."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.models.reference import init_accumulator, render_reference
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.ops.trace import trace_surface

    surface, anyhit = STRATEGY_KERNELS[name]
    out = {}
    with strategy(name):
        cuda_lib.reset_launch_counts()
        img = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=True, luts=luts)
        acc = init_accumulator(cam)
        for f in range(FRAMES):
            avg, acc = render_reference(scene, cam, acc, 100 + f, depth=DEPTH, include_sky=True,
                                        luts=luts)
        torch.cuda.synchronize()
        ref_launches = dict(cuda_lib.LAUNCHES)
        print(f"dungeon reference-mode launches under {name!r}: {ref_launches}", flush=True)
        want = {surface: (DEPTH + 1) * (1 + FRAMES), anyhit: (DEPTH + 1) * (1 + FRAMES)}
        for k in ALL_KERNELS:
            check(ref_launches.get(k, 0) == want.get(k, 0),
                  f"{name}: reference mode launched {k} {ref_launches.get(k, 0)} times, "
                  f"not {want.get(k, 0)}")
        for what, x in (("image", img), ("accumulated", avg)):
            check(tuple(x.shape) == (cam.height, cam.width, 3), f"{name} {what}: shape")
            check(bool(torch.isfinite(x).all()), f"{name} {what}: non-finite values")
            check(1e-3 < x.mean().item() < 5.0, f"{name} {what}: implausible mean")

        cuda_lib.reset_launch_counts()
        rt_mean, rt_state = drive_realtime(scene, cam, 5000, cfg, luts)
        torch.cuda.synchronize()
        rt_launches = dict(cuda_lib.LAUNCHES)
        print(f"dungeon realtime launches under {name!r} ({RT_FRAMES} frames): {rt_launches}",
              flush=True)
        want = realtime_launches(RT_FRAMES, big=(surface, anyhit))
        for k in ALL_KERNELS:
            check(rt_launches.get(k, 0) == want.get(k, 0),
                  f"{name}: the realtime frame launched {k} {rt_launches.get(k, 0)} times, "
                  f"not {want.get(k, 0)}")
        rel = abs(rt_mean.mean().item() - ref1.mean().item()) / ref1.mean().item()
        o, d = pixel_rays(cam, screen_grid(cam))
        flips = (trace_surface(scene, o, d).tri != stream_tri).float().mean().item()
        print(f"dungeon under {name!r}: realtime mean image {rt_mean.mean().item():.5f} vs "
              f"the depth-1 sky reference {ref1.mean().item():.5f}: relative difference "
              f"{rel:.4f}; primary tri differs from the stream route's on {flips:.2e} of "
              "pixels", flush=True)
        check(rel < DG_RT_TOLERANCE, f"{name}: realtime mean off the reference by {rel:.3f}")
        check(flips <= 0.01, f"{name}: primary tri differs from the stream route on {flips}")
    return {"ref_launches": ref_launches, "realtime_launches": rt_launches, "state": rt_state,
            "realtime_mean_vs_reference": rel, "primary_tri_flip_share": flips}


def time_strategies(scene, cam, luts, cfg, states: dict) -> list:
    """Both dungeon modes timed under each strategy in turns (stream,
    cluster, packet, stream), in one call on one card: reference mode
    (median of 5 samples) and the realtime frame (3 GI cycles from
    ``states[name]``, advanced in place), with a profile of 2 reference
    samples and, for cluster and packet, of 2 realtime frames (after
    their timing, whose state nothing reads again)."""
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import render_frame_fused

    turns = []
    for i, name in enumerate(("stream", "cluster", "packet", "stream")):
        def ref():
            return trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=True, luts=luts)

        phase(f"6, dungeon turn {i + 1} ({name})")
        seed = [9000 + 100 * i]

        def rt_frame():
            _, states[name] = render_frame_fused(scene, cam, states[name], seed[0], cfg, luts)
            seed[0] += 1

        with strategy(name):
            turn = {"strategy": name, "ref_ms_per_frame": time_ms(ref, warmup=1, iters=5)}
            (turn["realtime_ms_per_frame"], turn["realtime_cycle_ms_per_frame"],
             states[name]) = time_realtime(scene, cam, states[name], 6000 + 18 * i, cfg, luts)
            turn["profile_ref"] = profile_frames(ref, frames=2)
            if name != "stream":
                turn["profile_realtime"] = profile_frames(rt_frame, frames=2)
        print(f"dungeon under {name!r} (turn {i + 1}): reference "
              f"{turn['ref_ms_per_frame']:.1f} ms/frame, realtime "
              f"{turn['realtime_ms_per_frame']:.1f} ms/frame (cycles "
              f"{turn['realtime_cycle_ms_per_frame']})", flush=True)
        turns.append(turn)
    return turns


def drive_realtime(scene, cam, seed0: int, config=None, luts=None):
    """RT_FRAMES frames of render_frame_fused from a fresh state; checks
    every channel of every frame. Returns (mean image of frames 6 on,
    final state)."""
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame_fused

    config = config or RenderConfig()
    state = init_state(cam, device=cam.device)
    acc = None
    for f in range(RT_FRAMES):
        ch, state = render_frame_fused(scene, cam, state, seed0 + f, config, luts)
        for k, v in ch.items():
            check(bool(torch.isfinite(v).all()), f"realtime frame {f}: {k} not finite")
        check(tuple(ch["image"].shape) == (cam.height, cam.width, 3), "realtime image shape")
        if f >= 6:
            acc = ch["image"] if acc is None else acc + ch["image"]
    return acc / (RT_FRAMES - 6), state


def reference_depth1(scene, cam, include_sky: bool = False, luts=None) -> torch.Tensor:
    from strolle_tpu_torch.models.reference import trace_sample

    acc = None
    for s in range(REF_SAMPLES):
        img = trace_sample(scene, cam, s, depth=1, include_sky=include_sky, luts=luts)
        acc = img if acc is None else acc + img
    return acc / REF_SAMPLES


def time_realtime(scene, cam, state, seed0: int, config=None,
                  luts=None) -> tuple[float, list, object]:
    """ms/frame of render_frame_fused: the median over RT_TIMING_CYCLES
    whole cycles of (cycle time / 6), CUDA events. ``state`` starts at a
    cycle boundary."""
    from strolle_tpu_torch.models.restir import RenderConfig, render_frame_fused

    config = config or RenderConfig()
    check(state.frame % 6 == 0, "timing must start at a GI cycle boundary")
    per_frame = []
    for c in range(RT_TIMING_CYCLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in range(6):
            _, state = render_frame_fused(scene, cam, state, seed0 + 6 * c + f, config, luts)
        end.record()
        end.synchronize()
        per_frame.append(start.elapsed_time(end) / 6)
    return statistics.median(per_frame), per_frame, state


def time_stages(scene, cam, state, seed0: int, cfg=None, luts=None) -> tuple[dict, object]:
    """Per-frame ms of each stage of render_frame, averaged over one GI
    cycle: CUDA events between the stage calls of ``cfg``."""
    from strolle_tpu_torch.models import restir as rt
    from strolle_tpu_torch.sky.atmosphere import luts_for

    cfg = cfg or rt.RenderConfig()
    luts = luts if luts is not None else luts_for(scene.sun_altitude, cam.device)
    names = ("prelude", "history", "di", "gi", "denoise_pair", "compose")
    total = dict.fromkeys(names, 0.0)
    for f in range(6):
        seed = seed0 + f
        frame = state.frame
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        surf, reproj, sky, bn1, bn2 = rt._stage_prelude(
            scene, cam, state.prev_camera, state.prev_surface, frame, luts, cfg.include_sky)
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


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"[{time.perf_counter() - T_START:.1f} s] phase {name}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from strolle_tpu_torch.camera import pixel_rays, screen_grid
        from strolle_tpu_torch.models.reference import (
            init_accumulator, render_reference, trace_sample,
        )
        from strolle_tpu_torch import native
        from strolle_tpu_torch.models.restir import RenderConfig, render_frame_fused
        from strolle_tpu_torch.ops.kernels import cuda_lib
        from strolle_tpu_torch.ops.kernels import ref_kernel as rk
        from strolle_tpu_torch.ops.kernels import trace_kernels as tk
        from strolle_tpu_torch.ops.trace import packed_geom_rows, packed_tri_rows
        from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
        from strolle_tpu_torch.scene.demo import dungeon_camera
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
    t0 = time.perf_counter()
    native.library()
    native_s = time.perf_counter() - t0
    print(f"build: {native_s:.1f} s (native host library, one g++)", flush=True)

    # --- 2. each kernel against its plain version -------------------------
    phase("2")
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
    phase("3")
    entry_cam = cornell_camera(ENTRY_SIZE, ENTRY_SIZE, device=device)
    cuda_lib.reset_launch_counts()
    img = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False)
    entry = trace_sample(scene, entry_cam, SEED, depth=ENTRY_DEPTH, include_sky=False)
    acc = init_accumulator(cam)
    for f in range(FRAMES):
        avg, acc = render_reference(scene, cam, acc, 100 + f, depth=DEPTH, include_sky=False)
    # the staged loop's gradient route (use_pallas=False): kernels A and B
    staged = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                          use_megakernel=False, use_pallas=False)
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

    # --- 3b. the staged loop's default route, counted ----------------------
    phase("3b")
    # use_pallas=None, as the JAX package's loop: every surface through the
    # fused route (kernel 4 on Cornell), none through kernel A; with
    # use_megakernel=False, and with the sky (which the megakernel refuses)
    cuda_lib.reset_launch_counts()
    staged_fused = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                                use_megakernel=False)
    staged_sky = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=True)
    torch.cuda.synchronize()
    fused_launches = dict(cuda_lib.LAUNCHES)
    print(f"staged loop launches, use_pallas=None (2 samples): {fused_launches}", flush=True)
    want = {"trace_surface": 2 * (DEPTH + 1), "trace_anyhit_brute": 2 * (DEPTH + 1)}
    for k in ALL_KERNELS:
        check(fused_launches.get(k, 0) == want.get(k, 0),
              f"staged loop (use_pallas=None) launched {k} {fused_launches.get(k, 0)} times, "
              f"not {want.get(k, 0)}")
    check(bool(torch.isfinite(staged_sky).all()), "staged loop with the sky: non-finite values")
    # the same hits, attributes resolved in the kernel instead of by
    # surface_at: a few last bits, which may flip a rare decision
    diff = (staged_fused - staged).abs().amax(-1)
    frac_ok = (diff <= 1e-3).float().mean().item()
    print(f"staged loop, fused route vs use_pallas=False: {frac_ok:.5f} of pixels within 1e-3, "
          f"means {staged_fused.mean().item():.5f} vs {staged.mean().item():.5f}", flush=True)
    check(frac_ok > 0.99, "staged loop: the fused route disagrees with use_pallas=False")

    # --- 4. the realtime frame, counted -------------------------------------
    phase("4")
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

    # --- 5. the dungeon: kernels 5 and 6, reference mode, the realtime frame
    phase("5")
    t0 = time.perf_counter()
    dg, dluts = dungeon_scene(device)
    dg_load_s = time.perf_counter() - t0
    dcam = dungeon_camera(WIDTH, HEIGHT, device=device)
    print(f"dungeon: {dg.geometry.num_triangles} triangles, {dg.clusters.shape[0]} clusters, "
          f"atlas {tuple(dg.atlas.image.shape)}, tex_channels {dg.materials.tex_channels}, "
          f"loaded with its BVH in {dg_load_s:.1f} s", flush=True)
    serr, ssets = compare_stream_kernels(dg, dcam, device)
    err.update(serr)

    cuda_lib.reset_launch_counts()
    dimg = trace_sample(dg, dcam, SEED, depth=DEPTH, include_sky=True, luts=dluts)
    dacc = init_accumulator(dcam)
    for f in range(FRAMES):
        davg, dacc = render_reference(dg, dcam, dacc, 100 + f, depth=DEPTH, include_sky=True,
                                      luts=dluts)
    torch.cuda.synchronize()
    dg_launches = dict(cuda_lib.LAUNCHES)
    print(f"dungeon reference-mode launches: {dg_launches}", flush=True)
    for k in ("stream_trace_surface", "stream_trace_anyhit"):
        check(dg_launches.get(k, 0) == (DEPTH + 1) * (1 + FRAMES), f"dungeon {k} launch count")
    for k in ("trace_sample_megakernel", "trace_closest_brute", "trace_anyhit_brute",
              "trace_surface"):
        check(dg_launches.get(k, 0) == 0, f"dungeon reference mode launched {k}")
    for what, x in (("dungeon image", dimg), ("dungeon accumulated", davg)):
        check(tuple(x.shape) == (HEIGHT, WIDTH, 3), f"{what}: shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{what}: non-finite values")
        check(1e-3 < x.mean().item() < 5.0, f"{what}: implausible mean {x.mean().item()}")
    check(bool((dacc.samples == FRAMES).all()), "dungeon render_reference did not accumulate")
    check(abs(davg.mean().item() - dimg.mean().item()) < 0.1 * davg.mean().item(),
          "dungeon accumulated mean drifted")

    dcfg = RenderConfig(include_sky=True)
    cuda_lib.reset_launch_counts()
    drt_mean, drt_state = drive_realtime(dg, dcam, 5000, dcfg, dluts)
    torch.cuda.synchronize()
    drt_launches = dict(cuda_lib.LAUNCHES)
    print(f"dungeon realtime launches ({RT_FRAMES} frames): {drt_launches}", flush=True)
    want = realtime_launches(RT_FRAMES, big=STRATEGY_KERNELS["stream"])
    for k, n in want.items():
        check(drt_launches.get(k, 0) == n, f"dungeon realtime {k} launches "
              f"{drt_launches.get(k, 0)} != {n}")
    for k in ("trace_sample_megakernel", "trace_closest_brute", "trace_anyhit_brute",
              "trace_surface"):
        check(drt_launches.get(k, 0) == 0, f"dungeon realtime frame launched {k}")
    dref1 = reference_depth1(dg, dcam, include_sky=True, luts=dluts)
    drel = abs(drt_mean.mean().item() - dref1.mean().item()) / dref1.mean().item()
    print(f"dungeon realtime mean image (frames 6-{RT_FRAMES - 1}) "
          f"{drt_mean.mean().item():.5f} vs {REF_SAMPLES}-sample sky reference depth 1 "
          f"{dref1.mean().item():.5f}: relative difference {drel:.4f}", flush=True)
    check(drel < DG_RT_TOLERANCE, f"dungeon realtime mean off the reference by {drel:.3f}")

    # --- 5b. kernels 8-11 against their plain versions ---------------------
    phase("5b")
    err.update(compare_walk_kernels(dg, ssets, device))

    # --- 5c. the dungeon under the cluster and packet strategies ------------
    phase("5c")
    from strolle_tpu_torch.ops.trace import trace_closest, trace_surface

    dpo, dpd = ssets["primary"][:2]
    stream_tri = trace_surface(dg, dpo, dpd).tri
    strat = {name: drive_strategy(name, dg, dcam, dluts, dcfg, dref1, stream_tri)
             for name in ("cluster", "packet")}
    # the torch BVH traversal on the card: trace_closest's route under
    # "packet" (and every strategy but "stream")
    with strategy("packet"):
        cuda_lib.reset_launch_counts()
        ms_traverse = time_ms(lambda: trace_closest(dg, dpo, dpd), warmup=1, iters=3)
        profile_traverse = profile_frames(lambda: trace_closest(dg, dpo, dpd), frames=1)
        check(not cuda_lib.LAUNCHES, f"trace_closest under 'packet' launched {cuda_lib.LAUNCHES}")
    print(f"trace_closest under 'packet' (the torch BVH traversal) on {dpo.numel() // 3} "
          f"primary rays: {ms_traverse:.1f} ms, profile {profile_traverse}", flush=True)

    # --- 6. timings -----------------------------------------------------
    phase("6")
    rays = WIDTH * HEIGHT * (DEPTH + 1) * 2
    ms_mega = time_ms(lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False))
    ms_staged = time_ms(
        lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False,
                             use_megakernel=False, use_pallas=False),
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
    holder = {"state": rt_state, "seed": 4000}

    def rt_frame():
        _, holder["state"] = render_frame_fused(scene, cam, holder["state"], holder["seed"])
        holder["seed"] += 1

    rt_profile = profile_frames(rt_frame, frames=6)

    # the dungeon: both modes under each strategy in turns, then the
    # stream route's render_reference, stages and profile; kernels 5 and 6
    states = {"stream": drt_state, **{name: r.pop("state") for name, r in strat.items()}}
    turns = time_strategies(dg, dcam, dluts, dcfg, states)
    ms_dg_ref = turns[0]["ref_ms_per_frame"]
    drt_ms, drt_cycles = turns[0]["realtime_ms_per_frame"], turns[0]["realtime_cycle_ms_per_frame"]
    drt_state = states["stream"]
    dacc_t = init_accumulator(dcam)
    ms_dg_render = time_ms(
        lambda: render_reference(dg, dcam, dacc_t, 3, depth=DEPTH, include_sky=True, luts=dluts),
        warmup=1, iters=5,
    )
    drt_stages, drt_state = time_stages(dg, dcam, drt_state, 7000, dcfg, dluts)
    dholder = {"state": drt_state, "seed": 8000}

    def drt_frame():
        _, dholder["state"] = render_frame_fused(dg, dcam, dholder["state"], dholder["seed"],
                                                 dcfg, dluts)
        dholder["seed"] += 1

    drt_profile = profile_frames(drt_frame, frames=6)
    # kernel 5 on the realtime frame's primary rays, kernel 6 on the
    # reference loop's bounce-0 shadow rays toward the lights
    x5 = stream_inputs(dg, *ssets["primary"][:2])
    x6 = stream_inputs(dg, *ssets["lights"])
    ms_5 = time_ms(lambda: stream_launch(x5, False))
    plain_5 = time_ms(lambda: stream_plain(x5, False), warmup=1, iters=3)
    ms_6 = time_ms(lambda: stream_launch(x6, True))
    plain_6 = time_ms(lambda: stream_plain(x6, True), warmup=1, iters=3)
    cost = {"5": stream_cost(x5, False), "6": stream_cost(x6, True)}

    # kernels 8 and 10 on the primary rays, 9 and 11 on the reference
    # loop's bounce-0 shadow rays toward the lights (kernels 5 and 6's sets)
    walk = {}
    for key, (_, _, anyhit, _, _) in WALK_KERNELS.items():
        x = walk_inputs(dg, key, *ssets["lights" if anyhit else "primary"])
        walk[key] = {
            "ms": time_ms(lambda: walk_launch(x)),
            "plain_ms": time_ms(lambda: walk_plain(x), warmup=1, iters=3),
        }
        cost[key] = walk_cost(x)
    least_work_bounds(cost)

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
                                 use_megakernel=False, use_pallas=False), frames=2),
        "native_build_s": native_s,
        "dungeon_load_s": dg_load_s,
        "dungeon_ref_ms_per_frame": ms_dg_ref,
        "dungeon_ref_mrays_per_s": rays / (ms_dg_ref * 1e-3) / 1e6,
        "dungeon_render_reference_ms_per_frame": ms_dg_render,
        "dungeon_realtime_ms_per_frame": drt_ms,
        "dungeon_realtime_cycle_ms_per_frame": drt_cycles,
        "dungeon_realtime_stage_ms_per_frame": drt_stages,
        "dungeon_profile_realtime": drt_profile,
        "dungeon_realtime_mean_vs_reference": drel,
        "dungeon_profile_ref": turns[0]["profile_ref"],
        "walk_costs": cost,
        "strategies": {name: {k: v for k, v in r.items() if not k.endswith("launches")}
                       for name, r in strat.items()},
        "strategy_turns": turns,
        "walk_kernels": walk,
        "traverse_packet_ms": ms_traverse,
        "traverse_packet_profile": profile_traverse,
        "total_s": time.perf_counter() - T_START,
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
        "launches": rt_launches["trace_surface"] + fused_launches["trace_surface"],
        "max_abs_err": err["4"], "ms": ms_4, "plain_ms": plain_4,
        "bound_ms": bound_4, "bound_by": by_4, "library_ms": None,
    })
    for name, key, ms, plain in (
        ("stream_trace_surface", "5", ms_5, plain_5),
        ("stream_trace_anyhit", "6", ms_6, plain_6),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "strolle_tpu_torch/csrc/stream_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/stream_kernels.py:"
                        + ("660" if key == "5" else "736"),
            "launches": dg_launches[name] + drt_launches[name],
            "max_abs_err": err[key], "ms": ms, "plain_ms": plain,
            "bound_ms": cost[key]["bound_ms"], "bound_by": cost[key]["bound_by"],
            "walk_bound_ms": cost[key]["walk_bound_ms"], "library_ms": None,
        })
    for key, (name, mod, _, replaces, strat_name) in WALK_KERNELS.items():
        r = strat[strat_name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"strolle_tpu_torch/csrc/{mod}_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/" + replaces,
            "launches": r["ref_launches"][name] + r["realtime_launches"][name],
            "max_abs_err": err[key], "ms": walk[key]["ms"], "plain_ms": walk[key]["plain_ms"],
            "bound_ms": cost[key]["bound_ms"], "bound_by": cost[key]["bound_by"],
            "walk_bound_ms": cost[key]["walk_bound_ms"],
            "library_ms": None,
        })
    check(len(kernels) == 10, "the kernels line must list the ten ported kernels")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: never launched on its main path")
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

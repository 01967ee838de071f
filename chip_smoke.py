"""Smoke test of strolle_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the root of the repository:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   strolle_tpu_torch/csrc with one nvcc command, and prints kernels A's,
   B's, 4's, C's and 8-11's instructions per ray-triangle test as
   compiled, and 10's and 11's per node visit (where the toolkit has
   cuobjdump).
2. Holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: kernels A and B (brute closest hit / any hit)
   on 800x608 Cornell primary rays and on seeded random rays, and A and
   4 on the same rays against Cornell's rows twice over (every hit a tie
   that the lower copy must win: tri equal on every ray), kernel C
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
   the sun with t_max = inf, 65,536 seeded rays from inside the level
   and the realtime frame's GI shadow rays (captured from frame 0), with
   their counts of box and triangle tests, and again under list caps
   below the dungeon's 33 clusters (the overflow path, held against its
   plain version and against the front-to-back walk's results; cap 0 is
   the index-order walk, whose tests per ray are printed beside the
   front-to-back walk's, which must test fewer triangles per primary);
   drives reference
   mode (trace_sample depth 4 with the sky, render_reference for 8
   frames) and 18 realtime frames (RenderConfig(include_sky=True)), each
   with the counts set to 0 before and read after: kernels 5 and 6
   launch as the bounce loop, the GI schedule and the checkerboard
   compaction say, kernels A, B, C and 4 never; the realtime mean image
   of frames 6-17 is within 15% of a 64-sample depth-1 sky reference.
   Then holds kernels 8-11 (the cluster and BVH kernels) against their
   plain versions on the same ray sets, with their test counts, and
   kernel 10's triangles against the torch BVH traversal; kernels 10 and
   11 also on a chain of 64 nodes that overflows their 48-id stack (the
   clamp) and on 1,000 primaries and light shadow rays (a ray count that
   is no multiple of 32 and fills less than one wave); kernels 8 and
   9 also on their overflow path (list caps 0 and 4, as 5 and 6), with
   the index-order walk's tests per ray printed beside the front-to-back
   walk's (kernel 8 must test fewer triangles per primary front to
   back), and on the dungeon's rows twice over (every hit a tie; tri
   equal to the plain version's on every ray, and kernel 8's hits all on
   the first copy); drives both
   modes again under BIG_SCENE_STRATEGY "cluster" (kernels 8 and 9 only)
   and "packet" (kernels 10 and 11 only), counted the same way, with the
   same realtime check and the share of primary triangles that differ
   from the "stream" route's (trace_closest under "packet", the torch
   BVH traversal, is timed in 6). Then kernel 7 (the fused spatial probe): holds
   its stack entry in both modes against the plain version, oy/ox/found
   and jac bit-equal, on the DI and GI spatial passes' own inputs of a
   Cornell and a dungeon realtime frame (DI on frame 0, GI on frame 1)
   and on a seeded blocky stack, at the default tuning; holds its route
   entry (the spatial passes' own launch) against its plain version on
   the four captured passes and on the seeded stacks' planes read in
   place (strided fields), rhs_x/rhs_y/found, the advanced stream and
   jac bit-equal, and block 0's tables against _draw_probe_tables; counts
   the device operations of one fused pass (probe_fused: at most 5, from
   the aten ops and kernel launches it dispatches, printed beside a
   torch.profiler trace's count);
   with STROLLE_PROBE_KERNEL=1 drives 18
   realtime frames on each scene, counted: kernel 7 once a frame in DI
   mode and on frames 1 and 3 of each GI cycle in GI mode, the other
   kernels as with the switch off, the mean image within the reference
   check and within 1% of the switch-off run on the same seeds; checks
   that DI spatial gives the tensor probe's output on frame 0's inputs;
   runs one frame under each RenderConfig switch (needs_gi=False,
   needs_di=False, denoise=False) with kernel 7's launches following
   them; renders the dungeon's BVH heatmap. Then kernels A and B above
   1024 rows: held against their plain versions over the 8,393 rows of the
   dungeon without its BVH, on the 65,536 random rays (A also on those
   rows with copies of 256 winning rows in another slice of their
   1024-row tile and in a later tile: tri equal on every ray), and
   driven by one reference sample of it at 200x152 (counted: A and B
   once a bounce), whose image must agree with the BVH route's. Then the
   differentiable path on Cornell at 800x608, counted: three train_steps
   (depth 2, kernels A and B once a bounce) and, after three
   differentiable realtime frames, restir_train_step with DI only and
   with the whole frame (A and B as the frames' schedule says); losses
   and gradients finite, base colour, emissive and light colour nonzero,
   and a base-colour and a light-colour gradient against central
   differences of the card's own loss, with ms per step and peak device
   memory. Then the alpha restart loop: Cornell with an alpha-blended
   pane across the box, its primaries through trace_closest and
   trace_anyhit (kernel A on each of the 4 restarts) against the same
   loop on CPU copies (tri and occlusion equal, t within 1e-5); the
   alpha soup of tests/test_alpha.py (1,536 triangles, its BVH) on
   486,400 seeded rays under "stream" (kernel 5 on each restart),
   "cluster" and "packet" (the torch BVH traversal) against the brute
   route with the gate raised (at least 99% agreement); one staged
   reference sample and one realtime frame of the alpha Cornell (kernel A
   only, the megakernel refused).
   Then (phase 5i) the engine: the dungeon as a SceneEditor scene (its
   triangles as one soup instance per material, its material records,
   atlas and lights, the sun at 0.35) with 16 boxes of
   examples/stress_bvh.py's falling-box motion (a mesh and its instances)
   through a Renderer in "image" mode with the sky: 18 frames with no
   edit, whose mean over frames 6-17 is within 15% of a 64-sample depth-1
   reference of the same scene, then 20 frames with the boxes moving (a
   light removed at the 4th, the sun moved at the 8th), counted (kernels
   5 and 6 as the realtime frame's schedule says, no other kernel); every
   channel finite, refits and the rebuild after 15 refits in a row, the
   kill/remap markers on exactly one frame, the velocity on the moving
   boxes' pixels against a float64 host projection of their displacement
   (median error < 0.1 px); a checkpoint of the state after frame 10
   restored, its next frame bit-equal to the live one's; kernels 5 and 6
   against their plain versions on the refitted scene. Then
   stress_bvh's floor and 48 boxes (578 triangles, padded to 1024) in a
   Viewer with its HTTP server up: the same edits through kernels 4 and
   B, one frame in each of the viewer's 9 modes (reference twice,
   through kernel C), counted, one GET of the frame, and kernels A, B and
   4 against their plain versions on that scene; ms per tick (rebuild,
   refit) and per engine frame, and one engine frame under the profiler.
   Then (phase 5j) the multi-device layer at 800x608, at world size 1
   under NCCL and counted: the split Cornell sample (kernel C) bit-equal
   to trace_sample; one GI cycle of the dungeon with the sky on the
   row-split state with STROLLE_PROBE_KERNEL=1 (kernels 5 and 6, kernel
   7 never), every channel and state leaf bit-equal to render_frame's
   (switch off) with the same launches, and one frame's dispatched
   device ops equal to the unsplit frame's; train_step_sharded (A and B)
   against train_step; dryrun_multichip(1). Then two gloo ranks in
   subprocesses sharing the card, each holding and computing its 304
   rows, counted: the sample (to tests/test_sharding.py's criteria), one
   GI cycle of Cornell (kernels 4 and B on the rank's rows) and one of
   the dungeon with the sky, whose gathered channels and state are
   bit-equal to the unsplit cycles' (SHA-256 of every tensor), and a
   training step (gradients at rtol 1e-4, atol 1e-6 against the
   same row blocks summed in one process, and within 1e-3 of each
   field's largest component against train_step); per rank ms per call
   and per frame, one profiled frame's device busy time and ops, its
   dispatched ops, and the gathers' calls, bytes and ms per frame. Then (phase
   5k) each example's main() at its default size, counted, its images
   written and finite (the viewer: 2 frames and one GET of its frame),
   and stress_large's kernels 5 and 6 (262,144 triangles, 1,024
   clusters) against their plain versions on 32 seeded image rows of
   primaries and light shadow rays, with the warps whose cluster lists
   overflow LIST_CAP counted there and over every primary.
6. Times each kernel and its plain version with CUDA events, the
   reference-mode paths in ms/frame and Mrays/s, and the realtime frames
   in ms/frame, per stage, and under the profiler; kernels A and B also
   over the BVH-less dungeon's rows, kernel 6 also on the sun and GI sets. A walking kernel's
   bound (5, 6, 8-11) counts the fewest operations of the box and
   triangle tests that any of the walks counted here makes on the same
   rays (a triangle test's second half only where its first passes, as
   for A, B and 4); its own walk's count gives walk_bound_ms beside it,
   and for 10 and 11 its SASS counts issue_floor_ms. Kernel 7 in both
   modes on the Cornell frame's inputs (its route entry, its stack entry
   and the whole fused pass), and the DI and GI stages on both scenes
   with the probe switch off, on, on, off.

Prints a "kernels" JSON line and, last, {"ok": true, "device": ...}.
Any failed check raises: the script then exits non-zero and prints no
result. It exits non-zero without a CUDA device, or when the package is
not beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

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
#: One reference sample of the dungeon without its BVH (kernels A and B
#: over all 8,393 rows) at this reduced size.
FLAT_WIDTH, FLAT_HEIGHT = 200, 152
#: Kernels 10 and 11 on a chain of DEEP_TREE_DEPTH nodes (the stack
#: clamp at bvh_kernels.MAX_STACK - 1) and on RAGGED_RAYS rays (the
#: grid's ragged end: no multiple of 32, less than one wave of the card).
DEEP_TREE_DEPTH, DEEP_TREE_RAYS = 64, 384
RAGGED_RAYS = 1000
#: The differentiable path on Cornell at WIDTH x HEIGHT: TRAIN_STEPS steps
#: of train_step at TRAIN_DEPTH against a sample at TARGET_SEED x 0.8 (as
#: tests/test_grad.py builds its target), and of restir_train_step after
#: RESTIR_WARMUP differentiable frames, each held against central
#: differences of the card's own loss (tests/test_grad.py's and
#: tests/test_grad_restir.py's steps and tolerances).
TRAIN_STEPS, TRAIN_DEPTH, TRAIN_SEED, TARGET_SEED = 3, 2, 7, 123
RESTIR_WARMUP, RESTIR_SEED = 3, 9
#: The alpha phase: Cornell with one alpha-blended pane of base alpha
#: PANE_ALPHA (every ray passes it), and tests/test_alpha.py's soup at
#: SOUP_TRIS triangles (a quarter on a blend material of alpha 0.3) under
#: each big-scene strategy, on WIDTH x HEIGHT seeded rays.
PANE_ALPHA = 0.4
ALPHA_PANE = ([-0.7, 0.1, 0.7], [0.7, 0.1, 0.7], [0.7, 1.7, 0.7], [-0.7, 1.7, 0.7])
SOUP_TRIS = 1536

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: Its streaming multiprocessors (4 warp schedulers each, one warp
#: instruction a clock each) and its boost clock.
H100_SMS = 132
SM_CLOCK_HZ = 1.98e9
#: fp32 operations of one ray-triangle test (an fma counts 2), in the
#: two parts a kernel may stop between: Möller-Trumbore 46, of which 24
#: reach the determinant's test and u (pvec 9, det 5, the reciprocal 1,
#: tvec 3, u 6) and 22 the rest (qvec 9, v 6, t 6, u + v 1); Baldwin-Weber
#: 31, of which 12 reach the plane's t (nd 5, no 5, subtract 1, divide 1)
#: and 19 the rest (p 6, u 6, v 6, u + v 1). Shading of one ray-bounce in
#: the megakernel, counted from csrc/ref_megakernel.cu with each
#: sqrt/sin/cos/rsqrt/div as 1: ~190 without the metal lobe, ~420 with.
FLOPS_MT, FLOPS_MT_FRONT = 46, 24
FLOPS_BW_PLANE, FLOPS_BW_INSIDE = 12, 19
#: Kernel 4's resolve of a hit ray's winner, counted from
#: csrc/trace_kernels.cu with an fma as 2 and fmax/sqrt/div/compare/cvt
#: as 1: pvec 9, det 5, sign 1, barycentric w 2, normal 15, |n|^2 5,
#: fmax + sqrt + div 3, flip 4, uv 10, material id 1. A miss skips it.
FLOPS_RESOLVE = 55
#: A slab test of kernels 5 and 6 (csrc/stream_kernels.cu): 6 subtracts,
#: 6 multiplies, 10 min/max, 3 compares.
FLOPS_SLAB = 25
FLOPS_SHADE = {False: 420, True: 190}
#: Operations of one try of kernel 7 for one pixel, counted from
#: csrc/probe_kernels.cu with a compare, select, min/max, shift, sqrt,
#: modulo or division as 1: the PCG word 9, the done test 1, the table
#: entry 4, two mirrors 16, the same-pixel test 3, the depth gate 4, the
#: normal dot and its gate 6, is_some and the gate's logic 3, the level
#: step 2, m > 0 1, the result 3 (DI: 52); GI adds two Jacobian halves
#: of 23 (3 subtracts, |v|^2 5, sqrt, the guarded max 2, the reciprocal,
#: 3 multiplies, the dot 5, the clamp 3) and 19 to combine, test and
#: clamp them (117).
OPS_PROBE_TRY = {"di": 52, "gi": 117}
#: Operations of one entry of the route entry's tables, counted from
#: csrc/probe_kernels.cu the same way: the try and level 4, the seeds 5,
#: two PCG words 18, two unit floats 4, sqrt, the angle, cos and sin 4,
#: four products 4, two truncations 2, two clamps 4 (45).
OPS_PROBE_TABLE_ENTRY = 45
#: Bytes a pixel of the route entry's fields (read) and outputs (written):
#: depth 4, normal 12, is_some 1, m 4, and in GI mode v1_point, v2_point,
#: v2_normal and the point 12 each; rhs_x 4, rhs_y 4, found 1, the int64
#: stream 8, and in GI mode the Jacobian 4.
ROUTE_BYTES = {"di": (21, 17), "gi": (69, 21)}
#: Most device operations one fused pass (restir/di.py::probe_fused) may
#: take on the card: the kernel's one launch, with room to spare.
FUSED_PASS_MAX_OPS = 5
#: Realtime frames under the profiler in phase 6's frame profiles (after
#: one warm-up frame), each ~30,000 device records.
PROFILE_RT_FRAMES = 2


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
    that took the most device time. One call before them is the
    profiler's warm-up step, whose events are dropped (the device's
    tracing starts there); the recorded step's own marker is not
    counted. None when the trace holds no device events. The device
    records are read from the trace as it was collected (the profiler's
    ``kineto_results``): building ``prof.events()`` from them, with every
    host op linked to its children, took most of the ~13 s a profiled
    realtime frame cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            fn()
        end.record()
        end.synchronize()
        prof.step()
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and not e.name().startswith("ProfilerStep")
                and not getattr(e, "is_hidden_event", lambda: False)()):
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
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


#: The kernels whose instructions per ray-triangle test sass_per_test
#: counts: A, B, 4, C in its default (flat, no_metal) variant, and the
#: timed variants of 8, 9, 10 and 11 (10 and 11 per node visit too).
SASS_KERNELS = {"A": "closest_brute_kernel", "B": "anyhit_brute_kernel",
                "4": "surface_closest_kernel", "C": "ref_megakernelILb1ELb1E",
                "8": "cluster_surface_kernelILb0E", "9": "cluster_anyhit_kernelILb0E",
                "10": "bvh_surface_kernelILb0E", "11": "bvh_anyhit_kernelILb0E"}
#: The BVH kernels, which read their leaf rows from global memory.
BVH_SASS = ("10", "11")


def sass_per_test(lib) -> dict | None:
    """Instructions per ray-triangle test of kernels A, B, 4, C, 8-11 (and
    per node visit of 10 and 11) as compiled, from ``cuobjdump -sass`` of
    the built library (``sass_loops``). None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return sass_loops(subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                                     timeout=300, check=True).stdout)


_BRANCH = re.compile(r"(@!?U?P\w+\s+)?BRA\S*\s+(?:!?U?P\w+,\s*)?`?\(?0x([0-9a-f]+)")


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output -> {function name: [(address, instruction)]}."""
    fns: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = fns.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return fns


def loop_spans(ins) -> list:
    """The loops of one function: (first, last address) of each backward
    branch's span, the spans of one loop head merged."""
    heads: dict[int, int] = {}
    for addr, text in ins:
        m = _BRANCH.search(text)
        if m and int(m.group(2), 16) < addr:
            lo = int(m.group(2), 16)
            heads[lo] = max(heads.get(lo, addr), addr)
    return sorted(heads.items())


def sass_loops(sass: str) -> dict:
    """For each kernel of SASS_KERNELS: ``row_loops``, or ``walk_loops``
    for the BVH kernels."""
    fns = sass_functions(sass)
    result = {}
    for key, pattern in SASS_KERNELS.items():
        ins = next(v for name, v in fns.items() if pattern in name)
        result[key] = walk_loops(ins) if key in BVH_SASS else row_loops(ins)
    return result


def row_loops(ins) -> list:
    """Each innermost loop over rows in ``ins`` (a backward branch whose
    body reads each row it tests with three shared-memory loads): the
    instructions of its body (all paths, the division's rare slow path
    included) over the rows a pass tests; those up to a warp's any-vote
    and its branch (what a row costs where the vote skips the rest); for
    the first row of the body, the instructions from its first load to
    each conditional branch that leaves the row (the branch included: what
    a row costs where a warp takes that exit) and to the row's end; and
    the shared-memory loads by kind."""
    load = re.compile(r"(?:@!?U?P\w+\s+)?(LDS(?:\.\w+)*)\b")
    spans = [(int(m.group(2), 16), addr) for addr, text in ins
             if (m := _BRANCH.search(text)) and int(m.group(2), 16) < addr]
    loops = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue  # not innermost
        body = [(a, t) for a, t in ins if lo <= a <= hi]
        lds = [(j, m.group(1)) for j, (_, t) in enumerate(body) if (m := load.match(t))]
        if not lds or len(lds) % 3:
            continue
        rows = len(lds) // 3
        votes = [j for j, (_, t) in enumerate(body) if "VOTE.ANY" in t]
        # the first row: from its first load to the next row's (or the
        # loop's end); an exit jumps to within 4 instructions of that
        first = lds[0][0]
        end = lds[3][0] if rows > 1 else len(body) - 1
        end_addr = body[end][0]
        exits = [j - first + 1 for j in range(first, end)
                 if (m := _BRANCH.match(body[j][1])) and m.group(1)
                 and end_addr - 0x40 <= int(m.group(2), 16) <= end_addr]
        loops.append({"instructions": len(body), "rows": rows,
                      "per_test": len(body) / rows,
                      "before_vote": (votes[0] + 2) / rows if votes else None,
                      "row_exits": exits, "row_end": end - first,
                      "loads": {k: [n for _, n in lds].count(k)
                                for k in sorted({n for _, n in lds})}})
    return loops


def shortest_lap(ins, lo: int, hi: int) -> int | None:
    """The fewest instructions a thread issues going once around the loop
    [lo, hi] of ``ins``: from its head at ``lo`` to its backward branch at
    ``hi``, through branches that stay inside the loop (a call's body not
    counted)."""
    index = {a: j for j, (a, _) in enumerate(ins)}
    first, last = index[lo], index[hi]
    dist = {first: 1}
    todo = collections.deque([first])
    while todo:
        j = todo.popleft()
        if j == last:
            return dist[j]
        text = ins[j][1]
        nxt = []
        m = _BRANCH.search(text)
        if m and lo <= int(m.group(2), 16) <= hi:
            nxt.append(index.get(int(m.group(2), 16)))
        always = (m and not m.group(1) and not re.search(r"BRA\S*\s+!?U?P\w+,", text)) or (
            text.startswith(("EXIT", "RET", "BRX", "JMX")))
        if not always and j < last:
            nxt.append(j + 1)
        for k in nxt:
            if k is not None and k not in dist:
                dist[k] = dist[j] + 1
                todo.append(k)
    return None


def walk_loops(ins) -> dict:
    """Kernel 10's or 11's walk in ``ins``: its node loop, the loop whose
    nested loops are all innermost (the loops over a leaf's rows). The
    node loop's instructions outside the leaf loops (all paths: the pop,
    the node's loads, two slab tests, the leaf dispatch, the pushes, the
    loop's own vote) and the fewest a visit issues (``shortest_lap``: no
    leaf tested), and its memory instructions by kind (LDG: global, LDS
    and STS: shared, LDL and STL: local); each leaf loop's instructions per
    row (a row's v0, e1 and e2: three loads of 16 bytes, or nine of 4), all
    paths and fewest."""
    spans = loop_spans(ins)

    def nested(s):
        return [t for t in spans if s[0] <= t[0] and t[1] <= s[1] and t != s]

    node = next((s for s in spans if nested(s) and not any(nested(t) for t in nested(s))),
                None)
    if node is None:
        return {"node_visit": None, "node_visit_min": None, "node_memory": None,
                "leaf_loops": [], "per_test": None, "per_test_min": None}
    leaves = nested(node)
    body = [(a, t) for a, t in ins if node[0] <= a <= node[1]
            and not any(lo <= a <= hi for lo, hi in leaves)]
    mem = re.compile(r"(?:@!?U?P\w+\s+)?((?:LDG|LDS|STS|LDL|STL)(?:\.\w+)*)\b")

    def kinds(instrs):
        found = [m.group(1) for _, t in instrs if (m := mem.match(t))]
        return {k: found.count(k) for k in sorted(set(found))}

    loops = []
    for lo, hi in leaves:
        leaf = [(a, t) for a, t in ins if lo <= a <= hi]
        loads = kinds(leaf)
        ldg = [(k, n) for k, n in loads.items() if k.startswith("LDG")]
        # three loads a row where they are 16 bytes wide (the last one may
        # be cut to the 4 bytes of e2.z), nine of 4 bytes in the whole test
        per_row = 3 if any(".128" in k for k, _ in ldg) else 9
        rows = max(1, sum(n for _, n in ldg) // per_row)
        lap = shortest_lap(ins, lo, hi)
        loops.append({"instructions": len(leaf), "rows": rows, "per_test": len(leaf) / rows,
                      "per_test_min": None if lap is None else lap / rows, "loads": loads})
    lap = shortest_lap(ins, *node)
    mins = [lp["per_test_min"] for lp in loops if lp["per_test_min"] is not None]
    return {"node_visit": len(body), "node_visit_min": lap, "node_memory": kinds(body),
            "leaf_loops": loops,
            "per_test": statistics.mean(lp["per_test"] for lp in loops) if loops else None,
            "per_test_min": min(mins) if mins else None}


def issue_floor_ms(work: dict, walk: dict | None) -> float | None:
    """The least time the card could issue a BVH kernel's walk in, from its
    SASS counts (``walk_loops``): node visits (two box tests each) times
    the fewest instructions a visit issues plus triangle tests times the
    fewest a test issues, over 32 lanes a warp instruction, 4 issued per
    clock on each of 132 SMs at SM_CLOCK_HZ. None without the counts."""
    if not walk or walk["node_visit_min"] is None or walk["per_test_min"] is None:
        return None
    instructions = (work["box_tests"] / 2 * walk["node_visit_min"]
                    + work["triangle_tests"] * walk["per_test_min"])
    return instructions / 32 / (4 * H100_SMS * SM_CLOCK_HZ) * 1e3


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


def anyhit_flops(rows, o, d, t_max, chunk: int = 256) -> int:
    """Operations kernel B needs, ray by ray: each row up to the first
    occluder through u (FLOPS_MT_FRONT), and the rest of the test where
    |det| >= eps and 0 <= u <= 1."""
    from strolle_tpu_torch.ops.intersect import front_passes
    from strolle_tpu_torch.ops.kernels.trace_kernels import _row_isect

    o, d, t_max = o.reshape(-1, 1, 3), d.reshape(-1, 1, 3), t_max.reshape(-1, 1)
    done = torch.zeros(t_max.shape[:1], dtype=torch.bool, device=o.device)
    tests = fronts = 0
    for c0 in range(0, rows.shape[0], chunk):
        t, u, _, det = _row_isect(rows[c0:c0 + chunk], o, d)
        hits = t < t_max
        # rows tested: up to and including the first occluder
        last = torch.where(hits.any(-1), hits.int().argmax(-1) + 1, hits.shape[1])
        tested = (torch.arange(hits.shape[1], device=o.device) < last[:, None]) & ~done[:, None]
        front = front_passes(u, det)
        tests += int(tested.sum())
        fronts += int((tested & front).sum())
        done |= hits.any(-1)
    return tests * FLOPS_MT_FRONT + fronts * (FLOPS_MT - FLOPS_MT_FRONT)


def closest_flops(rows, o, d, chunk: int = 256) -> int:
    """Operations kernels A and 4 need, ray by ray: every row through u
    (FLOPS_MT_FRONT), and the rest of the test where |det| >= eps and
    0 <= u <= 1 (a closest hit tests every row)."""
    from strolle_tpu_torch.ops.intersect import front_passes
    from strolle_tpu_torch.ops.kernels.trace_kernels import _row_isect

    o, d = o.reshape(-1, 1, 3), d.reshape(-1, 1, 3)
    fronts = 0
    for c0 in range(0, rows.shape[0], chunk):
        _, u, _, det = _row_isect(rows[c0:c0 + chunk], o, d)
        fronts += int(front_passes(u, det).sum())
    return o.shape[0] * rows.shape[0] * FLOPS_MT_FRONT + fronts * (FLOPS_MT - FLOPS_MT_FRONT)


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


def hold_brute(rows, o, d, t_max, name: str) -> tuple[float, float]:
    """Kernels A and B against their plain versions on one ray set; returns
    each one's max abs error (A: t/u/v where tri agrees; B: the flags as
    0/1)."""
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk

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
    occ = tk.trace_anyhit_brute(rows, o, d, t_max)
    pocc = tk.trace_anyhit_brute_plain(rows, o, d, t_max)
    mism = (occ != pocc).float().mean().item()
    check(mism <= 1e-5, f"kernel B ({name}): occlusion differs on {mism:.2e} of rays")
    check(0.0 < occ.float().mean().item() < 1.0, f"kernel B ({name}): degenerate")
    print(f"kernel A/B vs plain ({name}, {o.numel() // 3} rays, {rows.shape[0]} rows): tri "
          f"mismatch {(tri != ptri).sum().item()}, t/u/v max err {e:.3g}, occlusion mismatch "
          f"{(occ != pocc).sum().item()}, hit rate {(tri >= 0).float().mean().item():.3f}, "
          f"occluded rate {occ.float().mean().item():.3f}", flush=True)
    return e, (occ != pocc).float().max().item()


def hold_ties(rows, o, d, name: str, copied, geom_rows=None) -> int:
    """Kernel A (and kernel 4 over ``geom_rows``, the same triangles as
    [T, 28] rows) against the plain version on a tie set, rows that hold
    copies of rows: tri equal on every ray (the lowest copy must win, as
    one ascending pass with strict < picks), t/u/v as hold_brute holds
    them. ``copied`` flags the rows that have a copy; returns the rays
    whose winner is one of them."""
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk

    t, tri, u, v = tk.trace_closest_brute(rows, o, d)
    want = dict(zip(("t", "tri", "u", "v"), tk.trace_closest_brute_plain(rows, o, d)))
    got = [("A", {"t": t, "tri": tri, "u": u, "v": v}, want)]
    if geom_rows is not None:
        got.append(("4", tk.trace_surface(geom_rows, o, d),
                    tk.trace_surface_plain(geom_rows, o, d)))
    torch.cuda.synchronize()
    for k, g, w in got:
        mism = int((g["tri"] != w["tri"]).sum())
        check(mism == 0, f"kernel {k} (ties, {name}): tri differs on {mism} rays")
        hit = w["tri"] >= 0
        fields = ("t", "u", "v") if k == "A" else ("t", "u", "v", "normal", "uv")
        e = max((g[f] - w[f])[hit].abs().max().item() for f in fields)
        check(e <= 1e-5, f"kernel {k} (ties, {name}): fields differ by {e}")
        check(k == "A" or torch.equal(g["mat_id"], w["mat_id"]),
              f"kernel 4 (ties, {name}): material ids differ")
    hit = want["tri"] >= 0
    ties = int(copied[want["tri"][hit].long()].sum())
    check(ties > 0, f"ties ({name}): no winner has a copy")
    print(f"kernel{'s A and 4' if geom_rows is not None else ' A'} vs plain on ties ({name}, "
          f"{o.numel() // 3} rays, {rows.shape[0]} rows): tri mismatch 0, {ties} winners with "
          f"a copy", flush=True)
    return ties


def doubled(rows):
    """Rows twice over: every hit ties with its copy, the lower must win."""
    return torch.cat([rows, rows]).contiguous()


def tie_rows(rows, winners, count: int = 256):
    """``rows`` with copies of ``count`` of the rows that ``winners`` holds:
    each in another slice of its own 1024-row tile of kernel A (the row
    512 further on, wrapped within the tile, overwritten) and in a later
    tile (appended). Returns the rows and the flags of the rows that have
    a copy."""
    w = torch.unique(winners[winners >= 0])
    w = w[torch.linspace(0, w.numel() - 1, min(count, w.numel()), device=w.device).long()]
    other = (w // 1024) * 1024 + (w % 1024 + 512) % 1024
    keep = (other < rows.shape[0]) & ~torch.isin(other, w)
    out = rows.clone()
    out[other[keep]] = rows[w[keep]]
    out = torch.cat([out, rows[w]]).contiguous()
    copied = torch.zeros(out.shape[0], dtype=torch.bool, device=rows.device)
    copied[w] = True
    copied[other[keep]] = True
    copied[rows.shape[0]:] = True
    return out, copied


def compare_trace_kernels(scene, cam, device) -> dict:
    """Kernels A and B against their plain versions on Cornell's primary
    rays and on seeded random rays; returns each one's max abs error."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops.trace import packed_geom_rows, packed_tri_rows

    rows = packed_tri_rows(scene)
    po, pd = pixel_rays(cam, screen_grid(cam))
    ro, rd, rt = random_rays(cam.width * cam.height, device, seed=1)
    err = {"A": 0.0, "B": 0.0}
    for name, (o, d, t_max) in {
        "primary": (po, pd, torch.full(po.shape[:-1], 2.5, device=device)),
        "random": (ro, rd, rt),
    }.items():
        ea, eb = hold_brute(rows, o, d, t_max, name)
        err["A"], err["B"] = max(err["A"], ea), max(err["B"], eb)
        twice = doubled(rows)
        hold_ties(twice, o, d, f"Cornell's rows twice over, {name}",
                  torch.ones(twice.shape[0], dtype=torch.bool, device=device),
                  doubled(packed_geom_rows(scene)))
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


def stream_ray_sets(scene, cam, device, luts) -> dict:
    """The ray sets kernels 5 and 6 are held on: name -> (o, d, t_max)
    (t_max None: a closest-hit set only)."""
    from strolle_tpu_torch.ops.trace import trace_surface
    from strolle_tpu_torch.sky.atmosphere import sun_direction

    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    surf = trace_surface(scene, po, pd)
    sun = sun_direction(scene.sun_azimuth, scene.sun_altitude, device=device)
    return {
        "primary": (po.contiguous(), pd.contiguous(), None),
        "lights": (so, sd, slen),
        "sun": (surf.point.contiguous(), sun.expand_as(surf.point).contiguous(),
                torch.full(po.shape[:-1], math.inf, device=device)),
        "random": level_random_rays(scene, device),
        "gi": gi_shadow_rays(scene, cam, luts),
    }


def level_random_rays(scene, device):
    """STREAM_RANDOM_RAYS seeded rays from inside the level's cluster
    boxes in uniform random directions, t_max in [0.05, 5): (o, d, t_max)."""
    lo = scene.clusters[:, 0:3].amin(0).cpu().numpy()
    hi = scene.clusters[:, 3:6].amax(0).cpu().numpy()
    rs = np.random.RandomState(11)
    n = STREAM_RANDOM_RAYS
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rt = rs.uniform(0.05, 5.0, n).astype(np.float32)
    return tuple(torch.tensor(x, device=device) for x in (ro, rd, rt))


def gi_shadow_rays(scene, cam, luts):
    """The realtime frame's GI shadow rays (restir/gi.py, from the
    secondary vertex toward a light, or toward the sky with t_max = inf),
    as trace_anyhit takes them on frame 0 (a GI sampling frame) of the
    dungeon with the sky: (o, d, t_max)."""
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame_fused
    from strolle_tpu_torch.restir import gi

    calls = []
    trace = gi.trace_anyhit

    def record(scene_, o, d, t_max):
        calls.append((o, d, t_max))
        return trace(scene_, o, d, t_max)

    gi.trace_anyhit = record
    try:
        render_frame_fused(scene, cam, init_state(cam, device=cam.device), 0,
                           RenderConfig(include_sky=True), luts)
    finally:
        gi.trace_anyhit = trace
    check(len(calls) == 1, f"GI sampling cast {len(calls)} shadow-ray batches, not 1")
    o, d, t_max = calls[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                               o.shape[:-1])
    sky = torch.isinf(t_max) & (d != 0).any(-1)
    check(bool(sky.any()) and bool((torch.isfinite(t_max) & (t_max > 0)).any()),
          "the GI shadow rays lack rays toward the sky or toward a light")
    return o.contiguous(), d.contiguous(), t_max.contiguous()


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


def stream_launch(x: dict, anyhit: bool, work=None, list_cap: int | None = None):
    """One launch of kernel 5 or 6 (the counting variant when ``work`` is
    given; the module's list cap unless ``list_cap``) on prepared inputs;
    returns its outputs."""
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
    cap = sk.LIST_CAP if list_cap is None else list_cap
    cuda_lib.launch_walk(entry, sk.launch_head(x["clus"], x["subs"], x["rows"], cap), x["o"],
                         x["d"], x["cap"], outs, work)
    return outs


def stream_plain(x: dict, anyhit: bool, work=None, list_cap: int | None = None):
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    fn = sk.stream_trace_anyhit_plain if anyhit else sk.stream_trace_surface_plain
    cap = sk.LIST_CAP if list_cap is None else list_cap
    out = fn(x["clus"], x["subs"], x["rows"], x["o"], x["d"], x["cap"], work, list_cap=cap)
    return (out,) if anyhit else out


def stream_mismatch(got, want, anyhit: bool, what: str) -> tuple[int, float]:
    """Rays whose kernel 5 or 6 outputs differ from the plain version's,
    and the max abs error of t/u/v where tri agrees (the flags as 0/1)."""
    if anyhit:
        return int((got[0] != want[0]).sum()), float((got[0] != want[0]).float().max())
    same = got[1] == want[1]
    e = max(float((a - b)[same].abs().max()) for a, b in zip(got, want)
            if a.dtype == torch.float32)
    check(e <= 1e-5, f"{what}: t/u/v differ by {e}")
    return int((~same).sum()), e


def compare_stream_kernels(scene, cam, device, luts) -> tuple[dict, dict]:
    """Kernels 5 and 6 against their plain versions on the dungeon's ray
    sets, launched through their wrappers, and their counting variants'
    box and triangle tests against the plain versions'. Returns (max abs
    error per kernel, the ray sets)."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    sets = stream_ray_sets(scene, cam, device, luts)
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
            work = torch.zeros((n, 2), dtype=torch.int32, device=device)
            pwork = torch.zeros_like(work)
            stream_launch(x, anyhit, work)
            want = stream_plain(x, anyhit, pwork)
            torch.cuda.synchronize()
            k = "6" if anyhit else "5"
            what = f"kernel {k} ({name}, {n} rays)"
            # The same warps, lists, slab tests and fused multiply-adds:
            # everything bit-equal; allow 1e-5 of rays for the plain
            # version's float64 emulation of fma (double rounding near a
            # float32 midpoint).
            mism, e = stream_mismatch(got, want, anyhit, what)
            rate = got[0].float().mean().item() if anyhit else (got[1] >= 0).float().mean().item()
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


#: List caps below the dungeon's 33 clusters: 0 sends every warp down the
#: overflow path (the index-order walk), 4 some warps of each ray set.
OVERFLOW_CAPS = (0, 4)


def compare_stream_overflow(scene, sets: dict, device) -> dict:
    """Kernels 5 (primaries, random rays) and 6 (shadow rays toward the
    lights and the sun, the realtime GI shadow rays, random rays) under
    list caps below the dungeon's cluster count, against their plain
    versions under the same cap (in values and per-ray work) and against
    the kernel's front-to-back walk
    (the module's cap; the walk order must not change a result); then the
    index-order walk's (cap 0) box and triangle tests per ray beside the
    front-to-back walk's on the same rays. Kernel 5's triangle tests per
    primary must be fewer front to back. Returns the per-ray counts by
    kernel and ray set."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    walks = {}
    for name, anyhit in (("primary", False), ("random", False), ("lights", True), ("sun", True),
                         ("gi", True), ("random", True)):
        o, d, t_max = sets[name]
        x = stream_inputs(scene, o, d, t_max if anyhit else None)
        n = o.numel() // 3
        k = "6" if anyhit else "5"
        per_ray = {}
        ref = stream_launch(x, anyhit, list_cap=sk.LIST_CAP)
        for cap in (sk.LIST_CAP,) + OVERFLOW_CAPS:
            work = torch.zeros((n, 2), dtype=torch.int32, device=device)
            got = stream_launch(x, anyhit, work, list_cap=cap)
            per_ray[cap] = [float(v) / n for v in work.sum(0, dtype=torch.int64)]
            if cap == sk.LIST_CAP:
                continue
            pwork = torch.zeros_like(work)
            want = stream_plain(x, anyhit, pwork, list_cap=cap)
            torch.cuda.synchronize()
            what = f"kernel {k} ({name}, list cap {cap})"
            mism, e = stream_mismatch(got, want, anyhit, what)
            wmism = int((work != pwork).any(-1).sum())
            rmism, re = stream_mismatch(got, ref, anyhit, f"{what} vs list cap {sk.LIST_CAP}")
            _, _, count = sk.warp_lists(x["clus"], x["o"].reshape(-1, 3), x["d"].reshape(-1, 3),
                                        x["cap"].reshape(-1))
            share = (count > cap).float().mean().item()
            print(f"{what} vs plain: mismatches {mism}, max err {e:.3g}, work mismatches "
                  f"{wmism}, warps overflowing {share:.3f}; vs list cap {sk.LIST_CAP}: "
                  f"mismatches {rmism}, max err {re:.3g}", flush=True)
            check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
            check(wmism <= 1e-5 * n, f"{what}: test counts differ on {wmism} rays")
            check(rmism <= 1e-5 * n, f"{what}: {rmism} rays differ from list cap {sk.LIST_CAP}")
        print(f"kernel {k} ({name}) per ray: front to back {per_ray[sk.LIST_CAP][0]:.2f} box and "
              f"{per_ray[sk.LIST_CAP][1]:.2f} triangle tests; index order (list cap 0, its "
              f"{x['clus'].shape[0]} list tests included) {per_ray[0][0]:.2f} and "
              f"{per_ray[0][1]:.2f}; list cap 4 {per_ray[4][0]:.2f} and {per_ray[4][1]:.2f}",
              flush=True)
        walks[f"{k} {name}"] = {"front_to_back": per_ray[sk.LIST_CAP],
                                "index_order": per_ray[0], "list_cap_4": per_ray[4]}
    primary = walks["5 primary"]
    check(primary["front_to_back"][1] < primary["index_order"][1],
          "kernel 5: the front-to-back walk tests no fewer triangles per primary")
    return walks


def drive_flat_dungeon(flat, scene, luts, device) -> dict:
    """One reference sample (trace_sample, depth DEPTH, the sky) of the
    dungeon without its BVH at FLAT_WIDTH x FLAT_HEIGHT, with the counts
    set to 0 before and read after: kernels A and B launch once a bounce
    each, no other kernel; the image finite and, on 99% of pixels, within
    1e-3 of the same sample of the dungeon with its BVH ("stream": the same
    hits, found by kernels 5 and 6). Returns the launches."""
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.scene.demo import dungeon_camera

    cam = dungeon_camera(FLAT_WIDTH, FLAT_HEIGHT, device=device)
    cuda_lib.reset_launch_counts()
    img = trace_sample(flat, cam, SEED, depth=DEPTH, include_sky=True, luts=luts)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"dungeon without a BVH, {FLAT_WIDTH}x{FLAT_HEIGHT} reference sample launches: "
          f"{launches}", flush=True)
    check_launches(launches, {"trace_closest_brute": DEPTH + 1, "trace_anyhit_brute": DEPTH + 1},
                   "the BVH-less dungeon")
    check(tuple(img.shape) == (FLAT_HEIGHT, FLAT_WIDTH, 3), "BVH-less dungeon: image shape")
    check(bool(torch.isfinite(img).all()), "BVH-less dungeon: non-finite values")
    check(1e-3 < img.mean().item() < 5.0, "BVH-less dungeon: implausible mean")
    with strategy("stream"):
        ref = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=True, luts=luts)
    close = ((img - ref).abs().amax(-1) <= 1e-3).float().mean().item()
    print(f"dungeon without a BVH vs with it: {close:.5f} of pixels within 1e-3, means "
          f"{img.mean().item():.5f} vs {ref.mean().item():.5f}", flush=True)
    check(close > 0.99, "the BVH-less dungeon disagrees with the stream route")
    return launches


def stream_cost(x: dict, anyhit: bool) -> dict:
    """Kernel 5 or 6's walk on these inputs (the counting variant's box and
    triangle tests, ``fronts_of``' tests whose first half passes) and the
    bytes it must move (rows and boxes read once, rays in and results
    out); ``least_work_bounds`` makes the bounds."""
    n = x["o"].numel() // 3
    work = torch.zeros((n, 2), dtype=torch.int32, device=x["o"].device)
    stream_launch(x, anyhit, work)
    box, tri = (int(v) for v in work.sum(0, dtype=torch.int64))
    pwork = torch.zeros((n, 3), dtype=torch.int32, device=work.device)
    stream_plain(x, anyhit, pwork)
    nbytes = (4 * (x["rows"].numel() + x["clus"].numel() + x["subs"].numel())
              + n * (24 + 4) + n * (1 if anyhit else 16))
    return {"work": {"rays": n, "box_tests": box, "triangle_tests": tri,
                     "fronts": fronts_of(work, pwork, "5" if not anyhit else "6")},
            "bytes": nbytes}


def fronts_of(work, pwork, key: str) -> int:
    """The triangle tests of a walk whose first half passes (|det| >= eps
    and 0 <= u <= 1), from its plain version's third work column
    (``pwork`` [R, 3]), whose box and triangle tests must equal the
    kernel's counting variant's (``work`` [R, 2]) on every ray."""
    wmism = int((pwork[:, :2] != work).any(-1).sum())
    check(wmism == 0, f"kernel {key}: the plain version's test counts differ on {wmism} rays")
    return int(pwork[:, 2].sum(dtype=torch.int64))


def walk_ops(work: dict) -> int:
    """fp32 operations of a walk's box and triangle tests: each triangle
    test to u (FLOPS_MT_FRONT), the rest where the first half passes."""
    return (work["box_tests"] * FLOPS_SLAB + work["triangle_tests"] * FLOPS_MT_FRONT
            + work["fronts"] * (FLOPS_MT - FLOPS_MT_FRONT))


def least_work_bounds(costs: dict) -> None:
    """Sets each walking kernel's bound_ms from the work its function
    needs on its rays: the fewest box and triangle test operations
    (``walk_ops``: a triangle test's second half only where its first
    passes, as ``closest_flops`` counts) of the walks counted here on the
    same rays (closest hit: kernels 5, 8, 10 on the primaries; any hit: 6,
    9, 11 on the light shadow rays), plus the resolve of each hit ray for
    8 and 10, against the kernel's own bytes.
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


def walk_launch(x: dict, work=None, list_cap: int | None = None):
    """One launch of kernel 8, 9, 10 or 11 (the counting variant when
    ``work`` is given; kernels 8 and 9 under the module's list cap unless
    ``list_cap``) on prepared inputs, past the wrapper and its launch
    count; returns its outputs."""
    from strolle_tpu_torch.ops.kernels import cluster_kernels as ck
    from strolle_tpu_torch.ops.kernels import cuda_lib

    name, mod, anyhit, _, _ = WALK_KERNELS[x["key"]]
    batch = x["o"].shape[:-1]
    if anyhit:
        outs = (torch.empty(batch, dtype=torch.bool, device=x["o"].device),)
    else:
        outs = cuda_lib.surface_outputs(batch, x["o"].device)
    cap = ck.LIST_CAP if list_cap is None else list_cap
    head = (ck.launch_head(x["table"], x["rows"], cap) if mod == "cluster"
            else (x["table"], x["rows"]))
    cuda_lib.launch_walk("strolle_" + name, head, x["o"], x["d"], x["t_max"], outs, work)
    return outs


def walk_module(key: str):
    """The module of kernel 8, 9, 10 or 11 (its wrapper and plain version)."""
    from strolle_tpu_torch.ops.kernels import bvh_kernels, cluster_kernels

    return cluster_kernels if WALK_KERNELS[key][1] == "cluster" else bvh_kernels


def walk_plain(x: dict, work=None, list_cap: int | None = None):
    """The plain version of kernel 8, 9, 10 or 11 on the same inputs (8 and
    9 under ``list_cap`` where given), its outputs in the order
    ``walk_launch`` returns them."""
    name, _, anyhit, _, _ = WALK_KERNELS[x["key"]]
    fn = getattr(walk_module(x["key"]), name + "_plain")
    kw = {} if list_cap is None else {"list_cap": list_cap}
    if anyhit:
        return (fn(x["table"], x["rows"], x["o"], x["d"], x["t_max"], work, **kw),)
    t, tri, _, _, normal, uv, mat = fn(x["table"], x["rows"], x["o"], x["d"], work, **kw)
    return t, tri, normal, uv, mat


def walk_mismatch(got, want, anyhit: bool) -> tuple[int, float]:
    """Rays whose kernel 8-11 outputs differ from ``want`` in any field, and
    the max abs error of the float fields where tri agrees (any hit: the
    flags as 0/1)."""
    n = got[0].numel()
    differ = torch.zeros(n, dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, want):
        differ |= (a != b).reshape(n, -1).any(-1)
    if anyhit:
        return int(differ.sum()), float(differ.float().max())
    agree = got[1] == want[1]
    e = max(float((a - b)[agree].abs().nan_to_num(0.0).max())
            for a, b in zip(got, want) if a.is_floating_point())
    return int(differ.sum()), e


def hold_walk(x: dict, what: str, device, all_may_hit: bool = False) -> tuple:
    """Kernel 8, 9, 10 or 11 on prepared inputs ``x`` through its wrapper
    against its plain version, every output bit-equal, and its counting
    variant's box and triangle tests against the plain version's on every
    ray (neither may hit or occlude every ray unless ``all_may_hit``);
    prints both and returns the max abs error and the outputs."""
    kname, _, anyhit, _, _ = WALK_KERNELS[x["key"]]
    o, d, t_max = x["o"], x["d"], x["t_max"]
    n = o.numel() // 3
    wrapper = getattr(walk_module(x["key"]), kname)
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
    # The same walk, slab tests, fused multiply-adds and resolve: every
    # output bit-equal, normals included (a correctly rounded sqrt and
    # divide on both sides); allow 1e-5 of rays for the plain version's
    # float64 emulation of fma (double rounding near a float32 midpoint).
    mism, e = walk_mismatch(got, want, anyhit)
    rate = got[0].float().mean().item() if anyhit else (got[1] >= 0).float().mean().item()
    wmism = int((work != pwork).any(-1).sum())
    print(f"{what} vs plain: rays differing {mism}, max err {e:.3g}, work mismatches "
          f"{wmism}, box tests {int(work[:, 0].sum())}, triangle tests "
          f"{int(work[:, 1].sum())}, {'occluded' if anyhit else 'hit'} rate {rate:.3f}",
          flush=True)
    check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
    check(wmism <= 1e-5 * n, f"{what}: test counts differ on {wmism} rays")
    check(anyhit or e <= 1e-5, f"{what}: fields differ by {e}")
    check(rate > 0.0 and (rate < 1.0 or all_may_hit), f"{what}: degenerate")
    return e, got


def deep_tree(device, depth: int = DEEP_TREE_DEPTH, n_rays: int = DEEP_TREE_RAYS):
    """A synthetic [N, 16] node table whose walk overflows the stack: a
    chain of ``depth`` nodes, each with both child boxes the cube [-1, 1]^3,
    child 0 the next node of the chain (near: the entry distances tie) and
    child 1 a side node (far, pushed first), whose two children are leaves
    of two seeded triangles each ([T', 28] rows); the chain ends in a leaf.
    Every ray that enters the cube pushes a side node per level, so the
    stack pointer reaches the clamp at MAX_STACK - 1 and the pushes there
    overwrite each other. Rays from a sphere of radius 3 toward points of
    the cube (a tenth from inside it), t_max in [0.5, 6). Returns (nodes,
    rows, o, d, t_max)."""
    rs = np.random.RandomState(23)
    n_side = depth
    n_rows = 4 * n_side + 2
    rows = np.zeros((n_rows, 28), np.float32)
    v0 = rs.uniform(-0.9, 0.9, (n_rows, 3))
    rows[:, 0:3] = v0
    rows[:, 3:6] = rs.uniform(-0.5, 0.5, (n_rows, 3))
    rows[:, 6:9] = rs.uniform(-0.5, 0.5, (n_rows, 3))
    nrm = rs.normal(size=(n_rows, 3, 3))
    rows[:, 9:18] = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).reshape(n_rows, 9)
    rows[:, 18:24] = rs.uniform(0.0, 1.0, (n_rows, 6))
    rows[:, 24] = rs.randint(0, 5, n_rows)
    nodes = np.zeros((2 * depth, 16), np.float32)
    box = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    nodes[:, 0:12] = box + box
    for i in range(depth):
        last = i + 1 == depth
        nodes[i, 12:16] = [-(4 * n_side + 1) if last else i + 1, depth + i, 2 if last else 0, 0]
        nodes[depth + i, 12:16] = [-(4 * i + 1), -(4 * i + 3), 2, 2]
    u = rs.normal(size=(n_rays, 3))
    o = 3.0 * u / np.linalg.norm(u, axis=-1, keepdims=True)
    inside = rs.uniform(size=n_rays) < 0.1
    o[inside] = rs.uniform(-0.95, 0.95, (int(inside.sum()), 3))
    d = rs.uniform(-0.9, 0.9, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rs.uniform(0.5, 6.0, n_rays)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device).contiguous()
                 for a in (nodes, rows, o, d, t_max))


def ragged(o, d, t_max, n: int = RAGGED_RAYS):
    """``n`` rays spread over a set (every k-th): a count that is no
    multiple of 32 and fills less than one resident wave of the card."""
    step = max(1, (o.numel() // 3) // n)
    o, d = (x.reshape(-1, 3)[::step][:n].contiguous() for x in (o, d))
    return o, d, None if t_max is None else t_max.reshape(-1)[::step][:n].contiguous()


def compare_walk_kernels(scene, sets: dict, device) -> dict:
    """Kernels 8-11 against their plain versions on the dungeon's ray sets
    (the ones kernels 5 and 6 are held on), launched through their
    wrappers, and their counting variants' box and triangle tests against
    the plain versions'; kernel 10's tri against the torch BVH traversal
    on the primaries. Kernels 10 and 11 also on ``deep_tree`` (the stack
    clamp) and on RAGGED_RAYS primaries and light shadow rays (the grid's
    ragged end). Returns the max abs error per kernel."""
    from strolle_tpu_torch.bvh.traverse import trace_closest_bvh
    from strolle_tpu_torch.ops.kernels.bvh_kernels import MAX_STACK

    err = {}
    for name, (o, d, t_max) in sets.items():
        n = o.numel() // 3
        for key, (_, _, anyhit, _, _) in WALK_KERNELS.items():
            if (anyhit and t_max is None) or (not anyhit and name not in ("primary", "random")):
                continue
            x = walk_inputs(scene, key, o, d, t_max)
            e, got = hold_walk(x, f"kernel {key} ({name}, {n} rays)", device,
                               all_may_hit=name in ("primary", "sun"))
            if key == "10" and name == "primary":
                tri_bvh = trace_closest_bvh(scene, o, d).tri
                flips = int((tri_bvh != got[1]).sum())
                print(f"kernel 10 vs the torch BVH traversal on the primaries: tri differs on "
                      f"{flips} rays", flush=True)
                check(flips <= 1e-5 * n, f"kernel 10: tri differs from the traversal on {flips}")
            err[key] = max(err.get(key, 0.0), e)
    nodes, rows, o, d, t_max = deep_tree(device)
    for key in ("10", "11"):
        x = dict(key=key, table=nodes, rows=rows, o=o, d=d, t_max=t_max if key == "11" else None)
        what = (f"kernel {key} (a chain of {nodes.shape[0] // 2} nodes, stack clamped at "
                f"{MAX_STACK - 1}, {o.shape[0]} rays)")
        err[key] = max(err[key], hold_walk(x, what, device)[0])
    for key, name in (("10", "primary"), ("11", "lights")):
        ro, rd, rt = ragged(*sets[name])
        x = walk_inputs(scene, key, ro, rd, rt)
        what = f"kernel {key} ({ro.numel() // 3} {name} rays, the grid's ragged end)"
        err[key] = max(err[key], hold_walk(x, what, device, all_may_hit=key == "10")[0])
    return err


def compare_cluster_walks(scene, sets: dict, device) -> dict:
    """Kernels 8 (primaries, random rays) and 9 (shadow rays toward the
    lights and the sun, the realtime GI shadow rays, random rays) on their
    overflow path, list caps OVERFLOW_CAPS below the dungeon's cluster
    count, against their plain versions under the same cap (outputs and
    per-ray work, bit-equal) and against the kernel's front-to-back walk
    (the module's cap: the walk order must not change a result); then the
    index-order walk's (cap 0) box and triangle tests per ray beside the
    front-to-back walk's on the same rays. Kernel 8's triangle tests per
    primary must be fewer front to back. Then kernels 8 and 9 on a tie
    set: the dungeon's rows twice over, clustered anew, where every hit
    ties with its copy and the lower must win (kernel 8: tri equal to the
    plain version's on every ray and every hit on the first copy).
    Returns the per-ray counts by kernel and ray set."""
    from strolle_tpu_torch.ops.kernels import cluster_kernels as ck

    walks = {}
    for name, key in (("primary", "8"), ("random", "8"), ("lights", "9"), ("sun", "9"),
                      ("gi", "9"), ("random", "9")):
        o, d, t_max = sets[name]
        x = walk_inputs(scene, key, o, d, t_max)
        anyhit = key == "9"
        n = o.numel() // 3
        per_ray = {}
        ref = walk_launch(x)
        for cap in (ck.LIST_CAP,) + OVERFLOW_CAPS:
            work = torch.zeros((n, 2), dtype=torch.int32, device=device)
            got = walk_launch(x, work, list_cap=cap)
            per_ray[cap] = [float(v) / n for v in work.sum(0, dtype=torch.int64)]
            pwork = torch.zeros_like(work)
            want = walk_plain(x, pwork, list_cap=cap)
            torch.cuda.synchronize()
            what = f"kernel {key} ({name}, list cap {cap})"
            mism, e = walk_mismatch(got, want, anyhit)
            wmism = int((work != pwork).any(-1).sum())
            rmism, re = walk_mismatch(got, ref, anyhit)
            bound = (x["t_max"] if anyhit
                     else torch.full((n,), math.inf, device=device)).reshape(-1)
            _, _, count = ck.warp_lists(x["table"], o.reshape(-1, 3), d.reshape(-1, 3), bound)
            share = (count > cap).float().mean().item()
            print(f"{what} vs plain: rays differing {mism}, max err {e:.3g}, work mismatches "
                  f"{wmism}, warps overflowing {share:.3f}; vs list cap {ck.LIST_CAP}: rays "
                  f"differing {rmism}, max err {re:.3g}", flush=True)
            check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
            check(wmism <= 1e-5 * n, f"{what}: test counts differ on {wmism} rays")
            check(anyhit or e <= 1e-5, f"{what}: fields differ by {e}")
            check(rmism <= 1e-5 * n, f"{what}: {rmism} rays differ from list cap {ck.LIST_CAP}")
        print(f"kernel {key} ({name}) per ray: front to back {per_ray[ck.LIST_CAP][0]:.2f} box "
              f"and {per_ray[ck.LIST_CAP][1]:.2f} triangle tests; index order (list cap 0, its "
              f"{x['table'].shape[0]} list tests included) {per_ray[0][0]:.2f} and "
              f"{per_ray[0][1]:.2f}; list cap 4 {per_ray[4][0]:.2f} and {per_ray[4][1]:.2f}",
              flush=True)
        walks[f"{key} {name}"] = {"front_to_back": per_ray[ck.LIST_CAP],
                                  "index_order": per_ray[0], "list_cap_4": per_ray[4]}
    primary = walks["8 primary"]
    check(primary["front_to_back"][1] < primary["index_order"][1],
          "kernel 8: the front-to-back walk tests no fewer triangles per primary")

    from strolle_tpu_torch.ops.trace import packed_geom_rows

    rows = doubled(packed_geom_rows(scene))
    v0 = rows[:, 0:3]
    table = ck.clusterize_bvh(None, rows.shape[0], torch.stack(
        [v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]], dim=1)).contiguous()
    for name, key in (("primary", "8"), ("random", "8"), ("lights", "9"), ("random", "9")):
        o, d, t_max = sets[name]
        x = dict(walk_inputs(scene, key, o, d, t_max), table=table, rows=rows)
        n = o.numel() // 3
        got, want = walk_launch(x), walk_plain(x)
        torch.cuda.synchronize()
        mism, e = walk_mismatch(got, want, key == "9")
        what = (f"kernel {key} on ties ({name}, the dungeon's rows twice over, "
                f"{table.shape[0]} clusters)")
        if key == "8":
            # Both copies of a winner are tested wherever the walk enters
            # both clusters; a cluster entered after the hit is re-tested
            # against best t times TIE_REACH, so the cluster of the first
            # copy is entered even where the copy lies on the box face the
            # ray enters by and the slab's t_near rounds a few ulps past
            # its t: every hit must land on the first copy, as in the
            # index-order walk.
            hit = got[1] >= 0
            lower = int((got[1][hit] < rows.shape[0] // 2).sum())
            print(f"{what} vs plain: rays differing {mism}, max err {e:.3g}; {lower} of "
                  f"{int(hit.sum())} hits on the first copy", flush=True)
            check(mism == 0, f"{what}: {mism} rays differ from the plain version")
            check(e <= 1e-5, f"{what}: fields differ by {e}")
            check(lower == int(hit.sum()) > 0,
                  f"{what}: {int(hit.sum()) - lower} hits on the second copy")
        else:
            print(f"{what} vs plain: rays differing {mism}", flush=True)
            check(mism <= 1e-5 * n, f"{what}: {mism} rays differ from the plain version")
    return walks


def walk_cost(x: dict) -> dict:
    """Kernel 8, 9, 10 or 11's walk on these inputs (the counting
    variant's box and triangle tests, ``fronts_of``' tests whose first half
    passes, and its hit rays, each resolved once) and the bytes it must
    move (the table and rows read once, rays in and results out);
    ``least_work_bounds`` makes the bounds."""
    anyhit = x["t_max"] is not None
    n = x["o"].numel() // 3
    work = torch.zeros((n, 2), dtype=torch.int32, device=x["o"].device)
    outs = walk_launch(x, work)
    box, tri = (int(v) for v in work.sum(0, dtype=torch.int64))
    pwork = torch.zeros((n, 3), dtype=torch.int32, device=work.device)
    walk_plain(x, pwork)
    hits = 0 if anyhit else int((outs[1] >= 0).sum())
    # out: t, tri, normal [3], uv [2], mat_id = 32 B per ray; or the flag
    nbytes = (4 * (x["rows"].numel() + x["table"].numel()) + n * (24 + (4 if anyhit else 0))
              + n * (1 if anyhit else 32))
    return {"work": {"rays": n, "box_tests": box, "triangle_tests": tri,
                     "fronts": fronts_of(work, pwork, x["key"]), "hits": hits},
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
               "trace_surface", "probe_spatial_di", "probe_spatial_gi") + tuple(
    k for ks in STRATEGY_KERNELS.values() for k in ks)


def check_launches(launches: dict, want: dict, what: str) -> None:
    """Every kernel launched as often as ``want`` says (0 where it says
    nothing)."""
    for k in ALL_KERNELS:
        check(launches.get(k, 0) == want.get(k, 0),
              f"{what} launched {k} {launches.get(k, 0)} times, not {want.get(k, 0)}")


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
        check_launches(ref_launches, {surface: (DEPTH + 1) * (1 + FRAMES),
                                      anyhit: (DEPTH + 1) * (1 + FRAMES)},
                       f"{name}: reference mode")
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
        check_launches(rt_launches, realtime_launches(RT_FRAMES, big=(surface, anyhit)),
                       f"{name}: the realtime frame")
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



@contextlib.contextmanager
def probe_switch(on: bool):
    """Runs the block with STROLLE_PROBE_KERNEL "1" (the fused probe,
    kernel 7) or "0" (the tensor probe); restores the previous value after
    it, also when a check fails."""
    old = os.environ.get("STROLLE_PROBE_KERNEL")
    os.environ["STROLLE_PROBE_KERNEL"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["STROLLE_PROBE_KERNEL"]
        else:
            os.environ["STROLLE_PROBE_KERNEL"] = old


@contextlib.contextmanager
def capture_spatial(calls: dict):
    """Records the arguments of each DI and GI spatial pass the block runs
    (camera, surface, reservoirs, seed, frame, tuning) under "di" and "gi":
    the real inputs of kernel 7 on the main path."""
    from strolle_tpu_torch.restir import di, gi

    real = {"di": di.di_spatial, "gi": gi.gi_spatial}

    def recorder(kind):
        def fn(scene, camera, surf, res, seed, frame, tuning, *rest):
            calls.setdefault(kind, []).append((camera, surf, res, seed, frame, tuning))
            return real[kind](scene, camera, surf, res, seed, frame, tuning, *rest)
        return fn

    di.di_spatial, gi.gi_spatial = recorder("di"), recorder("gi")
    try:
        yield
    finally:
        di.di_spatial, gi.gi_spatial = real["di"], real["gi"]


def spatial_inputs(scene, cam, cfg, luts, frames: int = 2) -> dict:
    """The first ``frames`` realtime frames from a fresh state with the
    tensor probe, recording each spatial pass's arguments: DI on frame 0,
    GI on frame 1 (its first odd tracing frame)."""
    from strolle_tpu_torch.models.restir import init_state, render_frame_fused

    calls: dict = {}
    state = init_state(cam, device=cam.device)
    with probe_switch(False), capture_spatial(calls):
        for f in range(frames):
            _, state = render_frame_fused(scene, cam, state, 300 + f, cfg, luts)
    check(len(calls["di"]) == frames and len(calls["gi"]) == 1, "spatial passes not captured")
    return {"di": calls["di"][0], "gi": calls["gi"][0]}


def pass_tuning(kind: str, t) -> tuple:
    """(tries, radius, the GI keyword arguments) of a spatial pass."""
    if kind == "di":
        return t.di_spatial_samples, t.di_spatial_radius, {}
    return t.gi_spatial_samples, t.gi_spatial_radius, dict(jac_reject=t.gi_jacobian_reject,
                                                           jac_clamp=t.gi_jacobian_clamp)


def probe_case(kind: str, args) -> tuple:
    """Kernel 7's stack-entry inputs (stack, dy, dx, seed, keyword
    arguments) for a captured spatial pass, as restir/di.py::probe_inputs
    builds them."""
    from strolle_tpu_torch.restir import di, gi

    _, surf, res, seed, _, t = args
    tries, radius, gi_kw = pass_tuning(kind, t)
    planes = (res.m,) if kind == "di" else gi.probe_planes(surf, res)
    stack, dy, dx, kw = di.probe_inputs(surf, planes, seed, tries, radius, **gi_kw)
    return stack, dy, dx, seed, kw


def synthetic_probe_cases(device) -> dict:
    """A seeded blocky stack at WIDTH x HEIGHT (8x8 blocks of depth and
    surface flags, random normals and reservoirs, a tenth of the v2
    vertices absent; tests/test_probe_kernels.py's fields at full size),
    with the default tuning's tables: (stack, dy, dx, seed, kwargs) per
    mode."""
    from strolle_tpu_torch.config import DEFAULT_TUNING as t
    from strolle_tpu_torch.restir import di

    h, w = HEIGHT, WIDTH
    rs = np.random.RandomState(21)

    def blocky(lo, hi):
        return np.repeat(np.repeat(rs.uniform(lo, hi, (h // 8, w // 8)), 8, 0), 8, 1)

    def unit(n):
        v = rs.normal(size=(n, h, w))
        return v / np.linalg.norm(v, axis=0, keepdims=True)

    planes = np.concatenate([
        blocky(1.0, 5.0)[None], unit(3), (blocky(0.0, 1.0) > 0.15)[None],
        ((rs.uniform(0, 1, (h, w)) > 0.2) * rs.uniform(1, 8, (h, w)))[None],
        rs.uniform(-2, 2, (3, h, w)),
        rs.uniform(-2, 2, (3, h, w)) * (rs.uniform(0, 1, (1, h, w)) > 0.1),
        unit(3), rs.uniform(-2, 2, (3, h, w)),
    ]).astype(np.float32)
    stack = torch.tensor(planes, device=device)
    surf_like = types.SimpleNamespace(depth=stack[0], normal=stack[1:4].permute(1, 2, 0),
                                      is_some=stack[4] > 0.5)
    seed = 0xBEEF
    cases = {}
    gi_planes = [stack[5]] + [stack[k:k + 3].permute(1, 2, 0) for k in (6, 9, 12, 15)]
    for mode, planes_after, gi_kw in (("di", [stack[5]], {}),
                                      ("gi", gi_planes, dict(jac_reject=10.0, jac_clamp=3.0))):
        radius = t.di_spatial_radius if mode == "di" else t.gi_spatial_radius
        tries = t.di_spatial_samples if mode == "di" else t.gi_spatial_samples
        st, dy, dx, kw = di.probe_inputs(surf_like, planes_after, seed, tries, radius, **gi_kw)
        cases[mode] = (st, dy, dx, seed, kw)
    return cases


def synthetic_route_cases(cases: dict) -> dict:
    """The route entry's inputs on the synthetic stacks (mode -> the
    ``synthetic_probe_cases`` tuple), their planes read as fields in place:
    pixel stride 1 and, for the vectors, component stride H x W (the
    layout of a [3, H, W] buffer seen as [H, W, 3])."""
    from strolle_tpu_torch.config import DEFAULT_TUNING as t
    from strolle_tpu_torch.ops import offsets as shoff, rng

    out = {}
    for mode, (stack, _, _, seed, kw) in cases.items():
        _, h, w = stack.shape

        def vec(k, stack=stack):
            return stack[k:k + 3].permute(1, 2, 0)

        fields = (stack[0], vec(1), stack[4] > 0.5, stack[5]) + (
            (vec(6), vec(9), vec(12), vec(15)) if mode == "gi" else ())
        ys, xs = torch.meshgrid(torch.arange(h, device=stack.device),
                                torch.arange(w, device=stack.device), indexing="ij")
        radius = t.di_spatial_radius if mode == "di" else t.gi_spatial_radius
        rkw = {k: v for k, v in kw.items() if k != "n_lvls"} | {
            "radii": shoff.radius_levels(radius)}
        out[mode] = (fields, seed, rng.wnoise_new(seed, xs, ys), rkw)
    return out


def compare_probe_kernel(cases: dict) -> dict:
    """Kernel 7 against its plain version on each named case (mode ->
    (stack, dy, dx, seed, kwargs)): oy, ox and found exact, jac bit-equal
    (the same operations in the same order, with a correctly rounded
    sqrt and division on both sides). Returns the max abs error per mode."""
    from strolle_tpu_torch.ops.kernels import probe_kernels as pk

    err = {"di": 0.0, "gi": 0.0}
    for name, (stack, dy, dx, seed, kw) in cases.items():
        got = pk.probe_spatial(stack, dy, dx, seed, **kw)
        want = pk.probe_spatial_plain(stack, dy, dx, seed, **kw)
        torch.cuda.synchronize()
        mode = kw["mode"]
        differing = {k: int((a != b).sum()) for k, a, b in zip(("oy", "ox", "found", "jac"),
                                                              got, want)}
        e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        found = got[2].float().mean().item()
        print(f"kernel 7 ({name}, {mode}, {tuple(stack.shape)}, {kw['tries']} tries) vs plain: "
              f"pixels differing {differing}, max err {e:.3g}, found share {found:.3f}",
              flush=True)
        check(not any(differing.values()), f"kernel 7 ({name}): differs from its plain version")
        check(0.0 < found < 1.0, f"kernel 7 ({name}): degenerate (found share {found})")
        err[mode] = max(err[mode], e)
    return err


def probe_cost(case: tuple) -> dict:
    """Kernel 7's least work on one case: the tries each pixel makes up to
    the one it accepts (the plain version counts them; later tries change
    nothing), and the bytes it must move (the stack and tables read once,
    oy, ox, found and, in GI mode, jac written once)."""
    from strolle_tpu_torch.ops.kernels import probe_kernels as pk

    stack, dy, dx, seed, kw = case
    work = torch.zeros(stack.shape[1:], dtype=torch.int32, device=stack.device)
    pk.probe_spatial_plain(stack, dy, dx, seed, work=work, **kw)
    tries = int(work.sum(dtype=torch.int64))
    px = stack.shape[1] * stack.shape[2]
    nbytes = 4 * (stack.numel() + dy.numel() + dx.numel()) + px * (
        9 + (4 if kw["mode"] == "gi" else 0))
    b, by = bound(tries * OPS_PROBE_TRY[kw["mode"]], nbytes)
    return {"pixels": px, "tries_made": tries, "bytes": nbytes, "bound_ms": b, "bound_by": by}


def route_case(kind: str, args) -> tuple:
    """Kernel 7's route-entry inputs for a captured spatial pass, as
    restir/di.py::probe_fused hands them over: (fields, seed, state, the
    keyword arguments of probe_route)."""
    from strolle_tpu_torch.camera import screen_xy
    from strolle_tpu_torch.ops import offsets as shoff, rng
    from strolle_tpu_torch.restir import di, gi

    cam, surf, res, seed, _, t = args
    tries, radius, gi_kw = pass_tuning(kind, t)
    planes = (res.m,) if kind == "di" else gi.probe_planes(surf, res)
    kw = dict(di._probe_kw(surf, tries, radius, gi_kw), radii=shoff.radius_levels(radius))
    xs, ys = screen_xy(cam)
    return (surf.depth, surf.normal, surf.is_some, *planes), seed, rng.wnoise_new(seed, xs, ys), kw


def compare_probe_route(cases: dict) -> None:
    """Kernel 7's route entry against its plain version on each named
    case (``route_case``): rhs_x, rhs_y, found, the advanced stream and,
    in GI mode, jac bit-equal; the same outputs without the tables'
    pointer (the main path's launch); block 0's tables equal to
    restir/di.py::_draw_probe_tables on the card."""
    from strolle_tpu_torch.ops.kernels import probe_kernels as pk
    from strolle_tpu_torch.restir import di

    for name, (fields, seed, state, kw) in cases.items():
        n = kw["tries"] * len(kw["radii"]) * kw["n_var"]
        tables = torch.full((2, n), -999, dtype=torch.int32, device=state.device)
        got = pk.probe_route(fields, seed, state, tables_out=tables, **kw)
        main = pk.probe_route(fields, seed, state, **kw)
        want = pk.probe_route_plain(fields, seed, state, **kw)
        drawn = torch.stack(di._draw_probe_tables(seed, kw["tries"], kw["radii"], kw["n_var"],
                                                  kw["margin"], state.device))
        torch.cuda.synchronize()
        names = ("rhs_x", "rhs_y", "found", "state", "jac")
        differing = {k: int((a != b).sum()) for k, a, b in zip(names, got, want)}
        unequal_main = [k for k, a, b in zip(names, main, got) if not torch.equal(a, b)]
        tab_off = int((tables != drawn).sum())
        found = got[2].float().mean().item()
        print(f"kernel 7 route entry ({name}, {kw['mode']}, {tuple(fields[0].shape)}, "
              f"{kw['tries']} tries) vs plain: pixels differing {differing}, found share "
              f"{found:.3f}; block 0's {n} table entries vs _draw_probe_tables: {tab_off} "
              f"differ", flush=True)
        check(not any(differing.values()), f"kernel 7 route entry ({name}): differs from its "
                                           f"plain version")
        check(not unequal_main, f"kernel 7 route entry ({name}): {unequal_main} change with "
                                f"the tables' pointer")
        check(tab_off == 0, f"kernel 7 route entry ({name}): block 0's tables differ from "
                            f"_draw_probe_tables")
        check(0.0 < found < 1.0, f"kernel 7 route entry ({name}): degenerate (found {found})")


def route_cost(case: tuple, stack_case: tuple) -> dict:
    """The route entry's least work on one case: the tries of the stack
    entry on the same pass (``probe_cost``), the tables drawn once, and
    the bytes it must move (``ROUTE_BYTES``; no tables, no stack)."""
    fields, _, _, kw = case
    work = probe_cost(stack_case)
    px = work["pixels"]
    n_tab = kw["tries"] * len(kw["radii"]) * kw["n_var"]
    nbytes = px * sum(ROUTE_BYTES[kw["mode"]])
    b, by = bound(work["tries_made"] * OPS_PROBE_TRY[kw["mode"]]
                  + n_tab * OPS_PROBE_TABLE_ENTRY, nbytes)
    return {"pixels": px, "tries_made": work["tries_made"], "bytes": nbytes, "bound_ms": b,
            "bound_by": by}


def fused_pass(kind: str, args):
    """One call of restir/di.py::probe_fused on a captured pass, as the
    spatial pass makes it."""
    from strolle_tpu_torch.restir import di

    cam, surf, _, seed, _, t = args
    fields, _, state, _ = route_case(kind, args)
    tries, radius, gi_kw = pass_tuning(kind, t)
    return lambda: di.probe_fused(cam, surf, fields[3:], seed, tries, radius, state, **gi_kw)


#: Aten ops that allocate or alias and launch nothing on the device.
NO_DEVICE_WORK = ("aten.empty.", "aten.empty_like.", "aten.empty_strided.",
                  "aten.lift_fresh.", "aten.detach.")


def dispatched_ops(fn, cuda_lib=None) -> tuple[int, dict]:
    """The device operations of one call of ``fn``, counted without a
    trace: the aten ops it dispatches other than views and allocations
    (a TorchDispatchMode), and the hand-written kernels it launches
    (``LAUNCHES`` of ``cuda_lib``, this checkout's by default). Returns
    (their number, the launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    if cuda_lib is None:
        from strolle_tpu_torch.ops.kernels import cuda_lib

    ops = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or str(func).startswith(NO_DEVICE_WORK)):
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    cuda_lib.reset_launch_counts()
    with Count():
        fn()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    return len(ops) + sum(launches.values()), launches


def fused_pass_ops(cases: dict, calls: int = 5) -> dict:
    """Device operations per fused pass on each named (kind, captured
    args): counted from what one pass dispatches (``dispatched_ops``: at
    most FUSED_PASS_MAX_OPS, kernel 7 launched once) and, beside that,
    from a torch.profiler trace of ``calls`` passes (whose device records
    a short trace can lose: then it is printed as lost)."""
    out = {}
    for name, (kind, args) in cases.items():
        fn = fused_pass(kind, args)
        ops, launches = dispatched_ops(fn)
        prof = profile_frames(fn, frames=calls)
        traced = ("lost its device records" if prof is None else
                  f"{prof['device_ops_per_frame']:.1f} device ops, {prof['device_busy_ms']:.4f} "
                  f"ms busy, {prof['wall_ms']:.4f} ms wall a call")
        print(f"fused probe pass ({name}): {ops} device ops dispatched (launches {launches}); "
              f"torch.profiler over {calls} passes: {traced}", flush=True)
        check(ops <= FUSED_PASS_MAX_OPS, f"fused pass ({name}): {ops} device ops")
        check(launches == {f"probe_spatial_{kind}": 1},
              f"fused pass ({name}): launched {launches}, not kernel 7 once")
        out[name] = {"device_ops": ops, "profile": prof}
    return out


def probe_launches(frames: int) -> dict:
    """Kernel 7's launches over ``frames`` realtime frames from frame 0
    with the switch on: DI once a frame, GI on the odd tracing frames."""
    return {"probe_spatial_di": frames,
            "probe_spatial_gi": sum(f % 6 in (1, 3) for f in range(frames))}


def drive_probe_route(scene, cam, seed0: int, cfg, luts, off_mean, ref1, tol: float,
                      big=None) -> tuple:
    """RT_FRAMES realtime frames with the switch on, counted from 0:
    kernel 7 launches as ``probe_launches`` says and every other kernel as
    with the switch off; the mean image within ``tol`` of ``ref1`` and
    within 1% of the switch-off run on the same seeds (``off_mean``).
    Returns (launches, final state, the two relative differences)."""
    from strolle_tpu_torch.ops.kernels import cuda_lib

    with probe_switch(True):
        cuda_lib.reset_launch_counts()
        mean, state = drive_realtime(scene, cam, seed0, cfg, luts)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
    check_launches(launches, {**realtime_launches(RT_FRAMES, big=big),
                              **probe_launches(RT_FRAMES)}, "the probe route")
    rel_ref = abs(mean.mean().item() - ref1.mean().item()) / ref1.mean().item()
    rel_off = abs(mean.mean().item() - off_mean.mean().item()) / off_mean.mean().item()
    print(f"probe route ({RT_FRAMES} frames, launches {launches}): mean image "
          f"{mean.mean().item():.5f}, vs the reference {rel_ref:.4f}, vs the switch-off run "
          f"{rel_off:.5f}", flush=True)
    check(rel_ref < tol, f"probe route: mean off the reference by {rel_ref:.3f}")
    check(rel_off < 0.01, f"probe route: mean off the switch-off run by {rel_off:.4f}")
    return launches, state, rel_ref, rel_off


def di_routes_equal(scene, args) -> None:
    """One DI spatial pass on captured inputs through the fused probe and
    through the tensor probe: every field equal."""
    from strolle_tpu_torch.restir import di

    cam, surf, res, seed, frame, tuning = args
    with probe_switch(True):
        fused = di.di_spatial(scene, cam, surf, res, seed, frame, tuning)
        tensor = di.di_spatial(scene, cam, surf, res, seed, frame, tuning, use_pallas=False)
    for f in dataclasses.fields(fused):
        check(torch.equal(getattr(fused, f.name), getattr(tensor, f.name)),
              f"DI spatial: {f.name} differs between the fused and the tensor probe")
    print("DI spatial on frame 0's inputs: the fused probe's output equals the tensor "
          "probe's in every field", flush=True)


def drive_switches(scene, cam, state, seed: int) -> dict:
    """One frame (an odd tracing frame, GI's spatial pass runs) from
    ``state`` under each RenderConfig switch with the probe switch on:
    kernel 7's DI and GI launches follow needs_di and needs_gi, every
    channel is finite, a channel that is off is zero. Returns the
    launches per switch."""
    from strolle_tpu_torch.models.restir import RenderConfig, render_frame_fused
    from strolle_tpu_torch.ops.kernels import cuda_lib

    check(state.frame % 6 in (1, 3), "the switches run on an odd tracing frame")
    out = {}
    for name, flags in (("default", {}), ("needs_gi=False", dict(needs_gi=False)),
                        ("needs_di=False", dict(needs_di=False)),
                        ("denoise=False", dict(denoise=False))):
        cfg = RenderConfig(**flags)
        with probe_switch(True):
            cuda_lib.reset_launch_counts()
            ch, _ = render_frame_fused(scene, cam, state, seed, cfg)
            torch.cuda.synchronize()
            launches = dict(cuda_lib.LAUNCHES)
        want = {"probe_spatial_di": int(cfg.needs_di), "probe_spatial_gi": int(cfg.needs_gi)}
        for k, n in want.items():
            check(launches.get(k, 0) == n, f"{name}: {k} launched {launches.get(k, 0)} times")
        for k, v in ch.items():
            check(bool(torch.isfinite(v).all()), f"{name}: {k} not finite")
        for off, chans in ((not cfg.needs_di, ("di_diffuse", "di_specular")),
                           (not cfg.needs_gi, ("gi_diffuse", "gi_specular"))):
            for k in chans if off else ():
                check(not bool(ch[k].any()), f"{name}: {k} is not zero")
        out[name] = {"launches": launches, "image_mean": ch["image"].mean().item()}
        print(f"switch {name}: launches {launches}, image mean {ch['image'].mean().item():.5f}",
              flush=True)
    return out


def check_heatmap(scene, cam) -> dict:
    """The BVH heatmap of the dungeon: finite colours of the right shape,
    equal to the gradient of trace_cost_bvh's byte costs."""
    from strolle_tpu_torch.bvh.traverse import trace_cost_bvh
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.models import heatmap

    img = heatmap.render_heatmap(scene, cam)
    o, d = pixel_rays(cam, screen_grid(cam))
    cost = trace_cost_bvh(scene, o, d).to(torch.float32)
    want = heatmap.heatmap_gradient(cost / heatmap.HEATMAP_SCALE)
    torch.cuda.synchronize()
    check(tuple(img.shape) == (cam.height, cam.width, 3), "heatmap shape")
    check(bool(torch.isfinite(img).all()), "heatmap: non-finite colours")
    check(torch.equal(img, want), "heatmap: colours differ from trace_cost_bvh's gradient")
    check(float(cost.min()) > 0 and float(cost.max()) > float(cost.min()), "heatmap: flat cost")
    out = {"cost_bytes_mean": cost.mean().item(), "cost_bytes_max": cost.max().item(),
           "ms": time_ms(lambda: heatmap.render_heatmap(scene, cam), warmup=1, iters=3)}
    print(f"dungeon heatmap: {out}", flush=True)
    return out


def time_probe_stages(scene, cam, state, seed0: int, cfg=None, luts=None) -> tuple:
    """The DI and GI stages' ms per frame over one GI cycle each with the
    probe switch off, on, on, off (in turns); returns (turns, state)."""
    turns = []
    for i, on in enumerate((False, True, True, False)):
        with probe_switch(on):
            stages, state = time_stages(scene, cam, state, seed0 + 6 * i, cfg, luts)
        turns.append({"probe_kernel": on, "di_ms": stages["di"], "gi_ms": stages["gi"]})
    return turns, state


def train_launches(frames, needs_gi: bool = True) -> dict:
    """The launches of differentiable realtime frames (every closest hit
    through kernel A, every any hit through kernel B) at frame numbers
    ``frames``: as realtime_launches counts them, with kernel A where the
    fused route takes kernel 4."""
    a = b = 0
    for f in frames:
        a += 1 + (needs_gi and gi_sampling_frame(f))
        b += 4 + (needs_gi and (1 if gi_sampling_frame(f) else 2))
    return {"trace_closest_brute": a, "trace_anyhit_brute": b}


def finite_grads(grads, what: str, nonzero=("base_color", "emissive", "light_color")) -> dict:
    """Checks every gradient field finite and the ``nonzero`` ones not all
    zero; returns each field's largest magnitude."""
    from strolle_tpu_torch.models import train

    out = {}
    for f in train.FIELDS:
        g = getattr(grads, f)
        check(bool(torch.isfinite(g).all()), f"{what}: {f} gradient not finite")
        out[f] = g.abs().max().item()
    for f in nonzero:
        check(out[f] > 0, f"{what}: {f} gradient is zero")
    return out


def central_difference(loss_fn, params, field: str, index, eps: float) -> float:
    """(loss(p + eps) - loss(p - eps)) / (2 eps) in one component."""
    def at(step):
        x = getattr(params, field).clone()
        x[index] += step
        with torch.no_grad():
            return loss_fn(params.replace(**{field: x})).item()

    return (at(eps) - at(-eps)) / (2 * eps)


def timed_steps(step, n: int) -> tuple[list, float]:
    """Runs ``step`` n times, each timed on the host clock between
    synchronisations; returns (the results, ms of each) and the peak of
    allocated device memory over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        out.append(step(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms, torch.cuda.max_memory_allocated()


def drive_train(scene, cam) -> dict:
    """TRAIN_STEPS train_steps on Cornell at WIDTH x HEIGHT, depth
    TRAIN_DEPTH, with the counts set to 0 before and read after: kernels
    A and B once a bounce each, no other kernel; the loss and every
    gradient finite, base colour, emissive and light colour nonzero; the
    first step's base-colour (0, 0) and light-colour (0, 1) gradients
    within tests/test_grad.py's tolerance of central differences of the
    card's own loss. Returns the launches, ms per step and peak memory."""
    from strolle_tpu_torch.models import train
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.ops.kernels import cuda_lib

    target = trace_sample(scene, cam, TARGET_SEED, depth=TRAIN_DEPTH, include_sky=False) * 0.8
    params0 = train.params_from_scene(scene)
    state = {"params": params0}

    def step(_):
        loss, state["params"], grads = train.train_step(state["params"], scene, cam, target,
                                                        TRAIN_SEED, depth=TRAIN_DEPTH)
        return loss, grads

    cuda_lib.reset_launch_counts()
    results, ms, peak = timed_steps(step, TRAIN_STEPS)
    launches = dict(cuda_lib.LAUNCHES)
    print(f"train: {TRAIN_STEPS} train_steps ({WIDTH}x{HEIGHT}, depth {TRAIN_DEPTH}) launches "
          f"{launches}, ms per step {ms}, peak memory {peak / 2**20:.1f} MiB, losses "
          f"{[r[0].item() for r in results]}", flush=True)
    n = TRAIN_STEPS * (TRAIN_DEPTH + 1)
    check_launches(launches, {"trace_closest_brute": n, "trace_anyhit_brute": n}, "train_step")
    for i, (loss, grads) in enumerate(results):
        check(bool(torch.isfinite(loss)), f"train step {i}: loss not finite")
        mags = finite_grads(grads, f"train step {i}")
    check(results[-1][0].item() < results[0][0].item(), "train_step did not lower the loss")

    def loss_fn(p):
        return train.render_loss(p, scene, cam, target, TRAIN_SEED, TRAIN_DEPTH)

    fd = {}
    for field, index in (("base_color", (0, 0)), ("light_color", (0, 1))):
        g = getattr(results[0][1], field)[index].item()
        f = central_difference(loss_fn, params0, field, index, 1e-3)
        fd[f"{field}{list(index)}"] = {"grad": g, "fd": f}
        check(math.isclose(g, f, rel_tol=0.05, abs_tol=1e-4),
              f"train: {field}{index} gradient {g} against central difference {f}")
    prof = profile_frames(lambda: step(0), frames=1)
    print(f"train: gradients against central differences {fd}; largest gradients {mags}; "
          f"profile of one step {prof}", flush=True)
    return {"launches": launches, "ms_per_step": ms, "peak_mib": peak / 2**20, "fd": fd,
            "losses": [r[0].item() for r in results], "profile": prof}


def drive_restir_train(scene, cam) -> dict:
    """RESTIR_WARMUP differentiable realtime frames on Cornell at WIDTH x
    HEIGHT, then restir_train_step with DI only (needs_gi=False, SVGF on)
    and with the whole frame, all with the counts set to 0 before and read
    after: kernels A and B as the differentiable frames' schedule says, no
    other kernel; the losses and gradients finite, base colour and light
    colour nonzero; DI's base-colour (0, 1) gradient within
    tests/test_grad_restir.py's tolerance of central differences of the
    card's own loss. Returns the launches, ms per step and peak memory."""
    from strolle_tpu_torch.models import train
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
    from strolle_tpu_torch.ops.kernels import cuda_lib

    cfg = RenderConfig(differentiable=True)
    configs = {"di": RenderConfig(differentiable=True, needs_gi=False), "full": cfg}
    target = torch.full((cam.height, cam.width, 3), 0.25, device=cam.device)
    params = train.params_from_scene(scene)
    cuda_lib.reset_launch_counts()
    state = init_state(cam, device=cam.device)
    for f in range(RESTIR_WARMUP):
        ch, state = render_frame(scene, cam, state, f, cfg)
        check(bool(torch.isfinite(ch["image"]).all()), f"differentiable frame {f}: not finite")
    names = list(configs)
    results, ms, peak = timed_steps(
        lambda i: train.restir_train_step(params, scene, cam, state, target, RESTIR_SEED,
                                          config=configs[names[i]]), len(names))
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"restir_train: {RESTIR_WARMUP} differentiable frames + restir_train_step "
          f"({', '.join(names)}) launches {launches}, ms per step {dict(zip(names, ms))}, "
          f"peak memory {peak / 2**20:.1f} MiB", flush=True)
    want = train_launches(range(RESTIR_WARMUP))
    for k, v in train_launches([RESTIR_WARMUP], needs_gi=False).items():
        want[k] += v
    for k, v in train_launches([RESTIR_WARMUP]).items():
        want[k] += v
    check_launches(launches, want, "restir_train_step")
    mags = {}
    for name, (loss, new, grads) in zip(names, results):
        check(bool(torch.isfinite(loss)), f"restir_train_step ({name}): loss not finite")
        mags[name] = finite_grads(grads, f"restir_train_step ({name})",
                                  nonzero=("base_color", "light_color"))
    cfg_di = configs["di"]

    def loss_fn(p):
        return train.restir_render_loss(p, scene, cam, state, target, RESTIR_SEED, cfg_di)

    g = results[0][2].base_color[0, 1].item()
    f = central_difference(loss_fn, params, "base_color", (0, 1), 2e-3)
    print(f"restir_train: DI base_color[0, 1] gradient {g} against central difference {f}; "
          f"largest gradients {mags}", flush=True)
    check(math.isclose(g, f, rel_tol=0.05, abs_tol=1e-4),
          f"restir_train: base_color[0, 1] gradient {g} against central difference {f}")
    prof = profile_frames(lambda: train.restir_train_step(params, scene, cam, state, target,
                                                          RESTIR_SEED), frames=1)
    print(f"restir_train: profile of one whole-frame step {prof}", flush=True)
    return {"launches": launches, "ms_per_step": dict(zip(names, ms)), "peak_mib": peak / 2**20,
            "fd": {"base_color[0, 1]": {"grad": g, "fd": f}},
            "losses": {n: r[0].item() for n, r in zip(names, results)}, "profile": prof}


def alpha_cornell(scene, alpha: float = PANE_ALPHA):
    """Cornell with one pane (ALPHA_PANE, across the front of the box) on
    an alpha-blended material of base alpha ``alpha``."""
    from strolle_tpu_torch.scene.build import MeshBuilder
    from strolle_tpu_torch.scene.types import make_materials

    dev = scene.geometry.positions.device
    b = MeshBuilder()
    b.add_quad(*ALPHA_PANE, scene.materials.num_materials)
    pane = b.build(dev)
    g, m = scene.geometry, scene.materials
    geom = dataclasses.replace(g, **{
        f.name: torch.cat([getattr(g, f.name), getattr(pane, f.name)])
        for f in dataclasses.fields(g)})
    blend = make_materials([{"base_color": [0.9, 0.5, 0.2, alpha], "alpha_blend": 1}],
                           device=dev)
    mats = dataclasses.replace(m, **{
        f.name: torch.cat([getattr(m, f.name), getattr(blend, f.name)])
        for f in dataclasses.fields(m) if f.name != "tex_channels"})
    return scene.replace(geometry=geom, materials=mats, has_alpha=True)


def alpha_soup(device):
    """tests/test_alpha.py's soup (_alpha_soup_scene, seed 23) at SOUP_TRIS
    triangles, a quarter on a blend material of alpha 0.3, with its BVH
    and cluster rows."""
    from strolle_tpu_torch.bvh import scene_with_bvh
    from strolle_tpu_torch.scene.types import Geometry, Scene, make_lights, make_materials

    rs = np.random.RandomState(23)
    n = SOUP_TRIS
    centers = rs.uniform(-3.0, 3.0, (n, 1, 3)).astype(np.float32)
    verts = centers + rs.uniform(-0.4, 0.4, (n, 3, 3)).astype(np.float32)
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    mid = (rs.uniform(0, 1, n) < 0.25).astype(np.int32)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)

    geom = Geometry(positions=t(verts), normals=t(np.repeat(nrm[:, None, :], 3, axis=1)),
                    uvs=t(np.zeros((n, 3, 2))), tangents=t(np.zeros((n, 3, 4))),
                    material_id=t(mid, torch.int32))
    mats = make_materials([{"base_color": [0.8, 0.8, 0.8, 1.0]},
                           {"base_color": [1.0, 1.0, 1.0, 0.3], "alpha_blend": 1}],
                          device=device)
    return scene_with_bvh(Scene(geometry=geom, materials=mats,
                                lights=make_lights([], device=device), atlas=None,
                                sun_azimuth=0.0, sun_altitude=-1.0, has_alpha=True))


def soup_rays(n: int, device, seed: int = 3):
    """tests/test_alpha.py's soup rays (_soup_rays): origins in [-4, 4]^3,
    uniform directions, and t_max 2 (its shadow-ray length)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, device=device), torch.tensor(d, device=device),
            torch.full((n,), 2.0, device=device))


def alpha_restarts(scene, o, d, t_max, what: str) -> dict:
    """trace_closest and trace_anyhit through the restart loop, with the
    counts set to 0 before and read after; returns the hits, the
    occlusion and the launches of the MAX_ALPHA_RESTARTS restarts."""
    from strolle_tpu_torch.ops import trace
    from strolle_tpu_torch.ops.kernels import cuda_lib

    cuda_lib.reset_launch_counts()
    hit = trace.trace_closest(scene, o, d)
    occ = trace.trace_anyhit(scene, o, d, t_max)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"alpha, {what}: {o.shape[0]} rays, launches {launches} "
          f"({trace.MAX_ALPHA_RESTARTS} restarts each of trace_closest and trace_anyhit)",
          flush=True)
    return {"tri": hit.tri, "t": hit.t, "occ": occ, "launches": launches}


def drive_alpha(scene, cam, staged, device) -> dict:
    """The alpha restart loop. Cornell with a pane of alpha PANE_ALPHA:
    its WIDTH x HEIGHT primaries through trace_closest and trace_anyhit
    (t_max seeded in [1.5, 5], before and past the pane), counted (kernel
    A on every restart, 2 x MAX_ALPHA_RESTARTS launches, no other kernel),
    held against the same loop on CPU copies of the inputs (the plain
    versions): tri and occlusion equal, t within 1e-5; no hit on the pane.
    The soup (SOUP_TRIS triangles, its BVH) on WIDTH x HEIGHT seeded rays
    under "stream" (kernel 5 on every restart), "cluster" and "packet"
    (the torch BVH traversal, their closest-hit route: no launch), each
    held against the brute route with the gate raised over the soup
    (kernel A): tri and occlusion on at least 99% of the rays, t within
    1e-4 where tri agrees. Then one staged reference sample (depth DEPTH)
    and one realtime frame of the alpha Cornell, counted: kernel A only,
    finite; the sample's mean within 1% of Cornell's (``staged``, the same
    seed): the pane lets every ray through. Returns the launches."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import init_state, render_frame_fused
    from strolle_tpu_torch.ops import trace
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.scene.cornell import cornell_box

    out = {}
    n = trace.MAX_ALPHA_RESTARTS
    ascene = alpha_cornell(scene)
    o, d = pixel_rays(cam, screen_grid(cam))
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    t_max = torch.tensor(np.random.RandomState(11).uniform(1.5, 5.0, o.shape[0]).astype(
        np.float32), device=device)
    card = alpha_restarts(ascene, o, d, t_max, "Cornell with a blend pane, primaries")
    check_launches(card["launches"], {"trace_closest_brute": 2 * n}, "the alpha loop on Cornell")
    out["cornell"] = card["launches"]
    cpu = alpha_restarts(alpha_cornell(cornell_box(device="cpu")), o.cpu(), d.cpu(),
                         t_max.cpu(), "the same on CPU copies (plain versions)")
    tri_off = (card["tri"].cpu() != cpu["tri"]).sum().item()
    occ_off = (card["occ"].cpu() != cpu["occ"]).sum().item()
    hit = cpu["tri"] >= 0
    t_err = (card["t"].cpu()[hit] - cpu["t"][hit]).abs().max().item()
    pane = ascene.geometry.num_triangles - 2
    on_pane = (trace.trace_closest(ascene.replace(has_alpha=False), o, d).tri >= pane)
    on_pane = on_pane.float().mean().item()
    occluded = card["occ"].float().mean().item()
    print(f"alpha, Cornell: card vs CPU {tri_off} tri and {occ_off} occlusion mismatches, t "
          f"max |err| {t_err:.3g}; {on_pane:.4f} of the primaries meet the pane first, "
          f"{occluded:.4f} occluded", flush=True)
    check(tri_off == 0 and occ_off == 0 and t_err <= 1e-5,
          "the alpha loop on the card disagrees with its plain version")
    check(not bool((card["tri"] >= pane).any()), "a primary stopped on the blend pane")
    check(on_pane > 0.3 and 0 < occluded < 1, "degenerate alpha rays")
    out["cornell_trace_closest_ms"] = {
        "alpha": time_ms(lambda: trace.trace_closest(ascene, o, d), warmup=1, iters=5),
        "opaque": time_ms(lambda: trace.trace_closest(scene, o, d), warmup=1, iters=5)}
    print(f"alpha, Cornell: trace_closest ms (4 restarts / Cornell without the pane) "
          f"{out['cornell_trace_closest_ms']}", flush=True)

    soup = alpha_soup(device)
    so, sd, st = soup_rays(WIDTH * HEIGHT, device)
    with_gate = trace.BRUTE_FORCE_MAX_TRIS
    trace.BRUTE_FORCE_MAX_TRIS = 2 * SOUP_TRIS
    try:
        brute = alpha_restarts(soup, so, sd, st, f"the soup ({SOUP_TRIS} triangles), brute")
    finally:
        trace.BRUTE_FORCE_MAX_TRIS = with_gate
    check_launches(brute["launches"], {"trace_closest_brute": 2 * n}, "the soup's brute route")
    out["soup_brute"] = brute["launches"]
    for name in ("stream", "cluster", "packet"):
        with strategy(name):
            big = alpha_restarts(soup, so, sd, st, f"the soup under {name!r}")
        want = {"stream_trace_surface": 2 * n} if name == "stream" else {}
        check_launches(big["launches"], want, f"the soup's alpha loop under {name!r}")
        same = big["tri"] == brute["tri"]
        agree = same.float().mean().item()
        occ = (big["occ"] == brute["occ"]).float().mean().item()
        m = same & (brute["tri"] >= 0)
        t_err = (big["t"][m] - brute["t"][m]).abs().max().item()
        print(f"alpha, the soup under {name!r} vs brute: tri {agree:.5f}, occlusion {occ:.5f}, "
              f"t max |err| {t_err:.3g}", flush=True)
        check(agree >= 0.99 and occ >= 0.99 and t_err <= 1e-4,
              f"the soup's alpha loop under {name!r} disagrees with the brute route")
        out[f"soup_{name}"] = big["launches"]
    check((brute["tri"] >= 0).float().mean().item() > 0.2, "the soup's rays mostly miss")

    cuda_lib.reset_launch_counts()
    img = trace_sample(ascene, cam, SEED, depth=DEPTH, include_sky=False)
    torch.cuda.synchronize()
    out["staged_sample"] = dict(cuda_lib.LAUNCHES)
    check_launches(out["staged_sample"], {"trace_closest_brute": 2 * n * (DEPTH + 1)},
                   "the alpha Cornell's reference sample")
    cuda_lib.reset_launch_counts()
    ch, _ = render_frame_fused(ascene, cam, init_state(cam, device=device), 0)
    torch.cuda.synchronize()
    out["realtime_frame"] = dict(cuda_lib.LAUNCHES)
    check(set(out["realtime_frame"]) == {"trace_closest_brute"},
          f"the alpha Cornell's realtime frame launched {out['realtime_frame']}")
    for what, x in (("reference sample", img), ("realtime frame", ch["image"])):
        check(bool(torch.isfinite(x).all()), f"alpha Cornell {what}: non-finite values")
    rel = abs(img.mean().item() - staged.mean().item()) / staged.mean().item()
    print(f"alpha Cornell: reference sample launches {out['staged_sample']}, mean "
          f"{img.mean().item():.5f} vs Cornell's {staged.mean().item():.5f}; realtime frame "
          f"launches {out['realtime_frame']}, mean {ch['image'].mean().item():.5f}", flush=True)
    check(rel < 0.01, f"the alpha Cornell's sample is {rel:.4f} off Cornell's")
    return out


#: Phase 5i, the engine: the dungeon as a SceneEditor scene (its
#: triangles as one soup instance per material, its lights, the sun at
#: DG_SUN) with ENGINE_BOXES unit boxes of ENGINE_BOX_SIZE (a mesh and its
#: instances) that examples/stress_bvh.py's integrator moves (gravity,
#: a bounce off the floor at ENGINE_FLOOR_Y): ENGINE_STATIC_FRAMES frames
#: with no edit, then ENGINE_MOVING_FRAMES with the boxes moving every
#: frame, a light removed at the 4th and the sun moved to
#: ENGINE_SUN_MOVED at the 8th. Twenty moving frames, so that the
#: editor's 15 refits in a row end in a rebuild inside the run.
ENGINE_BOXES, ENGINE_BOX_SIZE, ENGINE_FLOOR_Y = 16, 0.3, -0.83
ENGINE_STATIC_FRAMES, ENGINE_MOVING_FRAMES = 18, 20
ENGINE_LIGHT_REMOVED_AT, ENGINE_SUN_MOVED_AT, ENGINE_SUN_MOVED = 3, 7, 0.45
#: The checkpoint is saved after this frame of the static run.
ENGINE_CHECKPOINT_FRAME = 10
#: The sun light's colour at altitudes DG_SUN and ENGINE_SUN_MOVED
#: (azimuth 0) as the JAX package's SceneEditor makes it
#: (strolle_tpu/scene/dynamics.py _make_sun, its LUTs on the CPU); the
#: port's, from LUTs made on the card, is held within SUN_COLOR_RTOL.
#: (The same colour from the direct transmittance march differs by
#: 9-15%: the check tells the LUT path from another.)
JAX_SUN_COLOR = {0.35: (85.17781066894531, 69.03987121582031, 50.20526123046875),
                 0.45: (88.12002563476562, 74.65097045898438, 58.123870849609375)}
SUN_COLOR_RTOL = 1e-3
#: The small editor scene: examples/stress_bvh.py's floor and 48 boxes
#: (578 triangles, bucket 1024: kernels 4, B and C), its camera at
#: ENGINE_SMALL_SIZE.
ENGINE_SMALL_BOXES, ENGINE_SMALL_SIZE = 48, (384, 288)


def box_triangles(size: float = 1.0) -> np.ndarray:
    """examples/minecraft.py's axis-aligned cube at the origin, [12, 3, 3]
    with outward counter-clockwise winding."""
    h = size / 2.0
    v = np.asarray([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                    [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], np.float32)
    quads = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)]
    return np.asarray([[v[a], v[b], v[c]] for a, b, c, d in quads for a, b, c in
                       ((a, b, c), (a, c, d))], np.float32)


class Boxes:
    """examples/stress_bvh.py's falling boxes: seeded positions in
    [lo, hi), sideways speeds in [-1, 1), gravity and a damped bounce off
    the floor, one 1/30 s step a frame."""

    def __init__(self, n: int, lo, hi, floor_y: float, size: float, seed: int = 3):
        rng = np.random.default_rng(seed)
        self.pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        self.vel = np.zeros((n, 3), np.float32)
        self.vel[:, 0] = rng.uniform(-1, 1, n)
        self.vel[:, 2] = rng.uniform(-1, 1, n)
        self.floor, self.size = floor_y + size / 2.0, size

    def step(self, dt: float = 1.0 / 30.0) -> None:
        self.vel[:, 1] -= 9.8 * dt
        self.pos += self.vel * dt
        grounded = self.pos[:, 1] < self.floor
        self.pos[grounded, 1] = self.floor
        self.vel[grounded, 1] = np.abs(self.vel[grounded, 1]) * 0.55

    def insert(self, ed, materials) -> None:
        for i, p in enumerate(self.pos):
            xf = np.diag([self.size, self.size, self.size, 1.0]).astype(np.float32)
            xf[:3, 3] = p
            ed.insert_instance(("box", i), mesh="unit_box",
                               material=materials[i % len(materials)], transform=xf)


def dungeon_editor(dg, device):
    """The dungeon as a SceneEditor: its material records and atlas, its
    triangles as one soup instance per material, its lights, the sun at
    DG_SUN, the unit box mesh and three box materials."""
    from strolle_tpu_torch.scene.dynamics import SceneEditor

    m = dg.materials
    host = {f.name: getattr(m, f.name).cpu().numpy() for f in dataclasses.fields(m)
            if isinstance(getattr(m, f.name), torch.Tensor)}
    records = [{k: (v[i].tolist() if v[i].ndim else v[i].item()) for k, v in host.items()}
               for i in range(m.num_materials)]
    ed = SceneEditor(materials=records, light_capacity=dg.lights.capacity,
                     sun_azimuth=dg.sun_azimuth, sun_altitude=DG_SUN,
                     atlas=dg.atlas.image.cpu().numpy(), atlas_size=dg.atlas.image.shape[0],
                     device=device)
    g = dg.geometry
    pos, nrm, uv = (x.cpu().numpy() for x in (g.positions, g.normals, g.uvs))
    mid = g.material_id.cpu().numpy()
    for k in np.unique(mid):
        sel = mid == k
        ed.insert_instance(("material", int(k)), pos[sel], material_id=int(k), normals=nrm[sel],
                           uvs=uv[sel])
    lights = {f.name: getattr(dg.lights, f.name).cpu().numpy()
              for f in dataclasses.fields(dg.lights) if not f.name.startswith("prev_")
              and f.name not in ("remap", "killed", "count")}
    for i in range(dg.lights.count):
        ed.insert_light(("light", i), **{k: v[i] for k, v in lights.items()})
    ed.insert_mesh("unit_box", box_triangles())
    mats = [ed.insert_material(("box", k), base_color=c, roughness=0.6)
            for k, c in enumerate(([0.8, 0.3, 0.2, 1.0], [0.2, 0.5, 0.8, 1.0],
                                   [0.9, 0.8, 0.2, 1.0]))]
    return ed, mats


@contextlib.contextmanager
def frame_capture():
    """Records the channels of every realtime frame and the velocity of
    its primary pass (what restir.render_frame computes, no extra work)."""
    from strolle_tpu_torch.models import restir

    seen = {"channels": [], "primary": []}
    render, primary = restir.render_frame, restir.primary_pass

    def render_rec(*a, **kw):
        ch, st = render(*a, **kw)
        seen["channels"].append(ch)
        return ch, st

    def primary_rec(*a, **kw):
        out = primary(*a, **kw)
        seen["primary"].append(out)
        return out

    restir.render_frame, restir.primary_pass = render_rec, primary_rec
    try:
        yield seen
    finally:
        restir.render_frame, restir.primary_pass = render, primary


def host_screen(cam, p: np.ndarray) -> np.ndarray:
    """World points [N, 3] -> screen xy [N, 2] in float64 on the host
    (camera.world_to_screen_xy's arithmetic)."""
    m = cam.projection_view.cpu().numpy().astype(np.float64)
    c = p.astype(np.float64) @ m[:, :3].T + m[:, 3]
    return np.stack([(0.5 * c[:, 0] / c[:, 3] + 0.5) * cam.width,
                     (0.5 * -(c[:, 1] / c[:, 3]) + 0.5) * cam.height], -1)


def box_velocity_error(ed, scene, cam, surf, velocity, disp: np.ndarray) -> np.ndarray:
    """|velocity - host projection of the displacement| on the pixels that
    hit a moving box: the hit point moved back by its box's displacement
    ``disp`` [boxes, 3], both projected with ``cam`` (the camera stands
    still)."""
    slot_box = np.full(len(ed._motion_handles) + 1, -1)
    for slot, (_, handle) in enumerate(ed._motion_handles):
        if isinstance(handle, tuple) and handle[0] == "box":
            slot_box[slot] = handle[1]
    tri = surf.tri.cpu().numpy()
    inst = scene.motion.instance_id.cpu().numpy()[np.maximum(tri, 0)]
    box = np.where(surf.is_some.cpu().numpy(), slot_box[inst], -1)
    sel = box >= 0
    p = surf.point.cpu().numpy()[sel]
    want = host_screen(cam, p) - host_screen(cam, p - disp[box[sel]])
    moving = (want ** 2).sum(-1) >= 0.01  # the frame zeroes |v|^2 < 0.001
    got = np.stack([velocity[0].cpu().numpy()[sel], velocity[1].cpu().numpy()[sel]], -1)
    return np.abs(got - want).max(-1)[moving]


def markers(scene) -> int:
    lights = scene.lights
    return int(lights.killed.sum()) + int((lights.remap >= 0).sum())


def checkpoint_frame(scene, cam, state, seed: int, config, luts, path) -> bool:
    """Saves ``state``, restores it into a fresh state of the same shape,
    and renders the next frame from both: True when every channel and
    every leaf of the new state is bit-equal. Its launches are not the
    main path's: the counts are put back as they were."""
    from strolle_tpu_torch.models.restir import init_state, render_frame
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.utils import checkpoint
    from strolle_tpu_torch.utils.pytree import tree_map

    counts = dict(cuda_lib.LAUNCHES)
    checkpoint.save(path, {"state": state})
    restored = checkpoint.restore(path, {"state": init_state(cam, device=cam.device)})["state"]
    a, sa = render_frame(scene, cam, state, seed, config, luts)
    b, sb = render_frame(scene, cam, restored, seed, config, luts)
    same = all(torch.equal(a[k], b[k]) for k in a)
    leaves = []
    tree_map(leaves.append, (sa, sb))
    half = len(leaves) // 2
    same &= all(torch.equal(x, y) for x, y in zip(leaves[:half], leaves[half:]))
    same &= sa.frame == sb.frame
    cuda_lib.LAUNCHES.clear()
    cuda_lib.LAUNCHES.update(counts)
    return same


def timed_tick(ed) -> tuple[object, float, str]:
    """One editor tick with its wall time (the device copies waited for),
    and which BVH path it took."""
    before = dict(ed.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = ed.tick()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    kind = ("rebuild" if ed.stats["bvh_rebuilds"] > before["bvh_rebuilds"] else
            "refit" if ed.stats["bvh_refits"] > before["bvh_refits"] else "none")
    return scene, ms, kind


def drive_engine_dungeon(dg, cam, device) -> dict:
    """Phase 5i (a): the dungeon editor's frames through the Renderer,
    counted, with the checks of its channels, ticks, markers and box
    velocities, the checkpoint on the card, and the static frames' mean
    against a REF_SAMPLES-sample depth-1 reference of the same scene."""
    from strolle_tpu_torch import CameraSettings, Renderer
    from strolle_tpu_torch.models.restir import RenderConfig
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.sky.atmosphere import luts_for

    t0 = time.perf_counter()
    ed, box_mats = dungeon_editor(dg, device)
    boxes = Boxes(ENGINE_BOXES, [-2.5, 0.0, 0.5], [1.5, 1.5, 3.5], ENGINE_FLOOR_Y,
                  ENGINE_BOX_SIZE)
    boxes.insert(ed, box_mats)
    setup_s = time.perf_counter() - t0
    r = Renderer()
    r.create_camera("view", cam, CameraSettings(mode="image", include_sky=True))
    config = RenderConfig(mode="image", include_sky=True)
    luts_for(ENGINE_SUN_MOVED, device)  # made before the counted run, like the kernels
    ticks = {"rebuild": [], "refit": [], "none": []}
    acc, n_acc, per_frame, frame_ms, vel_err, ckpt_same = None, 0, [], [], [], None
    static_scene, sun_colors = None, []
    frames = ENGINE_STATIC_FRAMES + ENGINE_MOVING_FRAMES
    cuda_lib.reset_launch_counts()
    with frame_capture() as seen:
        for f in range(frames):
            moving = f - ENGINE_STATIC_FRAMES
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            before = boxes.pos.copy()
            if moving >= 0:
                boxes.step()
                boxes.insert(ed, box_mats)
                if moving == ENGINE_LIGHT_REMOVED_AT:
                    ed.remove_light(("light", 2))
                if moving == ENGINE_SUN_MOVED_AT:
                    ed.update_sun(altitude=ENGINE_SUN_MOVED)
            scene, tick_ms, kind = timed_tick(ed)
            ticks[kind].append(tick_ms)
            luts = luts_for(scene.sun_altitude, device)
            img = r.render_camera("view", scene, 20000 + f, luts)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end))
            per_frame.append((markers(scene), scene.lights.count))
            if f == 0 or moving == ENGINE_SUN_MOVED_AT:
                sun_colors.append((scene.sun_altitude, scene.lights.color[0].tolist(),
                                   scene.lights.prev_color[0].tolist()))
            for k, v in seen["channels"][-1].items():
                check(bool(torch.isfinite(v).all()), f"engine frame {f}: {k} not finite")
            check(tuple(img.shape) == (cam.height, cam.width, 3), "engine image shape")
            if 6 <= f < ENGINE_STATIC_FRAMES:
                acc = img if acc is None else acc + img
                n_acc += 1
                static_scene = scene
            if moving >= 1:  # frame 0 of the run moved nothing
                surf, velocity = seen["primary"][-1]
                vel_err.append(box_velocity_error(ed, scene, cam, surf, velocity,
                                                  boxes.pos - before))
            if f == ENGINE_CHECKPOINT_FRAME:
                with tempfile.TemporaryDirectory() as path:
                    ckpt_same = checkpoint_frame(scene, cam, r._cameras["view"].state,
                                                 20000 + f + 1, config, luts, path)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"engine: dungeon editor, {frames} frames through the Renderer: launches {launches}, "
          f"stats {ed.stats}, ticks (ms) {ticks}", flush=True)
    check_launches(launches, realtime_launches(frames, big=STRATEGY_KERNELS["stream"]),
                   "the engine's dungeon frames")
    check(ckpt_same is True, "a frame from the restored checkpoint differs from the live one")
    check(ed.stats["bvh_refits"] >= 15 and ed.stats["bvh_rebuilds"] >= 2,
          f"no refits or no rebuild after the refit streak: {ed.stats}")
    removal = ENGINE_STATIC_FRAMES + ENGINE_LIGHT_REMOVED_AT
    with_markers = [f for f, (n, _) in enumerate(per_frame) if n > 0]
    check(with_markers == [removal], f"kill/remap markers on frames {with_markers}, "
          f"not on frame {removal} alone")
    check(per_frame[removal][1] == dg.lights.count, "the light count after the removal")
    print(f"engine: the sun's colour (altitude, colour, previous colour): {sun_colors}; the "
          f"JAX package's: {JAX_SUN_COLOR}", flush=True)
    (a0, c0, _), (a1, c1, p1) = sun_colors
    for got, want in ((c0, JAX_SUN_COLOR[a0]), (c1, JAX_SUN_COLOR[a1]), (p1, JAX_SUN_COLOR[a0])):
        rel = max(abs(g - w) / w for g, w in zip(got, want))
        check(rel < SUN_COLOR_RTOL, f"the sun's colour {got} is {rel:.2e} off the JAX {want}")
    errs = np.concatenate(vel_err)
    med = float(np.median(errs))
    print(f"engine: box velocity against the host projection of the displacement: median "
          f"{med:.5f} px, 99th percentile {float(np.percentile(errs, 99)):.4f} px over "
          f"{errs.size} moving box pixels", flush=True)
    check(errs.size > 1000, f"only {errs.size} moving box pixels")
    check(med < 0.1, f"box velocity off its host projection by {med:.4f} px (median)")
    ref1 = reference_depth1(static_scene, cam, include_sky=True, luts=luts_for(DG_SUN, device))
    mean = acc / n_acc
    rel = abs(mean.mean().item() - ref1.mean().item()) / ref1.mean().item()
    print(f"engine: mean image of static frames 6-{ENGINE_STATIC_FRAMES - 1} "
          f"{mean.mean().item():.5f} vs {REF_SAMPLES}-sample sky reference depth 1 "
          f"{ref1.mean().item():.5f}: relative difference {rel:.4f}", flush=True)
    check(rel < DG_RT_TOLERANCE, f"engine realtime mean off the reference by {rel:.3f}")
    moving_ms = frame_ms[ENGINE_STATIC_FRAMES:]
    return {"editor": ed, "boxes": boxes, "box_mats": box_mats, "scene": scene,
            "renderer": r, "launches": launches,
            "info": {"setup_s": setup_s, "stats": dict(ed.stats),
                     "triangles": scene.geometry.num_triangles,
                     "clusters": int(scene.clusters.shape[0]),
                     # the first build (the atlas and materials uploaded
                     # too), then the streak's rebuild
                     "tick_ms_rebuilds": ticks["rebuild"],
                     "tick_ms_refit_median": statistics.median(ticks["refit"]),
                     "tick_ms_unchanged_median": statistics.median(ticks["none"]),
                     "tick_counts": {k: len(v) for k, v in ticks.items()},
                     "frame_ms_static": statistics.median(frame_ms[:ENGINE_STATIC_FRAMES]),
                     "frame_ms_moving": statistics.median(moving_ms),
                     "velocity_err_median_px": med, "velocity_pixels": int(errs.size),
                     "mean_vs_reference": rel}}


def hold_engine_stream(scene, cam, device, err: dict) -> None:
    """Phase 5i (c): kernels 5 and 6 through their wrappers against their
    plain versions on the refitted editor scene (padded rows, empty-leaf
    nodes, boxes loosened by refits, clusters rebuilt): the primaries and
    the bounce-0 shadow rays toward the lights."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    for what, anyhit, (o, d, t_max) in (("primary", False, (po, pd, None)),
                                        ("lights", True, (so, sd, slen))):
        x = stream_inputs(scene, o, d, t_max)
        if anyhit:
            got = (sk.stream_trace_anyhit(x["clus"], x["rows"], o, d, t_max),)
        else:
            g = sk.stream_trace_surface(x["clus"], x["rows"], o, d)
            got = (g["t"], torch.where(g["hit"], g["tri"], -1), g["u"], g["v"])
        want = stream_plain(x, anyhit)
        torch.cuda.synchronize()
        k = "6" if anyhit else "5"
        n = o.numel() // 3
        name = f"kernel {k} (engine dungeon, refitted, {what}, {n} rays)"
        mism, e = stream_mismatch(got, want, anyhit, name)
        rate = got[0].float().mean().item() if anyhit else (got[1] >= 0).float().mean().item()
        print(f"{name} vs plain: mismatches {mism}, max err {e:.3g}, "
              f"{'occluded' if anyhit else 'hit'} rate {rate:.3f}", flush=True)
        check(mism <= 1e-5 * n, f"{name}: {mism} rays differ from the plain version")
        check(0.0 < rate, f"{name}: degenerate")
        err[k] = max(err[k], e)


def small_editor(device):
    """examples/stress_bvh.py's scene: its materials, the sun at 0.6, its
    key light and a fill light (removed later), the floor and the unit
    box mesh, ENGINE_SMALL_BOXES boxes falling from 6-16 units."""
    from strolle_tpu_torch.camera import make_camera
    from strolle_tpu_torch.scene.dynamics import SceneEditor

    materials = [
        {"base_color": [0.75, 0.75, 0.75, 1.0], "roughness": 1.0},
        {"base_color": [0.8, 0.3, 0.2, 1.0], "roughness": 0.6},
        {"base_color": [0.2, 0.5, 0.8, 1.0], "roughness": 0.6},
        {"base_color": [0.9, 0.8, 0.2, 1.0], "roughness": 0.6},
    ]
    ed = SceneEditor(materials=materials, sun_altitude=0.6, sun_azimuth=0.3, device=device)
    ed.insert_light("key", pos=[6.0, 10.0, 6.0], radius=0.3, color=[60.0, 58.0, 52.0])
    ed.insert_light("fill", pos=[-6.0, 8.0, 4.0], radius=0.3, color=[20.0, 20.0, 24.0])
    floor = np.asarray([[[-12, 0, -12], [12, 0, -12], [12, 0, 12]],
                        [[-12, 0, -12], [12, 0, 12], [-12, 0, 12]]], np.float32)
    ed.insert_instance("floor", floor, material_id=0)
    ed.insert_mesh("unit_box", box_triangles())
    boxes = Boxes(ENGINE_SMALL_BOXES, [-6, 6, -6], [6, 16, 6], 0.0, 1.0)
    boxes.insert(ed, [1, 2, 3])
    w, h = ENGINE_SMALL_SIZE
    cam = make_camera(eye=[0.0, 7.0, 18.0], target=[0.0, 3.0, 0.0], fov_y=np.deg2rad(55.0),
                      width=w, height=h, device=device)
    return ed, boxes, cam


def drive_engine_small(device, err: dict) -> dict:
    """Phase 5i (b), (c) for kernels 4 and B, and (e): the small editor
    scene in a Viewer with its HTTP server up: the edit pattern (boxes
    every frame, the fill light removed at the 4th, the sun moved at the
    8th) in "image" mode, then one frame in each of the viewer's modes
    ("reference" twice: kernel C accumulates), counted; one GET of the
    frame; kernels A, B and 4 against their plain versions on the last
    scene."""
    import urllib.request

    from PIL import Image

    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.ops.trace import packed_tri_rows
    from strolle_tpu_torch.viewer import MODES, Viewer

    ed, boxes, cam = small_editor(device)
    v = Viewer(ed, cam, include_sky=False)  # kernel C takes no sky
    port = v.start_server("127.0.0.1", 0)
    frame_ms = []
    try:
        cuda_lib.reset_launch_counts()
        with frame_capture() as seen:
            for f in range(ENGINE_STATIC_FRAMES // 2):
                boxes.step()
                boxes.insert(ed, [1, 2, 3])
                if f == ENGINE_LIGHT_REMOVED_AT:
                    ed.remove_light("fill")
                if f == ENGINE_SUN_MOVED_AT:
                    ed.update_sun(altitude=0.5)
                v.render_one(seed=30000 + f)
                frame_ms.append(v.state()["frame_ms"])
            for m in MODES:
                v.push_control({"mode": m})
                for _ in range(2 if m == "reference" else 1):
                    u8 = v.render_one()
                    check(u8.shape == (cam.height, cam.width, 3) and u8.dtype == np.uint8,
                          f"viewer mode {m}: frame {u8.shape} {u8.dtype}")
                if m == "reference":
                    acc = v.renderer._cameras["view"].state
                    check(bool((acc.samples == 2).all()), "reference mode did not accumulate")
            for i, ch in enumerate(seen["channels"]):
                for k, x in ch.items():
                    check(bool(torch.isfinite(x).all()), f"viewer frame {i}: {k} not finite")
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.jpg", timeout=30) as resp:
            jpg = resp.read()
            ctype = resp.headers.get("Content-Type")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=30) as resp:
            state = json.loads(resp.read())
    finally:
        v.stop_server()
    size = Image.open(io.BytesIO(jpg)).size
    print(f"engine: small editor scene in the viewer ({len(frame_ms)} edit frames, "
          f"{len(MODES)} modes): launches {launches}, stats {ed.stats}; GET /frame.jpg: "
          f"{ctype}, {len(jpg)} bytes, {size}; /state {state}", flush=True)
    check(ctype == "image/jpeg" and size == (cam.width, cam.height), "GET /frame.jpg")
    check(state["frame"] == len(frame_ms) + len(MODES) + 1, "viewer frame counter")
    for k in ("trace_surface", "trace_anyhit_brute"):
        check(launches.get(k, 0) > 0, f"the small editor scene never launched {k}")
    check(launches.get("trace_sample_megakernel", 0) == 2, "kernel C launches in reference mode")
    for k in ALL_KERNELS:
        if k not in ("trace_surface", "trace_anyhit_brute", "trace_sample_megakernel"):
            check(launches.get(k, 0) == 0, f"the small editor scene launched {k}")
    check(ed.stats["bvh_refits"] > 0, "the small scene's boxes never took the refit path")

    scene = ed.tick()
    check(scene.geometry.num_triangles == 1024 and scene.bvh.max_depth >= 48,
          "the small editor scene's bucket")
    err["4"] = max(err["4"], compare_surface_kernel({"engine_small": scene}, cam, device))
    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    ea, eb = hold_brute(packed_tri_rows(scene), so, sd, slen, "engine small scene, shadow rays")
    err["A"], err["B"] = max(err["A"], ea), max(err["B"], eb)
    return {"launches": launches,
            "info": {"stats": dict(ed.stats), "frame_ms_edits": statistics.median(frame_ms),
                     "triangles": scene.geometry.num_triangles, "jpeg_bytes": len(jpg)}}


def drive_engine(dg, dcam, device, err: dict) -> dict:
    """Phase 5i: the engine. Returns its launches (for the kernels line)
    and its numbers."""
    from strolle_tpu_torch.sky.atmosphere import luts_for

    dungeon_run = drive_engine_dungeon(dg, dcam, device)
    hold_engine_stream(dungeon_run["scene"], dcam, device, err)
    small = drive_engine_small(device, err)
    # (f) one engine frame (the boxes' step, the tick, the frame) under
    # the profiler, and a rebuild timed on its own
    ed, boxes, mats = dungeon_run["editor"], dungeon_run["boxes"], dungeon_run["box_mats"]
    r = dungeon_run["renderer"]
    holder = {"seed": 40000}

    def engine_frame():
        boxes.step()
        boxes.insert(ed, mats)
        scene = ed.tick()
        r.render_camera("view", scene, holder["seed"], luts_for(scene.sun_altitude, device))
        holder["seed"] += 1

    profile = profile_frames(engine_frame, frames=2)
    ed.remove_instance(("box", 0))  # a new instance: a full rebuild
    boxes.insert(ed, mats)
    _, rebuild_ms, kind = timed_tick(ed)
    check(kind == "rebuild", "the forced rebuild")
    launches = collections.Counter(dungeon_run["launches"])
    launches.update(small["launches"])
    info = {"dungeon": dungeon_run["info"], "small": small["info"],
            "profile_engine_frame": profile, "forced_rebuild_ms": rebuild_ms}
    print(f"engine: {json.dumps(info)}", flush=True)
    return {"launches": launches, "info": info}


#: Phase 5j, the multi-device layer: the two-rank check's ranks (gloo
#: subprocesses on the one card, each killed after MULTI_CHILD_TIMEOUT s),
#: the seeds of the Cornell and the dungeon split GI cycles.
MULTI_RANKS = 2
MULTI_CHILD_TIMEOUT = 300
MULTI_FRAME_SEED = 1000
MULTI_DG_SEED = 9000
MULTI_FRAMES = 6
#: The two-rank Cornell frame of the earlier split, where each rank held
#: the whole state and split only its trace calls (NVIDIA H100 80GB HBM3,
#: 700.00 W): ms a frame a rank, printed beside the row-split frame's.
WHOLE_STATE_TWO_RANK_CORNELL_MS = (620.7, 665.7)
#: Phase 5k, the examples: frames (and fit_materials' steps) at each
#: example's default size; stress_large's seeded subset of image rows on
#: which kernels 5 and 6 are held against their plain versions.
EXAMPLE_FRAMES = 3
EXAMPLE_FIT_STEPS = 5
STRESS_SUBSET_ROWS = 32


def images_match(single: torch.Tensor, split: torch.Tensor) -> dict:
    """tests/test_sharding.py's criteria: under 1% of pixels off by more
    than 1e-5, the median difference at most 1e-6, no row with 25% of its
    pixels off. Returns the numbers, and whether the two are bit-equal."""
    diff = (single - split).abs().amax(-1)
    bad = diff > 1e-5
    out = {"bit_equal": bool(torch.equal(single, split)), "frac_bad": bad.float().mean().item(),
           "median": diff.median().item(), "row_max": bad.float().mean(1).max().item()}
    out["ok"] = out["frac_bad"] < 0.01 and out["median"] <= 1e-6 and out["row_max"] < 0.25
    return out


def tree_leaves(tree) -> list:
    from strolle_tpu_torch.utils.pytree import tree_map

    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def grad_diffs(grads, grads_m) -> dict:
    """Per gradient field: the largest difference, the field's largest
    component, bit-equality and rtol 1e-4, atol 1e-6 elementwise."""
    from strolle_tpu_torch.models.train import FIELDS

    out = {}
    for f in FIELDS:
        a = getattr(grads, f)
        b = getattr(grads_m, f).to(a.device)
        out[f] = {"max_abs_diff": (a - b).abs().max().item(), "largest": a.abs().max().item(),
                  "bit_equal": bool(torch.equal(a, b)),
                  "elementwise_ok": bool(torch.allclose(b, a, rtol=1e-4, atol=1e-6))}
    return out


def block_grads(params, scene, cam, target, n: int):
    """The training step's loss and gradients as ``n`` ranks compute them,
    in one process: each block of rows differentiated alone
    (``models.train.rows_loss``), the blocks summed in rank order, the
    float32 order of the ranks' all-reduce."""
    from strolle_tpu_torch.models import train

    parts = [train._value_and_grad(
        lambda p, i=i: train.rows_loss(p, scene, cam, target, TRAIN_SEED, TRAIN_DEPTH, i, n),
        params) for i in range(n)]
    loss, grads = parts[0]
    for l2, g2 in parts[1:]:
        loss = loss + l2
        grads = train.TrainableParams(*(getattr(grads, f) + getattr(g2, f) for f in train.FIELDS))
    return loss, grads


def counted(fn, launches: dict, name: str):
    """``fn()`` with the launch counts set to 0 before and read after (into
    ``launches[name]``), timed with CUDA events: (result, ms)."""
    from strolle_tpu_torch.ops.kernels import cuda_lib

    cuda_lib.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    launches[name] = dict(cuda_lib.LAUNCHES)
    return out, start.elapsed_time(end)


def digests(tree) -> list:
    """SHA-256 of every tensor of ``tree``, in order: equal digests are
    equal bytes."""
    import hashlib

    return [hashlib.sha256(x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
            .hexdigest() for x in tree_leaves(tree)]


def split_frame_digests(channels: list, state) -> dict:
    """The digests the two-rank check compares: every channel of every
    frame, then every [H, ...] leaf of the state after the cycle."""
    from strolle_tpu_torch.parallel.frame_sharding import ROW_FIELDS

    return {"frames": [digests(ch) for ch in channels],
            "state": digests([getattr(state, f) for f in ROW_FIELDS])}


def gather_meter(sharding, log: list):
    """``sharding.gather_rows`` replaced by a timed, counted one: each call
    appends (bytes this rank sends, bytes it receives, ms between two
    device synchronisations) to ``log``. Returns the restoring call."""
    import torch.distributed as dist

    plain = sharding.gather_rows

    def gather(tree):
        sent = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(tree)
        torch.cuda.synchronize()
        log.append((sent, sent * (dist.get_world_size() - 1), (time.perf_counter() - t0) * 1e3))
        return out

    sharding.gather_rows = gather
    return lambda: setattr(sharding, "gather_rows", plain)


def rank_child(argv: list) -> int:
    """One rank of phase 5j's two-rank check (``chip_smoke.py --rank-child
    RANK WORLD STORE OUT``): a gloo rank on the one card, which renders
    the Cornell sample, one GI cycle of Cornell (kernels 4 and B) and one
    of the dungeon with the sky (kernels 5 and 6), each on its own rows
    of the state (``render_frame_sharded``), and one training step with
    the rows split over the ranks, counted; times the sample, the step
    and a second GI cycle of each scene, meters the dungeon's gathers of
    a third, and profiles one dungeon frame; and writes its results
    (rank 0 also the sample, the digests of each cycle's gathered
    channels and state, and the gradients) to OUT."""
    import torch.distributed as dist

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    from strolle_tpu_torch.models.restir import RenderConfig
    from strolle_tpu_torch.models.train import FIELDS, params_from_scene, train_step_sharded
    from strolle_tpu_torch.ops.kernels import cuda_lib
    from strolle_tpu_torch.parallel import frame_sharding as fs
    from strolle_tpu_torch.parallel import sharding
    from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
    from strolle_tpu_torch.scene.demo import dungeon_camera

    cuda_lib.library()
    mesh = sharding.make_mesh(world)
    scene, cam = cornell_box(), cornell_camera(WIDTH, HEIGHT)
    launches, ms, info = {}, {}, {}
    img, _ = counted(
        lambda: sharding.render_sample_sharded(mesh, scene, cam, SEED, depth=DEPTH), launches,
        "sample")
    ms["sample"] = time_ms(lambda: sharding.render_sample_sharded(mesh, scene, cam, SEED,
                                                                  depth=DEPTH), 0, 3)

    # Cornell's GI cycle on this rank's rows
    rep = fs.replicate_scene(mesh, scene)
    cstate = fs.init_state_sharded(mesh, cam)

    def cornell_cycle():
        nonlocal cstate
        out = []
        for f in range(MULTI_FRAMES):
            ch, cstate = fs.render_frame_sharded(mesh, rep, cam, cstate, MULTI_FRAME_SEED + f)
            out.append(ch)
        return out

    blocks, _ = counted(cornell_cycle, launches, "cornell_frames")
    info["cornell_rows"] = sorted({x.shape[0] for ch in blocks for x in ch.values()} | {
        x.shape[0] for x in tree_leaves([getattr(cstate, f) for f in fs.ROW_FIELDS])})
    got_cornell = split_frame_digests([fs.gather_frame(ch) for ch in blocks],
                                      fs.gather_frame(cstate))
    del blocks
    _, t = counted(cornell_cycle, {}, "x")  # the next GI cycle, warm
    ms["cornell_frame"] = t / MULTI_FRAMES

    # the dungeon's GI cycle on this rank's rows
    dg, dluts = dungeon_scene(cam.device)
    dcam = dungeon_camera(WIDTH, HEIGHT)
    dcfg = RenderConfig(include_sky=True)
    state = fs.init_state_sharded(mesh, dcam)
    info["state_rows"] = sorted({x.shape[0] for x in tree_leaves(
        [getattr(state, f) for f in fs.ROW_FIELDS])})

    def frame():
        nonlocal state
        ch, state = fs.render_frame_sharded(mesh, dg, dcam, state, MULTI_DG_SEED + state.frame,
                                            dcfg, dluts)
        return ch

    def cycle():
        return [frame() for _ in range(MULTI_FRAMES)]

    blocks, _ = counted(cycle, launches, "frames")
    info["channel_rows"] = sorted({x.shape[0] for ch in blocks for x in ch.values()})
    whole = [fs.gather_frame(ch) for ch in blocks]
    got = split_frame_digests(whole, fs.gather_frame(state))
    del blocks, whole
    _, t = counted(cycle, {}, "x")  # the next GI cycle, warm
    ms["frame"] = t / MULTI_FRAMES
    log = []
    restore = gather_meter(sharding, log)
    try:
        cycle()
    finally:
        restore()
    sent, received, g_ms = (sum(c) / MULTI_FRAMES for c in zip(*log))
    info["gathers_per_frame"] = {"calls": len(log) / MULTI_FRAMES, "bytes_sent": sent,
                                 "bytes_received": received, "ms": g_ms}
    info["profile"] = profile_frames(frame, frames=1)
    info["dispatched_ops_per_frame"], _ = dispatched_ops(frame)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=cam.device)

    def step():
        return train_step_sharded(mesh, params_from_scene(scene), scene, cam, target, TRAIN_SEED,
                                  depth=TRAIN_DEPTH)

    (loss, _, grads), _ = counted(step, launches, "train")
    ms["step"] = time_ms(step, 0, 1)
    # the collectives alone: the sample's all-gather and the step's all-reduce
    block, _, _ = sharding.sample_rows(mesh, scene, cam, SEED, DEPTH)
    ms["gather_sample_rows"] = time_ms(lambda: sharding.gather_rows(block), warmup=1, iters=5)
    g = [getattr(grads, f) for f in FIELDS]
    ms["all_reduce_grads"] = time_ms(lambda: sharding.all_reduce_sum(g), warmup=1, iters=5)
    res = {"rank": rank, "launches": launches, "ms": ms, "rows": block.shape[0], "info": info}
    if rank == 0:
        res.update(sample=img.cpu(), digests=got, cornell_digests=got_cornell, loss=loss.cpu(),
                   grads=grads)
    torch.save(res, f"{out}.rank{rank}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_ranks(world: int, tmp: str) -> list:
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    script = os.path.abspath(__file__)
    return [subprocess.Popen([sys.executable, script, "--rank-child", str(r), str(world),
                              os.path.join(tmp, "store"), os.path.join(tmp, "out")],
                             cwd=os.path.dirname(script), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs: list, tmp: str) -> list:
    """Each rank's results; every child killed after MULTI_CHILD_TIMEOUT s."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=MULTI_CHILD_TIMEOUT))
            except subprocess.TimeoutExpired:
                outs.append(("", "timed out"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} of the two-rank check failed (rc {p.returncode}):\n"
              f"{err[-3000:]}")
    return [torch.load(os.path.join(tmp, f"out.rank{r}"), weights_only=False)
            for r in range(len(procs))]


def drive_multidevice(scene, cam, img, dg, dcam, dluts) -> dict:
    """Phase 5j: the multi-device layer at 800x608. At world size 1 under
    NCCL (make_mesh(1)), counted: the split Cornell sample (kernel C)
    bit-equal to ``trace_sample`` (``img``); one 6-frame GI cycle of the
    dungeon with the sky through replicate_scene, init_state_sharded and
    render_frame_sharded with STROLLE_PROBE_KERNEL=1 (kernels 5 and 6 as
    the schedule says, kernel 7 never: a mesh takes the tensor probe),
    every channel and state leaf bit-equal to render_frame's on the same
    seeds with the switch off, with the same launches, and one more
    frame's dispatched device ops equal to the unsplit frame's (every
    gather the identity); train_step_sharded (kernels A and B) against
    train_step; dryrun_multichip(1). Then MULTI_RANKS gloo ranks in
    subprocesses on the one card, each holding and computing its own
    rows: the sample, one GI cycle of Cornell and one of the dungeon and
    one training step, held against the unsplit ones (the sample to
    tests/test_sharding.py's criteria; each cycle's gathered channels and
    state bit-equal to an unsplit cycle, the dungeon's that of the
    world-size-1 check; gradients at rtol 1e-4, atol 1e-6), each rank's
    counts, times, profile and gathers printed.
    Returns the launches of the world-size-1 runs and the numbers."""
    import torch.distributed as dist

    from strolle_tpu_torch.entry import dryrun_multichip
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
    from strolle_tpu_torch.models.train import params_from_scene, train_step, train_step_sharded
    from strolle_tpu_torch.parallel import frame_sharding as fs
    from strolle_tpu_torch.parallel import sharding

    print(f"multi-device: torch {torch.__version__}, nccl available "
          f"{dist.is_nccl_available()}, gloo available {dist.is_gloo_available()}", flush=True)
    mesh = sharding.make_mesh(1)
    check(dist.get_backend() == "nccl", f"world size 1 runs {dist.get_backend()}, not nccl")
    launches, ms, info = {}, {}, {}

    # (a) the sample
    sample, ms["sample_split"] = counted(
        lambda: sharding.render_sample_sharded(mesh, scene, cam, SEED, depth=DEPTH), launches,
        "sample")
    check_launches(launches["sample"], {"trace_sample_megakernel": 1}, "split sample")
    check(torch.equal(sample, img), "the split sample differs from trace_sample")
    ms["sample_split"] = time_ms(
        lambda: sharding.render_sample_sharded(mesh, scene, cam, SEED, depth=DEPTH), 1, 5)
    ms["sample_unsplit"] = time_ms(
        lambda: trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False), 1, 5)

    # (b) one GI cycle of the dungeon, split and unsplit in lockstep
    dcfg = RenderConfig(include_sky=True)
    rep = fs.replicate_scene(mesh, dg)
    split = fs.init_state_sharded(mesh, dcam)
    state = init_state(dcam, device=dcam.device)
    ms_split = ms_unsplit = 0.0
    frame_launches, unsplit_launches = collections.Counter(), collections.Counter()
    unsplit_frames = []
    for f in range(MULTI_FRAMES):
        with probe_switch(True):
            (ch_m, split), t = counted(
                lambda: fs.render_frame_sharded(mesh, rep, dcam, split, MULTI_DG_SEED + f, dcfg,
                                                dluts), launches, "frame")
        frame_launches.update(launches.pop("frame"))
        ms_split += t
        (ch, state), t = counted(
            lambda: render_frame(dg, dcam, state, MULTI_DG_SEED + f, dcfg, dluts), launches, "x")
        unsplit_launches.update(launches.pop("x"))
        ms_unsplit += t
        for k in ch:
            check(torch.equal(ch[k], ch_m[k]), f"split dungeon frame {f}: {k} differs")
        unsplit_frames.append(digests(ch))
    for a, b in zip(tree_leaves(state), tree_leaves(split), strict=True):
        check(torch.equal(a, b), "split dungeon frames: a state leaf differs")
    want = split_frame_digests([], state)
    want["frames"] = unsplit_frames
    launches["dungeon_frames"] = dict(frame_launches)
    check_launches(frame_launches, realtime_launches(MULTI_FRAMES, big=STRATEGY_KERNELS["stream"]),
                   "split dungeon frames (STROLLE_PROBE_KERNEL=1)")
    check(frame_launches == unsplit_launches,
          f"split dungeon frames launch {dict(frame_launches)}, unsplit {dict(unsplit_launches)}")
    ms["dungeon_frame_split"] = ms_split / MULTI_FRAMES
    ms["dungeon_frame_unsplit"] = ms_unsplit / MULTI_FRAMES
    # one more frame each, from the same state: at world size 1 every gather
    # is the identity, so the split frame dispatches the unsplit frame's ops
    info["world1_dispatched_ops"] = {
        "split": dispatched_ops(lambda: fs.render_frame_sharded(
            mesh, rep, dcam, split, MULTI_DG_SEED + MULTI_FRAMES, dcfg, dluts))[0],
        "unsplit": dispatched_ops(lambda: render_frame(
            dg, dcam, state, MULTI_DG_SEED + MULTI_FRAMES, dcfg, dluts))[0]}
    check(info["world1_dispatched_ops"]["split"] == info["world1_dispatched_ops"]["unsplit"],
          f"world size 1: the split frame's ops differ: {info['world1_dispatched_ops']}")
    del split, state, ch, ch_m

    # (c) the training step
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=cam.device)
    params = params_from_scene(scene)
    def split_step():
        return train_step_sharded(mesh, params, scene, cam, target, TRAIN_SEED, depth=TRAIN_DEPTH)

    def unsplit_step():
        return train_step(params, scene, cam, target, TRAIN_SEED, depth=TRAIN_DEPTH)

    (loss_m, _, grads_m), _ = counted(split_step, launches, "train")
    n = TRAIN_DEPTH + 1
    check_launches(launches["train"], {"trace_closest_brute": n, "trace_anyhit_brute": n},
                   "train_step_sharded")
    loss, _, grads = unsplit_step()
    ms["step_split"] = time_ms(split_step, 0, 1)
    ms["step_unsplit"] = time_ms(unsplit_step, 0, 1)
    check(math.isclose(loss.item(), loss_m.item(), rel_tol=1e-5), "world size 1 step: loss")
    info["world1_grads"] = grad_diffs(grads, grads_m)
    for f, d in info["world1_grads"].items():
        check(d["elementwise_ok"], f"world size 1 step: {f} gradients differ: {d}")
    loss_b, grads_b = block_grads(params, scene, cam, target, MULTI_RANKS)

    # (d) the dry run
    (_, ms["dryrun"]) = counted(lambda: dryrun_multichip(1), launches, "dryrun")

    # (e) the unsplit Cornell cycle, then the ranks, each on its own rows:
    # their Cornell cycle is held to this one, their dungeon cycle to (b)'s
    cstate = init_state(cam, device=cam.device)
    cornell_frames = []
    for f in range(MULTI_FRAMES):
        ch, cstate = render_frame(scene, cam, cstate, MULTI_FRAME_SEED + f)
        cornell_frames.append(digests(ch))
    want_cornell = split_frame_digests([], cstate)
    want_cornell["frames"] = cornell_frames
    ms["cornell_frame_unsplit"] = time_ms(
        lambda: render_frame(scene, cam, cstate, MULTI_FRAME_SEED + MULTI_FRAMES), 1, 3)
    del cstate, ch
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = wait_ranks(spawn_ranks(MULTI_RANKS, tmp), tmp)
        info["two_rank_wall_s"] = time.perf_counter() - t0
    r0 = ranks[0]
    info["two_rank_sample"] = images_match(img.cpu(), r0["sample"])
    check(info["two_rank_sample"]["ok"],
          f"two ranks: the sample is off the unsplit one: {info['two_rank_sample']}")
    for f, (a, b) in enumerate(zip(want["frames"], r0["digests"]["frames"], strict=True)):
        check(a == b, f"two ranks: dungeon frame {f} differs from the unsplit frame "
              f"(channels equal: {[x == y for x, y in zip(a, b)]})")
    check(want["state"] == r0["digests"]["state"],
          "two ranks: the dungeon state after the cycle differs from the unsplit one")
    info["two_rank_dungeon_bit_equal"] = True
    for f, (a, b) in enumerate(zip(want_cornell["frames"], r0["cornell_digests"]["frames"],
                                   strict=True)):
        check(a == b, f"two ranks: Cornell frame {f} differs from the unsplit frame "
              f"(channels equal: {[x == y for x, y in zip(a, b)]})")
    check(want_cornell["state"] == r0["cornell_digests"]["state"],
          "two ranks: the Cornell state after the cycle differs from the unsplit one")
    info["two_rank_cornell_bit_equal"] = True
    rows = HEIGHT // MULTI_RANKS
    # The ranks' gradients against the same blocks differentiated and summed
    # in one process (the all-reduce's float32 order): rtol 1e-4, atol 1e-6
    # elementwise. Against train_step's one sum over every pixel: within
    # 1e-3 of each field's largest component (the light gradients sum
    # 486,400 terms that largely cancel, in another order).
    loss_r = r0["loss"].to(loss.device)
    check(math.isclose(loss_b.item(), loss_r.item(), rel_tol=1e-5)
          and math.isclose(loss.item(), loss_r.item(), rel_tol=1e-5), "two-rank step: loss")
    info["two_rank_grads_vs_blocks"] = grad_diffs(grads_b, r0["grads"])
    info["two_rank_grads_vs_train_step"] = grad_diffs(grads, r0["grads"])
    for f, d in info["two_rank_grads_vs_blocks"].items():
        check(d["elementwise_ok"], f"two-rank step: {f} gradients off the blocks' sum: {d}")
    for f, d in info["two_rank_grads_vs_train_step"].items():
        check(d["max_abs_diff"] <= 1e-3 * d["largest"] + 1e-6,
              f"two-rank step: {f} gradients off train_step's: {d}")
    want_frames = realtime_launches(MULTI_FRAMES, big=STRATEGY_KERNELS["stream"])
    card = card_line()
    for r in ranks:
        print(f"two ranks: rank {r['rank']} ({r['rows']} rows) launches {r['launches']}, ms "
              f"{r['ms']}", flush=True)
        print(f"two ranks: rank {r['rank']} row-split dungeon frame: "
              f"{json.dumps({'card': card, 'ms_per_frame': r['ms']['frame'], **r['info']})}",
              flush=True)
        print(f"two ranks: rank {r['rank']} row-split Cornell frame: {r['ms']['cornell_frame']} "
              f"ms ({card}; unsplit {ms['cornell_frame_unsplit']} ms); the whole-state split's "
              f"Cornell frame: {WHOLE_STATE_TWO_RANK_CORNELL_MS[0]}-"
              f"{WHOLE_STATE_TWO_RANK_CORNELL_MS[1]} ms a rank", flush=True)
        check(r["info"]["state_rows"] == [rows] and r["info"]["channel_rows"] == [rows],
              f"rank {r['rank']}: state rows {r['info']['state_rows']}, channel rows "
              f"{r['info']['channel_rows']}, not {rows}")
        check(r["info"]["cornell_rows"] == [rows],
              f"rank {r['rank']}: Cornell rows {r['info']['cornell_rows']}, not {rows}")
        check_launches(r["launches"]["cornell_frames"], realtime_launches(MULTI_FRAMES),
                       "rank Cornell frames")
        check_launches(r["launches"]["sample"], {"trace_sample_megakernel": 1}, "rank sample")
        check_launches(r["launches"]["frames"], want_frames, "rank dungeon frames")
        check_launches(r["launches"]["train"], {"trace_closest_brute": n,
                                                "trace_anyhit_brute": n}, "rank step")
    info["two_rank_ms"] = [r["ms"] for r in ranks]
    info["two_rank_info"] = [r["info"] for r in ranks]
    info["two_rank_launches"] = [r["launches"] for r in ranks]
    info["ms"] = ms
    info["launches"] = launches
    print(f"multi-device: {json.dumps(info)}", flush=True)
    dist.destroy_process_group()
    total = collections.Counter()
    for v in launches.values():
        total.update(v)
    return {"launches": total, "info": info}


def example_runs() -> list:
    """(name, argv, the launches it must make) of each example run, at the
    example's default size."""
    fr = str(EXAMPLE_FRAMES)
    realtime = realtime_launches(EXAMPLE_FRAMES)
    big = realtime_launches(EXAMPLE_FRAMES, big=STRATEGY_KERNELS["stream"])
    fit = EXAMPLE_FIT_STEPS * (TRAIN_DEPTH + 1)
    return [
        ("cornell", ["--frames", fr], realtime),
        ("cornell", ["--frames", fr, "--mode", "reference"],
         {"trace_sample_megakernel": EXAMPLE_FRAMES}),
        ("demo", ["--frames", fr], big),
        ("minecraft", ["--frames", fr], realtime),
        ("stress_bvh", ["--frames", fr], realtime),
        ("stress_lights", ["--frames", fr], realtime),
        ("stress_large", ["--frames", fr], big),
        ("fit_materials", ["--steps", str(EXAMPLE_FIT_STEPS)],
         {"trace_sample_megakernel": 48, "trace_closest_brute": fit, "trace_anyhit_brute": fit}),
        ("viewer", ["--frames", "2", "--port", "0"], realtime_launches(2)),
    ]


def hold_stress_large(scene, cam, device) -> dict:
    """Kernels 5 and 6 against their plain versions on stress_large's
    262,144 triangles: STRESS_SUBSET_ROWS seeded image rows of its
    primaries and of their bounce-0 shadow rays toward the lights; and
    the share of warps whose cluster lists overflow LIST_CAP, on the
    subset and over every primary."""
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    rows = torch.tensor(np.sort(np.random.RandomState(5).choice(
        cam.height, STRESS_SUBSET_ROWS, replace=False)), device=device)
    t0 = time.perf_counter()
    out = {"rows": STRESS_SUBSET_ROWS, "rays": STRESS_SUBSET_ROWS * cam.width}
    for name, anyhit, (o, d, t_max) in (("primary", False, (po, pd, None)),
                                        ("lights", True, (so, sd, slen))):
        o, d = o[rows].contiguous(), d[rows].contiguous()
        t_max = None if t_max is None else t_max[rows].contiguous()
        x = stream_inputs(scene, o, d, t_max)
        got = stream_launch(x, anyhit)
        want = stream_plain(x, anyhit)
        torch.cuda.synchronize()
        k = "6" if anyhit else "5"
        what = f"kernel {k} (stress_large {name}, {o.numel() // 3} rays)"
        mism, e = stream_mismatch(got, want, anyhit, what)
        check(mism == 0, f"{what}: {mism} rays differ from the plain version")
        _, _, count = sk.warp_lists(x["clus"], x["o"].reshape(-1, 3), x["d"].reshape(-1, 3),
                                    x["cap"].reshape(-1))
        out[name] = {"mismatches": mism, "max_abs_err": e, "warps": count.numel(),
                     "warps_overflowing": int((count > sk.LIST_CAP).sum()),
                     "most_clusters_a_warp": int(count.max())}
    # every primary warp of the frame, in chunks
    over = warps = most = 0
    fo, fd = po.reshape(-1, 3), pd.reshape(-1, 3)
    for i in range(0, fo.shape[0], 32768):
        o, d = fo[i:i + 32768].contiguous(), fd[i:i + 32768].contiguous()
        cap = sk.scene_tcap(scene.clusters, o, d)
        _, _, count = sk.warp_lists(scene.clusters, o, d, cap)
        over += int((count > sk.LIST_CAP).sum())
        warps += count.numel()
        most = max(most, int(count.max()))
    out["all_primaries"] = {"warps": warps, "warps_overflowing": over,
                            "most_clusters_a_warp": most}
    out["check_s"] = time.perf_counter() - t0
    print(f"stress_large: kernels 5 and 6 against their plain versions {json.dumps(out)}"
          + ("" if over or out["primary"]["warps_overflowing"] or out["lights"]["warps_overflowing"]
             else f"; no warp overflows LIST_CAP = {sk.LIST_CAP}"), flush=True)
    return out


def drive_examples(device) -> dict:
    """Phase 5k: each example's main() in-process at its default size
    (EXAMPLE_FRAMES realtime frames, EXAMPLE_FIT_STEPS of fit_materials,
    the viewer with 2 frames on a free port and one GET of its frame),
    counted: its kernels launch as its path says; its images written and
    finite. Then stress_large's kernels 5 and 6 against their plain
    versions. Returns the launches and the numbers."""
    import importlib

    launches, info = {}, {}
    total = collections.Counter()
    large = None
    for name, argv, want in example_runs():
        main = importlib.import_module(f"strolle_tpu_torch.examples.{name}").main
        key = name + ("_reference" if "reference" in argv else "")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res, _ = counted(lambda: main(argv + ["--out", tmp]), launches, key)
            wall = time.perf_counter() - t0
            if name == "viewer":
                from PIL import Image

                with Image.open(res["jpg"]) as im:
                    check(im.size == (512, 512), f"viewer: frame size {im.size}")
                    check(np.asarray(im).mean() > 1.0, "viewer: a black frame")
                check(res["frames"] == 2, "viewer: frame count")
                kept = {k: res[k] for k in ("port", "jpg_bytes", "frames")}
            else:
                check(bool(res["pngs"]) and all(os.path.exists(p) for p in res["pngs"]),
                      f"{key}: no image written")
                check(res["finite"], f"{key}: an image is not finite")
                kept = {k: v for k, v in res.items() if k not in ("pngs", "scene", "camera")}
                kept["pngs"] = len(res["pngs"])
        check_launches(launches[key], want, f"example {key}")
        total.update(launches[key])
        info[key] = {"wall_s": wall, "launches": launches[key], **kept}
        print(f"example {key}: {json.dumps(info[key])}", flush=True)
        if name == "stress_large":
            large = res
            check(res["stream"] and res["triangles"] == 262144 and res["clusters"] == 1024,
                  "stress_large: not 262,144 triangles in 1,024 clusters under 'stream'")
    info["stress_large_hold"] = hold_stress_large(large["scene"], large["camera"], device)
    return {"launches": total, "info": info}


T_START = time.perf_counter()
#: (phase, its start in seconds since T_START), in order.
PHASES: list = []


def phase(name: str) -> None:
    PHASES.append((name, time.perf_counter() - T_START))
    print(f"[{PHASES[-1][1]:.1f} s] phase {name}", flush=True)


def phase_seconds() -> dict:
    """Each phase's seconds: from its start to the next one's, the last
    to now (phase 6's dungeon turns count within phase 6)."""
    starts = [(n, t) for n, t in PHASES if "turn" not in n]
    ends = [t for _, t in starts[1:]] + [time.perf_counter() - T_START]
    return {n: e - t for (n, t), e in zip(starts, ends)}


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
    sass = sass_per_test(cuda_lib.build())
    print(f"SASS instructions per ray-triangle test (kernels A, B, 4, 8, 9; kernel C flat, no "
          f"metal: closest hit, shadow; kernels 10 and 11 also per node visit): {sass}",
          flush=True)
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
    check_launches(fused_launches, {"trace_surface": 2 * (DEPTH + 1),
                                    "trace_anyhit_brute": 2 * (DEPTH + 1)},
                   "staged loop (use_pallas=None)")
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
    serr, ssets = compare_stream_kernels(dg, dcam, device, dluts)
    err.update(serr)
    stream_walks = compare_stream_overflow(dg, ssets, device)

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
    cluster_walks = compare_cluster_walks(dg, ssets, device)

    # --- 5c. the dungeon under the cluster and packet strategies ------------
    phase("5c")
    from strolle_tpu_torch.ops.trace import trace_closest, trace_surface

    dpo, dpd = ssets["primary"][:2]
    stream_tri = trace_surface(dg, dpo, dpd).tri
    strat = {name: drive_strategy(name, dg, dcam, dluts, dcfg, dref1, stream_tri)
             for name in ("cluster", "packet")}

    # --- 5d. kernel 7, the spatial-probe route, the switches, the heatmap ---
    phase("5d")
    from strolle_tpu_torch.ops.kernels import probe_kernels as pk

    cap = spatial_inputs(scene, cam, RenderConfig(), None)
    dcap = spatial_inputs(dg, dcam, dcfg, dluts)
    probe_cases = {"cornell": probe_case("di", cap["di"]),
                   "cornell_gi": probe_case("gi", cap["gi"]),
                   "dungeon": probe_case("di", dcap["di"]),
                   "dungeon_gi": probe_case("gi", dcap["gi"])}
    synthetic = synthetic_probe_cases(device)
    probe_cases.update({f"synthetic_{k}": v for k, v in synthetic.items()})
    probe_err = compare_probe_kernel(probe_cases)
    err.update({"7di": probe_err["di"], "7gi": probe_err["gi"]})
    captured = {"cornell": ("di", cap["di"]), "cornell_gi": ("gi", cap["gi"]),
                "dungeon": ("di", dcap["di"]), "dungeon_gi": ("gi", dcap["gi"])}
    route_cases = {name: route_case(kind, args) for name, (kind, args) in captured.items()}
    route_cases.update({f"synthetic_{k}": v for k, v in synthetic_route_cases(synthetic).items()})
    compare_probe_route(route_cases)
    fused_ops = fused_pass_ops(captured)
    di_routes_equal(scene, cap["di"])
    probe_route = {}
    (probe_rt_launches, p_state, probe_route["cornell_vs_reference"],
     probe_route["cornell_vs_switch_off"]) = drive_probe_route(scene, cam, 1000, None, None,
                                                               rt_mean, ref1, 0.10)
    (probe_route["dungeon_launches"], _, probe_route["dungeon_vs_reference"],
     probe_route["dungeon_vs_switch_off"]) = drive_probe_route(
        dg, dcam, 5000, dcfg, dluts, drt_mean, dref1, DG_RT_TOLERANCE,
        big=STRATEGY_KERNELS["stream"])
    with probe_switch(True):
        _, p_state = render_frame_fused(scene, cam, p_state, 1000 + RT_FRAMES)
    probe_route["switches"] = drive_switches(scene, cam, p_state, 1001 + RT_FRAMES)
    heatmap_info = check_heatmap(dg, dcam)

    # --- 5e. kernels A and B above 1024 rows: the dungeon without its BVH --
    phase("5e")
    flat = dg.replace(bvh=None, clusters=None)
    flat_rows = packed_tri_rows(flat)
    fo, fd, ft = ssets["random"]
    ea, eb = hold_brute(flat_rows, fo, fd, ft, "dungeon without a BVH, random")
    err["A"], err["B"] = max(err["A"], ea), max(err["B"], eb)
    winners = tk.trace_closest_brute_plain(flat_rows, fo, fd)[1]
    copies, copied = tie_rows(flat_rows, winners)
    hold_ties(copies, fo, fd, "the dungeon's rows, copies in other slices and a later tile",
              copied)
    flat_launches = drive_flat_dungeon(flat, dg, dluts, device)

    # --- 5f-5h. the differentiable path and the alpha restart loop ---------
    phase("5f")
    train_info = drive_train(scene, cam)
    phase("5g")
    restir_train_info = drive_restir_train(scene, cam)
    phase("5h")
    alpha_info = drive_alpha(scene, cam, staged, device)

    # --- 5i. the engine: SceneEditor, Renderer, viewer, checkpoint ---------
    phase("5i")
    engine = drive_engine(dg, dcam, device, err)

    # --- 5j. the multi-device layer; 5k. the examples ----------------------
    phase("5j")
    multi = drive_multidevice(scene, cam, img, dg, dcam, dluts)
    phase("5k")
    examples = drive_examples(device)

    # --- 6. timings -----------------------------------------------------
    phase("6")
    # the torch BVH traversal on the card: trace_closest's route under
    # "packet" (and every strategy but "stream")
    with strategy("packet"):
        cuda_lib.reset_launch_counts()
        ms_traverse = time_ms(lambda: trace_closest(dg, dpo, dpd), warmup=1, iters=3)
        profile_traverse = profile_frames(lambda: trace_closest(dg, dpo, dpd), frames=1)
        check(not cuda_lib.LAUNCHES, f"trace_closest under 'packet' launched {cuda_lib.LAUNCHES}")
    print(f"trace_closest under 'packet' (the torch BVH traversal) on {dpo.numel() // 3} "
          f"primary rays: {ms_traverse:.1f} ms, profile {profile_traverse}", flush=True)
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
    flops_c = ((work["closest_tests"] + work["anyhit_tests"]) * FLOPS_BW_PLANE
               + (work["closest_inside"] + work["anyhit_inside"]) * FLOPS_BW_INSIDE
               + work["ray_bounces"] * FLOPS_SHADE[args["no_metal"]])
    bytes_c = (4 * (args["tri_rows"].numel() + args["mat_rows"].numel()
                    + args["light_rows"].numel()) + r * (24 + 8) + r * 12)
    bound_c, by_c = bound(flops_c, bytes_c)

    # kernels A and B alone on the staged loop's first-bounce rays
    rows = packed_tri_rows(scene)
    po, pd, so, sd, slen = bounce0_shadow_rays(scene, cam, SEED)
    ms_a = time_ms(lambda: tk.trace_closest_brute(rows, po, pd))
    plain_a = time_ms(lambda: tk.trace_closest_brute_plain(rows, po, pd), warmup=1, iters=5)
    bound_a, by_a = bound(closest_flops(rows, po, pd), 4 * rows.numel() + r * 24 + r * 16)
    ms_b = time_ms(lambda: tk.trace_anyhit_brute(rows, so, sd, slen))
    plain_b = time_ms(lambda: tk.trace_anyhit_brute_plain(rows, so, sd, slen),
                      warmup=1, iters=5)
    bound_b, by_b = bound(anyhit_flops(rows, so, sd, slen), 4 * rows.numel() + r * 28 + r)

    # kernels A and B over the BVH-less dungeon's rows on its random rays
    fn = fo.numel() // 3
    ms_a_flat = time_ms(lambda: tk.trace_closest_brute(flat_rows, fo, fd))
    plain_a_flat = time_ms(lambda: tk.trace_closest_brute_plain(flat_rows, fo, fd), warmup=1,
                           iters=3)
    bound_a_flat = bound(closest_flops(flat_rows, fo, fd),
                         4 * flat_rows.numel() + fn * 24 + fn * 16)
    ms_b_flat = time_ms(lambda: tk.trace_anyhit_brute(flat_rows, fo, fd, ft))
    plain_b_flat = time_ms(lambda: tk.trace_anyhit_brute_plain(flat_rows, fo, fd, ft),
                           warmup=1, iters=3)
    bound_b_flat = bound(anyhit_flops(flat_rows, fo, fd, ft),
                         4 * flat_rows.numel() + fn * 28 + fn)
    brute_flat = {"rays": fn, "rows": flat_rows.shape[0],
                  "A": {"ms": ms_a_flat, "plain_ms": plain_a_flat, "bound_ms": bound_a_flat[0],
                        "bound_by": bound_a_flat[1]},
                  "B": {"ms": ms_b_flat, "plain_ms": plain_b_flat, "bound_ms": bound_b_flat[0],
                        "bound_by": bound_b_flat[1]}}
    print(f"kernels A and B over {flat_rows.shape[0]} rows: {brute_flat}", flush=True)

    # kernel 4 alone on the realtime frame's primary rays
    grows = packed_geom_rows(scene)
    ms_4 = time_ms(lambda: tk.trace_surface(grows, po, pd))
    plain_4 = time_ms(lambda: tk.trace_surface_plain(grows, po, pd), warmup=1, iters=5)
    hits_4 = int((tk.trace_surface_plain(grows, po, pd)["tri"] >= 0).sum())
    # out: t, u, v, tri, normal [3], uv [2], mat_id = 40 B per ray
    bound_4, by_4 = bound(closest_flops(grows, po, pd) + hits_4 * FLOPS_RESOLVE,
                          4 * grows.numel() + r * 24 + r * 40)

    # the realtime frame: whole cycles, per stage, under the profiler
    rt_ms, rt_cycles, rt_state = time_realtime(scene, cam, rt_state, 2000)
    rt_stages, rt_state = time_stages(scene, cam, rt_state, 3000)
    holder = {"state": rt_state, "seed": 4000}

    def rt_frame():
        _, holder["state"] = render_frame_fused(scene, cam, holder["state"], holder["seed"])
        holder["seed"] += 1

    rt_profile = profile_frames(rt_frame, frames=PROFILE_RT_FRAMES)

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

    drt_profile = profile_frames(drt_frame, frames=PROFILE_RT_FRAMES)
    # kernel 5 on the realtime frame's primary rays, kernel 6 on the
    # reference loop's bounce-0 shadow rays toward the lights
    x5 = stream_inputs(dg, *ssets["primary"][:2])
    x6 = stream_inputs(dg, *ssets["lights"])
    ms_5 = time_ms(lambda: stream_launch(x5, False))
    plain_5 = time_ms(lambda: stream_plain(x5, False), warmup=1, iters=3)
    ms_6 = time_ms(lambda: stream_launch(x6, True))
    plain_6 = time_ms(lambda: stream_plain(x6, True), warmup=1, iters=3)
    cost = {"5": stream_cost(x5, False), "6": stream_cost(x6, True)}
    # kernel 6 also on the long rays: toward the sun, and the realtime GI
    # shadow rays (a quarter toward the sky)
    ms_6_long = {}
    for name in ("sun", "gi"):
        x = stream_inputs(dg, *ssets[name])
        ms_6_long[name] = time_ms(lambda: stream_launch(x, True))
    print(f"kernel 6 ms: lights {ms_6:.4f}, sun {ms_6_long['sun']:.4f}, realtime GI shadow "
          f"rays {ms_6_long['gi']:.4f} ({ssets['gi'][0].numel() // 3} rays)", flush=True)

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

    # kernel 7 on the Cornell frame's own spatial inputs (DI frame 0, GI
    # frame 1): the route entry (the main path's launch), the stack entry
    # and the whole fused pass; the DI and GI stages with the switch off
    # and on in turns
    probe_t = {}
    for mode, name in (("di", "cornell"), ("gi", "cornell_gi")):
        stack, dy, dx, seed, kw = probe_cases[name]
        fields, rseed, rstate, rkw = route_cases[name]
        fused = fused_pass(mode, captured[name][1])
        probe_t[mode] = {
            "ms": time_ms(lambda: pk.probe_route(fields, rseed, rstate, **rkw)),
            "plain_ms": time_ms(lambda: pk.probe_route_plain(fields, rseed, rstate, **rkw),
                                warmup=1, iters=5),
            **route_cost(route_cases[name], probe_cases[name]),
            "stack_entry": {
                "ms": time_ms(lambda: pk.probe_spatial(stack, dy, dx, seed, **kw)),
                "plain_ms": time_ms(lambda: pk.probe_spatial_plain(stack, dy, dx, seed, **kw),
                                    warmup=1, iters=5),
                **probe_cost(probe_cases[name]),
            },
            "fused_pass": {"ms": time_ms(fused), **fused_ops[name]},
        }
    probe_stages = {}
    probe_stages["cornell"], rt_state = time_probe_stages(scene, cam, rt_state, 11000)
    probe_stages["dungeon"], drt_state = time_probe_stages(dg, dcam, drt_state, 12000, dcfg,
                                                           dluts)
    # both realtime frames under the profiler with the switch on, beside
    # the switch-off profiles above
    probe_profiles = {}
    for name, args in (("cornell", (scene, cam, rt_state, RenderConfig(), None)),
                       ("dungeon", (dg, dcam, drt_state, dcfg, dluts))):
        pholder = {"state": args[2], "seed": 13000}

        def p_frame(args=args, pholder=pholder):
            _, pholder["state"] = render_frame_fused(args[0], args[1], pholder["state"],
                                                     pholder["seed"], args[3], args[4])
            pholder["seed"] += 1

        with probe_switch(True):
            probe_profiles[name] = profile_frames(p_frame, frames=PROFILE_RT_FRAMES)
    print(f"kernel 7 alone: {probe_t}; DI/GI stage ms in turns (switch off, on, on, off): "
          f"{probe_stages}", flush=True)

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
        "sass_per_test": sass,
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
        "stream_walks_per_ray": stream_walks,
        "cluster_walks_per_ray": cluster_walks,
        "stream_anyhit_long_rays_ms": ms_6_long,
        "brute_over_1024_rows": brute_flat,
        "flat_dungeon_launches": flat_launches,
        "strategies": {name: {k: v for k, v in r.items() if not k.endswith("launches")}
                       for name, r in strat.items()},
        "strategy_turns": turns,
        "walk_kernels": walk,
        "traverse_packet_ms": ms_traverse,
        "traverse_packet_profile": profile_traverse,
        "probe_kernel": probe_t,
        "probe_stage_turns": probe_stages,
        "probe_profiles_switch_on": probe_profiles,
        "probe_route": probe_route,
        "heatmap": heatmap_info,
        "train": train_info,
        "restir_train": restir_train_info,
        "alpha": alpha_info,
        "engine": engine["info"],
        "multi_device": multi["info"],
        "examples": examples["info"],
        "total_s": time.perf_counter() - T_START,
    }
    print("timings: " + json.dumps(timings), flush=True)

    # the launches of the differentiable, alpha, engine, multi-device and
    # example phases (5f-5k)
    new_path_launches = collections.Counter()
    alpha_counts = [v for k, v in alpha_info.items() if not k.endswith("_ms")]
    for counts in (train_info["launches"], restir_train_info["launches"], *alpha_counts,
                   engine["launches"], multi["launches"], examples["launches"]):
        new_path_launches.update(counts)
    kernels = [
        {
            "name": "trace_sample_megakernel", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/ref_megakernel.cu",
            "replaces": "strolle_tpu/ops/pallas/ref_kernel.py:617",
            "launches": (launches["trace_sample_megakernel"]
                         + new_path_launches["trace_sample_megakernel"]),
            "max_abs_err": err["C"], "ms": ms_c, "plain_ms": plain_c,
            "bound_ms": bound_c, "bound_by": by_c, "library_ms": None,
        },
        {
            "name": "trace_closest_brute", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:280",
            "launches": (launches["trace_closest_brute"] + flat_launches["trace_closest_brute"]
                         + new_path_launches["trace_closest_brute"]),
            "max_abs_err": err["A"], "ms": ms_a, "plain_ms": plain_a,
            "bound_ms": bound_a, "bound_by": by_a, "library_ms": None,
            "over_1024_rows": {"rows": brute_flat["rows"], "rays": fn, **brute_flat["A"]},
        },
        {
            "name": "trace_anyhit_brute", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:378",
            "launches": (launches["trace_anyhit_brute"] + rt_launches["trace_anyhit_brute"]
                         + flat_launches["trace_anyhit_brute"]
                         + new_path_launches["trace_anyhit_brute"]),
            "max_abs_err": err["B"], "ms": ms_b, "plain_ms": plain_b,
            "bound_ms": bound_b, "bound_by": by_b, "library_ms": None,
        },
    ]
    kernels.append({
        "name": "trace_surface", "route": "cuda",
        "source": "strolle_tpu_torch/csrc/trace_kernels.cu",
        "replaces": "strolle_tpu/ops/pallas/trace_kernels.py:328",
        "launches": (rt_launches["trace_surface"] + fused_launches["trace_surface"]
                     + new_path_launches["trace_surface"]),
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
            "launches": dg_launches[name] + drt_launches[name] + new_path_launches[name],
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
            **({"issue_floor_ms": issue_floor_ms(cost[key]["work"], sass and sass[key])}
               if key in BVH_SASS else {}),
            "library_ms": None,
        })
    for mode in ("di", "gi"):
        kernels.append({
            "name": f"probe_spatial_{mode}", "route": "cuda",
            "source": "strolle_tpu_torch/csrc/probe_kernels.cu",
            "replaces": "strolle_tpu/ops/pallas/probe_kernels.py:250",
            "launches": probe_rt_launches[f"probe_spatial_{mode}"],
            "max_abs_err": err["7" + mode], "ms": probe_t[mode]["ms"],
            "plain_ms": probe_t[mode]["plain_ms"], "bound_ms": probe_t[mode]["bound_ms"],
            "bound_by": probe_t[mode]["bound_by"], "library_ms": None,
            "stack_entry": {k: probe_t[mode]["stack_entry"][k]
                            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "fused_pass": probe_t[mode]["fused_pass"],
        })
    check(len(kernels) == 12, "the kernels line must list the twelve ported kernels")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: never launched on its main path")
        check(all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms")),
              f"{k['name']}: non-finite timing")
    print(f"phase seconds: {json.dumps(phase_seconds())}", flush=True)
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
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2:]))
    sys.exit(main())

"""Times kernels 5 and 6 (the big-scene stream kernels), 8 and 9 (the
cluster kernels), 10 and 11 (the BVH kernels), A and 4 (the brute-force closest hit, and with the
surface resolved), B (the brute-force any hit), C (the reference-mode
megakernel) and 7 (the spatial probe) of this checkout against those of
other checkouts, on the same inputs of the same card, in turns.

Run from the root of the repository, on a CUDA card:

    python3 stream_turns.py [--kernels 5,6,8,9,10,11,A,B,4,C,7] OTHER_ROOT [OTHER_ROOT ...]

OTHER_ROOT is the root of another checkout of the repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that .gitignore lists). Each checkout's ``strolle_tpu_torch`` is imported
under a name of its own and builds its kernels from its own sources.
``--kernels`` picks the kernels to time (all eleven by default).

The inputs of kernels 5 and 6: the dungeon at 800x608 with the sun at
0.35 (chip_smoke.py's scene), chip_smoke.py's ray sets (primaries and
seeded random rays for kernel 5; bounce-0 shadow rays toward the lights,
rays toward the sun with t_max = inf and the random rays for kernel 6),
and the inputs of every kernel 5 and 6 launch of one reference sample
(depth 4, the sky) and of one 6-frame realtime GI cycle
(RenderConfig(include_sky=True)), named by the line that called
``trace_anyhit`` or ``trace_surface``. Kernels 8 and 9 the same, with the
realtime GI shadow rays (captured from frame 0) among kernel 9's sets,
and the launches captured under BIG_SCENE_STRATEGY "cluster"; kernels 10
and 11 as 8 and 9, under "packet", and each checkout's SASS instructions
per node visit and per triangle test of 10 and 11 (chip_smoke.py's
``walk_loops``). Kernel A:
Cornell's primaries at
800x608, every kernel A launch of one staged sample on Cornell (depth 4,
use_pallas=False: the gradient route), the dungeon without its BVH
(8,400 rows) on chip_smoke.py's 65,536 random rays, and every kernel A
launch of one reference sample of it at 200x152 (chip_smoke.py's, depth
4 with the sky). Kernel B: Cornell's
bounce-0 shadow rays at 800x608 (the staged loop's), every kernel B
launch of one 6-frame realtime GI cycle on Cornell (RenderConfig()), and
the BVH-less dungeon on the same random rays. Kernel 4: Cornell's
primaries and every kernel 4 launch of the same realtime GI cycle.
Kernel C: Cornell at 800x608, depth 4, in its four (flat, no_metal)
variants (chip_smoke.py's scenes). Kernel 7: the DI and GI spatial
passes' own inputs, captured from a Cornell and a dungeon realtime frame
(DI on frame 0, GI on frame 1, chip_smoke.py's ``spatial_inputs``), in
three forms: the stack entry alone (``strolle_probe_spatial``, each
checkout's C entry on this checkout's stack and tables), the route entry
alone (``strolle_probe_route``, in the checkouts that have it) and each
checkout's whole fused pass (``restir/di.py::probe_fused``, from the
fields to its outputs, host time inside), whose device operations per
call are printed as it dispatches them (chip_smoke.py's
``dispatched_ops``) and with its busy and wall time from
``torch.profiler``.

The turns: for each set, the other checkouts in the order given, this
checkout twice, the others in reverse (A B B A). A turn launches the
checkout's kernel alone on inputs prepared once: kernels 5, 6 and 8-11
through its own ``cuda_lib.launch_walk`` (5, 6, 8 and 9 with its
``launch_head``: for 5 and 6 sub-block boxes, scene-box cap or clipped
t_max: the wrappers' set-up, the same in every checkout), A, B, 4 and C through its library's C entry point, into
outputs allocated once. Each is timed with CUDA events (median of 15
after 3; for A, B and 4, of 20 launches in a row, divided by 20), each
timed run queued behind a ~1 ms sleep of the device, so that the host's
time per launch stays out. Prints the card's line, per set the ms of every turn and
whether every turn's outputs equal this checkout's (tri and t for 5, the
flags for 6, 9, 11 and B, every output of 8, 10, A and 4, the radiance for
C, every output of 7: oy, ox, found and jac, or rhs_x, rhs_y, found,
the stream and jac), the sum
over the captured launches per turn, and last one JSON object of all of
it. For
C it also prints each checkout's kernel against its own plain version
(the largest difference, the share of pixels off by more than 1e-3).

Exits 1 if any turn's outputs differ from this checkout's, except C's
from a checkout whose kernel rounds otherwise (the parent of the
Baldwin-Weber repair): those must agree as chip_smoke.py holds C to its
plain version (at most 0.1% of pixels off by more than 1e-3, the means
within 1e-4).
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

WIDTH, HEIGHT = 800, 608
GI_CYCLE = 6
KERNELS = ("5", "6", "8", "9", "10", "11", "A", "B", "4", "C", "7")
#: ~1 ms of the device's sleep ahead of each timed run of launches
SLEEP_CYCLES = 2_000_000
#: The names of the launches captured on the BVH-less dungeon begin so.
FLAT_PREFIX = "dungeon_without_bvh "


def load_kernels(root: Path, alias: str):
    """The stream-kernel module of the package under ``root``, imported as
    ``alias``."""
    pkg = root / "strolle_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".ops.kernels.stream_kernels")


#: The big-scene kernels timed here: (strategy, wrapper module, closest-hit
#: kernel and wrapper, any-hit kernel and wrapper).
WALKS = {
    "stream": ("stream_kernels", ("5", "stream_trace_surface"), ("6", "stream_trace_anyhit")),
    "cluster": ("cluster_kernels", ("8", "cluster_trace_surface"), ("9", "cluster_trace_anyhit")),
    "packet": ("bvh_kernels", ("10", "bvh_trace_surface"), ("11", "bvh_trace_anyhit")),
}


def capture_launches(scene, cam, luts, dev, walk: str) -> list:
    """(kernel, call site, o, d, t_max) of every launch of the ``walk``
    strategy's two kernels (5 and 6, 8 and 9, or 10 and 11) in one reference sample
    and one realtime GI cycle on this checkout, under that strategy."""
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame_fused

    module, (ks, surface_name), (ka, anyhit_name) = WALKS[walk]
    mod = importlib.import_module("strolle_tpu_torch.ops.kernels." + module)
    calls = []
    surface, anyhit = getattr(mod, surface_name), getattr(mod, anyhit_name)

    def site() -> str:
        # the first caller outside ops/ (the trace dispatch, the checkerboard)
        f = sys._getframe(2)
        while f.f_back is not None and Path(f.f_code.co_filename).parent.name == "ops":
            f = f.f_back
        return f"{Path(f.f_code.co_filename).name}:{f.f_lineno}"

    def rec_surface(clus, rows, o, d, work=None):
        calls.append((ks, site(), o.clone(), d.clone(), None))
        return surface(clus, rows, o, d, work)

    def rec_anyhit(clus, rows, o, d, t_max, work=None):
        tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                                o.shape[:-1])
        calls.append((ka, site(), o.clone(), d.clone(), tm.clone()))
        return anyhit(clus, rows, o, d, t_max, work)

    setattr(mod, surface_name, rec_surface)
    setattr(mod, anyhit_name, rec_anyhit)
    try:
        with cs.strategy(walk):
            trace_sample(scene, cam, cs.SEED, depth=cs.DEPTH, include_sky=True, luts=luts)
            state = init_state(cam, device=dev)
            for f in range(GI_CYCLE):
                _, state = render_frame_fused(scene, cam, state, f,
                                              RenderConfig(include_sky=True), luts)
    finally:
        setattr(mod, surface_name, surface)
        setattr(mod, anyhit_name, anyhit)
    torch.cuda.synchronize()
    return calls


def capture_trace_launches(drive, names) -> list:
    """(wrapper, call site, rows, o, d[, t_max]) of every launch of the
    ``ops/kernels/trace_kernels.py`` wrappers ``names`` that ``drive()``
    makes on this checkout."""
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk

    calls = []
    saved = {name: getattr(tk, name) for name in names}

    def recorder(name):
        def rec(rows, o, d, *t_max):
            f = sys._getframe(1)
            while f.f_back is not None and Path(f.f_code.co_filename).parent.name == "ops":
                f = f.f_back
            tm = tuple(torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32, device=o.device),
                                          o.shape[:-1]).contiguous().clone() for t in t_max)
            calls.append((name, f"{Path(f.f_code.co_filename).name}:{f.f_lineno}",
                          rows.contiguous(), o.contiguous().clone(), d.contiguous().clone(), *tm))
            return saved[name](rows, o, d, *t_max)

        return rec

    for name in names:
        setattr(tk, name, recorder(name))
    try:
        drive()
    finally:
        for name, fn in saved.items():
            setattr(tk, name, fn)
    torch.cuda.synchronize()
    return calls


def time_launches(launch, reps: int, warmup: int = 3, iters: int = 15) -> tuple[float, float]:
    """Median device ms of one launch over ``iters`` runs of ``reps``
    launches in a row, and the host's ms per launch. Each run is enqueued
    behind a ~1 ms sleep of the device, so that the launches queue up and
    run back to back: the host's time per launch stays out."""
    for _ in range(warmup):
        launch()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            launch()
        h1 = time.perf_counter()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / reps)
        host.append((h1 - h0) * 1e3 / reps)
    return statistics.median(dev), statistics.median(host)


def run(prep, mod, k, x) -> tuple:
    """The outputs of one launch of ``prep(mod, k, x)``."""
    launch, outs = prep(mod, k, x)
    launch()
    return outs


def in_turns(order, labels, cases, prep, reps: int = 1) -> list:
    """Times the launches of every checkout in ``order`` on every case
    (kernel k, set, x, rays), ``reps`` launches per timed run, and holds
    each turn's outputs equal to this checkout's. ``prep(mod, k, x)``
    allocates a launch's outputs (a tuple of tensors) and returns them
    with a function that launches the checkout's kernel into them."""
    results = []
    for k, name, x, n in cases:
        want = run(prep, order[labels.index("this")], k, x)
        ms, host, equal = [], [], []
        for mod in order:
            launch, got = prep(mod, k, x)
            launch()
            equal.append(all(torch.equal(a, b) for a, b in zip(got, want)))
            t, h = time_launches(launch, reps)
            ms.append(t)
            host.append(h)
        results.append({"kernel": k, "set": name, "rays": n, "ms": ms, "host_ms": host,
                        "equal": equal})
        print(f"kernel {k} {name} ({n} rays): "
              + ", ".join(f"{lab} {t:.4f}" for lab, t in zip(labels, ms))
              + f" ms (host {max(host):.4f} ms a launch at most); outputs equal {all(equal)}",
              flush=True)
    return results


def captured_totals(results, labels, kernels) -> dict:
    """The sum over each kernel's captured launches, per turn (those of
    the BVH-less dungeon apart, under the key "<kernel> dungeon")."""
    totals = {}
    for k in kernels:
        for key, flat in ((k, False), (f"{k} dungeon", True)):
            picked = [r["ms"] for r in results if r["kernel"] == k and "#" in r["set"]
                      and r["set"].startswith(FLAT_PREFIX) == flat]
            if not picked:
                continue
            totals[key] = [sum(col) for col in zip(*picked)]
            print(f"kernel {key}, the {len(picked)} captured launches: "
                  + ", ".join(f"{lab} {t:.3f}" for lab, t in zip(labels, totals[key])) + " ms",
                  flush=True)
    return totals


def walk_turns(order, labels, dev, walk: str, kernels: set) -> tuple[list, dict]:
    """Kernels 5 and 6 ("stream"), 8 and 9 ("cluster") or 10 and 11
    ("packet"), those of ``kernels``, in turns on the dungeon's sets and
    captured launches."""
    from strolle_tpu_torch.scene.demo import dungeon_camera

    module, (ks, _), (ka, _) = WALKS[walk]
    scene, luts = cs.dungeon_scene(dev)
    cam = dungeon_camera(WIDTH, HEIGHT, device=dev)
    sets = cs.stream_ray_sets(scene, cam, dev, luts)
    rays = [(ks, name, *sets[name][:2], None) for name in ("primary", "random")]
    rays += [(ka, name, *sets[name])
             for name in (("lights", "sun", "random") if walk == "stream"
                          else ("lights", "sun", "gi", "random"))]
    captured = capture_launches(scene, cam, luts, dev, walk)
    seen: dict = {}
    for k, where, o, d, tm in captured:
        seen[(k, where)] = seen.get((k, where), 0) + 1
        rays.append((k, f"{where}#{seen[(k, where)]}", o, d, tm))
    print(f"{len(captured)} kernel {ks}/{ka} launches captured", flush=True)
    rays = [r for r in rays if r[0] in kernels]

    def inputs(k, o, d, tm):
        o, d = o.contiguous(), d.contiguous()
        if walk == "stream":
            return cs.stream_inputs(scene, o, d, tm if k == ka else None)
        return cs.walk_inputs(scene, k, o, d, tm)

    cases = [(k, name, inputs(k, o, d, tm), o.numel() // 3) for k, name, o, d, tm in rays]

    def prep(smod, k, x):
        mod = importlib.import_module(smod.__name__.rsplit(".", 1)[0] + "." + module)
        batch = x["o"].shape[:-1]
        anyhit = k == ka
        if anyhit:
            outs = (torch.empty(batch, dtype=torch.bool, device=dev),)
        elif walk == "stream":
            t = torch.empty(batch, device=dev)
            outs = (t, torch.empty(batch, dtype=torch.int32, device=dev), torch.empty_like(t),
                    torch.empty_like(t))
        else:
            outs = mod.cuda_lib.surface_outputs(batch, dev)
        if walk == "stream":
            head, ray_arg = mod.launch_head(x["clus"], x["subs"], x["rows"]), x["cap"]
        elif walk == "cluster":
            head, ray_arg = mod.launch_head(x["table"], x["rows"]), x["t_max"]
        else:
            head, ray_arg = (x["table"], x["rows"]), x["t_max"]
        entry = f"strolle_{module.split('_')[0]}_trace_{'anyhit' if anyhit else 'surface'}"

        def launch():
            mod.cuda_lib.launch_walk(entry, head, x["o"], x["d"], ray_arg, outs, None)

        # kernel 5's outputs compared: tri and t; kernels 8's and 10's: all
        return launch, ((outs[1], outs[0]) if k == "5" else outs)

    results = in_turns(order, labels, cases, prep)
    return results, captured_totals(results, labels, sorted({ks, ka} & kernels))


def brute_turns(order, labels, dev, kernels) -> tuple[list, dict, list]:
    """Kernels A, B, 4 and C (those of ``kernels``) in turns: A on
    Cornell's primaries, the launches of one staged sample
    (use_pallas=False) and the BVH-less dungeon; B on Cornell's bounce-0
    shadow rays, the launches of one realtime GI cycle and the BVH-less
    dungeon; 4 on Cornell's primaries and the launches of one realtime GI
    cycle; C in its four variants; also each checkout's C against its own
    plain version."""
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import init_state, render_frame_fused
    from strolle_tpu_torch.ops.trace import packed_geom_rows, packed_tri_rows
    from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
    from strolle_tpu_torch.scene.demo import dungeon_camera

    scene = cornell_box(device=dev)
    metal = cornell_box(metallic_tall_box=True, device=dev)
    cam = cornell_camera(WIDTH, HEIGHT, device=dev)
    rows = packed_tri_rows(scene).contiguous()
    po, pd = (x.contiguous() for x in pixel_rays(cam, screen_grid(cam)))
    cases, mega = [], []

    def add_captured(captured, wrapper, k, scene_name=""):
        seen: dict = {}
        picked = [c for c in captured if c[0] == wrapper]
        for _, where, *x in picked:
            seen[where] = seen.get(where, 0) + 1
            cases.append((k, f"{scene_name}{where}#{seen[where]}", tuple(x)))
        print(f"{len(picked)} kernel {k} launches captured {scene_name}", flush=True)

    def realtime_cycle():
        state = init_state(cam, device=dev)
        for f in range(GI_CYCLE):
            _, state = render_frame_fused(scene, cam, state, f)

    wrappers = [w for k, w in (("B", "trace_anyhit_brute"), ("4", "trace_surface"))
                if k in kernels]
    realtime = capture_trace_launches(realtime_cycle, wrappers) if wrappers else []
    flat = None
    if kernels & {"A", "B"}:
        dg, luts = cs.dungeon_scene(dev)
        flat_scene = dg.replace(bvh=None, clusters=None)
        flat_rows = packed_tri_rows(flat_scene).contiguous()
        flat = (f"dungeon_without_bvh_{flat_rows.shape[0]}_rows", flat_rows,
                *cs.level_random_rays(dg, dev))
    if "A" in kernels:
        cases.append(("A", "cornell_primary", (rows, po, pd)))
        add_captured(capture_trace_launches(
            lambda: trace_sample(scene, cam, cs.SEED, depth=cs.DEPTH, include_sky=False,
                                 use_megakernel=False, use_pallas=False),
            ["trace_closest_brute"]), "trace_closest_brute", "A")
        cases.append(("A", flat[0], flat[1:4]))
        fcam = dungeon_camera(cs.FLAT_WIDTH, cs.FLAT_HEIGHT, device=dev)
        add_captured(capture_trace_launches(
            lambda: trace_sample(flat_scene, fcam, cs.SEED, depth=cs.DEPTH, include_sky=True,
                                 luts=luts),
            ["trace_closest_brute"]), "trace_closest_brute", "A", FLAT_PREFIX)
    if "B" in kernels:
        _, _, so, sd, slen = cs.bounce0_shadow_rays(scene, cam, cs.SEED)
        cases.append(("B", "cornell_bounce0_shadow", (rows, so, sd, slen)))
        add_captured(realtime, "trace_anyhit_brute", "B")
        cases.append(("B", flat[0], flat[1:]))
    if "4" in kernels:
        cases.append(("4", "cornell_primary", (packed_geom_rows(scene).contiguous(), po, pd)))
        add_captured(realtime, "trace_surface", "4")
    cases = [(k, name, x, x[1].numel() // 3) for k, name, x in cases]
    if "C" in kernels:
        variants = {"cornell": scene, "metallic_tall_box": metal,
                    "perturbed_normals": cs.perturbed(scene),
                    "perturbed_normals_metallic": cs.perturbed(metal)}
        mega = [("C", name, cs.megakernel_inputs(v, cam, cs.SEED), WIDTH * HEIGHT)
                for name, v in variants.items()]

    def prep(mod, k, x):
        lib = mod.cuda_lib.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        f32, i32 = dict(device=dev), dict(dtype=torch.int32, device=dev)
        if k in ("A", "4"):
            r, o, d = x
            batch = o.shape[:-1]
            outs = (torch.empty(batch, **f32), torch.empty(batch, **i32),
                    torch.empty(batch, **f32), torch.empty(batch, **f32))
            if k == "4":
                outs += (torch.empty(batch + (3,), **f32), torch.empty(batch + (2,), **f32),
                         torch.empty(batch, **i32))
            entry = lib.strolle_trace_closest_brute if k == "A" else lib.strolle_trace_surface
            args = (r.data_ptr(), r.shape[0], o.data_ptr(), d.data_ptr(), o.numel() // 3,
                    *(y.data_ptr() for y in outs), stream)
        elif k == "B":
            r, o, d, tm = x
            outs = (torch.empty(o.shape[:-1], dtype=torch.bool, device=dev),)
            entry = lib.strolle_trace_anyhit_brute
            args = (r.data_ptr(), r.shape[0], o.data_ptr(), d.data_ptr(), tm.data_ptr(),
                    o.numel() // 3, outs[0].data_ptr(), stream)
        else:
            outs = (torch.empty(x["o"].shape, **f32),)
            entry = lib.strolle_trace_sample_megakernel
            args = (x["tri_rows"].data_ptr(), x["tri_rows"].shape[0], x["mat_rows"].data_ptr(),
                    x["mat_rows"].shape[0], x["light_rows"].data_ptr(), x["light_rows"].shape[0],
                    int(x["lcount"]), x["o"].data_ptr(), x["d"].data_ptr(),
                    x["state0"].data_ptr(), WIDTH * HEIGHT, cs.DEPTH, int(bool(x["flat"])),
                    int(bool(x["no_metal"])), outs[0].data_ptr(), stream)

        def launch():
            mod.cuda_lib.check(f"kernel {k}", entry(*args))

        return launch, outs

    results = in_turns(order, labels, cases, prep, reps=20)
    results += in_turns(order, labels, mega, prep)
    # kernel C of a checkout that rounds otherwise: held as chip_smoke.py
    # holds C to its plain version
    within = []
    for _, name, x, _ in mega:
        want, = run(prep, order[labels.index("this")], "C", x)
        for lab, mod in dict(zip(labels, order)).items():
            got, = run(prep, mod, "C", x)
            diff = (got - want).abs().amax(-1)
            frac = (diff > 1e-3).float().mean().item()
            dmean = abs(got.mean().item() - want.mean().item())
            within.append(frac <= 1e-3 and dmean <= 1e-4)
            if lab != "this":
                print(f"kernel C {name}, {lab} against this: max diff {diff.max().item():.3g}, "
                      f"pixels > 1e-3: {frac:.2e}, means differ by {dmean:.2e}", flush=True)
            rk = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".ref_kernel")
            diff = (got - rk.trace_sample_megakernel_plain(**x, depth=cs.DEPTH)).abs().amax(-1)
            print(f"kernel C {name}, {lab} against its own plain version: max err "
                  f"{diff.max().item():.3g}, pixels > 1e-3: "
                  f"{(diff > 1e-3).float().mean().item():.2e}", flush=True)
    return results, captured_totals(results, labels, ("A", "B", "4")), within


def package_module(smod, name: str):
    """Module ``name`` (a path under the package) of the checkout whose
    stream-kernel module is ``smod``."""
    return importlib.import_module(smod.__name__.split(".")[0] + "." + name)


def probe_turns(order, labels, dev) -> tuple[list, dict]:
    """Kernel 7 in turns on the spatial passes' own inputs, captured from a
    Cornell and a dungeon realtime frame (DI on frame 0, GI on frame 1;
    chip_smoke.py's ``spatial_inputs``): the stack entry alone, through
    each checkout's C entry on this checkout's stack and tables; the route
    entry alone, in the checkouts that have it; and each checkout's whole
    fused pass, ``restir/di.py::probe_fused``, from the fields to its
    outputs (host time inside), with its device operations per call as it
    dispatches them and as ``torch.profiler`` traces them."""
    from strolle_tpu_torch.models.restir import RenderConfig
    from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
    from strolle_tpu_torch.scene.demo import dungeon_camera

    scene, cam = cornell_box(device=dev), cornell_camera(WIDTH, HEIGHT, device=dev)
    dg, luts = cs.dungeon_scene(dev)
    dcam = dungeon_camera(WIDTH, HEIGHT, device=dev)
    caps = {"cornell": cs.spatial_inputs(scene, cam, RenderConfig(), None),
            "dungeon": cs.spatial_inputs(dg, dcam, RenderConfig(include_sky=True), luts)}
    passes = [(f"{name}_{kind}", kind, cap[kind]) for name, cap in caps.items()
              for kind in ("di", "gi")]
    f32, i32 = dict(device=dev), dict(dtype=torch.int32, device=dev)

    def prep_stack(mod, k, x):
        stack, dy, dx, seed, kw = x
        _, h, w = stack.shape
        gi = kw["mode"] == "gi"
        outs = (torch.empty((h, w), **i32), torch.empty((h, w), **i32),
                torch.empty((h, w), dtype=torch.bool, device=dev)) + (
            (torch.empty((h, w), **f32),) if gi else ())
        lib = mod.cuda_lib.library()
        args = (stack.data_ptr(), h, w, dy.data_ptr(), dx.data_ptr(), int(seed) & 0xFFFFFFFF,
                int(gi), kw["tries"],
                kw["n_var"], kw["n_lvls"], kw["depth_tol"], kw["normal_min"],
                1.0 / kw.get("jac_reject", 10.0), kw.get("jac_reject", 10.0),
                1.0 / kw.get("jac_clamp", 3.0), kw.get("jac_clamp", 3.0),
                *(o.data_ptr() for o in outs[:3]), outs[3].data_ptr() if gi else None,
                torch.cuda.current_stream(dev).cuda_stream)

        def launch():
            mod.cuda_lib.check("kernel 7", lib.strolle_probe_spatial(*args))

        return launch, outs

    def prep_route(mod, k, x):
        fields, seed, state, kw = x
        pk = package_module(mod, "ops.kernels.probe_kernels")
        layouts = pk._check_route(fields, state, kw["mode"], kw["tries"], kw["radii"],
                                  kw["n_var"], kw["margin"], None)
        h, w = state.shape
        gi = kw["mode"] == "gi"
        outs = (torch.empty((h, w), **i32), torch.empty((h, w), **i32),
                torch.empty((h, w), dtype=torch.bool, device=dev),
                torch.empty((h, w), dtype=torch.int64, device=dev)) + (
            (torch.empty((h, w), **f32),) if gi else ())
        rows = [(f.data_ptr(), px, comp) for f, (px, comp) in zip(fields, layouts)]
        rows += [(0, 0, 0)] * (8 - len(rows))
        table = (ctypes.c_longlong * 24)(*(v for row in rows for v in row))
        radii = (ctypes.c_float * len(kw["radii"]))(*kw["radii"])
        lib = mod.cuda_lib.library()
        jr, jc = kw.get("jac_reject", 10.0), kw.get("jac_clamp", 3.0)
        args = (table, h, w, int(seed) & 0xFFFFFFFF, int(gi), kw["tries"], kw["n_var"],
                len(kw["radii"]), radii,
                kw["margin"], kw["depth_tol"], kw["normal_min"], 1.0 / jr, jr, 1.0 / jc, jc,
                *(o.data_ptr() for o in outs[:4]), outs[4].data_ptr() if gi else None, None,
                torch.cuda.current_stream(dev).cuda_stream)

        def launch():
            mod.cuda_lib.check("kernel 7 route", lib.strolle_probe_route(*args))

        return launch, outs

    def prep_fused(mod, k, x):
        kind, (pcam, surf, res, seed, _, t) = x
        di = package_module(mod, "restir.di")
        gi = package_module(mod, "restir.gi")
        tries, radius, gi_kw = cs.pass_tuning(kind, t)
        planes = (res.m,) if kind == "di" else gi.probe_planes(surf, res)
        xs, ys = package_module(mod, "camera").screen_xy(pcam)
        state = package_module(mod, "ops.rng").wnoise_new(seed, xs, ys)
        outs = []

        def launch():
            outs[:] = di.probe_fused(pcam, surf, planes, seed, tries, radius, state, **gi_kw)

        return launch, outs

    results = in_turns(order, labels, [("7", f"{name} stack", cs.probe_case(kind, args),
                                        HEIGHT * WIDTH) for name, kind, args in passes],
                       prep_stack, reps=20)
    with_route = [(m, lab) for m, lab in zip(order, labels)
                  if hasattr(package_module(m, "ops.kernels.probe_kernels"), "probe_route")]
    results += in_turns([m for m, _ in with_route], [lab for _, lab in with_route],
                        [("7", f"{name} route", cs.route_case(kind, args), HEIGHT * WIDTH)
                         for name, kind, args in passes], prep_route, reps=20)
    results += in_turns(order, labels, [("7", f"{name} fused", (kind, args), HEIGHT * WIDTH)
                                        for name, kind, args in passes], prep_fused)
    profiles = {}
    for lab, mod in dict(zip(labels, order)).items():
        for name, kind, args in passes:
            launch, _ = prep_fused(mod, "7", (kind, args))
            ops, _ = cs.dispatched_ops(launch, package_module(mod, "ops.kernels.cuda_lib"))
            prof = cs.profile_frames(launch, frames=5)
            profiles[f"{lab} {name}"] = {"dispatched_ops": ops, "profile": prof}
            traced = ("lost its device records" if prof is None else
                      f"{prof['device_ops_per_frame']:.1f} device ops, "
                      f"{prof['device_busy_ms']:.4f} ms busy, {prof['wall_ms']:.4f} ms wall a call")
            print(f"kernel 7 fused pass, {lab}, {name}: {ops} device ops dispatched; "
                  f"torch.profiler over 5 passes: {traced}", flush=True)
    return results, profiles


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("stream_turns: no CUDA device available", file=sys.stderr)
        return 2
    kernels = set(KERNELS)
    if argv[:1] == ["--kernels"]:
        kernels, argv = set(argv[1].split(",")), argv[2:]
    if not argv or not kernels <= set(KERNELS):
        print(__doc__, file=sys.stderr)
        return 2
    from strolle_tpu_torch.ops.kernels import stream_kernels as mine

    card = cs.card_line()
    print(card, flush=True)
    others = [load_kernels(Path(r).resolve(), f"turn_tree_{j}") for j, r in enumerate(argv)]
    names = [str(Path(r)) for r in argv]
    dev = torch.device(cs.DEVICE)
    order = others + [mine, mine] + others[::-1]
    labels = names + ["this", "this"] + names[::-1]
    results, totals, within = [], {}, []
    sass = {}
    if kernels & set(cs.BVH_SASS):
        for lab, mod in zip(names + ["this"], others + [mine]):
            counts = cs.sass_per_test(mod.cuda_lib.build()) or {}
            sass[lab] = {k: counts.get(k) for k in cs.BVH_SASS}
            print(f"SASS of kernels 10 and 11, {lab}: {sass[lab]}", flush=True)
    for walk, (_, (ks, _), (ka, _)) in WALKS.items():
        if kernels & {ks, ka}:
            r, t = walk_turns(order, labels, dev, walk, kernels)
            results += r
            totals.update(t)
    if kernels & {"A", "B", "4", "C"}:
        r, t, within = brute_turns(order, labels, dev, kernels)
        results += r
        totals.update(t)
    probe_profiles = {}
    if "7" in kernels:
        r, probe_profiles = probe_turns(order, labels, dev)
        results += r
    print(json.dumps({"card": card, "turns": labels, "sets": results,
                      "captured_total_ms": totals, "sass_10_11": sass,
                      "probe_fused_profiles": probe_profiles}))
    ok = all(all(r["equal"]) for r in results if r["kernel"] != "C")
    return 0 if ok and all(within) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

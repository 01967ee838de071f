"""Times kernels 5 and 6 (the big-scene stream kernels) and kernels B
(the brute-force any hit) and C (the reference-mode megakernel) of this
checkout against those of other checkouts, on the same inputs of the
same card, in turns.

Run from the root of the repository, on a CUDA card:

    python3 stream_turns.py [--kernels 5,6,B,C] OTHER_ROOT [OTHER_ROOT ...]

OTHER_ROOT is the root of another checkout of the repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that .gitignore lists). Each checkout's ``strolle_tpu_torch`` is imported
under a name of its own and builds its kernels from its own sources.
``--kernels`` picks the kernels to time (all four by default; 5 and 6
share their inputs and are timed together).

The inputs of kernels 5 and 6: the dungeon at 800x608 with the sun at
0.35 (chip_smoke.py's scene), chip_smoke.py's ray sets (primaries and
seeded random rays for kernel 5; bounce-0 shadow rays toward the lights,
rays toward the sun with t_max = inf and the random rays for kernel 6),
and the inputs of every kernel 5 and 6 launch of one reference sample
(depth 4, the sky) and of one 6-frame realtime GI cycle
(RenderConfig(include_sky=True)), named by the line that called
``trace_anyhit`` or ``trace_surface``. Kernel B: Cornell's bounce-0
shadow rays at 800x608 (the staged loop's), every kernel B launch of one
6-frame realtime GI cycle on Cornell (RenderConfig()), and the dungeon
without its BVH (8,393 rows) on chip_smoke.py's 65,536 random rays.
Kernel C: Cornell at 800x608, depth 4, in its four (flat, no_metal)
variants (chip_smoke.py's scenes).

The turns: for each set, the other checkouts in the order given, this
checkout twice, the others in reverse (A B B A). A turn launches the
checkout's kernel alone on inputs prepared once: kernels 5 and 6 through
its own ``cuda_lib.launch_walk`` and ``launch_head`` (sub-block boxes,
scene-box cap or clipped t_max: the wrappers' set-up, the same in every
checkout), B and C through its library's C entry point into outputs
allocated once. Each is timed with CUDA events (median of 15 after 3;
for B, of 20 launches in a row, divided by 20, so that the host's time
per launch stays out). Prints the card's line, per set the ms of every
turn and whether every turn's outputs equal this checkout's (tri and t
for 5, the flags for 6 and B, the radiance for C), the sum over the
captured launches per turn, and last one JSON object of all of it. For
C it also prints each checkout's kernel against its own plain version
(the largest difference, the share of pixels off by more than 1e-3).

Exits 1 if any turn's outputs differ from this checkout's, except C's
from a checkout whose kernel rounds otherwise (the parent of the
Baldwin-Weber repair): those must agree as chip_smoke.py holds C to its
plain version (at most 0.1% of pixels off by more than 1e-3, the means
within 1e-4).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

WIDTH, HEIGHT = 800, 608
GI_CYCLE = 6


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


def capture_launches(scene, cam, luts, dev) -> list:
    """(kernel, call site, o, d, t_max) of every kernel 5 and 6 launch of
    one reference sample and one realtime GI cycle on this checkout."""
    from strolle_tpu_torch.models.reference import trace_sample
    from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame_fused
    from strolle_tpu_torch.ops.kernels import stream_kernels as sk

    calls = []
    surface, anyhit = sk.stream_trace_surface, sk.stream_trace_anyhit

    def site() -> str:
        # the first caller outside ops/ (the trace dispatch, the checkerboard)
        f = sys._getframe(2)
        while f.f_back is not None and Path(f.f_code.co_filename).parent.name == "ops":
            f = f.f_back
        return f"{Path(f.f_code.co_filename).name}:{f.f_lineno}"

    def rec_surface(clus, rows, o, d, work=None):
        calls.append(("5", site(), o.clone(), d.clone(), None))
        return surface(clus, rows, o, d, work)

    def rec_anyhit(clus, rows, o, d, t_max, work=None):
        tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                                o.shape[:-1])
        calls.append(("6", site(), o.clone(), d.clone(), tm.clone()))
        return anyhit(clus, rows, o, d, t_max, work)

    sk.stream_trace_surface, sk.stream_trace_anyhit = rec_surface, rec_anyhit
    try:
        trace_sample(scene, cam, cs.SEED, depth=cs.DEPTH, include_sky=True, luts=luts)
        state = init_state(cam, device=dev)
        for f in range(GI_CYCLE):
            _, state = render_frame_fused(scene, cam, state, f, RenderConfig(include_sky=True),
                                          luts)
    finally:
        sk.stream_trace_surface, sk.stream_trace_anyhit = surface, anyhit
    torch.cuda.synchronize()
    return calls


def capture_brute_launches(scene, cam, dev) -> list:
    """(call site, rows, o, d, t_max) of every kernel B launch of one
    realtime GI cycle on Cornell on this checkout."""
    from strolle_tpu_torch.models.restir import init_state, render_frame_fused
    from strolle_tpu_torch.ops.kernels import trace_kernels as tk

    calls = []
    anyhit = tk.trace_anyhit_brute

    def rec_anyhit(rows, o, d, t_max):
        f = sys._getframe(1)
        while f.f_back is not None and Path(f.f_code.co_filename).parent.name == "ops":
            f = f.f_back
        tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                                o.shape[:-1])
        calls.append((f"{Path(f.f_code.co_filename).name}:{f.f_lineno}", rows.contiguous(),
                      o.contiguous().clone(), d.contiguous().clone(), tm.contiguous().clone()))
        return anyhit(rows, o, d, t_max)

    tk.trace_anyhit_brute = rec_anyhit
    try:
        state = init_state(cam, device=dev)
        for f in range(GI_CYCLE):
            _, state = render_frame_fused(scene, cam, state, f)
    finally:
        tk.trace_anyhit_brute = anyhit
    torch.cuda.synchronize()
    return calls


def in_turns(order, labels, cases, run, reps: int = 1) -> list:
    """Times ``run(mod, k, x)`` of every checkout in ``order`` on every
    case (kernel k, set, x, rays), ``reps`` launches per timed call, and
    holds each turn's outputs (a tuple of tensors) equal to this
    checkout's."""
    results = []
    for k, name, x, n in cases:
        want = run(order[labels.index("this")], k, x)
        ms, equal = [], []
        for mod in order:
            got = run(mod, k, x)
            equal.append(all(torch.equal(a, b) for a, b in zip(got, want)))

            def launches(mod=mod):
                for _ in range(reps):
                    run(mod, k, x)

            ms.append(cs.time_ms(launches) / reps)
        results.append({"kernel": k, "set": name, "rays": n, "ms": ms, "equal": equal})
        print(f"kernel {k} {name} ({n} rays): "
              + ", ".join(f"{lab} {t:.4f}" for lab, t in zip(labels, ms))
              + f" ms; outputs equal {all(equal)}", flush=True)
    return results


def captured_totals(results, labels, kernels) -> dict:
    """The sum over each kernel's captured launches, per turn."""
    totals = {}
    for k in kernels:
        picked = [r["ms"] for r in results if r["kernel"] == k and "#" in r["set"]]
        if not picked:
            continue
        totals[k] = [sum(col) for col in zip(*picked)]
        print(f"kernel {k}, the {len(picked)} captured launches: "
              + ", ".join(f"{lab} {t:.3f}" for lab, t in zip(labels, totals[k])) + " ms",
              flush=True)
    return totals


def stream_turns(order, labels, dev) -> tuple[list, dict]:
    """Kernels 5 and 6 in turns on the dungeon's sets and captured launches."""
    from strolle_tpu_torch.scene.demo import dungeon_camera

    scene, luts = cs.dungeon_scene(dev)
    cam = dungeon_camera(WIDTH, HEIGHT, device=dev)
    sets = cs.stream_ray_sets(scene, cam, dev, luts)
    rays = [("5", "primary", sets["primary"][0], sets["primary"][1], None),
            ("5", "random", *sets["random"][:2], None)]
    rays += [("6", name, *sets[name]) for name in ("lights", "sun", "random")]
    captured = capture_launches(scene, cam, luts, dev)
    seen: dict = {}
    for k, where, o, d, tm in captured:
        seen[(k, where)] = seen.get((k, where), 0) + 1
        rays.append((k, f"{where}#{seen[(k, where)]}", o, d, tm))
    print(f"{len(captured)} kernel 5/6 launches captured", flush=True)
    cases = [(k, name, cs.stream_inputs(scene, o.contiguous(), d.contiguous(),
                                        tm if k == "6" else None), o.numel() // 3)
             for k, name, o, d, tm in rays]

    def run(mod, k, x):
        batch = x["o"].shape[:-1]
        if k == "5":
            t = torch.empty(batch, device=dev)
            tri = torch.empty(batch, dtype=torch.int32, device=dev)
            outs, entry = (t, tri, torch.empty_like(t), torch.empty_like(t)), "surface"
        else:
            outs, entry = (torch.empty(batch, dtype=torch.bool, device=dev),), "anyhit"
        mod.cuda_lib.launch_walk(f"strolle_stream_trace_{entry}",
                                 mod.launch_head(x["clus"], x["subs"], x["rows"]), x["o"],
                                 x["d"], x["cap"], outs, None)
        return (outs[1], outs[0]) if k == "5" else outs

    results = in_turns(order, labels, cases, run)
    return results, captured_totals(results, labels, ("5", "6"))


def brute_turns(order, labels, dev, kernels) -> tuple[list, dict, list]:
    """Kernels B and C (those of ``kernels``) in turns: B on Cornell's
    bounce-0 shadow rays, the launches of one realtime GI cycle and the
    BVH-less dungeon, C in its four variants; also each checkout's C
    against its own plain version."""
    from strolle_tpu_torch.ops.trace import packed_tri_rows
    from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera

    scene = cornell_box(device=dev)
    metal = cornell_box(metallic_tall_box=True, device=dev)
    cam = cornell_camera(WIDTH, HEIGHT, device=dev)
    cases, mega = [], []
    if "B" in kernels:
        rows = packed_tri_rows(scene).contiguous()
        _, _, so, sd, slen = cs.bounce0_shadow_rays(scene, cam, cs.SEED)
        cases.append(("B", "cornell_bounce0_shadow", (rows, so, sd, slen)))
        seen: dict = {}
        captured = capture_brute_launches(scene, cam, dev)
        for where, r, o, d, tm in captured:
            seen[where] = seen.get(where, 0) + 1
            cases.append(("B", f"{where}#{seen[where]}", (r, o, d, tm)))
        print(f"{len(captured)} kernel B launches captured", flush=True)
        dg, _ = cs.dungeon_scene(dev)
        flat_rows = packed_tri_rows(dg.replace(bvh=None, clusters=None)).contiguous()
        cases.append(("B", f"dungeon_without_bvh_{flat_rows.shape[0]}_rows",
                      (flat_rows, *cs.level_random_rays(dg, dev))))
        cases = [(k, name, x, x[1].numel() // 3) for k, name, x in cases]
    if "C" in kernels:
        variants = {"cornell": scene, "metallic_tall_box": metal,
                    "perturbed_normals": cs.perturbed(scene),
                    "perturbed_normals_metallic": cs.perturbed(metal)}
        mega = [("C", name, cs.megakernel_inputs(v, cam, cs.SEED), WIDTH * HEIGHT)
                for name, v in variants.items()]

    def run(mod, k, x):
        lib = mod.cuda_lib.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if k == "B":
            r, o, d, tm = x
            n = o.numel() // 3
            occ = torch.empty(o.shape[:-1], dtype=torch.bool, device=dev)
            err = lib.strolle_trace_anyhit_brute(r.data_ptr(), r.shape[0], o.data_ptr(),
                                                 d.data_ptr(), tm.data_ptr(), n, occ.data_ptr(),
                                                 stream)
            out = occ
        else:
            out = torch.empty(x["o"].shape, dtype=torch.float32, device=dev)
            err = lib.strolle_trace_sample_megakernel(
                x["tri_rows"].data_ptr(), x["tri_rows"].shape[0], x["mat_rows"].data_ptr(),
                x["mat_rows"].shape[0], x["light_rows"].data_ptr(), x["light_rows"].shape[0],
                int(x["lcount"]), x["o"].data_ptr(), x["d"].data_ptr(), x["state0"].data_ptr(),
                WIDTH * HEIGHT, cs.DEPTH, int(bool(x["flat"])), int(bool(x["no_metal"])),
                out.data_ptr(), stream)
        mod.cuda_lib.check(f"kernel {k}", err)
        return (out,)

    results = in_turns(order, labels, cases, run, reps=20)
    results += in_turns(order, labels, mega, run)
    # kernel C of a checkout that rounds otherwise: held as chip_smoke.py
    # holds C to its plain version
    within = []
    for _, name, x, _ in mega:
        want, = run(order[labels.index("this")], "C", x)
        for lab, mod in dict(zip(labels, order)).items():
            got, = run(mod, "C", x)
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
    return results, captured_totals(results, labels, ("B",)), within


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("stream_turns: no CUDA device available", file=sys.stderr)
        return 2
    kernels = {"5", "6", "B", "C"}
    if argv[:1] == ["--kernels"]:
        kernels, argv = set(argv[1].split(",")), argv[2:]
    if not argv or not kernels <= {"5", "6", "B", "C"}:
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
    if kernels & {"5", "6"}:
        r, t = stream_turns(order, labels, dev)
        results += r
        totals.update(t)
    if kernels & {"B", "C"}:
        r, t, within = brute_turns(order, labels, dev, kernels)
        results += r
        totals.update(t)
    print(json.dumps({"card": card, "turns": labels, "sets": results,
                      "captured_total_ms": totals}))
    ok = all(all(r["equal"]) for r in results if r["kernel"] != "C")
    return 0 if ok and all(within) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

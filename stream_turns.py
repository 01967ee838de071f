"""Times kernels 5 and 6 (the big-scene stream kernels) of this checkout
against those of other checkouts, on the same rays of the same card, in
turns.

Run from the root of the repository, on a CUDA card:

    python3 stream_turns.py OTHER_ROOT [OTHER_ROOT ...]

OTHER_ROOT is the root of another checkout of the repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that .gitignore lists). Each checkout's ``strolle_tpu_torch`` is imported
under a name of its own and builds its kernels from its own sources.

The rays: the dungeon at 800x608 with the sun at 0.35 (chip_smoke.py's
scene), chip_smoke.py's ray sets (primaries and seeded random rays for
kernel 5; bounce-0 shadow rays toward the lights, rays toward the sun
with t_max = inf and the random rays for kernel 6), and the inputs of
every kernel 5 and 6 launch of one reference sample (depth 4, the sky)
and of one 6-frame realtime GI cycle (RenderConfig(include_sky=True)),
named by the line that called ``trace_anyhit`` or ``trace_surface``.

The turns: for each set, the other checkouts in the order given, this
checkout twice, the others in reverse (A B B A). A turn launches the
checkout's kernel through its own ``cuda_lib.launch_walk`` and
``launch_head`` on inputs prepared once (sub-block boxes, scene-box cap or
clipped t_max: the wrappers' set-up, the same in every checkout), timed
with CUDA events (median of 15 launches after 3). Prints the card's line,
per set the ms of every turn and whether every turn's outputs equal this
checkout's (tri and t for 5, the flags for 6), the sum over the captured
launches per turn, and last one JSON object of all of it.
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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("stream_turns: no CUDA device available", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    from strolle_tpu_torch.ops.kernels import stream_kernels as mine
    from strolle_tpu_torch.scene.demo import dungeon_camera

    card = cs.card_line()
    print(card, flush=True)
    others = [load_kernels(Path(r).resolve(), f"turn_tree_{j}") for j, r in enumerate(argv)]
    names = [str(Path(r)) for r in argv]
    dev = torch.device(cs.DEVICE)
    scene, luts = cs.dungeon_scene(dev)
    cam = dungeon_camera(WIDTH, HEIGHT, device=dev)
    sets = cs.stream_ray_sets(scene, cam, dev, luts)
    cases = [("5", "primary", sets["primary"][0], sets["primary"][1], None),
             ("5", "random", *sets["random"][:2], None)]
    cases += [("6", name, *sets[name]) for name in ("lights", "sun", "random")]
    captured = capture_launches(scene, cam, luts, dev)
    seen: dict = {}
    for k, where, o, d, tm in captured:
        seen[(k, where)] = seen.get((k, where), 0) + 1
        cases.append((k, f"{where}#{seen[(k, where)]}", o, d, tm))
    print(f"{len(captured)} launches captured", flush=True)

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

    order = others + [mine, mine] + others[::-1]
    labels = names + ["this", "this"] + names[::-1]
    results = []
    for k, name, o, d, tm in cases:
        x = cs.stream_inputs(scene, o.contiguous(), d.contiguous(), tm if k == "6" else None)
        want = run(mine, k, x)
        ms, equal = [], []
        for mod in order:
            got = run(mod, k, x)
            equal.append(all(torch.equal(a, b) for a, b in zip(got, want)))
            ms.append(cs.time_ms(lambda mod=mod: run(mod, k, x)))
        n = o.numel() // 3
        results.append({"kernel": k, "set": name, "rays": n, "ms": ms, "equal": equal})
        print(f"kernel {k} {name} ({n} rays): "
              + ", ".join(f"{lab} {t:.4f}" for lab, t in zip(labels, ms))
              + f" ms; outputs equal {all(equal)}", flush=True)
    totals = {}
    for k in ("5", "6"):
        picked = [r["ms"] for r in results if r["kernel"] == k and "#" in r["set"]]
        totals[k] = [sum(col) for col in zip(*picked)]
        print(f"kernel {k}, the {len(picked)} captured launches: "
              + ", ".join(f"{lab} {t:.3f}" for lab, t in zip(labels, totals[k])) + " ms",
              flush=True)
    print(json.dumps({"card": card, "turns": labels, "sets": results,
                      "captured_total_ms": totals}))
    return 0 if all(all(r["equal"]) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

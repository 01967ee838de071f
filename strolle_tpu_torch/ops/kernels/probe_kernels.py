"""The ReSTIR DI/GI spatial neighbour probe (port of
strolle_tpu/ops/pallas/probe_kernels.py: ``probe_spatial_pallas``).

Each pixel makes up to ``tries`` tries at shared per-try offsets
(ops/offsets.py). At try t it draws one word of its PCG stream (seeded
``seed ^ 48619x ^ 95461y``), picks the table entry ``sel = level * n_var
+ word % n_var`` and taps the fields at the mirrored ``(y + dy[t*V +
sel], x + dx[t*V + sel])`` (V = n_lvls * n_var). A tap on the pixel
itself is skipped; a tap that fails the similarity gates (no surface,
depth off by more than ``depth_tol`` of the centre's, normal dot below
``normal_min``) moves the pixel one radius level down; a tap that passes
them with a non-empty reservoir (m > 0) is accepted and ends the search.
In GI mode an accepted tap must also have a reconnection Jacobian in
[1/jac_reject, jac_reject]; the Jacobian, clamped to [1/jac_clamp,
jac_clamp], is returned.

Kernel 7 (``csrc/probe_kernels.cu``, one thread per pixel) has two
entries, each with its plain version here:

- ``probe_route``, the spatial passes' own (``restir/di.py::probe_fused``):
  the fields as they lie (depth, normal, is_some as bool, m and, in GI
  mode, v1_point, v2_point, v2_normal and the surface point), the tables
  drawn from the seed inside the kernel (``draw_tables_plain``), and
  what the pass needs back: the accepted neighbour's mirrored
  coordinates, the accept mask, each pixel's stream after ``tries``
  words and, in GI mode, the Jacobian. On the card that is one launch.
- ``probe_spatial``, the JAX kernel's contract: a float32 [P, H, W]
  stack (depth, normal x y z, is_some as 0/1, m: P = 6, DI; in GI mode
  also v1_point, v2_point, v2_normal and the surface point, three planes
  each: P = 18) and int32 [tries * V] tables given; it returns the
  accepted offsets.

Every table entry lies within +-``margin`` and ``margin`` is below both
screen sizes (``offsets.probe_margin``), so one reflection brings every
tap back on screen.

The plain versions repeat the TPU kernel's own arithmetic: the normal dot
as ``(a*b + c*d) + e*f``, the Jacobian's direction as ``v * (1 / max(|v|,
1e-20))`` from the raw v1 taps. In DI mode that is exactly the tensor
probe of ``restir/di.py``; in GI mode the tensor probe divides instead
and probes precomputed candidate terms, so the two can differ in the
last bits of the Jacobian. Each wrapper runs its plain version for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import rng
from . import cuda_lib

#: Stack planes of each mode.
PLANES = {"di": 6, "gi": 18}
#: The route entry's fields of each mode, in the kernel's order, with
#: their components (1: [H, W], 3: [H, W, 3]); is_some is bool, the
#: others float32.
ROUTE_FIELDS = {
    "di": (("depth", 1), ("normal", 3), ("is_some", 1), ("m", 1)),
    "gi": (("depth", 1), ("normal", 3), ("is_some", 1), ("m", 1), ("v1_point", 3),
           ("v2_point", 3), ("v2_normal", 3), ("point", 3)),
}
#: Most tries the kernel takes (the reference's spatial passes make 8).
MAX_TRIES = 8
#: Most radius levels the route entry takes (the default tuning's 128 px
#: make 6).
MAX_LEVELS = 16


def try_seed(seed: int, nth: int) -> int:
    """The offset-table seed of spatial try ``nth`` (``restir/di.py``'s)."""
    return (int(seed) ^ ((0x9E3779B9 * (nth + 1)) & rng.MASK32)) & rng.MASK32


def draw_tables_plain(seed: int, tries: int, radii, n_var: int, margin: int, device):
    """The per-try shared offset tables, (dy, dx) int32 [tries * V], drawn
    in one pass as the route entry's blocks draw them: entry k of try t
    is ``offsets.draw_offset_table(try_seed(seed, t), radii, n_var,
    margin)``'s, from the stream ``wnoise_new(try_seed(seed, t), k, k //
    n_var)``."""
    v = len(radii) * n_var
    k = torch.arange(tries * v, dtype=torch.int64, device=device)
    e = k % v
    lvl = e // n_var
    seeds = torch.tensor([try_seed(seed, t) for t in range(tries)], dtype=torch.int64,
                         device=device)
    # wnoise_new(try_seed(seed, t), e, lvl), each entry under its try's seed
    state = rng.wnoise_new(0, e, lvl) ^ seeds[k // v]
    _, disk = rng.sample_disk(state)
    r = torch.tensor(radii, dtype=torch.float32, device=device)[lvl]
    dx = torch.clamp((disk[..., 0] * r).to(torch.int32), -margin, margin)
    dy = torch.clamp((disk[..., 1] * r).to(torch.int32), -margin, margin)
    return dy, dx


def _mirror(v: torch.Tensor, n: int) -> torch.Tensor:
    """camera.contain_xy on one axis (low edge reflect, high edge
    symmetric), then clamped on screen: a no-op for taps within the
    margin, and a memory guard for tables outside it."""
    v = torch.where(v < 0, -v, v)
    v = torch.where(v >= n, 2 * n - v - 1, v)
    return torch.clamp(v, 0, n - 1)


def _jacobian_part(px, py, pz, v2, v2n):
    """(distance, saturated cosine) of a point seen from the sample's v2
    vertex, with the TPU kernel's reciprocal multiply."""
    vx, vy, vz = px - v2[0], py - v2[1], pz - v2[2]
    d = torch.sqrt((vx * vx + vy * vy) + vz * vz)
    inv = torch.reciprocal(torch.clamp(d, min=1e-20))
    cos = (v2n[0] * (vx * inv) + v2n[1] * (vy * inv)) + v2n[2] * (vz * inv)
    return d, torch.clamp(cos, 0.0, 1.0)


def probe_spatial_plain(stack, dy_tab, dx_tab, seed, *, mode, tries, n_var, n_lvls, margin,
                        depth_tol, normal_min, jac_reject=10.0, jac_clamp=3.0, work=None):
    """Plain version of kernel 7; arguments and results as ``probe_spatial``.
    ``work`` (optional, int32 [H, W]) accumulates the tries each pixel
    makes up to and including the one it accepts: the work the function
    needs, later tries change nothing."""
    _check(stack, dy_tab, dx_tab, mode, tries, n_var, n_lvls, margin)
    p, h, w = stack.shape
    dev = stack.device
    v = n_lvls * n_var
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    state = rng.wnoise_new(seed, xs, ys)
    flat = stack.reshape(p, h * w)
    c_depth = stack[0]
    gi = mode == "gi"
    if gi:
        j_lo, j_hi = 1.0 / jac_reject, jac_reject
        c_lo, c_hi = 1.0 / jac_clamp, jac_clamp
        jac_r = torch.zeros((h, w), dtype=torch.float32, device=dev)
    level = torch.zeros((h, w), dtype=torch.int32, device=dev)
    done = torch.zeros((h, w), dtype=torch.bool, device=dev)
    oy_r = torch.zeros((h, w), dtype=torch.int32, device=dev)
    ox_r = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for t in range(tries):
        if work is not None:
            work += (~done).to(torch.int32)
        state, word = rng.next_u32(state)
        entry = (t * v + level * n_var + (word % n_var).to(torch.int32)).long()
        oy_t, ox_t = dy_tab[entry], dx_tab[entry]
        y2, x2 = _mirror(ys + oy_t, h), _mirror(xs + ox_t, w)
        same = (x2 == xs) & (y2 == ys)
        taps = flat[:, (y2.long() * w + x2.long())]  # [P, H, W]
        depth_bad = torch.abs(taps[0] - c_depth) > depth_tol * c_depth
        ndot = (taps[1] * stack[1] + taps[2] * stack[2]) + taps[3] * stack[3]
        gate_fail = ~(taps[4] > 0.5) | depth_bad | (ndot < normal_min)
        shrink = ~done & ~same & gate_fail
        level = torch.where(shrink, torch.clamp(level + 1, max=n_lvls - 1), level)
        accept = ~done & ~same & ~gate_fail & (taps[5] > 0.0)
        if gi:
            # the candidate's v2 vertex seen from the centre's point and
            # from the candidate's own v1
            v2, v2n = taps[9:12], taps[12:15]
            nd, nc = _jacobian_part(stack[15], stack[16], stack[17], v2, v2n)
            od, oc = _jacobian_part(taps[6], taps[7], taps[8], v2, v2n)
            xj = nc * od * od
            yj = oc * nd * nd
            flat_y = yj == 0.0
            j = torch.where(flat_y, 0.0, xj / torch.where(flat_y, 1.0, yj))
            exists = (v2[0] != 0.0) | (v2[1] != 0.0) | (v2[2] != 0.0)
            j = torch.where(exists, j, 1.0)
            accept = accept & (j >= j_lo) & (j <= j_hi)
            jac_r = torch.where(accept, torch.clamp(j, c_lo, c_hi), jac_r)
        oy_r = torch.where(accept, oy_t, oy_r)
        ox_r = torch.where(accept, ox_t, ox_r)
        done = done | accept
    if gi:
        return oy_r, ox_r, done, jac_r
    return oy_r, ox_r, done


def _check(stack, dy_tab, dx_tab, mode, tries, n_var, n_lvls, margin):
    if mode not in PLANES:
        raise ValueError(f"probe_spatial: mode must be 'di' or 'gi', got {mode!r}")
    if stack.ndim != 3 or stack.shape[0] != PLANES[mode] or stack.dtype != torch.float32:
        raise ValueError(f"probe_spatial: {mode} mode takes a float32 [{PLANES[mode]}, H, W] "
                         f"stack, got {stack.dtype} {tuple(stack.shape)}")
    n = tries * n_lvls * n_var
    for tab in (dy_tab, dx_tab):
        if tab.dtype != torch.int32 or tuple(tab.shape) != (n,) or tab.device != stack.device:
            raise ValueError(f"probe_spatial: offset tables must be int32 [{n}] on "
                             f"{stack.device}, got {tab.dtype} {tuple(tab.shape)} on {tab.device}")
    if not 0 < margin < min(stack.shape[1:]):
        raise ValueError(f"probe_spatial: margin {margin} must lie in [1, min(H, W) - 1]")
    if stack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"probe_spatial: unsupported device {stack.device}")


def probe_spatial(stack, dy_tab, dx_tab, seed, *, mode, tries, n_var, n_lvls, margin,
                  depth_tol, normal_min, jac_reject=10.0, jac_clamp=3.0):
    """Kernel 7's stack entry: the spatial probe over a float32 [P, H, W]
    field stack with int32 [tries * n_lvls * n_var] offset tables and a
    u32 ``seed``. Returns (oy, ox, found) as int32, int32 and bool [H, W]
    tensors, and in GI mode also the clamped Jacobian (float32 [H, W]):
    each pixel's accepted offset (0 where none) and accept mask. CPU
    tensors run the plain version; CUDA tensors launch kernel 7 (1 to
    MAX_TRIES tries)."""
    if stack.device.type == "cpu":
        return probe_spatial_plain(
            stack, dy_tab, dx_tab, seed, mode=mode, tries=tries, n_var=n_var, n_lvls=n_lvls,
            margin=margin, depth_tol=depth_tol, normal_min=normal_min, jac_reject=jac_reject,
            jac_clamp=jac_clamp)
    _check(stack, dy_tab, dx_tab, mode, tries, n_var, n_lvls, margin)
    if not 1 <= tries <= MAX_TRIES:
        raise ValueError(f"probe_spatial: the kernel takes 1 to {MAX_TRIES} tries, got {tries}")
    cuda_lib.check_tensors("probe_spatial", stack, dy_tab, dx_tab)
    _, h, w = stack.shape
    dev = stack.device
    gi = mode == "gi"
    oy = torch.empty((h, w), dtype=torch.int32, device=dev)
    ox = torch.empty_like(oy)
    found = torch.empty((h, w), dtype=torch.bool, device=dev)
    jac = torch.empty((h, w), dtype=torch.float32, device=dev) if gi else None
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        err = lib.strolle_probe_spatial(
            stack.data_ptr(), h, w, dy_tab.data_ptr(), dx_tab.data_ptr(),
            int(seed) & rng.MASK32, int(gi), tries, n_var, n_lvls, depth_tol, normal_min,
            1.0 / jac_reject, jac_reject, 1.0 / jac_clamp, jac_clamp,
            oy.data_ptr(), ox.data_ptr(), found.data_ptr(), None if jac is None else jac.data_ptr(),
            cuda_lib.stream(dev),
        )
    cuda_lib.check("probe_spatial", err)
    cuda_lib.count_launch("probe_spatial_gi" if gi else "probe_spatial_di")
    return (oy, ox, found, jac) if gi else (oy, ox, found)


def probe_route_plain(fields, seed, state, *, mode, tries, radii, n_var, margin, depth_tol,
                      normal_min, jac_reject=10.0, jac_clamp=3.0, tables_out=None):
    """Plain version of kernel 7's route entry; arguments and results as
    ``probe_route``: the stack of ``probe_spatial``, the tables of
    ``draw_tables_plain``, ``probe_spatial_plain``, the accepted taps
    mirrored (0 where none) and ``state`` advanced by ``tries`` words."""
    _check_route(fields, state, mode, tries, radii, n_var, margin, tables_out)
    depth, normal, is_some, m, *vectors = fields
    stack = torch.stack([depth, *normal.unbind(-1), is_some.to(torch.float32), m,
                         *(c for f in vectors for c in f.unbind(-1))])
    dy, dx = draw_tables_plain(seed, tries, radii, n_var, margin, depth.device)
    if tables_out is not None:
        tables_out.copy_(torch.stack([dy, dx]))
    out = probe_spatial_plain(stack, dy, dx, seed, mode=mode, tries=tries, n_var=n_var,
                              n_lvls=len(radii), margin=margin, depth_tol=depth_tol,
                              normal_min=normal_min, jac_reject=jac_reject, jac_clamp=jac_clamp)
    oy, ox, found = out[:3]
    h, w = depth.shape
    ys = torch.arange(h, dtype=torch.int32, device=depth.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=depth.device)[None, :]
    rhs_x = torch.where(found, _mirror(xs + ox, w), 0)
    rhs_y = torch.where(found, _mirror(ys + oy, h), 0)
    for _ in range(tries):
        state, _ = rng.next_u32(state)
    return (rhs_x, rhs_y, found, state) + tuple(out[3:])


def _layout(name: str, f: torch.Tensor, h: int, w: int, comps: int) -> tuple[int, int]:
    """(pixel stride, component stride) in elements of a field the kernel
    reads in place: pixel (y, x) at (y * W + x) * pixel stride, every
    offset below 2^31."""
    px = f.stride(1) if w > 1 else f.stride(0)
    if h > 1 and f.stride(0) != w * px:
        raise ValueError(f"probe_route: {name}'s rows are not at W times its pixel stride "
                         f"(strides {f.stride()})")
    comp = f.stride(2) if comps == 3 else 0
    if (h * w - 1) * px + 2 * comp >= 2**31:
        raise ValueError(f"probe_route: {name} spans 2^31 elements or more")
    return px, comp


def _check_route(fields, state, mode, tries, radii, n_var, margin, tables_out):
    """Validates the route entry's arguments; returns each field's layout."""
    if mode not in ROUTE_FIELDS:
        raise ValueError(f"probe_route: mode must be 'di' or 'gi', got {mode!r}")
    names = ROUTE_FIELDS[mode]
    if len(fields) != len(names):
        raise ValueError(f"probe_route: {mode} mode takes {len(names)} fields "
                         f"({', '.join(n for n, _ in names)}), got {len(fields)}")
    h, w = fields[0].shape
    dev = fields[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"probe_route: unsupported device {dev}")
    layouts = []
    for f, (name, comps) in zip(fields, names):
        dtype = torch.bool if name == "is_some" else torch.float32
        shape = (h, w) if comps == 1 else (h, w, 3)
        if f.dtype != dtype or tuple(f.shape) != shape or f.device != dev:
            raise ValueError(f"probe_route: {name} must be {dtype} {list(shape)} on {dev}, got "
                             f"{f.dtype} {list(f.shape)} on {f.device}")
        layouts.append(_layout(name, f, h, w, comps))
    if state.dtype != torch.int64 or tuple(state.shape) != (h, w) or state.device != dev:
        raise ValueError(f"probe_route: state must be int64 [{h}, {w}] on {dev}")
    if not 1 <= len(radii) <= MAX_LEVELS or n_var < 1:
        raise ValueError(f"probe_route: 1 to {MAX_LEVELS} radius levels and n_var >= 1, got "
                         f"{len(radii)} and {n_var}")
    if not 0 < margin < min(h, w):
        raise ValueError(f"probe_route: margin {margin} must lie in [1, min(H, W) - 1]")
    n = tries * len(radii) * n_var
    if tables_out is not None and (tables_out.dtype != torch.int32 or tuple(tables_out.shape)
                                   != (2, n) or tables_out.device != dev
                                   or not tables_out.is_contiguous()):
        raise ValueError(f"probe_route: tables_out must be contiguous int32 [2, {n}] on {dev}")
    return layouts


def probe_route(fields, seed, state, *, mode, tries, radii, n_var, margin, depth_tol,
                normal_min, jac_reject=10.0, jac_clamp=3.0, tables_out=None):
    """Kernel 7's route entry: one spatial pass's probe over ``fields`` as
    they lie (``ROUTE_FIELDS``: depth, normal, is_some, m and in GI mode
    v1_point, v2_point, v2_normal and the surface point; each [H, W] or
    [H, W, 3] with its pixels in row-major order at one stride, as any
    contiguous tensor and its component views have them), with the
    tables drawn from the u32 ``seed`` over the radius ladder ``radii``.
    ``state`` (int64 [H, W]) is the pass's stream, ``rng.wnoise_new(seed,
    x, y)``: the kernel seeds it from ``seed`` itself and does not read
    it. Returns (rhs_x, rhs_y, found, state advanced by ``tries`` words)
    and in GI mode also the clamped Jacobian: the accepted neighbour's
    mirrored coordinates (int32, 0 where none), the accept mask (bool),
    the stream (int64) and float32, all [H, W]. ``tables_out`` (optional,
    int32 [2, tries * V]) receives the tables (dy, then dx). CPU tensors
    run the plain version; CUDA tensors launch kernel 7 (1 to MAX_TRIES
    tries), copying nothing: a field the kernel cannot read in place
    raises."""
    kw = dict(mode=mode, tries=tries, radii=radii, n_var=n_var, margin=margin,
              depth_tol=depth_tol, normal_min=normal_min, jac_reject=jac_reject,
              jac_clamp=jac_clamp, tables_out=tables_out)
    if fields[0].device.type == "cpu":
        return probe_route_plain(fields, seed, state, **kw)
    layouts = _check_route(fields, state, mode, tries, radii, n_var, margin, tables_out)
    if not 1 <= tries <= MAX_TRIES:
        raise ValueError(f"probe_route: the kernel takes 1 to {MAX_TRIES} tries, got {tries}")
    h, w = fields[0].shape
    dev = fields[0].device
    gi = mode == "gi"
    i32 = dict(dtype=torch.int32, device=dev)
    rhs_x, rhs_y = torch.empty((h, w), **i32), torch.empty((h, w), **i32)
    found = torch.empty((h, w), dtype=torch.bool, device=dev)
    new_state = torch.empty((h, w), dtype=torch.int64, device=dev)
    jac = torch.empty((h, w), dtype=torch.float32, device=dev) if gi else None
    rows = [(f.data_ptr(), px, comp) for f, (px, comp) in zip(fields, layouts)]
    rows += [(0, 0, 0)] * (8 - len(rows))
    table = (ctypes.c_longlong * 24)(*(v for row in rows for v in row))
    radii_f = (ctypes.c_float * len(radii))(*radii)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        err = lib.strolle_probe_route(
            table, h, w, int(seed) & rng.MASK32, int(gi), tries, n_var, len(radii), radii_f,
            margin, depth_tol, normal_min, 1.0 / jac_reject, jac_reject, 1.0 / jac_clamp,
            jac_clamp, rhs_x.data_ptr(), rhs_y.data_ptr(), found.data_ptr(), new_state.data_ptr(),
            None if jac is None else jac.data_ptr(),
            None if tables_out is None else tables_out.data_ptr(), cuda_lib.stream(dev),
        )
    cuda_lib.check("probe_route", err)
    cuda_lib.count_launch("probe_spatial_gi" if gi else "probe_spatial_di")
    return (rhs_x, rhs_y, found, new_state, jac) if gi else (rhs_x, rhs_y, found, new_state)

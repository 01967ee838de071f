"""The ReSTIR DI/GI spatial neighbour probe (port of
strolle_tpu/ops/pallas/probe_kernels.py: ``probe_spatial_pallas``).

Each pixel makes up to ``tries`` tries at shared per-try offsets
(ops/offsets.py). At try t it draws one word of its PCG stream (seeded
``seed ^ 48619x ^ 95461y``), picks the table entry ``sel = level * n_var
+ word % n_var`` and taps the field stack at the mirrored ``(y + dy[t*V
+ sel], x + dx[t*V + sel])`` (V = n_lvls * n_var). A tap on the pixel
itself is skipped; a tap that fails the similarity gates (no surface,
depth off by more than ``depth_tol`` of the centre's, normal dot below
``normal_min``) moves the pixel one radius level down; a tap that passes
them with a non-empty reservoir (m > 0) is accepted and ends the search.
In GI mode an accepted tap must also have a reconnection Jacobian in
[1/jac_reject, jac_reject]; the Jacobian, clamped to [1/jac_clamp,
jac_clamp], is returned.

The stack is float32 [P, H, W]: depth, normal x y z, is_some (0/1), m
(P = 6, DI) and, in GI mode, v1_point, v2_point, v2_normal and the
surface point, three planes each (P = 18). The offset tables are int32
[tries * V]; every entry lies within +-``margin`` and ``margin`` is below
both screen sizes (``offsets.probe_margin``), so one reflection brings
every tap back on screen.

The plain version repeats the TPU kernel's own arithmetic: the normal dot
as ``(a*b + c*d) + e*f``, the Jacobian's direction as ``v * (1 / max(|v|,
1e-20))`` from the raw v1 taps. In DI mode that is exactly the tensor
probe of ``restir/di.py``; in GI mode the tensor probe divides instead
and probes precomputed candidate terms, so the two can differ in the
last bits of the Jacobian. The CUDA kernel (``csrc/probe_kernels.cu``)
runs one thread per pixel; ``probe_spatial`` runs the plain version for
CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import rng
from . import cuda_lib

#: Stack planes of each mode.
PLANES = {"di": 6, "gi": 18}
#: Most tries the kernel takes (the reference's spatial passes make 8).
MAX_TRIES = 8


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
    """The fused spatial probe over a float32 [P, H, W] field stack with
    int32 [tries * n_lvls * n_var] offset tables and a u32 ``seed``.
    Returns (oy, ox, found) as int32, int32 and bool [H, W] tensors, and
    in GI mode also the clamped Jacobian (float32 [H, W]): each pixel's
    accepted offset (0 where none) and accept mask. CPU tensors run the
    plain version; CUDA tensors launch kernel 7 (1 to MAX_TRIES tries)."""
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

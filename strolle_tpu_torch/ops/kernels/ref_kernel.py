"""Reference-mode megakernel: one whole path-traced sample per ray
(port of strolle_tpu/ops/pallas/ref_kernel.py ``trace_sample_megakernel``).

The CUDA kernel is ``csrc/ref_megakernel.cu``. Its plain PyTorch version
below is the same function with the kernel's own math — Baldwin-Weber
rows, the polynomial ``acos``, the light picked by ``word % count`` —
and not the staged loop of models/reference.py, which intersects with
Möller-Trumbore and so decides triangle edges differently.
"""

from __future__ import annotations

import math

import torch

from .. import rng
from ..brdf import MIN_ROUGHNESS, ggx_distribution
from ..intersect import F32_EPS, fma_cross
from ..lights import RANGE_UNLIMITED, pack_lights
from ..math import dot
from ..math import saturate as _saturate
from . import cuda_lib
from .trace_kernels import MAX_TRIS, PLAIN_CHUNK

__all__ = [
    "pack_geometry_bw", "pack_materials", "pack_lights",
    "trace_sample_megakernel", "trace_sample_megakernel_plain",
]

NUDGE = 0.01
LIGHT_POINT = 1


def pack_geometry_bw(geom) -> torch.Tensor:
    """Geometry -> [T, 24] Baldwin-Weber rows:
    n(3) d0 T1(3) d1 T2(3) d2 n0(3) n1(3) n2(3) mat pad(2).

    n is the unnormalised e1 x e2, so sign(n . d) carries the
    orientation of Möller-Trumbore's determinant (det = -n . d). The
    cross products fuse their multiply-adds and the dot products do not,
    as XLA:CPU compiles the JAX packer, so both packages hold the same
    rows bit for bit."""
    p = geom.positions
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    e1 = b - a
    e2 = c - a
    n = fma_cross(e1, e2)
    denom = torch.clamp(dot(n, n), min=1e-30)[:, None]
    t1 = fma_cross(e2, n) / denom
    t2 = fma_cross(n, e1) / denom
    rows = [
        n,
        dot(n, a)[:, None],  # d0
        t1,
        -dot(t1, a)[:, None],  # d1
        t2,
        -dot(t2, a)[:, None],  # d2
        geom.normals[:, 0],
        geom.normals[:, 1],
        geom.normals[:, 2],
        geom.material_id.to(torch.float32)[:, None],
        torch.zeros((p.shape[0], 2), dtype=torch.float32, device=p.device),
    ]
    return torch.cat(rows, dim=-1)


def pack_materials(materials) -> torch.Tensor:
    """[M, 12] rows: base_color(4) emissive(3) metallic roughness
    reflectance pad(2)."""
    m = materials
    return torch.cat(
        [
            m.base_color,
            m.emissive[..., :3],
            m.metallic[:, None],
            m.roughness[:, None],
            m.reflectance[:, None],
            torch.zeros((m.num_materials, 2), dtype=torch.float32, device=m.base_color.device),
        ],
        dim=-1,
    )


# --- plain version ----------------------------------------------------------


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _bw_block(rows, ox, oy, oz, dx, dy, dz):
    """Rays (each component [R, 1]) against rows [C, 24] -> (t, u, v, nd)
    [R, C], t = +inf on a miss."""
    c = [rows[:, k] for k in range(12)]
    nd = c[0] * dx + c[1] * dy + c[2] * dz
    no = c[0] * ox + c[1] * oy + c[2] * oz
    miss_plane = torch.abs(nd) < F32_EPS
    t = (c[3] - no) / torch.where(miss_plane, 1.0, nd)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = c[4] * px + c[5] * py + c[6] * pz + c[7]
    v = c[8] * px + c[9] * py + c[10] * pz + c[11]
    hit = ~miss_plane & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, math.inf), u, v, nd


def _bw_closest(rows, ox, oy, oz, dx, dy, dz):
    """Closest Baldwin-Weber hit, lowest index on ties; returns
    (t, index (-1 on miss), u, v, nd) over [R]."""
    r = ox.shape[0]
    dev = ox.device
    bt = torch.full((r,), math.inf, dtype=torch.float32, device=dev)
    bi = torch.full((r,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    bnd = torch.zeros_like(bu)
    rays = [x[:, None] for x in (ox, oy, oz, dx, dy, dz)]
    for c0 in range(0, rows.shape[0], PLAIN_CHUNK):
        t, u, v, nd = _bw_block(rows[c0 : c0 + PLAIN_CHUNK], *rays)
        j = torch.argmin(t, dim=-1, keepdim=True)
        tj = t.gather(-1, j)[:, 0]
        better = tj < bt
        bt = torch.where(better, tj, bt)
        bi = torch.where(better, j[:, 0] + c0, bi)
        bu = torch.where(better, u.gather(-1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(-1, j)[:, 0], bv)
        bnd = torch.where(better, nd.gather(-1, j)[:, 0], bnd)
    return bt, bi, bu, bv, bnd


def _bw_occluded(rows, ox, oy, oz, dx, dy, dz, t_max, counts=None):
    occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    rays = [x[:, None] for x in (ox, oy, oz, dx, dy, dz)]
    for c0 in range(0, rows.shape[0], PLAIN_CHUNK):
        hits = _bw_block(rows[c0 : c0 + PLAIN_CHUNK], *rays)[0] < t_max[:, None]
        if counts is not None:
            # rows the kernel tests: up to and including the first occluder
            first = torch.where(hits.any(-1), hits.int().argmax(-1) + 1, hits.shape[1])
            counts["anyhit_tests"] += int(torch.where(occ, 0, first).sum())
        occ = occ | hits.any(-1)
    return occ


def _take_rows(table, idx):
    """table[idx] with zeros where idx is out of range; idx int64 [R]."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.clamp(idx, 0, table.shape[0] - 1)]
    return torch.where(ok[:, None], rows, 0.0)


def _specular_eval(bc_r, bc_g, bc_b, metallic, roughness, reflectance,
                   nx, ny, nz, lx, ly, lz, vx, vy, vz):
    a = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
    hx, hy, hz = _normalize3(lx + vx, ly + vy, lz + vz)
    n_dot_l = _saturate(_dot3(nx, ny, nz, lx, ly, lz))
    n_dot_h = _saturate(_dot3(nx, ny, nz, hx, hy, hz))
    l_dot_h = _saturate(_dot3(lx, ly, lz, hx, hy, hz))
    n_dot_v = _saturate(_dot3(nx, ny, nz, vx, vy, vz))
    d = ggx_distribution(n_dot_h, a)
    k = a * a / 2.0
    g = (n_dot_v / (n_dot_v * (1.0 - k) + k)) * (n_dot_l / (n_dot_l * (1.0 - k) + k))
    f0_base = 0.16 * reflectance * reflectance * (1.0 - metallic)
    f0r = f0_base + bc_r * metallic
    f0g = f0_base + bc_g * metallic
    f0b = f0_base + bc_b * metallic
    f90 = _saturate((f0r + f0g + f0b) * (50.0 * 0.33))
    x = torch.clamp(1.0 - l_dot_h, min=0.001)
    x2 = x * x
    p = x2 * x2 * x
    scale = d * g / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-8)
    ok = (metallic > 0.0) & (n_dot_l > 0.0) & (n_dot_v > 0.0)
    return tuple(
        torch.where(ok, scale * (f0 + (f90 - f0) * p), 0.0) for f0 in (f0r, f0g, f0b)
    )


def trace_sample_megakernel_plain(
    tri_rows, mat_rows, light_rows, lcount: int, o, d, state0,
    depth: int = 5, flat: bool = False, no_metal: bool = False,
    counts: dict | None = None,
):
    """Plain version of kernel C, step for step as csrc/ref_megakernel.cu.
    Returns radiance over o's batch shape + (3,).

    ``counts``, when given, receives the work the kernel does on these
    inputs: ``ray_bounces``, ``closest_tests`` and ``anyhit_tests``
    (ray-triangle tests; the any-hit loop stops at the first occluder).
    """
    batch = o.shape[:-1]
    of = o.reshape(-1, 3)
    df = d.reshape(-1, 3)
    ox, oy, oz = of[:, 0], of[:, 1], of[:, 2]
    dx, dy, dz = df[:, 0], df[:, 1], df[:, 2]
    state = state0.reshape(-1).to(torch.int64)
    zero = torch.zeros_like(ox)
    col_r, col_g, col_b = zero, zero, zero
    thr_r, thr_g, thr_b = zero + 1.0, zero + 1.0, zero + 1.0
    alive = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    lc = max(int(lcount), 1)
    lcount_f = float(lc)
    has_lights = 1.0 if lcount > 0 else 0.0

    if counts is not None:
        for k in ("ray_bounces", "closest_tests", "anyhit_tests"):
            counts.setdefault(k, 0)
    for bounce in range(depth + 1):
        if counts is not None:
            counts["ray_bounces"] += ox.shape[0]
            counts["closest_tests"] += ox.shape[0] * tri_rows.shape[0]
        bt, bi, bu, bv, bnd = _bw_closest(tri_rows, ox, oy, oz, dx, dy, dz)
        hit = bi >= 0
        row = _take_rows(tri_rows, bi)
        dsign = torch.where(hit, torch.where(bnd <= 0.0, 1.0, -1.0), 0.0)
        mat = row[:, 21]
        if flat:
            nx, ny, nz = row[:, 12] * dsign, row[:, 13] * dsign, row[:, 14] * dsign
        else:
            w = 1.0 - bu - bv
            nx, ny, nz = _normalize3(
                w * row[:, 12] + bu * row[:, 15] + bv * row[:, 18],
                w * row[:, 13] + bu * row[:, 16] + bv * row[:, 19],
                w * row[:, 14] + bu * row[:, 17] + bv * row[:, 20],
            )
            nx, ny, nz = nx * dsign, ny * dsign, nz * dsign
        is_some = bt < math.inf
        alive = alive & is_some
        bts = torch.where(is_some, bt, 0.0)
        px = ox + dx * bts + nx * NUDGE
        py = oy + dy * bts + ny * NUDGE
        pz = oz + dz * bts + nz * NUDGE

        # material (a miss reads material 0, as the kernel does)
        mi = mat.to(torch.int64)
        m = _take_rows(mat_rows, torch.where(mi.to(torch.float32) == mat, mi, -1))
        bc_r, bc_g, bc_b = m[:, 0], m[:, 1], m[:, 2]
        em_r, em_g, em_b = m[:, 4], m[:, 5], m[:, 6]
        if no_metal:
            metallic, roughness, reflectance = zero, zero + 1.0, zero
        else:
            metallic, roughness, reflectance = m[:, 7], m[:, 8], m[:, 9]
            if bounce > 0:
                roughness = torch.clamp(roughness, min=0.75 * 0.75)

        alive_f = alive.to(torch.float32)
        col_r = col_r + alive_f * thr_r * em_r
        col_g = col_g + alive_f * thr_g * em_g
        col_b = col_b + alive_f * thr_b * em_b

        # NEE: one uniformly picked light
        state, word = rng.next_u32(state)
        lr = _take_rows(light_rows, word % lc)
        lpx, lpy, lpz, lrad = lr[:, 0], lr[:, 1], lr[:, 2], lr[:, 3]
        lcr, lcg, lcb = lr[:, 4], lr[:, 5], lr[:, 6]
        lrange, lkind = lr[:, 7], lr[:, 8]
        sdx, sdy, sdz, sangle = lr[:, 9], lr[:, 10], lr[:, 11], lr[:, 12]

        state, u0 = rng.next_f32(state)
        state, u1 = rng.next_f32(state)
        state, u2 = rng.next_f32(state)
        phi = u0 * (2.0 * math.pi)
        cos_t = torch.clamp(u1 * 2.0 - 1.0, -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        rr = torch.sqrt(u2)
        sox = lpx + lrad * (rr * sin_t * torch.cos(phi))
        soy = lpy + lrad * (rr * sin_t * torch.sin(phi))
        soz = lpz + lrad * (rr * cos_t)
        thx, thy, thz = px - sox, py - soy, pz - soz
        slen = torch.sqrt(torch.clamp(thx * thx + thy * thy + thz * thz, min=1e-20))
        occ = _bw_occluded(
            tri_rows, sox, soy, soz, thx / slen, thy / slen, thz / slen, slen, counts
        ).to(torch.float32)

        # light radiance
        lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
        tpx, tpy, tpz = _normalize3(-lvx, -lvy, -lvz)
        sdnx, sdny, sdnz = _normalize3(sdx, sdy, sdz)
        cosang = torch.clamp(_dot3(sdnx, sdny, sdnz, tpx, tpy, tpz), -1.0, 1.0)
        ax = torch.abs(cosang)
        poly = 1.5707288 + ax * (-0.2121144 + ax * (0.074261 - 0.0187293 * ax))
        acos_pos = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * poly
        angle = torch.where(cosang >= 0.0, acos_pos, math.pi - acos_pos)
        q = angle / torch.clamp(sangle, min=1e-6)
        spot_f = _saturate(1.0 - q * q * q)
        f_angle = torch.where(lkind == float(LIGHT_POINT), 1.0, spot_f)

        l2 = lvx * lvx + lvy * lvy + lvz * lvz
        inv_r2 = 1.0 / torch.clamp(lrange * lrange, min=1e-12)
        factor = l2 * inv_r2
        smooth = _saturate(1.0 - factor * factor)
        atten = smooth * smooth / torch.clamp(l2, min=1e-4)
        f_dist = torch.where(lrange >= RANGE_UNLIMITED, 1.0, atten)
        lnx, lny, lnz = _normalize3(lvx, lvy, lvz)
        f_cos = _saturate(_dot3(nx, ny, nz, lnx, lny, lnz))

        diff_k = (1.0 - metallic) / math.pi
        dbr, dbg, dbb = bc_r * diff_k, bc_g * diff_k, bc_b * diff_k
        vx, vy, vz = -dx, -dy, -dz
        if no_metal:
            sbr = sbg = sbb = zero
        else:
            ndv2 = _dot3(-vx, -vy, -vz, nx, ny, nz)
            rx = -vx - 2.0 * ndv2 * nx
            ry = -vy - 2.0 * ndv2 * ny
            rz = -vz - 2.0 * ndv2 * nz
            lr_dot = _dot3(lvx, lvy, lvz, rx, ry, rz)
            ctx = lr_dot * rx - lvx
            cty = lr_dot * ry - lvy
            ctz = lr_dot * rz - lvz
            ct_len2 = torch.clamp(ctx * ctx + cty * cty + ctz * ctz, min=1e-20)
            tt = _saturate(lrad * torch.rsqrt(ct_len2))
            clx, cly, clz = lvx + ctx * tt, lvy + cty * tt, lvz + ctz * tt
            inv_len = torch.rsqrt(torch.clamp(clx * clx + cly * cly + clz * clz, min=1e-20))
            cr = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
            i_rough = cr / _saturate(cr + lrad * 0.5 * inv_len)
            sbr, sbg, sbb = _specular_eval(
                bc_r, bc_g, bc_b, metallic, roughness, reflectance,
                nx, ny, nz, clx * inv_len, cly * inv_len, clz * inv_len, vx, vy, vz,
            )
            ir2 = i_rough * i_rough
            sbr, sbg, sbb = ir2 * sbr, ir2 * sbg, ir2 * sbb

        rad_k = f_angle * f_dist * f_cos
        take = alive_f * has_lights * (1.0 - occ) * lcount_f  # 1 / light pdf
        col_r = col_r + take * thr_r * lcr * rad_k * (dbr + sbr)
        col_g = col_g + take * thr_g * lcg * rad_k * (dbg + sbg)
        col_b = col_b + take * thr_b * lcb * rad_k * (dbb + sbb)

        # layered BRDF continuation
        if bounce < depth:
            state, pick = rng.next_f32(state)
            state, ra = rng.next_f32(state)
            state, rb = rng.next_f32(state)
            sign = torch.where(nz >= 0.0, 1.0, -1.0)
            a_onb = -1.0 / (sign + nz)
            b_onb = nx * ny * a_onb
            tx, ty, tz = 1.0 + sign * nx * nx * a_onb, sign * b_onb, -sign * nx
            bx, by, bz = b_onb, sign + ny * ny * a_onb, -ny

            d_cos = ra
            d_sin = torch.sqrt(torch.clamp(1.0 - d_cos * d_cos, min=0.0))
            dphi = 2.0 * math.pi * rb
            dcp, dsp = torch.cos(dphi), torch.sin(dphi)
            ndx = (tx * dcp + bx * dsp) * d_sin + nx * d_cos
            ndy = (ty * dcp + by * dsp) * d_sin + ny * d_cos
            ndz = (tz * dcp + bz * dsp) * d_sin + nz * d_cos
            pdf = zero + 1.0 / math.pi
            rad_r, rad_g, rad_b = dbr, dbg, dbb
            if not no_metal:
                use_spec = pick < metallic
                a = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
                a2 = a * a
                cos_th = torch.sqrt(
                    torch.clamp((1.0 - ra) / ((a2 - 1.0) * ra + 1.0), min=0.0)
                )
                sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
                sphi = rb * math.pi * 2.0
                cp, sp = torch.cos(sphi), torch.sin(sphi)
                hx = tx * (sin_th * cp) + bx * (sin_th * sp) + nx * cos_th
                hy = ty * (sin_th * cp) + by * (sin_th * sp) + ny * cos_th
                hz = tz * (sin_th * cp) + bz * (sin_th * sp) + nz * cos_th
                n_dot_h = _saturate(_dot3(nx, ny, nz, hx, hy, hz))
                h_dot_v = _saturate(_dot3(hx, hy, hz, vx, vy, vz))
                sdx2, sdy2, sdz2 = _normalize3(
                    2.0 * h_dot_v * hx - vx,
                    2.0 * h_dot_v * hy - vy,
                    2.0 * h_dot_v * hz - vz,
                )
                s_pdf = (
                    ggx_distribution(n_dot_h, a)
                    * n_dot_h
                    / torch.clamp(4.0 * h_dot_v, min=1e-8)
                )
                srr, srg, srb = _specular_eval(
                    bc_r, bc_g, bc_b, metallic, roughness, reflectance,
                    nx, ny, nz, sdx2, sdy2, sdz2, vx, vy, vz,
                )
                ndx = torch.where(use_spec, sdx2, ndx)
                ndy = torch.where(use_spec, sdy2, ndy)
                ndz = torch.where(use_spec, sdz2, ndz)
                pdf = torch.where(
                    use_spec,
                    s_pdf / torch.clamp(metallic, min=1e-8),
                    pdf / torch.clamp(1.0 - metallic, min=1e-8),
                )
                rad_r = torch.where(use_spec, srr, dbr)
                rad_g = torch.where(use_spec, srg, dbg)
                rad_b = torch.where(use_spec, srb, dbb)

            alive = alive & (pdf > 0.0)
            cosw = _dot3(ndx, ndy, ndz, nx, ny, nz)
            scale = cosw / torch.clamp(pdf, min=1e-20)
            thr_r = thr_r * scale * rad_r
            thr_g = thr_g * scale * rad_g
            thr_b = thr_b * scale * rad_b
            ox, oy, oz = px, py, pz
            dx = torch.where(alive, ndx, dx)
            dy = torch.where(alive, ndy, dy)
            dz = torch.where(alive, ndz, dz)

    return torch.stack([col_r, col_g, col_b], dim=-1).reshape(batch + (3,))


# --- wrapper ----------------------------------------------------------------


def trace_sample_megakernel(
    tri_rows, mat_rows, light_rows, lcount: int, o, d, state0,
    depth: int = 5, flat: bool = False, no_metal: bool = False,
):
    """One path-traced sample per ray, fully in one kernel.

    tri_rows [T, 24] (pack_geometry_bw), mat_rows [M, 12], light_rows
    [L, 13], ``lcount`` the live light count (a Python int), o/d [..., 3],
    state0 int64 PCG states (values in [0, 2^32)) over o's batch shape.
    Returns radiance [..., 3]. CPU tensors run the plain version; CUDA
    tensors launch kernel C in its (flat, no_metal) variant.
    """
    name = "trace_sample_megakernel"
    if tri_rows.ndim != 2 or tri_rows.shape[1] != 24:
        raise ValueError(f"{name}: tri_rows must be [T, 24]")
    if mat_rows.ndim != 2 or mat_rows.shape[1] != 12:
        raise ValueError(f"{name}: mat_rows must be [M, 12]")
    if light_rows.ndim != 2 or light_rows.shape[1] != 13:
        raise ValueError(f"{name}: light_rows must be [L, 13]")
    if tri_rows.shape[0] > MAX_TRIS:
        raise NotImplementedError(
            f"{name}: {tri_rows.shape[0]} triangles > {MAX_TRIS}; big scenes "
            "take the staged loop (use_megakernel=False) through the stream kernels"
        )
    if o.shape != d.shape or o.shape[-1] != 3 or state0.shape != o.shape[:-1]:
        raise ValueError(f"{name}: o/d must be [..., 3] and state0 [...]")
    for t in (tri_rows, mat_rows, light_rows, o, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if state0.dtype != torch.int64:
        raise TypeError(f"{name}: state0 must be int64 PCG states")
    if o.device.type == "cpu":
        return trace_sample_megakernel_plain(
            tri_rows, mat_rows, light_rows, lcount, o, d, state0,
            depth=depth, flat=flat, no_metal=no_metal,
        )
    if o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {o.device}")
    cuda_lib.check_tensors(name, tri_rows, mat_rows, light_rows, o, d, state0)
    lib = cuda_lib.library()
    n = o.numel() // 3
    dev = o.device
    out = torch.empty(o.shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.strolle_trace_sample_megakernel(
            tri_rows.data_ptr(), tri_rows.shape[0],
            mat_rows.data_ptr(), mat_rows.shape[0],
            light_rows.data_ptr(), light_rows.shape[0], int(lcount),
            o.data_ptr(), d.data_ptr(), state0.data_ptr(), n, int(depth),
            int(bool(flat)), int(bool(no_metal)), out.data_ptr(),
            cuda_lib.stream(dev),
        )
    cuda_lib.check(name, err)
    cuda_lib.count_launch(name)
    return out

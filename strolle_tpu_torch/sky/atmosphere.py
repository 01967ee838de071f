"""Hillaire-style sky/atmosphere model (port of
strolle_tpu/sky/atmosphere.py).

* ``luts_for(sun_altitude, device)`` / ``sample_atmosphere(luts, sun,
  dir)``: the LUT pipeline (transmittance, multi-scattering and sky-view
  LUTs, the sky LUT keyed on the sun altitude). The realtime frame's GI
  samples these LUTs for its miss rays even with the sky off.
* ``sample_sky(sun_dir, ray_dir)``: the analytic single-scattering march,
  kept as the fallback without LUTs.
* ``sun_direction(azimuth, altitude)``.

Loop-step scalars are formed in float32, as the JAX package forms them
from its int32 loop counters, so each march step meets the same
distances.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops import math as vm
from ..ops.intersect import ray_sphere

GROUND_RADIUS_MM = 6.360
ATMOSPHERE_RADIUS_MM = 6.460
VIEW_POS = np.asarray([0.0, GROUND_RADIUS_MM + 0.0002, 0.0], np.float32)

RAYLEIGH_SCATTERING_BASE = np.asarray([5.802, 13.558, 33.1], np.float32)
RAYLEIGH_ABSORPTION_BASE = 0.0
MIE_SCATTERING_BASE = 3.996
MIE_ABSORPTION_BASE = 4.4
OZONE_ABSORPTION_BASE = np.asarray([0.650, 1.881, 0.085], np.float32)
GROUND_ALBEDO = 0.25
EXPOSURE = 20.0

TRANSMITTANCE_LUT_RES = (256, 64)
SCATTERING_LUT_RES = (32, 32)
SKY_LUT_RES = (256, 256)

SUN_DISTANCE = 1000.0


_CONSTANTS = {
    "view_pos": VIEW_POS,
    "rayleigh": RAYLEIGH_SCATTERING_BASE,
    "ozone": OZONE_ABSORPTION_BASE,
}


@functools.cache
def _const(name: str, device: str) -> torch.Tensor:
    """A constant vector on the device, copied there once."""
    return torch.as_tensor(_CONSTANTS[name], device=device)


def _c(name: str, device) -> torch.Tensor:
    return _const(name, str(torch.device(device)))


def _step_frac(i: int, steps: int) -> float:
    """(i + 0.3) / steps rounded as float32 arithmetic."""
    return float((np.float32(i) + np.float32(0.3)) / np.float32(steps))


def sun_direction(azimuth, altitude, device=None) -> torch.Tensor:
    """Spherical -> cartesian sun direction [3]; float32 cos/sin of the
    float32 angles. For Python angles the result is made once per
    device."""
    if isinstance(azimuth, torch.Tensor) or isinstance(altitude, torch.Tensor):
        return _sun_direction(torch.as_tensor(azimuth, dtype=torch.float32, device=device),
                              torch.as_tensor(altitude, dtype=torch.float32, device=device))
    return _sun_cached(float(azimuth), float(altitude), str(torch.device(device or "cpu")))


def _sun_direction(az, alt):
    return torch.stack(
        [torch.cos(alt) * torch.sin(az), torch.sin(alt), -torch.cos(alt) * torch.cos(az)],
        dim=-1,
    )


@functools.cache
def _sun_cached(azimuth: float, altitude: float, device: str) -> torch.Tensor:
    return _sun_direction(torch.tensor(azimuth, dtype=torch.float32, device=device),
                          torch.tensor(altitude, dtype=torch.float32, device=device))


def _atmosphere_density(altitude_mm):
    """Rayleigh/Mie/ozone density profiles; the altitude is clamped so a
    march below the ground cannot overflow exp."""
    altitude_km = torch.clamp(altitude_mm * 1000.0, -0.5, 120.0)
    rayleigh = torch.exp(-altitude_km / 8.0)
    mie = torch.exp(-altitude_km / 1.2)
    ozone = torch.clamp(1.0 - torch.abs(altitude_km - 25.0) / 15.0, min=0.0)
    return rayleigh, mie, ozone


def _scattering_values(pos):
    """(rayleigh_scat [..., 3], mie_scat [...], extinction [..., 3])."""
    dev = pos.device
    altitude = vm.length(pos) - GROUND_RADIUS_MM
    rayleigh_d, mie_d, ozone_d = _atmosphere_density(altitude)
    rayleigh_scat = _c("rayleigh", dev) * rayleigh_d[..., None]
    mie_scat = MIE_SCATTERING_BASE * mie_d
    mie_abs = MIE_ABSORPTION_BASE * mie_d
    ozone_abs = _c("ozone", dev) * ozone_d[..., None]
    extinction = (
        rayleigh_scat
        + (RAYLEIGH_ABSORPTION_BASE * rayleigh_d + mie_scat + mie_abs)[..., None]
        + ozone_abs
    )
    return rayleigh_scat, mie_scat, extinction


def _rayleigh_phase(cos_theta):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def _mie_phase(cos_theta):
    g = 0.8
    scale = 3.0 / (8.0 * math.pi)
    num = (1.0 - g * g) * (1.0 + cos_theta * cos_theta)
    den = (2.0 + g * g) * torch.pow(
        torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-7), 1.5
    )
    return scale * num / den


def transmittance(pos, sun_dir, steps: int = 40):
    """Optical-depth march toward the sun."""
    zero = torch.zeros(3, device=pos.device)
    t_atmo = ray_sphere(pos, sun_dir, zero, ATMOSPHERE_RADIUS_MM)
    t_atmo = torch.where(torch.isinf(t_atmo), 0.0, t_atmo)
    dt = t_atmo / steps
    total = torch.zeros(pos.shape[:-1] + (3,), device=pos.device)
    t = 0.3 * dt
    p = pos + t[..., None] * sun_dir
    for _ in range(steps):
        _, _, extinction = _scattering_values(p)
        total = total + extinction * dt[..., None]
        p = p + dt[..., None] * sun_dir
    return torch.exp(-total)


def _sun_disk(cos_theta):
    """Analytic sun disk + small bloom around it."""
    sun_cos = float(np.cos(np.float32(np.deg2rad(0.535 / 2.0))))
    disk = torch.where(cos_theta >= sun_cos, 1.0, 0.0)
    offset = sun_cos - cos_theta
    gaussian = torch.exp(-offset * 50000.0) * 0.5
    inv = 0.002 / torch.clamp(offset, min=0.0002) * 0.01
    bloom = torch.where(cos_theta < sun_cos, gaussian + inv, 1.0)
    return torch.maximum(disk, bloom * 0.2)[..., None] * torch.ones(3, device=cos_theta.device)


def sample_sky(sun_dir, ray_dir, steps: int = 16):
    """Sky radiance toward ray_dir: single-scattering march + analytic
    sun disk, ground-occluded, scaled by EXPOSURE (no LUTs)."""
    dev = ray_dir.device
    pos = torch.broadcast_to(_c("view_pos", dev), ray_dir.shape)
    zero = torch.zeros(3, device=dev)
    t_ground = ray_sphere(pos, ray_dir, zero, GROUND_RADIUS_MM)
    t_atmo = ray_sphere(pos, ray_dir, zero, ATMOSPHERE_RADIUS_MM)
    t_max = torch.where(torch.isinf(t_ground), t_atmo, t_ground)
    t_max = torch.where(torch.isinf(t_max), 0.0, t_max)

    cos_theta = vm.dot(ray_dir, sun_dir)
    rayleigh_ph = _rayleigh_phase(cos_theta)
    mie_ph = _mie_phase(cos_theta)

    dt = t_max / steps
    lum = torch.zeros(ray_dir.shape, device=dev)
    trans = torch.ones(ray_dir.shape, device=dev)
    t = 0.3 * dt
    for _ in range(steps):
        p = pos + t[..., None] * ray_dir
        rayleigh_scat, mie_scat, extinction = _scattering_values(p)
        sample_trans = torch.exp(-dt[..., None] * extinction)
        sun_trans = transmittance(p, sun_dir, steps=8)
        ground_t = ray_sphere(p, sun_dir, zero, GROUND_RADIUS_MM)
        shadow = torch.where(torch.isinf(ground_t), 1.0, 0.0)[..., None]
        in_scat = (
            rayleigh_scat * rayleigh_ph[..., None] + (mie_scat * mie_ph)[..., None]
        ) * sun_trans * shadow
        integral = in_scat * (1.0 - sample_trans) / torch.clamp(extinction, min=1e-7)
        lum = lum + integral * trans
        trans = trans * sample_trans
        t = t + dt
    lum = lum + _sun_disk(cos_theta) * trans
    return lum * EXPOSURE


# ===========================================================================
# LUT pipeline
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class AtmosphereLuts:
    """The three Hillaire LUTs; the sky-view LUT is keyed on the sun
    altitude."""

    transmittance: torch.Tensor  # f32[64, 256, 3]
    scattering: torch.Tensor  # f32[32, 32, 3]
    sky: torch.Tensor  # f32[256, 256, 3]


def _bilinear(lut: torch.Tensor, u, v):
    """Clamped bilinear fetch at normalised uv (texel centres)."""
    h, w = lut.shape[0], lut.shape[1]
    x = torch.clamp(u * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    # indices clamped like the JAX package's take(mode="clip"): a NaN
    # coordinate (a masked-out lane) must not index out of bounds
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    c00, c10 = lut[y0, x0], lut[y0, x1]
    c01, c11 = lut[y1, x0], lut[y1, x1]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_lut_at(lut, pos, sun_dir):
    """u from the sun's cos-zenith angle, v from the normalised height."""
    height = vm.length(pos)
    up = pos / torch.clamp(height, min=1e-20)[..., None]
    cos_zenith = vm.dot(sun_dir, up)
    u = vm.saturate(0.5 + 0.5 * cos_zenith)
    v = vm.saturate((height - GROUND_RADIUS_MM) / (ATMOSPHERE_RADIUS_MM - GROUND_RADIUS_MM))
    return _bilinear(lut, u, v)


def _march_tmax(pos, d):
    zero = torch.zeros(3, device=pos.device)
    t_g = ray_sphere(pos, d, zero, GROUND_RADIUS_MM)
    t_a = ray_sphere(pos, d, zero, ATMOSPHERE_RADIUS_MM)
    return torch.where(torch.isinf(t_g), torch.where(torch.isinf(t_a), 0.0, t_a), t_g), t_g


def _texel_grid(w: int, h: int, device):
    us = torch.arange(w, dtype=torch.float32, device=device) / w
    vs = torch.arange(h, dtype=torch.float32, device=device) / h
    v, u = torch.meshgrid(vs, us, indexing="ij")
    return u, v


def _sun_at_cos(sun_cos):
    sun_sin = torch.sin(torch.arccos(torch.clamp(sun_cos, -1.0, 1.0)))
    return vm.normalize(torch.stack([torch.zeros_like(sun_cos), sun_cos, -sun_sin], -1))


def generate_transmittance_lut(device, steps: int = 40) -> torch.Tensor:
    """Per texel, the optical-depth march toward a sun at cos-zenith u
    from height v: [64, 256, 3]."""
    u, v = _texel_grid(TRANSMITTANCE_LUT_RES[0], TRANSMITTANCE_LUT_RES[1], device)
    sun_dir = _sun_at_cos(2.0 * u - 1.0)
    height = GROUND_RADIUS_MM + (ATMOSPHERE_RADIUS_MM - GROUND_RADIUS_MM) * v
    pos = torch.stack([torch.zeros_like(height), height, torch.zeros_like(height)], -1)
    zero = torch.zeros(3, device=device)
    hits_ground = ~torch.isinf(ray_sphere(pos, sun_dir, zero, GROUND_RADIUS_MM))
    t_atmo = ray_sphere(pos, sun_dir, zero, ATMOSPHERE_RADIUS_MM)
    t_atmo = torch.where(torch.isinf(t_atmo), 0.0, t_atmo)
    t = torch.zeros_like(t_atmo)
    trans = torch.ones_like(pos)
    for i in range(steps):
        new_t = _step_frac(i, steps) * t_atmo
        dt = new_t - t
        p = pos + new_t[..., None] * sun_dir
        _, _, extinction = _scattering_values(p)
        t, trans = new_t, trans * torch.exp(-dt[..., None] * extinction)
    return torch.where(hits_ground[..., None], 0.0, trans)


def generate_scattering_lut(tlut, steps: int = 20, dirs_sqrt: int = 8) -> torch.Tensor:
    """Multi-scattering psi LUT [32, 32, 3]: 8x8 directions x 20-step
    marches per texel, lum / (1 - f_ms). The 64 directions march as one
    batch; their sums are taken in the JAX package's order."""
    device = tlut.device
    res = SCATTERING_LUT_RES[0]
    u, v = _texel_grid(res, res, device)
    sun_dir = _sun_at_cos(2.0 * u - 1.0)
    height = GROUND_RADIUS_MM + (ATMOSPHERE_RADIUS_MM - GROUND_RADIUS_MM) * torch.clamp(v, min=0.01)
    pos = torch.stack([torch.zeros_like(height), height, torch.zeros_like(height)], -1)

    n = dirs_sqrt * dirs_sqrt
    theta = torch.tensor(
        [math.pi * (i + 0.5) / dirs_sqrt for i in range(dirs_sqrt) for _ in range(dirs_sqrt)],
        dtype=torch.float32, device=device,
    )
    phi = torch.arccos(torch.clamp(torch.tensor(
        [1.0 - 2.0 * (j + 0.5) / dirs_sqrt for _ in range(dirs_sqrt) for j in range(dirs_sqrt)],
        dtype=torch.float32, device=device,
    ), -1.0, 1.0))
    dirs = torch.stack(
        [torch.sin(phi) * torch.sin(theta), torch.cos(phi), torch.sin(phi) * torch.cos(theta)],
        -1,
    )  # [64, 3]
    ray_dir = torch.broadcast_to(dirs[:, None, None, :], (n,) + pos.shape)
    posb = torch.broadcast_to(pos, (n,) + pos.shape)
    sunb = torch.broadcast_to(sun_dir, (n,) + pos.shape)

    zero = torch.zeros(3, device=device)
    t_a = ray_sphere(posb, ray_dir, zero, ATMOSPHERE_RADIUS_MM)
    t_g = ray_sphere(posb, ray_dir, zero, GROUND_RADIUS_MM)
    ground_hit = ~torch.isinf(t_g)
    t_max = torch.where(ground_hit, t_g, torch.where(torch.isinf(t_a), 0.0, t_a))
    cos_th = vm.dot(ray_dir, sunb)
    mie_ph = _mie_phase(cos_th)[..., None]
    ray_ph = _rayleigh_phase(-cos_th)[..., None]

    t = torch.zeros(t_max.shape, device=device)
    lum = torch.zeros(posb.shape, device=device)
    lum_f = torch.zeros(posb.shape, device=device)
    trans = torch.ones(posb.shape, device=device)
    for si in range(steps):
        new_t = _step_frac(si, steps) * t_max
        dt = (new_t - t)[..., None]
        p = posb + new_t[..., None] * ray_dir
        r_s, m_s, ext = _scattering_values(p)
        m_s = m_s[..., None]
        s_trans = torch.exp(-dt * ext)
        no_phase = r_s + m_s
        scat_f = (no_phase - no_phase * s_trans) / torch.clamp(ext, min=1e-7)
        lum_f = lum_f + trans * scat_f
        sun_t = sample_lut_at(tlut, p, sunb)
        in_s = (r_s * ray_ph + m_s * mie_ph) * sun_t
        integral = (in_s - in_s * s_trans) / torch.clamp(ext, min=1e-7)
        t, lum, trans = new_t, lum + integral * trans, trans * s_trans

    hit_pos = posb + t_g[..., None] * ray_dir
    hit_pos = vm.normalize(hit_pos) * GROUND_RADIUS_MM
    bounce = trans * GROUND_ALBEDO * sample_lut_at(tlut, hit_pos, sunb)
    sun_up = vm.dot(posb, sunb) > 0.0
    lum = torch.where((ground_hit & sun_up)[..., None], lum + bounce, lum)

    inv_samples = 1.0 / n
    lum_total = torch.zeros(pos.shape, device=device)
    fms_total = torch.zeros(pos.shape, device=device)
    for k in range(n):
        fms_total = fms_total + lum_f[k] * inv_samples
        lum_total = lum_total + lum[k] * inv_samples
    return lum_total / torch.clamp(1.0 - fms_total, min=1e-4)


def generate_sky_lut(tlut, slut, sun_altitude: float, steps: int = 32) -> torch.Tensor:
    """Per-sun-altitude 256x256 sky view with the horizon-centric
    non-linear V parameterisation."""
    device = tlut.device
    res = SKY_LUT_RES[0]
    u, v = _texel_grid(res, res, device)
    azimuth = (u - 0.5) * 2.0 * math.pi
    vv = torch.where(v < 0.5, -vm.sqr(1.0 - 2.0 * v), vm.sqr(v * 2.0 - 1.0))
    height = vm.length(_c("view_pos", device))
    horizon = (
        torch.arccos(torch.clamp(
            torch.sqrt(torch.clamp(height**2 - GROUND_RADIUS_MM**2, min=0.0)) / height,
            -1.0, 1.0,
        ))
        - 0.5 * math.pi
    )
    altitude = vv * 0.5 * math.pi - horizon
    ray_dir = torch.stack(
        [torch.cos(altitude) * torch.sin(azimuth), torch.sin(altitude),
         -torch.cos(altitude) * torch.cos(azimuth)],
        -1,
    )
    alt = torch.remainder(torch.tensor(sun_altitude, dtype=torch.float32, device=device),
                          2.0 * math.pi)
    if alt < 0.5 * math.pi:
        sun = torch.stack([0.0 * alt, torch.sin(alt), -torch.cos(alt)], -1)
    else:
        sun = torch.stack([0.0 * alt, torch.sin(alt), torch.cos(alt)], -1)
    sun_dir = torch.broadcast_to(sun, ray_dir.shape)
    pos = torch.broadcast_to(_c("view_pos", device), ray_dir.shape)
    t_max, _ = _march_tmax(pos, ray_dir)
    cos_th = vm.dot(ray_dir, sun_dir)
    mie_ph = _mie_phase(cos_th)[..., None]
    ray_ph = _rayleigh_phase(-cos_th)[..., None]

    shape = ray_dir.shape[:-1]
    t = torch.zeros(shape, device=device)
    lum = torch.zeros(shape + (3,), device=device)
    trans = torch.ones(shape + (3,), device=device)
    for i in range(steps):
        new_t = _step_frac(i, steps) * t_max
        dt = (new_t - t)[..., None]
        p = pos + new_t[..., None] * ray_dir
        r_s, m_s, ext = _scattering_values(p)
        m_s = m_s[..., None]
        s_trans = torch.exp(-dt * ext)
        sun_t = sample_lut_at(tlut, p, sun_dir)
        psi = sample_lut_at(slut, p, sun_dir)
        in_s = r_s * (ray_ph * sun_t + psi) + m_s * (mie_ph * sun_t + psi)
        integral = (in_s - in_s * s_trans) / torch.clamp(ext, min=1e-7)
        t, lum, trans = new_t, lum + integral * trans, trans * s_trans
    return lum


_LUT_CACHE: dict = {}


def luts_for(sun_altitude: float, device=None) -> AtmosphereLuts:
    """LUT bundle from a host cache: transmittance and scattering made
    once per device, the sky LUT per rounded sun altitude."""
    device = torch.device(device) if device is not None else torch.device("cuda")
    key = ("static", str(device))
    if key not in _LUT_CACHE:
        t = generate_transmittance_lut(device)
        _LUT_CACHE[key] = (t, generate_scattering_lut(t))
    t, s = _LUT_CACHE[key]
    sky_key = ("sky", str(device), round(float(sun_altitude), 4))
    if sky_key not in _LUT_CACHE:
        _LUT_CACHE[sky_key] = generate_sky_lut(t, s, float(sun_altitude))
    return AtmosphereLuts(transmittance=t, scattering=s, sky=_LUT_CACHE[sky_key])


def sample_sky_lut(luts: AtmosphereLuts, ray_dir, sun_dir):
    """Sky-view LUT radiance toward ray_dir."""
    dev = ray_dir.device
    view = _c("view_pos", dev)
    height = vm.length(view)
    up = view / height
    horizon = torch.arccos(torch.clamp(
        torch.sqrt(torch.clamp(height**2 - GROUND_RADIUS_MM**2, min=0.0)) / height, -1.0, 1.0
    ))
    dot_up = vm.dot(ray_dir, torch.broadcast_to(up, ray_dir.shape))
    altitude = horizon - torch.arccos(torch.clamp(dot_up, -1.0 + 1e-6, 1.0 - 1e-6))

    right = vm.cross(sun_dir, torch.broadcast_to(up, sun_dir.shape))
    forward = vm.cross(torch.broadcast_to(up, right.shape), right)
    projected = vm.normalize(ray_dir - up * dot_up[..., None])
    sin_th = vm.dot(projected, right)
    cos_th = vm.dot(projected, forward)
    vertical = torch.abs(altitude) > (0.5 * math.pi - 1e-4)
    degenerate = vertical | ((sin_th == 0.0) & (cos_th == 0.0))
    azimuth = torch.where(
        vertical,
        0.0,
        torch.atan2(torch.where(degenerate, 0.0, sin_th), torch.where(degenerate, 1.0, cos_th))
        + math.pi,
    )
    u = azimuth / (2.0 * math.pi)
    s = torch.sqrt(torch.clamp(torch.abs(altitude) * 2.0 / math.pi, min=1e-12))
    v = 0.5 + 0.5 * torch.where(altitude >= 0.0, s, -s)
    return _bilinear(luts.sky, u, v)


def sample_atmosphere(luts: AtmosphereLuts, sun_dir, ray_dir):
    """Sky LUT + analytic sun bloom x transmittance, ground-occluded,
    scaled by EXPOSURE."""
    dev = ray_dir.device
    lum = sample_sky_lut(luts, ray_dir, sun_dir)
    cos_theta = vm.dot(ray_dir, sun_dir)
    sun_cos = float(np.cos(np.float32(np.deg2rad(0.53))))
    offset = sun_cos - cos_theta
    bloom = torch.where(
        cos_theta >= sun_cos,
        1.0,
        torch.exp(-offset * 50000.0) * 0.5 + 0.01 / (0.02 + offset * 300.0),
    )
    tt = torch.clamp((bloom - 0.002) / (1.0 - 0.002), 0.0, 1.0)
    sun_lum = tt * tt * (3.0 - 2.0 * tt)
    view = _c("view_pos", dev)
    pos = torch.broadcast_to(view, ray_dir.shape)
    hits_ground = ~torch.isinf(
        ray_sphere(pos, ray_dir, torch.zeros(3, device=dev), GROUND_RADIUS_MM)
    )
    trans = sample_lut_at(luts.transmittance, view, sun_dir)
    sun_contrib = torch.where(
        (hits_ground | (sun_lum <= 0.0))[..., None], 0.0, sun_lum[..., None] * trans
    )
    return (lum + sun_contrib) * EXPOSURE



def sun_color(luts: AtmosphereLuts, sun_dir):
    """The sun light's colour: the transmittance at the view position
    toward ``sun_dir`` [..., 3] x EXPOSURE x 5."""
    view = _c("view_pos", sun_dir.device)
    trans = sample_lut_at(luts.transmittance, torch.broadcast_to(view, sun_dir.shape), sun_dir)
    return trans * EXPOSURE * 5.0

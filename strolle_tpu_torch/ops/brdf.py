"""Lambert diffuse + GGX specular + layered mix (port of
strolle_tpu/ops/brdf.py, with its non-standard uniform-cos hemisphere
sample paired with pdf = 1/pi)."""

from __future__ import annotations

import math

import torch

from . import math as vm
from . import rng

MIN_ROUGHNESS = 0.089 * 0.089


def clamped_roughness(roughness):
    return torch.clamp(roughness, MIN_ROUGHNESS, 1.0)


def diffuse_eval(base_color, metallic):
    """Lambert: base_color.rgb * (1 - metallic) / pi."""
    return base_color[..., :3] * ((1.0 - metallic) / math.pi)[..., None]


def diffuse_sample(state, normal):
    """(state, dir, pdf): a hemisphere sample around ``normal`` [..., 3]
    with the reference's pdf of 1/pi."""
    state, d = rng.sample_hemisphere(state, normal)
    return state, d, torch.full(normal.shape[:-1], 1.0 / math.pi, device=normal.device)


def ggx_distribution(n_dot_h, a):
    a2 = a * a
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (math.pi * d * d)


def specular_eval(base_color, metallic, roughness, reflectance, normal, l, v):
    """GGX specular; zero where metallic <= 0 or back-facing."""
    a = clamped_roughness(roughness)
    h = vm.normalize(l + v)
    n_dot_l = vm.saturate(vm.dot(normal, l))
    n_dot_h = vm.saturate(vm.dot(normal, h))
    l_dot_h = vm.saturate(vm.dot(l, h))
    n_dot_v = vm.saturate(vm.dot(normal, v))

    d = ggx_distribution(n_dot_h, a)
    k = a * a / 2.0
    g = (n_dot_v / (n_dot_v * (1.0 - k) + k)) * (n_dot_l / (n_dot_l * (1.0 - k) + k))
    f0 = (0.16 * reflectance * reflectance * (1.0 - metallic))[..., None] + (
        base_color[..., :3] * metallic[..., None]
    )
    f0k = f0 * (50.0 * 0.33)
    f90 = vm.saturate(f0k[..., 0] + f0k[..., 1] + f0k[..., 2])
    x = torch.clamp(1.0 - l_dot_h, min=0.001)
    x2 = x * x
    p = x2 * x2 * x
    f = f0 + (f90[..., None] - f0) * p[..., None]

    denom = 4.0 * n_dot_l * n_dot_v
    spec = (d * g)[..., None] * f / torch.clamp(denom, min=1e-8)[..., None]
    ok = (metallic > 0.0) & (n_dot_l > 0.0) & (n_dot_v > 0.0)
    return torch.where(ok[..., None], spec, 0.0)


def specular_sample(state, base_color, metallic, roughness, reflectance, normal, v):
    """NDF importance sampling. Returns (state, dir, pdf, radiance)."""
    state, r0 = rng.next_f32(state)
    state, r1 = rng.next_f32(state)

    a = clamped_roughness(roughness)
    a2 = a * a
    b, t = vm.any_orthonormal_pair(normal)

    cos_theta = torch.sqrt(torch.clamp((1.0 - r0) / ((a2 - 1.0) * r0 + 1.0), min=0.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = r1 * math.pi * 2.0

    h = (
        t * (sin_theta * torch.cos(phi))[..., None]
        + b * (sin_theta * torch.sin(phi))[..., None]
        + normal * cos_theta[..., None]
    )
    n_dot_h = vm.saturate(vm.dot(normal, h))
    h_dot_v = vm.saturate(vm.dot(h, v))

    d = vm.normalize(2.0 * h_dot_v[..., None] * h - v)
    pdf = ggx_distribution(n_dot_h, a) * n_dot_h / torch.clamp(4.0 * h_dot_v, min=1e-8)
    radiance = specular_eval(base_color, metallic, roughness, reflectance, normal, d, v)
    return state, d, pdf, radiance


def layered_sample(state, base_color, metallic, roughness, reflectance, normal, v):
    """Picks the specular lobe with probability ``metallic``, else the
    diffuse one, and divides the pdf by the pick probability. Both lobes
    draw two uniforms, so the state advances the same either way.

    Returns (state, dir, pdf, radiance [..., 3]); pdf == 0 marks an
    invalid sample.
    """
    state, pick = rng.next_f32(state)
    use_spec = pick < metallic

    spec_state, s_dir, s_pdf, s_rad = specular_sample(
        state, base_color, metallic, roughness, reflectance, normal, v
    )
    diff_state, d_dir = rng.sample_hemisphere(state, normal)
    d_pdf = torch.full_like(metallic, 1.0 / math.pi)
    d_rad = diffuse_eval(base_color, metallic)

    new_state = torch.where(use_spec, spec_state, diff_state)
    direction = torch.where(use_spec[..., None], s_dir, d_dir)
    pdf = torch.where(
        use_spec,
        s_pdf / torch.clamp(metallic, min=1e-8),
        d_pdf / torch.clamp(1.0 - metallic, min=1e-8),
    )
    radiance = torch.where(use_spec[..., None], s_rad, d_rad)
    return new_state, direction, pdf, radiance

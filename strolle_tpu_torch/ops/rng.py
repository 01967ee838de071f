"""PCG white noise, bit-exact with strolle_tpu/ops/rng.py.

PyTorch's CPU ``uint32`` has no add, right shift or remainder, so a
state here is an ``int64`` tensor holding a value in [0, 2^32): every
step multiplies and adds in 64 bits (no product exceeds 2^62) and masks
back to 32 bits, which is exactly uint32 wrap-around. The CUDA kernels
run the same steps on ``uint32_t``.
"""

from __future__ import annotations

import math

import torch

from . import math as vm

MASK32 = 0xFFFFFFFF
_MAX_U32_F = 4294967295.0  # rounds to 2^32 in float32, as in the JAX package


def wnoise_new(seed, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel stream seeding: seed ^ 48619x ^ 95461y (mod 2^32)."""
    x = x.to(torch.int64) & MASK32
    y = y.to(torch.int64) & MASK32
    return (int(seed) & MASK32) ^ ((48619 * x) & MASK32) ^ ((95461 * y) & MASK32)


def next_u32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PCG-hash step. Returns (state', uniform u32), both int64."""
    state = (state * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return state, (word >> 22) ^ word


def next_f32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform sample in [0, 1]: one round-to-nearest u32 -> f32
    conversion, divided by 4294967295 (2^32 in float32)."""
    state, word = next_u32(state)
    return state, word.to(torch.float32) / _MAX_U32_F


def sample_circle(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform point on the unit circle [..., 2]."""
    state, u = next_f32(state)
    angle = u * (2.0 * math.pi)
    return state, torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def sample_disk(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform point inside the unit disk [..., 2]."""
    state, u = next_f32(state)
    radius = torch.sqrt(u)
    state, circ = sample_circle(state)
    return state, circ * radius[..., None]


def sample_sphere(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Point on/in the unit sphere with the sqrt(u) radial factor;
    cos(acos(2u-1)) and sin(acos(x)) evaluated algebraically."""
    state, u0 = next_f32(state)
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    phi = u0 * (2.0 * math.pi)
    cos_theta = torch.clamp(u1 * 2.0 - 1.0, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    r = torch.sqrt(u2)
    return state, torch.stack(
        [
            r * sin_theta * torch.cos(phi),
            r * sin_theta * torch.sin(phi),
            r * cos_theta,
        ],
        dim=-1,
    )


def sample_hemisphere(
    state: torch.Tensor, normal: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hemisphere sample around ``normal`` [..., 3]: cos_theta drawn
    uniformly (paired with pdf = 1/pi by the diffuse lobe)."""
    state, cos_theta = next_f32(state)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    state, u = next_f32(state)
    phi = 2.0 * math.pi * u
    t, b = vm.any_orthonormal_pair(normal)
    d = (
        t * torch.cos(phi)[..., None] + b * torch.sin(phi)[..., None]
    ) * sin_theta[..., None] + normal * cos_theta[..., None]
    return state, d

"""Weighted-reservoir sampling over per-pixel tensors (port of
strolle_tpu/restir/reservoir.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import rng

#: LightId::sky() analogue.
LIGHT_SKY = -1


def resampling_weight(w, pdf, norm_num, norm_denom):
    """The unbiased contribution weight W = w * num / (pdf * denom), 0
    where the denominator is. Its derivative is zero, as the JAX package
    defines it (a custom JVP with a zero tangent): the resampling
    statistics are fixed decisions and gradients follow the selected
    sample's radiance. The value is computed from detached inputs, so it
    is a constant to autograd and no division by a pdf near 0 reaches the
    backward pass."""
    w, pdf, norm_num, norm_denom = (
        x.detach() if isinstance(x, torch.Tensor) else x for x in (w, pdf, norm_num, norm_denom)
    )
    denom = pdf * norm_denom
    zero = denom == 0.0
    return torch.where(zero, 0.0, w * norm_num / torch.where(zero, 1.0, denom))


def _where(mask, a, b):
    return torch.where(mask[..., None] if a.ndim > mask.ndim else mask, a, b)


@dataclasses.dataclass(frozen=True)
class DiReservoirs:
    """Per-pixel DI reservoirs."""

    m: torch.Tensor  # f32[...]
    w: torch.Tensor  # f32[...]
    pdf: torch.Tensor  # f32[...]  target pdf at the own pixel
    confidence: torch.Tensor  # f32[...]
    light_id: torch.Tensor  # i32[...]
    light_point: torch.Tensor  # f32[..., 3]
    is_occluded: torch.Tensor  # bool[...]

    @property
    def is_empty(self) -> torch.Tensor:
        return self.m == 0.0

    def replace(self, **updates) -> "DiReservoirs":
        return dataclasses.replace(self, **updates)

    @staticmethod
    def empty(shape, device) -> "DiReservoirs":
        z = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        return DiReservoirs(
            m=z, w=z, pdf=z, confidence=z,
            light_id=torch.zeros(tuple(shape), dtype=torch.int32, device=device),
            light_point=torch.zeros(tuple(shape) + (3,), dtype=torch.float32, device=device),
            is_occluded=torch.zeros(tuple(shape), dtype=torch.bool, device=device),
        )


_SAMPLE_FIELDS = ("pdf", "light_id", "light_point", "is_occluded", "confidence")


def select(mask, a: DiReservoirs, b: DiReservoirs) -> DiReservoirs:
    """a where mask else b, field by field."""
    return DiReservoirs(
        **{f.name: _where(mask, getattr(a, f.name), getattr(b, f.name))
           for f in dataclasses.fields(DiReservoirs)}
    )


def select_sample(mask, a: DiReservoirs, b: DiReservoirs) -> DiReservoirs:
    """b with its sample fields replaced by a's where mask (m, w stay b's)."""
    return b.replace(**{f: _where(mask, getattr(a, f), getattr(b, f)) for f in _SAMPLE_FIELDS})


def update(state, res, cand, weight, enabled=None, select_sample_fn=select_sample):
    """Stream one candidate in. Returns (rng_state, reservoirs,
    accepted). Disabled lanes keep their reservoir; every lane's RNG
    advances."""
    if enabled is None:
        enabled = torch.ones(weight.shape, dtype=torch.bool, device=weight.device)
    m = res.m + 1.0
    w = res.w + weight
    state, u = rng.next_f32(state)
    accept = (u * w < weight) & enabled
    out = res.replace(m=torch.where(enabled, m, res.m), w=torch.where(enabled, w, res.w))
    return state, select_sample_fn(accept, cand, out), accept


def merge(state, res, rhs, pdf, enabled=None, update_fn=update):
    """Merge reservoir rhs into res with target pdf ``pdf``."""
    ok = rhs.m > 0.0
    if enabled is not None:
        ok = ok & enabled
    res2 = res.replace(m=torch.where(ok, res.m + rhs.m - 1.0, res.m))
    return update_fn(state, res2, rhs, rhs.w * rhs.m * pdf, ok)


def clamp_m(res, max_m: float):
    return res.replace(m=torch.clamp(res.m, max=max_m))


def clamp_w(res, max_w: float):
    return res.replace(w=torch.clamp(res.w, max=max_w))


def norm(res, pdf, norm_num, norm_denom):
    """``norm_num`` / ``norm_denom``: a Python float or a per-pixel tensor."""
    return res.replace(w=resampling_weight(res.w, pdf, norm_num, norm_denom))


def norm_avg(res, pdf):
    return norm(res, pdf, 1.0, res.m)


def norm_mis(res, pdf):
    return norm(res, pdf, 1.0, 1.0)

"""Pairwise defensive MIS for reservoir merges (port of
strolle_tpu/restir/mis.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import math as vm


class MisResult(NamedTuple):
    m: torch.Tensor
    lhs_pdf: torch.Tensor
    lhs_mis: torch.Tensor
    rhs_pdf: torch.Tensor
    rhs_mis: torch.Tensor


def _mis(x, y):
    s = x + y
    return torch.where(s == 0.0, 0.0, x / torch.where(s == 0.0, 1.0, s))


def _m(q0, q1):
    ratio = torch.clamp(q1 / torch.where(q0 <= 0.0, 1.0, q0), max=1.0)
    val = vm.saturate(ratio**8.0)
    return torch.where(q0 <= 0.0, 1.0, val)


def mis_eval(lhs_m, rhs_m, rhs_jacobian, lhs_lhs_pdf, lhs_rhs_pdf, rhs_lhs_pdf,
             rhs_rhs_pdf) -> MisResult:
    m = rhs_m * torch.minimum(_m(rhs_rhs_pdf, rhs_lhs_pdf), _m(lhs_rhs_pdf, lhs_lhs_pdf))
    t = _mis(lhs_m, rhs_m)
    lhs_mis = t + (1.0 - t) * _mis(lhs_m * lhs_lhs_pdf, rhs_m * lhs_rhs_pdf)
    rhs_mis = (1.0 - t) * _mis(rhs_m * rhs_rhs_pdf * rhs_jacobian, lhs_m * rhs_lhs_pdf)
    return MisResult(m=m, lhs_pdf=lhs_lhs_pdf, lhs_mis=lhs_mis, rhs_pdf=rhs_lhs_pdf,
                     rhs_mis=rhs_mis)

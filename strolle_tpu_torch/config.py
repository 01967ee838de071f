"""Pipeline tuning knobs (port of strolle_tpu/config.py).

One frozen, hashable dataclass of Python numbers; the defaults are the
reference renderer's hard-coded constants. Override per render with
``RenderConfig(tuning=Tuning(...))``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Tuning:
    # --- ReSTIR DI ------------------------------------------------------
    #: RIS candidates per pixel
    di_candidates: int = 16
    #: temporal history length clamp
    di_temporal_m_clamp: float = 64.0
    #: neighbour tries per spatial pass
    di_spatial_samples: int = 8
    #: starting spatial search radius, px
    di_spatial_radius: float = 128.0

    # --- ReSTIR GI ------------------------------------------------------
    #: temporal history length clamp
    gi_temporal_m_clamp: float = 128.0
    #: anti-firefly contribution-weight clamp
    gi_w_clamp: float = 5.0
    #: reconnection-Jacobian rejection bound
    gi_jacobian_reject: float = 10.0
    #: reconnection-Jacobian clamp after acceptance
    gi_jacobian_clamp: float = 3.0
    #: neighbour tries per spatial pass
    gi_spatial_samples: int = 8
    #: starting spatial search radius, px
    gi_spatial_radius: float = 128.0
    #: radiance-shift fraction that invalidates a replayed sample
    gi_validation_threshold: float = 0.33
    #: probability of sampling the sky instead of the lights at the
    #: secondary vertex when the sun is up
    sky_sample_prob: float = 0.25

    # --- SVGF denoiser --------------------------------------------------
    #: temporal accumulation history cap
    svgf_history_clamp: float = 16.0
    #: frames of history before temporal variance is trusted
    svgf_variance_min_history: float = 4.0
    #: à-trous iterations, strides 1, 2, 4, ...
    svgf_wavelet_passes: int = 5


#: The reference renderer's defaults.
DEFAULT_TUNING = Tuning()

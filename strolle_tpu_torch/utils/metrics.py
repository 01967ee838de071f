"""Host-side timers, scene stats and device traces (port of
strolle_tpu/utils/metrics.py).

* ``measure(name)``: per-stage wall timers, on when ``STROLLE_TPU_METRICS``
  is set; ``STROLLE_TPU_METRIC_THRESHOLD`` (seconds) leaves out faster
  stages. Each timing is logged as ``metric(name)=...ms`` at DEBUG level
  and summed into ``totals``.
* ``scene_stats(scene)``: per-tick entity counts, on when
  ``STROLLE_TPU_STATS`` is set.
* ``device_trace(dir)``: a ``torch.profiler`` trace of the enclosed work
  (CPU and, where there is a card, CUDA activity), written to ``dir`` as a
  Chrome trace.

All three do nothing unless switched on. A timer measures host time: it
does not wait for the card, so a stage that only queues device work
reads short.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

log = logging.getLogger("strolle_tpu_torch")

_ENABLED = bool(os.environ.get("STROLLE_TPU_METRICS"))
_THRESHOLD = float(os.environ.get("STROLLE_TPU_METRIC_THRESHOLD", "0") or 0)
_STATS = bool(os.environ.get("STROLLE_TPU_STATS"))

#: Cumulative [total_seconds, calls] per metric name.
totals: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True, threshold: float | None = None) -> None:
    global _ENABLED, _THRESHOLD
    _ENABLED = on
    if threshold is not None:
        _THRESHOLD = threshold


def _record(name: str, dt: float) -> None:
    tot = totals[name]
    tot[0] += dt
    tot[1] += 1
    if dt >= _THRESHOLD:
        log.debug("metric(%s)=%.3fms", name, dt * 1e3)


@contextlib.contextmanager
def measure(name: str):
    """``with measure("tick.bvh"): ...`` times the block when metrics are
    on."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


def metric(name: str, t0: float) -> None:
    """Manual form: ``t0 = time.perf_counter(); ...; metric(name, t0)``."""
    if _ENABLED:
        _record(name, time.perf_counter() - t0)


def summary() -> dict[str, dict[str, float]]:
    """Cumulative timings: {name: {total_s, calls, mean_ms}}."""
    return {
        k: {"total_s": v[0], "calls": v[1], "mean_ms": v[0] / max(v[1], 1) * 1e3}
        for k, v in totals.items()
    }


def scene_stats(scene, frame: int | None = None) -> dict[str, int] | None:
    """Logs the scene's entity counts at INFO level and returns them, or
    None when stats are off."""
    if not _STATS:
        return None
    stats = {
        "triangles": int(scene.geometry.num_triangles),
        "materials": int(scene.materials.num_materials),
        "lights": int(scene.lights.count),
        "bvh_nodes": 0 if scene.bvh is None else int(scene.bvh.num_nodes),
    }
    log.info("stats%s: %s", "" if frame is None else f"[frame {frame}]", stats)
    return stats


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profiles the enclosed work with ``torch.profiler`` and writes a
    Chrome trace into ``log_dir``. Usage: ``with device_trace(d): ...``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

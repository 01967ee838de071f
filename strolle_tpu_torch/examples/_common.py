"""Shared example plumbing: tonemap, PNG output, CLI (port of
examples/_common.py).

Headless: render N frames, write PNGs under out/<name>/, print per-frame
timing. The camera modes become the --mode flag. Frames render on the
CUDA card; ``--cpu`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

MODES = [
    "image",
    "di_diffuse",
    "di_specular",
    "gi_diffuse",
    "gi_specular",
    "albedo",
    "depth",
    "reference",
    "bvh_heatmap",
]


def parse_args(name: str, frames: int = 32, width: int = 512, height: int = 512, argv=None):
    ap = argparse.ArgumentParser(description=f"strolle_tpu_torch example: {name}")
    ap.add_argument("--frames", type=int, default=frames)
    ap.add_argument("--width", type=int, default=width)
    ap.add_argument("--height", type=int, default=height)
    ap.add_argument("--mode", choices=MODES, default="image")
    ap.add_argument("--no-denoise", action="store_true")
    ap.add_argument("--out", default=os.path.join("out", name))
    ap.add_argument("--save-every", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def device_of(cpu: bool):
    """The examples' device: the CUDA card, or the CPU with --cpu."""
    return "cpu" if cpu else None


def tonemap(img: np.ndarray) -> np.ndarray:
    """Linear HDR -> sRGB-ish u8 (plain gamma)."""
    a = np.clip(np.asarray(img, np.float32), 0.0, 1.0) ** (1.0 / 2.2)
    return (a * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if arr.ndim == 2:  # depth-style channel
        mx = float(arr.max()) or 1.0
        arr = np.repeat((arr / mx)[..., None], 3, axis=-1)
    Image.fromarray(tonemap(arr)).save(path)


class Saved:
    """The PNGs an example writes under ``out``, and whether every image
    it saved was finite."""

    def __init__(self, out: str) -> None:
        self.out = out
        self.pngs: list[str] = []
        self.finite = True

    def save(self, name: str, img: torch.Tensor) -> None:
        path = os.path.join(self.out, name)
        save_png(path, img)
        self.pngs.append(path)
        self.finite = self.finite and bool(torch.isfinite(img).all())

    def result(self, **info) -> dict:
        return {"pngs": self.pngs, "finite": self.finite, **info}


def frame_done(img: torch.Tensor) -> None:
    """Waits for the device work behind ``img``, so that the timer reads it."""
    if img.is_cuda:
        torch.cuda.synchronize(img.device)


def should_save(f: int, frames: int, every: int) -> bool:
    return (f + 1) % every == 0 or f == frames - 1


class FrameTimer:
    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self._t0
        self._t0 = t
        self.times.append(dt)
        return dt

    def report(self, skip_first: int = 1) -> str:
        ts = self.times[skip_first:] or self.times
        ms = 1e3 * sum(ts) / len(ts)
        return f"{ms:.1f} ms/frame ({1e3 / ms:.1f} FPS) over {len(ts)} frames"

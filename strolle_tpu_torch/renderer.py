"""Per-camera render orchestration (port of strolle_tpu/renderer.py).

Each camera owns the temporal state that outlives one frame (the
realtime frame's RenderState, or reference mode's accumulator); the
state is dropped when the viewport, the mode or the denoise switch
changes.

Modes:
    "image"        the ReSTIR DI + GI frame with SVGF
    "di_diffuse" / "di_specular" / "gi_diffuse" / "gi_specular" /
    "albedo" / "depth"
                   one channel of the same frame
    "reference"    the accumulating path tracer (ground truth)
    "bvh_heatmap"  traversal cost
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable

import torch

from .camera import Camera
from .models import reference as ref_mod
from .models import restir as restir_mod
from .scene.types import Scene


@dataclasses.dataclass
class CameraSettings:
    """Per-camera render settings."""

    mode: str = "image"
    denoise: bool = True
    include_sky: bool = False
    reference_depth: int = 5


@dataclasses.dataclass
class _CameraRec:
    camera: Camera
    settings: CameraSettings
    state: Any = None  # RenderState | RefAccumulator | None


class Renderer:
    """Holds per-camera temporal state; renders frames on demand."""

    def __init__(self):
        self._cameras: dict[Hashable, _CameraRec] = {}

    def create_camera(self, handle: Hashable, camera: Camera,
                      settings: CameraSettings | None = None):
        self._cameras[handle] = _CameraRec(camera=camera, settings=settings or CameraSettings())

    def update_camera(self, handle: Hashable, camera: Camera | None = None,
                      settings: CameraSettings | None = None):
        """Updates the camera or its settings; the temporal state is
        dropped when the viewport size, the mode or the denoise switch
        changes."""
        rec = self._cameras[handle]
        invalidate = False
        if camera is not None:
            if (camera.height, camera.width) != (rec.camera.height, rec.camera.width):
                invalidate = True
            rec.camera = camera
        if settings is not None:
            if settings.mode != rec.settings.mode or settings.denoise != rec.settings.denoise:
                invalidate = True
            rec.settings = settings
        if invalidate:
            rec.state = None

    def delete_camera(self, handle: Hashable):
        self._cameras.pop(handle, None)

    def has_camera(self, handle: Hashable) -> bool:
        return handle in self._cameras

    def render_camera(self, handle: Hashable, scene: Scene, seed: int, luts=None) -> torch.Tensor:
        """Renders one frame for the camera and advances its temporal
        state; returns the [H, W, 3] image of its mode."""
        rec = self._cameras[handle]
        mode = rec.settings.mode

        if mode == "bvh_heatmap":
            from .models.heatmap import render_heatmap

            return render_heatmap(scene, rec.camera)

        if mode == "reference":
            if rec.state is None:
                rec.state = ref_mod.init_accumulator(rec.camera)
            image, rec.state = ref_mod.render_reference(
                scene, rec.camera, rec.state, int(seed), depth=rec.settings.reference_depth,
                include_sky=rec.settings.include_sky, luts=luts,
            )
            return image

        if rec.state is None:
            rec.state = restir_mod.init_state(rec.camera, device=rec.camera.device)
        config = restir_mod.RenderConfig(
            mode=mode,
            denoise=rec.settings.denoise,
            needs_di=True,
            needs_gi=mode in ("image", "gi_diffuse", "gi_specular"),
            include_sky=rec.settings.include_sky,
        )
        channels, rec.state = restir_mod.render_frame(
            scene, rec.camera, rec.state, int(seed), config, luts=luts
        )
        out = channels[mode if mode in channels else "image"]
        return out if out.ndim == 3 else out[..., None].repeat(1, 1, 3)

"""strolle_tpu_torch — the strolle_tpu renderer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX package `strolle_tpu` module for module.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead. The engine's API: ``SceneEditor`` (scene edits
between frames, ``tick()`` per frame), ``Renderer`` and
``CameraSettings`` (per-camera temporal state and modes).
"""

from .device import resolve_device
from .renderer import CameraSettings, Renderer
from .scene.dynamics import SceneEditor

__all__ = ["CameraSettings", "Renderer", "SceneEditor", "resolve_device"]

"""strolle_tpu_torch — the reference-mode path tracer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX package `strolle_tpu` module for module.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

"""Differentiable rendering: steps on scene parameters (port of
strolle_tpu/models/train.py).

Gradients of the rendered image with respect to materials, lights and
vertex positions flow through the path integrator. Discrete choices (hit
ids, light picks, the RNG) carry none: the trace kernels find the winner
on detached rays and t/u/v are recomputed through it with tensor ops
(``ops/trace.py``), the resampling statistics are detached
(``restir/reservoir.resampling_weight``, the GI light pdf) and the
à-trous filter passes the colour cotangent through its frozen-weight
adjoint (``denoise/svgf._WaveletCore``). Both losses take the
differentiable route, ``use_pallas=False``: on a small scene every
closest hit is one launch of kernel A and every shadow ray one of
kernel B.

    from strolle_tpu_torch.models.train import params_from_scene, train_step
    params = params_from_scene(scene)
    loss, params, grads = train_step(params, scene, camera, target, seed=7)

With a device mesh (``parallel/``) each rank renders only its own rows:
``train_step_sharded`` runs the backward locally and sums the loss and
every gradient over the ranks in one all-reduce, the JAX package's psum.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera
from ..parallel.sharding import all_reduce_sum, mesh_block, sample_block
from ..scene.types import Scene
from .reference import trace_sample
from .restir import RenderConfig, render_frame


@dataclasses.dataclass(frozen=True)
class TrainableParams:
    """The differentiable slice of a Scene."""

    base_color: torch.Tensor  # f32[M, 4]
    emissive: torch.Tensor  # f32[M, 4]
    light_pos: torch.Tensor  # f32[L, 3]
    light_color: torch.Tensor  # f32[L, 3]
    positions: torch.Tensor  # f32[T, 3, 3] vertex positions

    def replace(self, **updates) -> "TrainableParams":
        return dataclasses.replace(self, **updates)


FIELDS = tuple(f.name for f in dataclasses.fields(TrainableParams))


def params_from_scene(scene: Scene) -> TrainableParams:
    return TrainableParams(
        base_color=scene.materials.base_color,
        emissive=scene.materials.emissive,
        light_pos=scene.lights.pos,
        light_color=scene.lights.color,
        positions=scene.geometry.positions,
    )


def apply_params(scene: Scene, params: TrainableParams) -> Scene:
    """A new scene with the parameters in place (the other fields shared)."""
    return scene.replace(
        materials=dataclasses.replace(
            scene.materials, base_color=params.base_color, emissive=params.emissive
        ),
        lights=dataclasses.replace(scene.lights, pos=params.light_pos, color=params.light_color),
        geometry=dataclasses.replace(scene.geometry, positions=params.positions),
    )


def render_loss(params: TrainableParams, scene: Scene, camera: Camera, target: torch.Tensor,
                seed, depth: int = 2, mesh=None) -> torch.Tensor:
    """L2 image loss of a 1-spp render against ``target``, through the
    staged loop's differentiable route (``use_pallas=False``). With
    ``mesh`` each rank renders only its own rows: the value is the whole
    image's loss on every rank, its gradient this rank's share (summed
    over the ranks by ``train_step_sharded``)."""
    if mesh is not None:
        part = rows_loss(params, scene, camera, target, seed, depth, mesh_block(mesh),
                         mesh.size())
        (total,) = all_reduce_sum([part])
        return part + (total - part.detach())
    img = trace_sample(apply_params(scene, params), camera, seed, depth, False,
                       use_pallas=False)
    diff = img - target
    return torch.mean(diff * diff)


def rows_loss(params: TrainableParams, scene: Scene, camera: Camera, target: torch.Tensor,
              seed, depth: int, block: int, n: int) -> torch.Tensor:
    """Block ``block`` of ``n``'s share of the mean squared error (the
    share of the rank that holds it): the sum over its real rows (pad rows
    masked out) divided by H * W * 3."""
    img, yy, real = sample_block(apply_params(scene, params), camera, seed, depth, False, False,
                                 block, n)
    diff = img - target[yy.long()]
    sq = torch.where(real[:, None, None], diff * diff, 0.0)
    return sq.sum() / (camera.height * camera.width * 3)


def _value_and_grad(loss_fn, params: TrainableParams):
    """(loss, gradients as TrainableParams) of ``loss_fn(params)``; a
    parameter the loss does not reach gets a zero gradient."""
    leaves = [getattr(params, f).detach().requires_grad_() for f in FIELDS]
    loss = loss_fn(TrainableParams(*leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), TrainableParams(*grads)


def _sgd(params: TrainableParams, grads: TrainableParams, lr: float) -> TrainableParams:
    return TrainableParams(*(getattr(params, f).detach() - lr * getattr(grads, f)
                             for f in FIELDS))


def train_step(params: TrainableParams, scene: Scene, camera: Camera, target: torch.Tensor,
               seed, lr: float = 0.05, depth: int = 2):
    """One SGD step on scene parameters (one device): (loss, params -
    lr * grads, grads)."""
    loss, grads = _value_and_grad(
        lambda p: render_loss(p, scene, camera, target, seed, depth), params
    )
    return loss, _sgd(params, grads, lr), grads


def restir_render_loss(params: TrainableParams, scene: Scene, camera: Camera, state,
                       target: torch.Tensor, seed, config=None, luts=None) -> torch.Tensor:
    """L2 image loss of one realtime ReSTIR + SVGF frame against
    ``target``; ``config`` defaults to ``RenderConfig(differentiable=True)``,
    which sends every trace through ``use_pallas=False``."""
    if config is None:
        config = RenderConfig(differentiable=True)
    channels, _ = render_frame(apply_params(scene, params), camera, state, seed, config, luts)
    diff = channels["image"] - target
    return torch.mean(diff * diff)


def restir_train_step(params: TrainableParams, scene: Scene, camera: Camera, state,
                      target: torch.Tensor, seed, lr: float = 0.05, config=None, luts=None):
    """One SGD step on scene parameters through the realtime frame: (loss,
    params - lr * grads, grads)."""
    loss, grads = _value_and_grad(
        lambda p: restir_render_loss(p, scene, camera, state, target, seed, config, luts),
        params,
    )
    return loss, _sgd(params, grads, lr), grads


def train_step_sharded(mesh, params: TrainableParams, scene: Scene, camera: Camera,
                       target: torch.Tensor, seed, lr: float = 0.05, depth: int = 2):
    """One SGD step with the pixel rows split over ``mesh``: each rank
    renders and differentiates its own rows, then the loss and gradients
    are summed over the ranks in one all-reduce. (loss, params - lr *
    grads, grads), equal on every rank."""
    loss, grads = _value_and_grad(
        lambda p: rows_loss(p, scene, camera, target, seed, depth, mesh_block(mesh), mesh.size()),
        params
    )
    loss, *summed = all_reduce_sum([loss.reshape(1)] + [getattr(grads, f) for f in FIELDS])
    grads = TrainableParams(*summed)
    return loss.reshape(()), _sgd(params, grads, lr), grads

"""The realtime ReSTIR + SVGF frame with its trace calls split over a
device mesh (port of strolle_tpu/parallel/frame_sharding.py).

The JAX package partitions every per-pixel stage along the rows and
lets the partitioner all-gather what reprojection, spatial taps and the
à-trous stencils read. The port keeps the state whole on every rank
instead and splits only the trace calls: inside ``trace_surface``,
``trace_closest`` and ``trace_anyhit`` each rank traces its own block of
rows and the blocks are gathered (``ops.trace.trace_rows_sharded``);
every other stage runs at full height on every rank, so the frame equals
the unsplit one. The frame is bound by the host's dispatch of its small
ops, which a row split of those stages would not cut on any rank.

    mesh = make_mesh()
    scene = replicate_scene(mesh, scene)
    state = init_state_sharded(mesh, camera)
    channels, state = render_frame_sharded(mesh, scene, camera, state, seed)
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..camera import Camera
from ..models.restir import RenderConfig, RenderState, init_state, render_frame
from ..scene.types import Scene
from ..utils.pytree import tree_map
from .sharding import AXIS, make_mesh, rank_device  # noqa: F401


def row_sharding(mesh: DeviceMesh) -> list:
    """Rows split over every axis of the mesh, host-major: a DTensor's
    placements."""
    return [Shard(0)] * mesh.ndim


def replicated(mesh: DeviceMesh) -> list:
    """Whole on every rank: a DTensor's placements."""
    return [Replicate()] * mesh.ndim


def _check_height(mesh: DeviceMesh, camera: Camera) -> None:
    if camera.height % mesh.size():
        raise ValueError(f"height {camera.height} not divisible by mesh size {mesh.size()}")


def shard_render_state(mesh: DeviceMesh, state: RenderState, camera: Camera) -> RenderState:
    """The state on this rank's device. The port keeps every leaf whole
    on every rank (the frame splits only its trace calls); the image
    height must divide by the mesh size, as in the JAX package."""
    _check_height(mesh, camera)
    dev = rank_device(mesh)
    return tree_map(lambda x: x.to(dev), state)


def init_state_sharded(mesh: DeviceMesh, camera: Camera) -> RenderState:
    return shard_render_state(mesh, init_state(camera, device=rank_device(mesh)), camera)


def replicate_scene(mesh: DeviceMesh, scene: Scene) -> Scene:
    """The scene whole on this rank's device."""
    dev = rank_device(mesh)
    return tree_map(lambda x: x.to(dev), scene)


def render_frame_sharded(mesh: DeviceMesh, scene: Scene, camera: Camera, state: RenderState,
                         seed, config: RenderConfig = RenderConfig(), luts=None):
    """One realtime frame with the trace calls' rows split over ``mesh``;
    equal to ``render_frame`` on one device. The image height must divide
    by the mesh size."""
    _check_height(mesh, camera)
    return render_frame(scene, camera, state, seed, config, luts=luts, mesh=mesh)

"""The realtime ReSTIR + SVGF frame with its pixel rows split over a
device mesh (port of strolle_tpu/parallel/frame_sharding.py).

As in the JAX package, every rank holds, computes and returns only its
own block of rows (split host-major in rank order, ``sharding.mesh_block``):
every ``[H, ...]`` leaf of the RenderState, every per-pixel intermediate
and every returned channel. The scene, ``prev_camera`` and the frame
counter are the same on every rank.

- Per-pixel stages run on the block at global coordinates: the frame
  passes its ``parallel.rows.RowBlock`` (first row, rows, image height)
  through every stage, and the screen grid, the RNG streams, the blue
  noise and the checkerboard parity take the global row.
- Trace calls take the block's own rays (kernels 4 and B on a small
  scene, 5 and 6 under "stream") and gather nothing. The fused spatial
  probe (kernel 7) stays off under a mesh, as in the JAX package.
- The cross-pixel reads all-gather the whole height of exactly the
  arrays they tap, then tap them for the block's own pixels: the
  reprojected history (the previous surface and reservoirs) and the
  current surface, once a frame each; the DI and GI spatial reuse and
  the GI previews (each pass's reservoirs), the denoiser's bilinear
  history, its 5x5 variance taps' luma and each à-trous pass's colour
  and variance. Each gather is one byte-packed ``all_gather``
  (``sharding.gather_rows``).

On a mesh of one rank every gather is the identity and the frame
launches what the unsplit frame launches (the probe kernel aside). The
frame is forward only and the image height must divide by the mesh
size.

    mesh = make_mesh()
    scene = replicate_scene(mesh, scene)
    state = init_state_sharded(mesh, camera)
    channels, state = render_frame_sharded(mesh, scene, camera, state, seed)
    image = gather_frame(channels)["image"]      # [H, W, 3] where needed
"""

from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..camera import Camera
from ..models.restir import RenderConfig, RenderState, init_state, render_frame
from ..scene.types import Scene
from ..utils.pytree import tree_map
from .rows import RowBlock
from .sharding import AXIS, gather_rows, make_mesh, rank_device  # noqa: F401

#: The RenderState fields whose leaves are [H, ...] screen arrays.
ROW_FIELDS = ("prev_surface", "di_prev", "gi_prev", "di_diff_denoiser", "gi_diff_denoiser")


def row_sharding(mesh: DeviceMesh) -> list:
    """Rows split over every axis of the mesh, host-major: a DTensor's
    placements."""
    return [Shard(0)] * mesh.ndim


def replicated(mesh: DeviceMesh) -> list:
    """Whole on every rank: a DTensor's placements."""
    return [Replicate()] * mesh.ndim


def shard_render_state(mesh: DeviceMesh, state: RenderState, camera: Camera) -> RenderState:
    """This rank's rows of a whole state, on its device: every [H, ...]
    leaf sliced to the rank's block; ``prev_camera`` and ``frame`` whole.
    The image height must divide by the mesh size."""
    rows = RowBlock.of(mesh, camera.height)
    dev = rank_device(mesh)
    block = {f: tree_map(lambda x: x[rows.y0:rows.y0 + rows.rows].to(dev).contiguous(),
                         getattr(state, f)) for f in ROW_FIELDS}
    return dataclasses.replace(state, prev_camera=tree_map(lambda x: x.to(dev), state.prev_camera),
                               **block)


def init_state_sharded(mesh: DeviceMesh, camera: Camera) -> RenderState:
    """The state before the first frame, holding only this rank's rows."""
    return init_state(camera, device=rank_device(mesh), rows=RowBlock.of(mesh, camera.height))


def replicate_scene(mesh: DeviceMesh, scene: Scene) -> Scene:
    """The scene whole on this rank's device."""
    dev = rank_device(mesh)
    return tree_map(lambda x: x.to(dev), scene)


def render_frame_sharded(mesh: DeviceMesh, scene: Scene, camera: Camera, state: RenderState,
                         seed, config: RenderConfig = RenderConfig(), luts=None):
    """One realtime frame with the pixel rows split over ``mesh``:
    ``state`` holds this rank's rows (``init_state_sharded``, or a
    previous call) and so do the returned channels and state. Gathered
    (``gather_frame``), they equal ``render_frame``'s on one device. The
    image height must divide by the mesh size; forward only (a scene or
    state that requires grad raises ``ValueError``)."""
    return render_frame(scene, camera, state, seed, config, luts=luts, mesh=mesh)


def gather_frame(tree):
    """The channels dict or the RenderState of ``render_frame_sharded``
    at the whole image height on every rank: one all-gather of every
    [rows, ...] leaf (``prev_camera`` and ``frame`` stay as they are)."""
    if isinstance(tree, RenderState):
        return dataclasses.replace(tree, **gather_rows({f: getattr(tree, f) for f in ROW_FIELDS}))
    return gather_rows(tree)

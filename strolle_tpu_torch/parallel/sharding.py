"""Pixel rows split over the ranks of a 1-D device mesh (port of
strolle_tpu/parallel/sharding.py).

The scene is whole on every rank and the forward pass needs no
collective until its result: each rank traces its own block of rows and
the blocks are gathered. Rows are padded up to a multiple of the mesh
size by wrapping past the bottom (``y % H``) and the pad rows are
dropped.

    from strolle_tpu_torch.parallel.sharding import make_mesh, render_sample_sharded
    mesh = make_mesh()            # every rank of the process group
    img = render_sample_sharded(mesh, scene, camera, seed=5, depth=2)   # [H, W, 3]

With no process group, ``make_mesh()`` starts one of world size 1
(``nccl`` on the card, ``gloo`` with ``device="cpu"``); a bigger group is
started by ``torchrun`` or ``parallel.distributed.initialize``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..camera import Camera
from ..device import resolve_device
from ..models.reference import sample_pixels
from ..scene.types import Scene
from ..utils.pytree import tree_map

AXIS = "px"


def init_world(device=None) -> torch.device:
    """The device this rank renders on; starts a process group of world
    size 1 (an in-process store) when none is running."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dev


def make_mesh(n: int | None = None, device=None) -> DeviceMesh:
    """A 1-D ``("px",)`` mesh over every rank of the process group; ``n``,
    where given, must be the world size."""
    if not dist.is_initialized() and n not in (None, 1):
        raise ValueError(f"make_mesh({n}): start a process group of {n} ranks first "
                         "(torchrun, or parallel.distributed.initialize)")
    dev = init_world(device)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} ranks")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank renders on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pad_rows(h: int, n: int) -> int:
    """Rows padded up so the mesh size divides the image height."""
    return -(-h // n) * n


def mesh_block(mesh: DeviceMesh) -> int:
    """This rank's block of rows: its coordinate flattened host-major,
    which is its rank, as the mesh must span the process group in rank
    order."""
    idx = 0
    for c, s in zip(mesh.get_coordinate(), mesh.shape):
        idx = idx * s + c
    if mesh.size() != dist.get_world_size() or idx != dist.get_rank():
        raise ValueError("the mesh must span the process group in rank order")
    return idx


def _staged(x: torch.Tensor) -> bool:
    """Gloo's collectives take host tensors here: a CUDA buffer goes
    through the host."""
    return x.is_cuda and dist.get_backend() == "gloo"


def gather_rows(tree):
    """Every tensor of ``tree`` (a dataclass, tuple or dict of [rows, ...]
    tensors) gathered along dim 0 over the ranks, in rank order: one
    all-gather of the fields' bytes side by side. Forward only: a tensor
    that requires grad raises, as its gradient would be lost."""
    leaves = []
    tree_map(lambda x: leaves.append(x) or x, tree)
    if any(x.requires_grad for x in leaves):
        raise ValueError("gather_rows splits the forward pass only: its tensors must not "
                         "require grad (no sharded frame is differentiated)")
    rows = leaves[0].shape[0]
    cols = [x.contiguous().reshape(rows, -1).view(torch.uint8) for x in leaves]
    buf = torch.cat(cols, 1)
    src = buf.cpu() if _staged(buf) else buf
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    full = torch.cat(parts).to(buf.device)
    chunks = iter(full.split([c.shape[1] for c in cols], 1))
    n_rows = full.shape[0]
    return tree_map(
        lambda x: next(chunks).contiguous().view(x.dtype).reshape((n_rows,) + x.shape[1:]), tree)


def all_reduce_sum(tensors: list) -> list:
    """The tensors (one dtype) summed over the ranks in one all-reduce."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = flat.cpu() if _staged(flat) else flat
    dist.all_reduce(buf)
    buf = buf.to(flat.device)
    return [c.view_as(t) for c, t in zip(buf.split([t.numel() for t in tensors]), tensors)]


def sample_rows(mesh: DeviceMesh, scene: Scene, camera: Camera, seed, depth: int = 5,
                include_sky: bool = False, use_pallas: bool | None = None):
    """This rank's rows of one path-traced sample: (radiance [rows, W, 3],
    the image row of each [rows], which of them are real rows)."""
    return sample_block(scene, camera, seed, depth, include_sky, use_pallas,
                        mesh_block(mesh), mesh.size())


def sample_block(scene: Scene, camera: Camera, seed, depth: int, include_sky: bool,
                 use_pallas: bool | None, block: int, n: int):
    """Block ``block`` of ``n`` of one path-traced sample, as
    ``sample_rows`` returns it: the grid comes from the block's index,
    wrapped past the image bottom for pad rows."""
    h, w = camera.height, camera.width
    rows = pad_rows(h, n) // n
    dev = camera.device
    y = torch.arange(rows, dtype=torch.int32, device=dev) + block * rows
    yy = y % h
    xx = torch.arange(w, dtype=torch.int32, device=dev)
    grid = torch.stack([xx.expand(rows, w), yy[:, None].expand(rows, w)], -1)
    img = sample_pixels(scene, camera, grid, seed, depth, include_sky, use_pallas=use_pallas)
    return img, yy, y < h


def render_sample_sharded(mesh: DeviceMesh, scene: Scene, camera: Camera, seed,
                          depth: int = 5, include_sky: bool = False,
                          use_pallas: bool | None = None) -> torch.Tensor:
    """One path-traced sample with rows split over the mesh: [H, W, 3] on
    every rank, equal to ``trace_sample``'s."""
    img, _, _ = sample_rows(mesh, scene, camera, seed, depth, include_sky, use_pallas)
    return gather_rows(img)[:camera.height]

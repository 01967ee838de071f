"""Process-group set-up and the host x chip mesh (port of
strolle_tpu/parallel/distributed.py).

One process per card. ``initialize`` starts the ``torch.distributed``
group from its arguments or from the variables ``torchrun`` sets
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); without a coordinator it does nothing, so the same code
runs on one process. ``make_host_chip_mesh`` lays the ranks out as a
2-D ``("host", "chip")`` mesh. Rows split over both axes host-major,
which is the rank order, so the sample and the training step are those
of ``sharding.py`` and ``models/train.py``: the forward pass has no
collective until its result, and the gradients are summed over every
rank in one all-reduce.

    torchrun --nproc_per_node=4 script.py     # script.py:
    initialize()
    mesh = make_host_chip_mesh()
    img = render_sample_hostmesh(mesh, scene, camera, seed=5)
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ..device import resolve_device
from ..models.train import render_loss, train_step_sharded
from .frame_sharding import replicated, row_sharding  # noqa: F401
from .sharding import init_world, rank_device, render_sample_sharded

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_initialized = False


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Starts the process group for a run of several processes; True when
    more than one process runs afterwards. Arguments default to
    torchrun's variables (``coordinator_address`` "host:port" from
    ``MASTER_ADDR``/``MASTER_PORT``). With no coordinator anywhere this
    is a no-op that returns False; calling it again returns the same
    answer. The group runs ``nccl`` on the card and ``gloo`` with
    ``device="cpu"``; each rank's card is ``LOCAL_RANK`` (else its rank)
    modulo the cards present."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return dist.is_initialized() and dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        _initialized = True
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of processes and this "
                         "process's id (or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    return num_processes > 1


def make_host_chip_mesh(n_hosts: int | None = None, device=None) -> DeviceMesh:
    """A 2-D ``("host", "chip")`` mesh over every rank in rank order.
    ``n_hosts`` defaults to the world size over torchrun's
    ``LOCAL_WORLD_SIZE`` (one host without it)."""
    dev = init_world(device)
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return init_device_mesh(dev.type, (n_hosts, world // n_hosts),
                            mesh_dim_names=(HOST_AXIS, CHIP_AXIS))


def row_spec() -> list:
    """Pixel rows split over both axes, host-major: the placements of a
    row-split DTensor on the host x chip mesh."""
    return [Shard(0), Shard(0)]


def host_local_rows(mesh: DeviceMesh, local_block) -> DTensor:
    """A row-split DTensor from each process's own block of rows
    ([H / world, ...]); no process holds the whole screen. With one
    process the block is the whole array."""
    x = torch.as_tensor(local_block, device=rank_device(mesh))
    return DTensor.from_local(x, mesh, row_sharding(mesh))


def render_sample_hostmesh(mesh: DeviceMesh, scene, camera, seed, depth: int = 5,
                           include_sky: bool = False, use_pallas: bool | None = None):
    """One path-traced sample with rows split over the host x chip mesh:
    [H, W, 3] on every rank."""
    return render_sample_sharded(mesh, scene, camera, seed, depth, include_sky, use_pallas)


def render_loss_hostmesh(params, scene, camera, target, seed, depth, mesh):
    """L2 image loss with rows split over the host x chip mesh (the whole
    loss on every rank, its gradient this rank's share)."""
    return render_loss(params, scene, camera, target, seed, depth, mesh=mesh)


def train_step_hostmesh(mesh: DeviceMesh, params, scene, camera, target, seed,
                        lr: float = 0.05, depth: int = 2):
    """One SGD step on scene parameters over the host x chip mesh; the
    gradients summed over both axes."""
    return train_step_sharded(mesh, params, scene, camera, target, seed, lr, depth)

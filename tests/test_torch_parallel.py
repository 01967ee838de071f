"""The port's multi-device layer (strolle_tpu_torch/parallel/, the mesh
terms of ops/trace.py, restir/di.py, models/restir.py and
models/train.py, entry.py) on gloo ranks on the CPU.

In-process, on a process group of world size 1: the split sample,
training step and realtime frame equal their unsplit counterparts
exactly. Spawned ranks (plain subprocesses that never import JAX, each
killed after CHILD_TIMEOUT seconds): four ranks hold the host x chip
mesh, its DTensor rows, its sample and training step, the 1-D mesh's
training step and two split frames to the one-rank results; two ranks
hold the split sample of 21 rows to the JAX package's
``render_sample_sharded`` on its 8-device mesh (22 padded rows against
24)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.models import train
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.models.restir import init_state, render_frame
from strolle_tpu_torch.ops import trace
from strolle_tpu_torch.parallel import distributed as pdist
from strolle_tpu_torch.parallel import frame_sharding, sharding
from strolle_tpu_torch.restir.di import _probe_kernel_enabled
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.utils.pytree import tree_map

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 120


def _assert_images_match(single, sharded):
    """tests/test_sharding.py's criteria (copied): under 1% of pixels off
    by more than 1e-5, the median difference at most 1e-6, and no row
    with 25% of its pixels off (a split artifact concentrates on
    rows)."""
    assert sharded.shape == single.shape
    diff = np.abs(single - sharded).max(axis=-1)
    frac_bad = (diff > 1e-5).mean()
    assert frac_bad < 0.01, f"{frac_bad:.4f} of pixels differ"
    assert np.median(diff) <= 1e-6
    row_bad = (diff > 1e-5).mean(axis=1)
    assert row_bad.max() < 0.25, f"row {row_bad.argmax()} has {row_bad.max():.2f} differing"


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of world size 1 from a FileStore."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield sharding.make_mesh(1, device="cpu")
    dist.destroy_process_group()


def _cornell(w, h, bvh=True):
    scene = cornell_box(device="cpu")
    return (scene_with_bvh(scene) if bvh else scene), cornell_camera(w, h, device="cpu")


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def _equal_trees(a, b):
    for f in train.FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_world_of_one_equals_unsplit(world1):
    """Sample, loss, training step and two realtime frames (every channel
    and state leaf) on one rank: bit-equal to the unsplit calls."""
    mesh = world1
    scene, cam = _cornell(32, 24)
    assert torch.equal(sharding.render_sample_sharded(mesh, scene, cam, 5, depth=2),
                       trace_sample(scene, cam, 5, depth=2, include_sky=False))
    params = train.params_from_scene(scene)
    target = torch.full((24, 32, 3), 0.1)
    loss, new, grads = train.train_step(params, scene, cam, target, 3, depth=1)
    loss_m, new_m, grads_m = train.train_step_sharded(mesh, params, scene, cam, target, 3,
                                                      depth=1)
    assert torch.equal(loss, loss_m)
    _equal_trees(grads, grads_m)
    _equal_trees(new, new_m)
    assert torch.equal(train.render_loss(params, scene, cam, target, 3, 1, mesh=mesh), loss)

    state = init_state(cam, device="cpu")
    split = frame_sharding.init_state_sharded(mesh, cam)
    rep = frame_sharding.replicate_scene(mesh, scene)
    for f in range(2):
        ch, state = render_frame(scene, cam, state, f)
        ch_m, split = frame_sharding.render_frame_sharded(mesh, rep, cam, split, f)
        for k in ch:
            assert torch.equal(ch[k], ch_m[k]), (f, k)
    for a, b in zip(_leaves(state), _leaves(split), strict=True):
        assert torch.equal(a, b)


def test_trace_rows_sharded_none_is_a_noop():
    with trace.trace_rows_sharded(None):
        assert trace._TRACE_MESH.get() is None
    assert trace._TRACE_MESH.get() is None


def test_split_refuses_rows_and_gradients(world1):
    """Rows that do not divide over the mesh raise, as shard_map refuses
    them; rays that require grad, or a scene whose hits would carry one,
    raise (the split is forward only)."""
    scene, _ = _cornell(4, 4, bvh=False)
    o = torch.zeros(3, 2, 3)
    d = torch.ones(3, 2, 3)
    fake = type("Mesh", (), {"size": lambda self: 2})()
    with trace.trace_rows_sharded(fake):
        with pytest.raises(ValueError, match="do not divide"):
            trace.trace_closest(scene, o, d)
    with trace.trace_rows_sharded(world1):
        with pytest.raises(ValueError, match="forward"):
            trace.trace_surface(scene, o, d.requires_grad_())
        hit = trace.trace_closest(scene, o, d.detach())
        grad_scene = scene.replace(geometry=dataclasses.replace(
            scene.geometry, positions=scene.geometry.positions.clone().requires_grad_()))
        with pytest.raises(ValueError, match="forward"):
            trace.trace_closest(grad_scene, o, d.detach())
    assert hit.tri.shape == (3, 2)


def test_probe_kernel_is_off_under_a_mesh(world1, monkeypatch):
    monkeypatch.setenv("STROLLE_PROBE_KERNEL", "1")
    assert _probe_kernel_enabled(None)
    with trace.trace_rows_sharded(world1):
        assert not _probe_kernel_enabled(None)
    assert _probe_kernel_enabled(None)


def test_initialize_without_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False
    assert pdist.initialize() is False
    assert not dist.is_initialized()


def test_make_mesh_and_entry_points(world1):
    """make_mesh refuses a size other than the world's; the port's
    entry() is the main path's call; dryrun_multichip(1) runs."""
    from strolle_tpu_torch import entry

    with pytest.raises(ValueError, match="1 ranks"):
        sharding.make_mesh(2, device="cpu")
    assert world1.mesh_dim_names == (sharding.AXIS,) and world1.size() == 1
    fn, (scene, cam, seed) = entry.entry(device="cpu")
    assert (cam.width, cam.height, seed) == (256, 256, 1)
    small = cornell_camera(8, 8, device="cpu")
    assert torch.equal(fn(scene, small, seed),
                       trace_sample(scene, small, 1, depth=3, include_sky=False))
    entry.dryrun_multichip(1, device="cpu")


def _spawn(code: str, world: int, tmp_path) -> list:
    """``world`` ranks of ``code`` as plain subprocesses (argv: rank,
    world, store, output); every child killed after CHILD_TIMEOUT s."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), store,
                               str(tmp_path / f"rank{r}.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    return procs


def _wait(procs, tmp_path) -> dict:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n{err[-3000:]}"
    return torch.load(tmp_path / "rank0.pt", weights_only=False)


_CHILD_PRELUDE = """
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
"""

_FOUR_RANKS = _CHILD_PRELUDE + """
from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.models.train import params_from_scene, train_step_sharded
from strolle_tpu_torch.parallel import distributed as pd, frame_sharding as fs, sharding
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera

res = {}
mesh = pd.make_host_chip_mesh(n_hosts=2, device="cpu")
res["shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
H, W = 8, 4
local = torch.arange(H // world * W, dtype=torch.float32).reshape(H // world, W) + rank * 1000.0
rows = pd.host_local_rows(mesh, local)
res["rows_shape"] = tuple(rows.shape)
res["rows"] = rows.full_tensor()
res["total"] = float(rows.sum().full_tensor())
scene = scene_with_bvh(cornell_box(device="cpu"))
cam = cornell_camera(32, 32, device="cpu")
res["sample"] = pd.render_sample_hostmesh(mesh, scene, cam, 5, depth=2)
params = params_from_scene(scene)
target = torch.full((32, 32, 3), 0.1)
res["hostmesh_step"] = pd.train_step_hostmesh(mesh, params, scene, cam, target, 3, depth=1)
flat = sharding.make_mesh(world, device="cpu")
res["sharded_step"] = train_step_sharded(flat, params, scene, cam, target, 3, depth=1)
state = fs.init_state_sharded(flat, cam)
rep = fs.replicate_scene(flat, scene)
res["frames"] = []
for f in range(2):
    ch, state = fs.render_frame_sharded(flat, rep, cam, state, f)
    res["frames"].append(ch)
if rank == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""

_TWO_RANKS = _CHILD_PRELUDE + """
from strolle_tpu_torch.parallel.sharding import make_mesh, render_sample_sharded
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera

img = render_sample_sharded(make_mesh(2, device="cpu"), cornell_box(device="cpu"),
                            cornell_camera(16, 21, device="cpu"), 9, depth=1)
if rank == 0:
    torch.save(img, out)
dist.destroy_process_group()
"""


def test_four_gloo_ranks(tmp_path):
    """Four spawned ranks against the port's one-rank results:
    - make_host_chip_mesh(n_hosts=2) is {"host": 2, "chip": 2}; the
      DTensor of each rank's block of rows stacks the blocks in rank
      order and sums (the psum) to the blocks' total, exactly;
    - render_sample_hostmesh equals trace_sample exactly (every ray is
      traced alone, whatever rank holds it);
    - train_step_hostmesh and train_step_sharded against train_step
      (which tests/test_torch_train.py holds against jax.vjp): loss at
      rtol 1e-5, gradients at rtol 1e-4, atol 1e-6 (the ranks' partial
      sums are added in another order);
    - two render_frame_sharded frames equal render_frame's, every channel."""
    procs = _spawn(_FOUR_RANKS, 4, tmp_path)
    scene, cam = _cornell(32, 32)
    sample = trace_sample(scene, cam, 5, depth=2, include_sky=False)
    params = train.params_from_scene(scene)
    target = torch.full((32, 32, 3), 0.1)
    loss, _, grads = train.train_step(params, scene, cam, target, 3, depth=1)
    state = init_state(cam, device="cpu")
    frames = []
    for f in range(2):
        ch, state = render_frame(scene, cam, state, f)
        frames.append(ch)
    res = _wait(procs, tmp_path)

    assert res["shape"] == {"host": 2, "chip": 2}
    assert res["rows_shape"] == (8, 4)
    want = torch.cat([torch.arange(8, dtype=torch.float32).reshape(2, 4) + r * 1000.0
                      for r in range(4)])
    assert torch.equal(res["rows"], want)
    assert res["total"] == float(want.sum())
    assert torch.equal(res["sample"], sample)
    for what in ("hostmesh_step", "sharded_step"):
        loss_m, _, grads_m = res[what]
        np.testing.assert_allclose(loss_m.item(), loss.item(), rtol=1e-5, err_msg=what)
        for f in train.FIELDS:
            np.testing.assert_allclose(getattr(grads_m, f).numpy(), getattr(grads, f).numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{what} {f}")
    for f, (ch, ch_m) in enumerate(zip(frames, res["frames"])):
        for k in ch:
            assert torch.equal(ch[k], ch_m[k]), (f, k)


def test_two_ranks_match_jax_sharded_sample(tmp_path):
    """Cornell at 16 x 21, depth 1, seed 9: the port's sample on two gloo
    ranks (21 rows padded to 22) against the JAX package's
    render_sample_sharded on make_mesh(8) (padded to 24), under
    tests/test_sharding.py's criteria."""
    from strolle_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from strolle_tpu.parallel.sharding import render_sample_sharded as jax_sharded
    from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
    from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera

    procs = _spawn(_TWO_RANKS, 2, tmp_path)
    want = np.asarray(jax_sharded(jax_make_mesh(8), jax_cornell_box(),
                                  jax_cornell_camera(16, 21), jnp.uint32(9), 1, False))
    got = _wait(procs, tmp_path)
    assert got.shape == (21, 16, 3)
    _assert_images_match(want, got.numpy())

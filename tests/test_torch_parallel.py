"""The port's multi-device layer (strolle_tpu_torch/parallel/, the mesh
terms of ops/trace.py, restir/di.py, models/restir.py and
models/train.py, entry.py) on gloo ranks on the CPU.

In-process, on a process group of world size 1: the split sample,
training step and realtime frame equal their unsplit counterparts
exactly, and the row-split frame dispatches exactly the unsplit frame's
ops. Spawned ranks (plain subprocesses that never import JAX, each
killed after CHILD_TIMEOUT seconds): four ranks hold the host x chip
mesh, its DTensor rows, its sample and training step, the 1-D mesh's
training step and two row-split frames to the one-rank results; two
ranks hold the split sample of 21 rows to the JAX package's
``render_sample_sharded`` on its 8-device mesh (22 padded rows against
24), and a whole GI cycle of the row-split frame at 9 rows a rank, on a
scene that compacts its checkerboarded rays, with the sky, to
``render_frame``'s."""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_arrays import CHILD_PRELUDE, blocks_scene, spawn_ranks, wait_ranks

from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.models import train
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
from strolle_tpu_torch.ops import trace
from strolle_tpu_torch.ops.checkerboard import compaction_pays
from strolle_tpu_torch.ops.kernels import stream_kernels, trace_kernels
from strolle_tpu_torch.parallel import distributed as pdist
from strolle_tpu_torch.parallel import frame_sharding, sharding
from strolle_tpu_torch.parallel.rows import RowBlock
from strolle_tpu_torch.restir.di import _probe_kernel_enabled
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.utils.pytree import tree_map

#: The odd-block case: two ranks of 9 rows; a whole 6-frame GI cycle.
ODD_W, ODD_H, ODD_FRAMES, ODD_SEED = 32, 18, 6, 100


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


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_world_of_one_frame_dispatches_the_unsplit_ops(world1, monkeypatch):
    """On a mesh of one rank every gather is the identity: two row-split
    frames (GI sampling, then the GI spatial pass) dispatch exactly the
    aten ops and the trace-kernel calls of two ``render_frame`` frames,
    and gather nothing."""
    calls = collections.Counter()
    for name in ("trace_surface", "trace_anyhit_brute", "trace_closest_brute"):
        fn = getattr(trace_kernels, name)
        monkeypatch.setattr(trace_kernels, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.update([_n]) or _fn(*a, **k))

    def no_gather(tree):
        raise AssertionError("a gather at world size 1")

    monkeypatch.setattr(sharding, "gather_rows", no_gather)
    scene, cam = _cornell(24, 16, bvh=False)
    state = init_state(cam, device="cpu")
    for f in range(2):  # the LUTs, the blue-noise table and the radii on the device
        _, state = render_frame(scene, cam, state, f)
    runs = {}
    for split in (False, True):
        state = (frame_sharding.init_state_sharded(world1, cam) if split
                 else init_state(cam, device="cpu"))
        before, ops = collections.Counter(calls), _Ops()
        with ops:
            for f in range(2):
                if split:
                    _, state = frame_sharding.render_frame_sharded(world1, scene, cam, state, f)
                else:
                    _, state = render_frame(scene, cam, state, f)
        runs[split] = (ops.ops, calls - before)
    assert runs[True] == runs[False]
    assert runs[True][1] == {"trace_surface": 3, "trace_anyhit_brute": 11}


def test_trace_rows_sharded_none_is_a_noop():
    with trace.trace_rows_sharded(None):
        assert trace._TRACE_MESH.get() is None
    assert trace._TRACE_MESH.get() is None


def test_split_refuses_rows_and_gradients(world1):
    """Rows that do not divide over the mesh raise, as shard_map refuses
    them; rays that require grad, or a scene whose hits would carry one,
    raise (the split is forward only); so do the row-split frame's row
    block over a height that does not divide and its frame on a scene
    that requires grad."""
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
    # the row-split frame: a height that does not divide, a scene that
    # requires grad
    with pytest.raises(ValueError, match="not divisible"):
        RowBlock.of(fake, 5)
    cam = cornell_camera(4, 4, device="cpu")
    state = frame_sharding.init_state_sharded(world1, cam)
    with pytest.raises(ValueError, match="forward only"):
        frame_sharding.render_frame_sharded(world1, grad_scene, cam, state, 0)


def test_probe_kernel_is_off_under_a_mesh(world1, monkeypatch):
    """Kernel 7 stays off under a mesh of any size: keyed on the frame's
    row block (what render_frame_sharded passes its stages) and on the
    split trace calls' mesh, as the JAX package keys it on its trace
    mesh; and no row-split frame launches it."""
    monkeypatch.setenv("STROLLE_PROBE_KERNEL", "1")
    assert _probe_kernel_enabled(None)
    assert not _probe_kernel_enabled(None, RowBlock.of(world1, 16))
    with trace.trace_rows_sharded(world1):
        assert not _probe_kernel_enabled(None)
    assert _probe_kernel_enabled(None)
    from strolle_tpu_torch.ops.kernels import probe_kernels

    def no_kernel(*args, **kwargs):
        raise AssertionError("kernel 7 under a mesh")

    monkeypatch.setattr(probe_kernels, "probe_route", no_kernel)
    scene, cam = _cornell(16, 8, bvh=False)
    state = frame_sharding.init_state_sharded(world1, cam)
    for f in range(2):
        _, state = frame_sharding.render_frame_sharded(world1, scene, cam, state, f)


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


_FOUR_RANKS = CHILD_PRELUDE + """
from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.models.train import params_from_scene, train_step_sharded
from strolle_tpu_torch.parallel import distributed as pd, frame_sharding as fs, sharding
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.utils.pytree import tree_map


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


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
res["frames"], res["block_rows"] = [], set()
for f in range(2):
    ch, state = fs.render_frame_sharded(flat, rep, cam, state, f)
    res["block_rows"] |= {x.shape[0] for x in ch.values()}
    res["block_rows"] |= {x.shape[0] for x in leaves([getattr(state, f) for f in fs.ROW_FIELDS])}
    res["frames"].append(fs.gather_frame(ch))
# 5 rows of 30 pixels a rank: blocks that are no whole number of the CPU's
# float32 vectors (see ROADMAP.md, section 3)
cam = cornell_camera(30, 20, device="cpu")
state = fs.init_state_sharded(flat, cam)
res["frames_30x20"] = []
for f in range(2):
    ch, state = fs.render_frame_sharded(flat, rep, cam, state, f)
    res["frames_30x20"].append(fs.gather_frame(ch))
# a whole state given to the row-split frame: refused before any gather
try:
    from strolle_tpu_torch.models.restir import init_state
    fs.render_frame_sharded(flat, rep, cam, init_state(cam, device="cpu"), 0)
    res["whole_state"] = None
except ValueError as e:
    res["whole_state"] = str(e)
if rank == 0:
    torch.save(res, out)
dist.destroy_process_group()
"""

_TWO_RANKS = CHILD_PRELUDE + f"""
from torch_port_arrays import blocks_scene
from strolle_tpu_torch.models.restir import RenderConfig
from strolle_tpu_torch.ops import trace
from strolle_tpu_torch.parallel import frame_sharding as fs, sharding
from strolle_tpu_torch.parallel.sharding import make_mesh, render_sample_sharded
from strolle_tpu_torch.restir import di, gi, primary
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.utils.pytree import tree_map

mesh = make_mesh(2, device="cpu")
res = dict(sample=render_sample_sharded(mesh, cornell_box(device="cpu"),
                                        cornell_camera(16, 21, device="cpu"), 9, depth=1))

# the row-split frames: the rows of every trace call's rays, and the rows
# and calls of every gather; a split trace call would raise
rays, gathers = [], []
for mod in (primary, di, gi):
    for name in ("trace_surface", "trace_anyhit"):
        if hasattr(mod, name):
            fn = getattr(mod, name)
            setattr(mod, name, lambda scene, o, *a, _fn=fn, **k: rays.append(o.shape[0])
                    or _fn(scene, o, *a, **k))
gather_rows = sharding.gather_rows


def counted(tree):
    rows = set()
    tree_map(lambda x: rows.add(x.shape[0]) or x, tree)
    gathers[-1].append(rows)
    return gather_rows(tree)


def refuse(*args):
    raise AssertionError("a split trace call")


sharding.gather_rows = counted
trace._shard_over_rows = refuse
scene, cam = blocks_scene({ODD_W}, {ODD_H})
state = fs.init_state_sharded(mesh, cam)
res["frames"], res["gathers"] = [], []
for f in range({ODD_FRAMES}):
    gathers.append([])
    ch, state = fs.render_frame_sharded(mesh, scene, cam, state, {ODD_SEED} + f,
                                        RenderConfig(include_sky=True))
    res["gathers"].append(gathers.pop())
    res["frames"].append(fs.gather_frame(ch))
state_rows = []
tree_map(lambda x: state_rows.append(x.shape[0]) or x, [getattr(state, f) for f in fs.ROW_FIELDS])
res["block_rows"] = {{x.shape[0] for x in ch.values()}} | set(state_rows)
res["state"] = fs.gather_frame(state)
res["rays"] = rays
if rank == 0:
    torch.save(res, out)
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
    - two render_frame_sharded frames on the row-split state (8 rows a
      rank in every channel and state leaf), gathered, equal
      render_frame's, every channel; and at 30 x 20 (5 rows of 30 pixels
      a rank) to tests/test_sharding.py's criteria: there torch's CPU
      float32 sqrt and pow round some of a block's pixels apart from the
      whole screen's (ROADMAP.md, section 3); a whole state given to the
      split frame raises, naming init_state_sharded."""
    procs = spawn_ranks(_FOUR_RANKS, 4, tmp_path)
    scene, cam = _cornell(32, 32)
    sample = trace_sample(scene, cam, 5, depth=2, include_sky=False)
    params = train.params_from_scene(scene)
    target = torch.full((32, 32, 3), 0.1)
    loss, _, grads = train.train_step(params, scene, cam, target, 3, depth=1)
    frames, frames_30x20 = [], []
    for c, out in ((cam, frames), (cornell_camera(30, 20, device="cpu"), frames_30x20)):
        state = init_state(c, device="cpu")
        for f in range(2):
            ch, state = render_frame(scene, c, state, f)
            out.append(ch)
    res = wait_ranks(procs, tmp_path)

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
    assert res["block_rows"] == {8}
    for f, (ch, ch_m) in enumerate(zip(frames, res["frames"])):
        for k in ch:
            assert torch.equal(ch[k], ch_m[k]), (f, k)
    for ch, ch_m in zip(frames_30x20, res["frames_30x20"]):
        for k in ch:
            want, got = ch[k].numpy(), ch_m[k].numpy()
            _assert_images_match(want.reshape(20, 30, -1), got.reshape(20, 30, -1))
    assert "init_state_sharded" in (res["whole_state"] or "")


def test_two_ranks_match_jax_sharded_sample(tmp_path):
    """Cornell at 16 x 21, depth 1, seed 9: the port's sample on two gloo
    ranks (21 rows padded to 22) against the JAX package's
    render_sample_sharded on make_mesh(8) (padded to 24), under
    tests/test_sharding.py's criteria. The same two ranks render a whole
    GI cycle of the row-split frame at 9 rows a rank (an odd block, whose
    checkerboard parity flips on rank 1) of ``blocks_scene``: 2,048
    triangle rows with a BVH, so the checkerboarded rays are compacted,
    and the sky on. Gathered, every channel and state leaf equals
    ``render_frame``'s; every trace call took the rank's 9 rows (none
    was split and gathered); each frame gathers what its schedule taps
    (the history, the current surface, DI spatial, GI spatial on odd
    tracing frames, two GI previews, the denoiser's history, and for each
    channel its variance taps and five à-trous passes), each gather of
    the block's 9 rows."""
    from strolle_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from strolle_tpu.parallel.sharding import render_sample_sharded as jax_sharded
    from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
    from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera

    procs = spawn_ranks(_TWO_RANKS, 2, tmp_path)
    want = np.asarray(jax_sharded(jax_make_mesh(8), jax_cornell_box(),
                                  jax_cornell_camera(16, 21), jnp.uint32(9), 1, False))
    scene, cam = blocks_scene(ODD_W, ODD_H)
    cfg = RenderConfig(include_sky=True)
    assert scene.bvh is not None and compaction_pays(scene, ODD_W)
    state = init_state(cam, device="cpu")
    frames = []
    for f in range(ODD_FRAMES):
        ch, state = render_frame(scene, cam, state, ODD_SEED + f, cfg)
        frames.append(ch)
    res = wait_ranks(procs, tmp_path)
    got = res["sample"]
    assert got.shape == (21, 16, 3)
    _assert_images_match(want, got.numpy())

    rows = ODD_H // 2
    assert res["block_rows"] == {rows} and set(res["rays"]) == {rows}
    odd_tracing = [f % 6 < 4 and f % 2 == 1 for f in range(ODD_FRAMES)]
    assert [len(g) for g in res["gathers"]] == [18 + o for o in odd_tracing]
    assert all(r == {rows} for g in res["gathers"] for r in g)
    for f, (ch, ch_m) in enumerate(zip(frames, res["frames"])):
        for k in ch:
            assert torch.equal(ch[k], ch_m[k]), (f, k)
    for a, b in zip(_leaves([getattr(state, f) for f in frame_sharding.ROW_FIELDS]),
                    _leaves([getattr(res["state"], f) for f in frame_sharding.ROW_FIELDS]),
                    strict=True):
        assert torch.equal(a, b)
    assert res["state"].frame == state.frame == ODD_FRAMES

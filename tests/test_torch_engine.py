"""The port's dynamic-scene engine (scene/dynamics.py) and the native
and builder helpers under it, against the JAX package.

One edit script runs on both packages' ``SceneEditor``s: meshes,
materials with slot reuse, soup and mesh instances, lights and a dynamic
atlas image; then a transform-only move (refit), sixteen moves in a row
(the streak's rebuild after 15 refits), an in-place
edit of the dynamic image, a light removal (kill/remap), a mesh swap
(rebuild) and an instance whose mesh arrives a tick later. Both editors
keep host numpy records and compile the same C++ builder, so after
every tick every array of the two Scenes is compared for exact equality:
geometry, BVH nodes and order, lights with their previous copies and
markers, Motion, materials, atlas and the editors' stats. One
exception: the sun's position (slot 0 of ``pos`` and ``prev_pos``) is
1000 x its direction, whose cos and sin come from XLA:CPU on one side
and PyTorch on the other, and is held to 1 ulp. The sun stays below the
altitude at which the editors build sky LUTs.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_arrays import np_tree

from strolle_tpu import native as jnative
from strolle_tpu.bvh import builder as jbuilder
from strolle_tpu.scene import dynamics as jdyn
from strolle_tpu.scene.types import Motion as JMotion
from strolle_tpu.scene.types import commit_lights as jcommit_lights
from strolle_tpu.scene.types import make_lights as jmake_lights
from strolle_tpu_torch import native, convert
from strolle_tpu_torch.bvh import builder
from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.scene import dynamics
from strolle_tpu_torch.scene.types import commit_lights, make_lights

_BOX = np.asarray(
    [
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1]], [[-1, -1, -1], [1, 1, -1], [-1, 1, -1]],
        [[-1, -1, 1], [1, 1, 1], [1, -1, 1]], [[-1, -1, 1], [-1, 1, 1], [1, 1, 1]],
        [[-1, -1, -1], [-1, 1, 1], [-1, -1, 1]], [[-1, -1, -1], [-1, 1, -1], [-1, 1, 1]],
        [[1, -1, -1], [1, -1, 1], [1, 1, 1]], [[1, -1, -1], [1, 1, 1], [1, 1, -1]],
        [[-1, -1, -1], [-1, -1, 1], [1, -1, 1]], [[-1, -1, -1], [1, -1, 1], [1, -1, -1]],
        [[-1, 1, -1], [1, 1, 1], [-1, 1, 1]], [[-1, 1, -1], [1, 1, -1], [1, 1, 1]],
    ],
    np.float32,
) * 0.5
_QUAD = np.asarray(
    [[[-1, 0, -1], [1, 0, -1], [1, 0, 1]], [[-1, 0, -1], [1, 0, 1], [-1, 0, 1]]], np.float32
)


def _xf(x, y, z, angle=0.0, scale=1.0):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * scale
    m[:3, 3] = [x, y, z]
    return m


def _soup(n, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-3, 3, (n, 1, 3))
    return (c + rs.uniform(-0.3, 0.3, (n, 3, 3))).astype(np.float32)


def loaded_jax_native():
    """The JAX package's native library, which its editor needs to build
    the same BVH as the port's. That package builds it with ``make`` at
    first use in each test process; a process whose first load met
    another process's half-written build would carry on without it (and
    its editor on the numpy builder), so such a load is tried again once
    the build is whole."""
    for _ in range(120):
        if jnative.available():
            return jnative
        jnative._tried = False
        time.sleep(0.5)
    raise RuntimeError("the JAX package's native library does not load")


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    loaded_jax_native()


class _Both:
    """The same edits on the JAX editor and the port's."""

    def __init__(self, **kw):
        self.eds = (jdyn.SceneEditor(materials=[{}], **kw),
                    dynamics.SceneEditor(materials=[{}], device="cpu", **kw))

    def __getattr__(self, name):
        def call(*a, **kw):
            return [getattr(ed, name)(*a, **kw) for ed in self.eds]
        return call


def _jax_arrays(s) -> dict:
    out = {
        "geometry": np_tree(s.geometry), "materials": np_tree(s.materials),
        "lights": np_tree(s.lights), "bvh": np_tree(s.bvh), "motion": np_tree(s.motion),
        "atlas": None if s.atlas is None else np.asarray(s.atlas.image),
        "clusters": None if s.clusters is None else np.asarray(s.clusters),
    }
    out["lights"]["count"] = int(out["lights"]["count"])
    out["materials"]["tex_channels"] = s.materials.tex_channels
    for k in ("has_alpha", "flat_normals", "has_metal"):
        out[k] = bool(getattr(s, k))
    for k in ("sun_azimuth", "sun_altitude"):  # JAX float32 scalars, the port's floats
        out[k] = np.float32(getattr(s, k))
    return out


def _port_arrays(s) -> dict:
    out = convert.scene_to_arrays(s)
    for k in ("sun_azimuth", "sun_altitude"):
        out[k] = np.float32(out[k])
    return out


def _assert_equal(got, want, path="scene"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.shape, g.dtype.kind) == (w.shape, w.dtype.kind), f"{path}: {g.dtype} {w.dtype}"
        if path.endswith(("lights.pos", "lights.prev_pos")):  # the sun's slot: 1 ulp
            np.testing.assert_array_max_ulp(g[0], w[0], maxulp=1)
            g, w = g[1:], w[1:]
        np.testing.assert_array_equal(g, w, err_msg=path)


def _tick_and_compare(both, what: str):
    jscene, pscene = both.tick()
    jed, ped = both.eds
    _assert_equal(_port_arrays(pscene), _jax_arrays(jscene), what)
    np.testing.assert_array_equal(ped._tri_order, np.asarray(jed._tri_order), err_msg=what)
    assert ped.stats == jed.stats, what
    assert ped.frame == jed.frame
    return jscene, pscene


def test_editor_matches_jax_tick_by_tick():
    """Exact equality of every Scene array after each of 25 ticks."""
    both = _Both(light_capacity=8, atlas_size=64)
    jed, ped = both.eds
    both.insert_mesh("box", _BOX)
    both.insert_mesh("quad", _QUAD)
    both.insert_material("m0", base_color=[0.8, 0.2, 0.2, 1.0], roughness=0.4)
    both.insert_material("m1", base_color=[0.2, 0.8, 0.2, 1.0], metallic=1.0)
    both.remove_material("m0")
    slots = both.insert_material("m2", base_color=[0.2, 0.2, 0.8, 1.0])
    assert slots[0] == slots[1] == 1  # m0's freed slot reused
    image = np.random.RandomState(3).uniform(0, 1, (8, 8, 4)).astype(np.float32)
    both.insert_image("tex", image, dynamic=True)
    both.insert_material("tm", base_color=[1, 1, 1, 1], base_color_image="tex")
    both.insert_instance("floor", _QUAD * 4, material_id=2, transform=_xf(0, -1, 0))
    both.insert_instance("soup", _soup(40, 5), material_id=1)
    for i in range(3):
        both.insert_instance(f"b{i}", mesh="box", material="m1" if i else "tm",
                             transform=_xf(2.0 * i - 2, 0, -3, 0.3 * i))
    for i, pos in enumerate(((0, 2, 0), (2, 2, 1), (-2, 2, -1))):
        both.insert_light(f"l{i}", pos=pos, color=[1.0, 0.5 + 0.2 * i, 0.3], radius=0.2)
    s0 = _tick_and_compare(both, "tick 0")
    assert s0[1].geometry.num_triangles == 256 and s0[1].bvh.max_depth >= 48
    assert (ped.stats["bvh_rebuilds"], ped.stats["bvh_refits"]) == (1, 0)

    # a transform-only move: the refit path
    both.insert_instance("b0", mesh="box", material="tm", transform=_xf(-2, 0.5, -3, 0.1))
    both.insert_light("l0", pos=(0, 2.5, 0), color=[2.0, 2.0, 2.0])
    _, p1 = _tick_and_compare(both, "refit")
    assert ped.stats["bvh_refits"] == 1
    assert float(p1.motion.prev_of_curr[:, 3].abs().max()) > 0  # b0 moved
    np.testing.assert_array_equal(p1.lights.prev_pos[1].numpy(), [0, 2, 0])

    # sixteen moves in a row: after 15 refits in a row (the one above and
    # 14 here) the 15th move rebuilds and the 16th refits again; the
    # dynamic image changes in place along the way
    for k in range(16):
        both.insert_instance("b1", mesh="box", material="m1",
                             transform=_xf(0.1 * k, 0.05 * k, -3, 0.2 * k))
        if k == 7:
            image *= 0.5
        _tick_and_compare(both, f"streak move {k}")
    assert (ped.stats["bvh_rebuilds"], ped.stats["bvh_refits"]) == (2, 16)

    # a light removal: slot 2 killed, slot 3 remapped to 2, for one frame
    both.remove_light("l1")
    _, pk = _tick_and_compare(both, "light removal")
    assert pk.lights.count == 3 and int(pk.lights.killed[2]) == 1
    assert int(pk.lights.remap[3]) == 2
    _, pn = _tick_and_compare(both, "after the removal")
    assert int(pn.lights.killed.sum()) == 0 and bool((pn.lights.remap == -1).all())

    # a mesh swap: a rebuild, not a refit
    both.insert_instance("b2", mesh="quad", material="m1", transform=_xf(2, 0, -3))
    _tick_and_compare(both, "mesh swap")
    assert ped.stats["bvh_rebuilds"] == 3

    # an instance whose mesh arrives a tick later
    both.insert_instance("late", mesh="late_mesh", material="m2", transform=_xf(0, 1, -5))
    _, pp = _tick_and_compare(both, "pending instance")
    both.insert_mesh("late_mesh", _BOX * 2)
    _, pl = _tick_and_compare(both, "mesh arrived")
    assert pl.motion.prev_of_curr.shape[0] == pp.motion.prev_of_curr.shape[0] + 1
    both.update_sun(azimuth=0.4, altitude=-0.5)
    both.remove_image("tex")
    _tick_and_compare(both, "sun moved, image removed")


def test_scene_of_a_tick_survives_later_refits():
    """The refit rewrites the editor's host nodes in place and a dynamic
    image rewrites its atlas: a Scene already handed out keeps its
    values (every tensor of it is a copy)."""
    ed = dynamics.SceneEditor(device="cpu", atlas_size=32)
    image = np.ones((4, 4, 4), np.float32)
    ed.insert_image("tex", image, dynamic=True)
    ed.insert_material("m", base_color_image="tex")
    ed.insert_mesh("box", _BOX)
    ed.insert_instance("floor", _QUAD)
    ed.insert_instance("b", mesh="box", material="m", transform=_xf(0, 0, -3))
    ed.tick()
    ed.insert_instance("b", mesh="box", material="m", transform=_xf(0.5, 0, -3))
    s1 = ed.tick()
    kept = {k: v.clone() for k, v in (
        ("cmin", s1.bvh.child_min), ("cmax", s1.bvh.child_max),
        ("pos", s1.geometry.positions), ("atlas", s1.atlas.image))}
    ed.insert_instance("b", mesh="box", material="m", transform=_xf(3.0, 1.0, -6))
    image *= 0.25
    s2 = ed.tick()
    assert ed.stats["bvh_refits"] == 2
    assert not torch.equal(s2.bvh.child_min, kept["cmin"])
    assert not torch.equal(s2.atlas.image, kept["atlas"])
    for k, v in (("cmin", s1.bvh.child_min), ("cmax", s1.bvh.child_max),
                 ("pos", s1.geometry.positions), ("atlas", s1.atlas.image)):
        assert torch.equal(v, kept[k]), k


def test_editor_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dynamics.SceneEditor()


def test_prev_of_curr_affine_matches_jax():
    rs = np.random.RandomState(2)
    cases = [(None, None), (_xf(0, 0, 0), _xf(1, 2, 3)), (None, _xf(0, 1, 0, 0.5, 2.0)),
             (_xf(1, 1, 1, 0.2), None), (_xf(1, 1, 1, 0.2), _xf(1, 1, 1, 0.2))]
    cases.append((_xf(*rs.normal(size=3), 1.1, 0.7), _xf(*rs.normal(size=3), -0.4, 1.3)))
    for prev, curr in cases:
        np.testing.assert_array_equal(dynamics._prev_of_curr_affine(prev, curr),
                                      jdyn._prev_of_curr_affine(prev, curr))


def test_transform_triangles_matches_jax():
    rs = np.random.RandomState(1)
    p = rs.uniform(-1, 1, (64, 3, 3)).astype(np.float32)
    n = rs.normal(size=(64, 3, 3)).astype(np.float32)
    for m in (_xf(1, -2, 3, 0.7, 2.0), _xf(0, 0, 0)):
        m[:3, :3] = m[:3, :3] @ np.diag([1.0, 0.5, 1.5]).astype(np.float32)
        for got, want in zip(native.transform_triangles(p, n, m),
                             jnative.transform_triangles(p, n, m)):
            np.testing.assert_array_equal(got, want)


def test_bvh_refit_and_incremental_build_match_jax():
    """The incremental builder after a partial change (a static cluster,
    a small far one that moves): the same tree and reuse count."""
    rs = np.random.RandomState(11)
    stat = (rs.uniform(-2, 2, (600, 1, 3)) + rs.uniform(-0.2, 0.2, (600, 3, 3))).astype(np.float32)
    dyn = [(rs.uniform(-0.5, 0.5, (24, 3, 3)) + [20, y, 0]).astype(np.float32) for y in (0, 3)]
    ours, theirs = native.BvhContext(), jnative.BvhContext()
    for d in dyn:
        moved = np.concatenate([stat, d])
        got, want = ours.build(moved), theirs.build(moved)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert ours.last_reused == theirs.last_reused
    assert ours.last_reused > 0
    pos = _soup(300, 4)
    cmin, cmax, child, count, order, _ = native.bvh_build(pos)
    jmin, jmax = cmin.copy(), cmax.copy()
    moved = pos[order] * 1.1 + np.float32([0.3, -1.0, 0.7])
    native.bvh_refit(moved, cmin, cmax, child, count)
    assert jnative.bvh_refit(moved, jmin, jmax, child, count)
    np.testing.assert_array_equal(cmin, jmin)
    np.testing.assert_array_equal(cmax, jmax)


def test_range_allocator_matches_jax():
    ours, theirs = native.RangeAllocator(), jnative.RangeAllocator()
    ops = [("take", 1), ("give", 0, 100), ("take", 30), ("take", 30), ("give", 0, 30),
           ("take", 10), ("take", 50), ("give", 30, 30), ("take", 50), ("take", 5)]
    for op, *args in ops:
        assert getattr(ours, op)(*args) == getattr(theirs, op)(*args), (op, args)
    assert ours.num_free_ranges() == theirs.num_free_ranges()


def test_atlas_dealloc_frees_the_rect():
    at = native.AtlasAllocator(64, 64)
    assert at.alloc(64, 64) == (0, 0)
    assert at.alloc(8, 8) is None
    at.dealloc(0, 0, 64, 64)
    assert at.alloc(32, 32) == (0, 0)
    at.close()


@pytest.mark.parametrize("n", [1, 37, 300])
def test_numpy_builder_sah_and_pad_match_jax(n):
    pos = _soup(n, 9)
    arrays, order = builder.build_bvh_numpy(pos, "cpu")
    jarrays, jorder = jbuilder.build_bvh_numpy(pos)
    np.testing.assert_array_equal(order, jorder)
    for f in ("child_min", "child_max", "child", "child_count"):
        np.testing.assert_array_equal(getattr(arrays, f).numpy(), np.asarray(getattr(jarrays, f)))
    assert arrays.max_depth == jarrays.max_depth
    assert builder.sah_cost(arrays) == jbuilder.sah_cost(jarrays)
    native_arrays, _ = builder.build_bvh(pos, "cpu")
    # the SAH quality of the native build against the numpy oracle
    assert builder.sah_cost(native_arrays) <= 1.25 * builder.sah_cost(arrays) + 1e-6
    cap = dynamics._bucket(arrays.num_nodes)
    padded, jpadded = builder.pad_nodes(arrays, cap), jbuilder.pad_nodes(jarrays, cap)
    for f in ("child_min", "child_max", "child", "child_count"):
        np.testing.assert_array_equal(getattr(padded, f).numpy(), np.asarray(getattr(jpadded, f)))
    assert padded.num_nodes == cap


def test_scene_with_bvh_reorders_motion():
    """scene_with_bvh permutes Motion.instance_id with the triangles, as
    the JAX package's does."""
    from strolle_tpu.bvh import scene_with_bvh as jscene_with_bvh
    from strolle_tpu.scene.cornell import cornell_box as jcornell

    js = jcornell()
    t = js.geometry.num_triangles
    iid = np.arange(t, dtype=np.int32) % 5
    mats = np.tile(np.eye(3, 4, dtype=np.float32).reshape(12), (5, 1))
    js = js.replace(motion=JMotion(instance_id=jnp.asarray(iid), prev_of_curr=jnp.asarray(mats)))
    from torch_port_arrays import scene_arrays

    arrays = scene_arrays(js)
    arrays["motion"] = np_tree(js.motion)
    ps = scene_with_bvh(convert.scene_from_arrays(arrays, device="cpu"))
    jb = jscene_with_bvh(js)
    np.testing.assert_array_equal(ps.motion.instance_id.numpy(), np.asarray(jb.motion.instance_id))
    np.testing.assert_array_equal(ps.geometry.positions.numpy(), np.asarray(jb.geometry.positions))
    back = convert.scene_to_arrays(ps)["motion"]
    np.testing.assert_array_equal(back["prev_of_curr"], mats)


def test_commit_lights_matches_jax():
    recs = [{"pos": [0, 1, 0], "color": [1, 2, 3]}, {"pos": [2, 1, 0], "radius": 0.3}]
    ours = commit_lights(dataclasses.replace(make_lights(recs, 4, device="cpu"),
                                             killed=torch.ones(4, dtype=torch.int32)))
    theirs = jcommit_lights(jmake_lights(recs, 4).replace(killed=jnp.ones(4, jnp.int32)))
    assert int(ours.killed.sum()) == 0
    for f in dataclasses.fields(ours):
        if f.name != "count":
            np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                          np.asarray(getattr(theirs, f.name)), err_msg=f.name)

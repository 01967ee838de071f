"""Per-instance motion and the light kill/remap markers of editor scenes,
the port against the JAX package.

The scenes come from both packages' ``SceneEditor``s under the same edits
(their arrays are equal, tests/test_torch_engine.py). The JAX functions
run eagerly on the tensor route (``use_pallas=False``, trace_closest +
surface_at); so does the port's. Eager JAX fuses no multiply-add, so the
velocity (the hit point through its instance's 3x4 affine, then the
previous camera's projection) rounds alike on both sides.

Tolerances: float outputs within 1e-4 + 1e-3 relative; integer and mask
outputs (triangle ids, hit masks, validity bits, light ids) equal on at
least 99% of pixels (a last-bit difference can move a rounded tap or flip
a reservoir's acceptance). The confidence assertions of
tests/test_motion.py hold for the port's own outputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_engine import loaded_jax_native
from torch_port_arrays import np_tree

from strolle_tpu.camera import make_camera as jmake_camera
from strolle_tpu.restir import di as jdi
from strolle_tpu.restir.primary import build_reprojection_map as jreproj_map
from strolle_tpu.restir.primary import primary_pass as jprimary
from strolle_tpu.restir.reservoir import DiReservoirs as JDi
from strolle_tpu.scene.dynamics import SceneEditor as JEditor
from strolle_tpu_torch import convert
from strolle_tpu_torch.camera import world_to_screen_xy
from strolle_tpu_torch.ops.hit import Surface
from strolle_tpu_torch.restir import di as tdi
from strolle_tpu_torch.restir.primary import Reprojection, build_reprojection_map, primary_pass
from strolle_tpu_torch.restir.reservoir import DiReservoirs
from strolle_tpu_torch.scene.dynamics import SceneEditor
from strolle_tpu_torch.scene.types import commit_lights

ATOL, RTOL = 1e-4, 1e-3
MIN_AGREE = 0.99


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    loaded_jax_native()

_QUAD = np.asarray(
    [[[-1, -1, 0], [1, -1, 0], [1, 1, 0]], [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float32
)


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _quad_scenes(xform0, xform1):
    """(JAX, port) editor scenes of tick 0 and 1 of a quad moved from
    ``xform0`` to ``xform1``."""
    out = []
    for ed in (JEditor(), SceneEditor(device="cpu")):
        ed.insert_mesh("quad", _QUAD)
        ed.insert_material("m", base_color=[1.0, 1.0, 1.0, 1.0])
        ed.insert_instance("q", mesh="quad", material="m", transform=xform0)
        s0 = ed.tick()
        ed.insert_instance("q", mesh="quad", material="m", transform=xform1)
        out.append((s0, ed.tick()))
    return out


def _cameras(size=32, eye=(0, 0, 0), target=(0, 0, -1)):
    jcam = jmake_camera(eye, target, width=size, height=size)
    return jcam, convert.camera_from_arrays(np_tree(jcam), "cpu")


def _agree(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        ok = got.astype(np.int64) == want.astype(np.int64)
    else:
        ok = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
        ok |= np.isnan(got) & np.isnan(want)
    return float(ok.reshape(ok.shape[0], ok.shape[1], -1).all(-1).mean())


def _assert_close(got, want, what):
    """Every field of a dataclass (or tuple) agrees on MIN_AGREE of pixels."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_close(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{what}[{i}]")
    else:
        agree = _agree(got.numpy(), want)
        assert agree >= MIN_AGREE, f"{what}: {agree:.4f} of pixels agree"


def test_moving_instance_velocity_matches_jax():
    dx = 0.4
    (_, j1), (_, p1) = _quad_scenes(_translate(0, 0, -3), _translate(dx, 0, -3))
    jcam, cam = _cameras()
    jsurf, jvel = jprimary(j1, jcam, jcam, use_pallas=False)
    surf, vel = primary_pass(p1, cam, cam, use_pallas=False)
    _assert_close(surf, jsurf, "surface")
    _assert_close(vel, jvel, "velocity")

    # test_motion.py's check on the port: the centre pixel's velocity is
    # the screen displacement of the hit point moved back by dx
    cy, cx = 16, 16
    assert bool(surf.is_some[cy, cx])
    p = surf.point[cy, cx]
    sx_now, _ = world_to_screen_xy(cam, p)
    sx_prev, _ = world_to_screen_xy(cam, p - p.new_tensor([dx, 0, 0]))
    expected = float(sx_now - sx_prev)
    assert expected > 0.5
    assert abs(float(vel[0][cy, cx]) - expected) < 0.1
    assert abs(float(vel[1][cy, cx])) < 0.1
    # camera-only velocity (motion stripped) is zero
    _, (vx2, _) = primary_pass(p1.replace(motion=None), cam, cam, use_pallas=False)
    assert abs(float(vx2[cy, cx])) < 1e-3


def test_moving_tilted_quad_keeps_confidence_as_jax():
    xform0 = _translate(0, 0, -4) @ _rot_y(np.radians(45.0))
    xform1 = _translate(0.5, 0, -4) @ _rot_y(np.radians(45.0))
    (j0, j1), (p0, p1) = _quad_scenes(xform0, xform1)
    jcam, cam = _cameras()
    jprev, _ = jprimary(j0, jcam, jcam, use_pallas=False)
    jsurf, jvel = jprimary(j1, jcam, jcam, use_pallas=False)
    jrep = jreproj_map(jcam, jsurf, jprev, jvel)

    prev_surf, _ = primary_pass(p0, cam, cam, use_pallas=False)
    surf, vel = primary_pass(p1, cam, cam, use_pallas=False)
    reproj = build_reprojection_map(cam, surf, prev_surf, vel)
    _assert_close(reproj, jrep, "reprojection")
    # the same map from the JAX surfaces and velocity: the rounding of the
    # taps alone
    same_in = build_reprojection_map(
        cam, convert.dataclass_from_arrays(Surface, np_tree(jsurf), "cpu"),
        convert.dataclass_from_arrays(Surface, np_tree(jprev), "cpu"),
        tuple(convert.tensor_from_array(v, "cpu") for v in jvel))
    _assert_close(same_in, jrep, "reprojection from the JAX inputs")

    surf_n, vel_n = primary_pass(p1.replace(motion=None), cam, cam, use_pallas=False)
    reproj_n = build_reprojection_map(cam, surf_n, prev_surf, vel_n)
    on = (surf.is_some & prev_surf.is_some).numpy()
    conf = reproj.confidence.numpy()[on]
    conf_n = reproj_n.confidence.numpy()[on]
    assert conf.mean() > 0.8, conf.mean()
    assert conf.mean() > conf_n.mean() + 0.3, (conf.mean(), conf_n.mean())


def _reservoirs(shape, ids, light_pos, seed):
    """Seeded DI reservoirs over light slots ``ids`` as numpy fields."""
    rs = np.random.RandomState(seed)
    light_id = rs.choice(ids, shape).astype(np.int32)
    return {
        "m": np.where(rs.uniform(size=shape) < 0.15, 0.0,
                      rs.randint(1, 20, shape)).astype(np.float32),
        "w": rs.uniform(0.1, 2.0, shape).astype(np.float32),
        "pdf": rs.uniform(0.1, 3.0, shape).astype(np.float32),
        "confidence": rs.uniform(0.0, 1.0, shape).astype(np.float32),
        "light_id": light_id,
        "light_point": (light_pos[light_id] + rs.normal(0, 0.05, shape + (3,))).astype(np.float32),
        "is_occluded": rs.uniform(size=shape) < 0.2,
    }


def test_di_temporal_kill_remap_matches_jax():
    """DI temporal on an editor scene whose removed light sets the
    markers: slot 2 killed, slot 3's history remapped to slot 2."""
    scenes = []
    for ed in (JEditor(light_capacity=8), SceneEditor(light_capacity=8, device="cpu")):
        ed.insert_instance("floor", _QUAD[:, :, [0, 2, 1]] * 3)
        for i, x in enumerate((-1.5, 0.0, 1.5)):
            ed.insert_light(f"l{i}", pos=[x, 1.5, 0.5], color=[4.0, 4.0, 4.0], radius=0.2)
        s0 = ed.tick()
        ed.remove_light("l1")
        scenes.append((s0, ed.tick()))
    (j0, j1), (_, p1) = scenes
    assert int(p1.lights.killed[2]) == 1 and int(p1.lights.remap[3]) == 2

    size = 16
    jcam, cam = _cameras(size, eye=(0.0, 2.5, 3.0), target=(0.0, 0.0, 0.0))
    jprev, _ = jprimary(j0, jcam, jcam, use_pallas=False)
    jsurf, jvel = jprimary(j1, jcam, jcam, use_pallas=False)
    jrep = jreproj_map(jcam, jsurf, jprev, jvel)
    shape = (size, size)
    lp = np.asarray(j0.lights.pos)
    curr = _reservoirs(shape, [1, 2], np.asarray(j1.lights.pos), seed=1)
    prev = _reservoirs(shape, [1, 2, 3], lp, seed=2)
    jout = jdi.di_temporal(j1, jcam, jsurf, jprev, jrep,
                           JDi(**{k: jnp.asarray(v) for k, v in curr.items()}),
                           JDi(**{k: jnp.asarray(v) for k, v in prev.items()}), 12345)

    def port(cls, x):
        return convert.dataclass_from_arrays(cls, np_tree(x) if not isinstance(x, dict) else x,
                                             "cpu")

    args = (cam, port(Surface, jsurf), port(Surface, jprev), port(Reprojection, jrep),
            port(DiReservoirs, curr), port(DiReservoirs, prev), 12345)
    out = tdi.di_temporal(p1, *args)
    _assert_close(out, jout, "di_temporal")
    # the markers acted: history of slot 3 was there, none keeps slot 3,
    # and the merge without the markers differs
    has = jrep.confidence > 0
    assert int(((prev["light_id"] == 3) & np.asarray(has)).sum()) > 0
    assert int((out.light_id == 3).sum()) == 0
    plain = tdi.di_temporal(p1.replace(lights=commit_lights(p1.lights)), *args)
    assert bool((plain.light_id != out.light_id).any() | (plain.w != out.w).any())

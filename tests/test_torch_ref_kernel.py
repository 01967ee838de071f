"""Kernel C (the reference-mode megakernel): the port's packers and its
plain version against the JAX package's Pallas megakernel run in
interpret mode: default Cornell (flat, no metal), the metallic tall box
(flat, metal), and a perturbed-normals Cornell (flat=False) lit by a
spot light and a finite-range light."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.camera import pixel_rays as jax_pixel_rays
from strolle_tpu.camera import screen_grid as jax_screen_grid
from strolle_tpu.models.reference import _sample_pixels_megakernel
from strolle_tpu.ops import rng as jax_rng
from strolle_tpu.ops.pallas import ref_kernel as jax_ref_kernel
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu.scene.types import LIGHT_SPOT
from strolle_tpu.scene.types import compute_static_flags as jax_static_flags
from strolle_tpu.scene.types import make_lights as jax_make_lights
from strolle_tpu_torch import convert
from strolle_tpu_torch.camera import pixel_rays, screen_grid
from strolle_tpu_torch.models.reference import _sample_pixels_megakernel as port_megakernel
from strolle_tpu_torch.ops import rng
from strolle_tpu_torch.ops.kernels import ref_kernel
from strolle_tpu_torch.scene.cornell import cornell_box
from torch_port_arrays import tt

W, H = 32, 24


def _fields(obj) -> dict:
    return {
        f.name: getattr(obj, f.name)
        if f.name == "tex_channels"
        else np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
    }


def _port_scene(jscene):
    return convert.scene_from_arrays(
        {
            "geometry": _fields(jscene.geometry),
            "materials": _fields(jscene.materials),
            "lights": _fields(jscene.lights),
            "atlas": None,
            "sun_azimuth": np.asarray(jscene.sun_azimuth),
            "sun_altitude": np.asarray(jscene.sun_altitude),
            "has_alpha": jscene.has_alpha,
            "flat_normals": jscene.flat_normals,
            "has_metal": jscene.has_metal,
        },
        device="cpu",
    )


def _perturbed_with_spot_lights():
    """Cornell with jittered unit vertex normals (flat=False), a spot
    light and a finite-range point light."""
    jscene = jax_cornell_box()
    rs = np.random.RandomState(4)
    n = np.asarray(jscene.geometry.normals)
    n = n + rs.normal(0.0, 0.08, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    geom = jscene.geometry.replace(normals=n.astype(np.float32))
    lights = jax_make_lights(
        [
            # downward spot under the ceiling; finite-range point light
            # over the short box (both outside the boxes, so they light)
            {"pos": [0.0, 1.8, 0.1], "radius": 0.03, "color": [4.0, 3.5, 3.0],
             "kind": LIGHT_SPOT, "spot_dir": [0.2, -1.0, 0.0], "spot_angle": 0.7,
             "range": np.inf},
            {"pos": [0.4, 1.0, 0.4], "radius": 0.02, "color": [2.0, 2.0, 2.5],
             "range": 1.2},
        ],
        capacity=4,
    )
    flags = jax_static_flags(geom, jscene.materials)
    return jscene.replace(geometry=geom, lights=lights, **flags)


VARIANTS = {
    # name: (scene factory, depth); each is one interpret-mode JAX call
    "cornell": (lambda: jax_cornell_box(), 2),  # flat, no_metal
    # (the fourth variant, smooth + metal, is held against its plain
    # version on the card by chip_smoke.py)
    "metallic": (lambda: jax_cornell_box(metallic_tall_box=True), 1),  # flat, metal
    "perturbed_spot": (lambda: _perturbed_with_spot_lights(), 1),  # smooth, no_metal
}


def test_packers_match_jax():
    for make, _ in VARIANTS.values():
        jscene = make()
        scene = _port_scene(jscene)
        for port_fn, jax_fn, arg in (
            (ref_kernel.pack_geometry_bw, jax_ref_kernel.pack_geometry_bw, "geometry"),
            (ref_kernel.pack_materials, jax_ref_kernel.pack_materials, "materials"),
            (ref_kernel.pack_lights, jax_ref_kernel.pack_lights, "lights"),
        ):
            want = np.asarray(jax_fn(getattr(jscene, arg)))
            got = port_fn(getattr(scene, arg)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=arg)


def test_bw_test_rounds_as_jitted_jax():
    """The plain version's Baldwin-Weber test against the JAX kernel's
    ``_bw_isect`` jitted on the CPU, where XLA fuses its multiply-adds:
    Cornell's rows and seeded random triangles (packed by the port's
    packer, which matches the JAX package's bit for bit) against 100,000
    seeded rays from inside the box, all pairs."""
    rs = np.random.RandomState(5)
    soup = rs.uniform(-1.0, 1.0, (16, 3, 3)).astype(np.float32) + np.float32([0.0, 1.0, 0.0])
    geom = types.SimpleNamespace(positions=tt(soup), normals=tt(np.zeros_like(soup)),
                                 material_id=torch.zeros(16, dtype=torch.int32))
    rows = torch.cat([ref_kernel.pack_geometry_bw(g)
                      for g in (cornell_box(device="cpu").geometry, geom)]).numpy()
    n = 100_000
    o = rs.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [x[:, None] for x in (*o.T, *d.T)]  # six [R, 1] components

    # rows as [12, 1, C] columns: every output [R, C]
    want = jax.jit(jax_ref_kernel._bw_isect)(rows[:, :12].T[:, None, :], *rays)
    got = ref_kernel._bw_block(tt(rows), *map(tt, rays))
    # t, u, v, nd and the hit mask bit for bit; allow 1e-5 of the pairs
    # for the float64 emulation of fma (double rounding lands within
    # 2^-29 of a float32 midpoint)
    bits = [np.asarray(x).view(np.int32) for x in want]
    differ = np.zeros(bits[0].shape, bool)
    for w, g in zip(bits, got):  # t, u, v, nd
        differ |= g.numpy().view(np.int32) != w
    hit = np.isfinite(np.asarray(want[0]))
    differ |= torch.isfinite(got[0]).numpy() != hit
    assert differ.mean() <= 1e-5, differ.mean()
    assert 0.01 < hit.mean() < 0.5, hit.mean()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_megakernel_matches_pallas_interpret(variant):
    make, depth = VARIANTS[variant]
    jscene = make()
    scene = _port_scene(jscene)
    flags = (scene.flat_normals, scene.has_metal)
    assert flags == {
        "cornell": (True, False),
        "metallic": (True, True),
        "perturbed_spot": (False, False),
    }[variant]

    jcam = jax_cornell_camera(W, H)
    jgrid = jax_screen_grid(jcam)
    jo, jd = jax_pixel_rays(jcam, jgrid)
    seed = 11
    jstate = jax_rng.wnoise_new(jnp.uint32(seed), jgrid[..., 0], jgrid[..., 1])
    want = np.asarray(_sample_pixels_megakernel(jscene, jo, jd, jstate, depth, interpret=True))

    cam = convert.camera_from_arrays(
        {f.name: getattr(jcam, f.name) for f in dataclasses.fields(jcam)}, device="cpu"
    )
    grid = screen_grid(cam)
    o, d = pixel_rays(cam, grid)
    state = rng.wnoise_new(seed, grid[..., 0], grid[..., 1])
    got = port_megakernel(scene, o, d, state, depth).numpy()

    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert want.mean() > 0.01
    # Same PCG stream, same Baldwin-Weber math: pixels match sample for
    # sample except where float32 rounding (XLA:CPU fuses multiply-adds,
    # PyTorch does not) flips a binary visibility or edge decision — the
    # tolerance of the JAX package's own megakernel-vs-oracle test.
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 2e-3).mean() > 0.99, (diff > 2e-3).mean()
    assert abs(got.mean() - want.mean()) < 5e-3

"""Reference mode end to end: the port's trace_sample on both routes
against the JAX package's staged trace_sample on CPU, and the
accumulation of render_reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)

from strolle_tpu.models.reference import trace_sample as jax_trace_sample
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu_torch.camera import make_camera
from strolle_tpu_torch.models.reference import (
    init_accumulator,
    render_reference,
    trace_sample,
)
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera

W, H, DEPTH, SEED = 32, 24, 2, 11


@pytest.fixture(scope="module")
def jax_staged():
    """One staged (use_pallas=False) JAX sample: the oracle of both routes."""
    out = jax_trace_sample(
        jax_cornell_box(), jax_cornell_camera(W, H), jnp.uint32(SEED),
        depth=DEPTH, include_sky=False, use_pallas=False,
    )
    return np.asarray(out)


@pytest.fixture(scope="module")
def port():
    return cornell_box(device="cpu"), cornell_camera(W, H, device="cpu")


def test_staged_loop_matches_jax_staged(jax_staged, port):
    scene, cam = port
    got = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False, use_megakernel=False)
    got = got.numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    # Same PCG stream, same Möller-Trumbore rounding (multiply-adds fused
    # as XLA:CPU fuses them), so hits match; the shading rounds without
    # fused multiply-adds here, and a rare pixel flips a binary decision
    # (a shadow-ray edge) on those last bits.
    diff = np.abs(got - jax_staged).max(axis=-1)
    assert (diff <= 1e-4).mean() > 0.99, (diff > 1e-4).mean()
    assert abs(got.mean() - jax_staged.mean()) < 2e-3


def test_megakernel_route_matches_jax_staged(jax_staged, port):
    scene, cam = port
    got = trace_sample(scene, cam, SEED, depth=DEPTH, include_sky=False).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    # Baldwin-Weber rounds triangle edges differently from the staged
    # loop's Möller-Trumbore: the JAX package's megakernel tolerance.
    diff = np.abs(got - jax_staged).max(axis=-1)
    assert (diff <= 2e-3).mean() > 0.99, (diff > 2e-3).mean()
    assert abs(got.mean() - jax_staged.mean()) < 5e-3


def test_render_reference_accumulates_and_resets(port):
    scene, cam = port
    acc = init_accumulator(cam)
    samples = []
    for seed in (1, 2, 3):
        img, acc = render_reference(scene, cam, acc, seed, depth=1, include_sky=False)
        samples.append(trace_sample(scene, cam, seed, depth=1, include_sky=False))
    assert (acc.samples == 3).all()
    torch.testing.assert_close(img, sum(samples) / 3, rtol=1e-6, atol=1e-6)

    # a move below the 0.0025 tolerance keeps accumulating ...
    nudged = make_camera(
        eye=[0.0, 1.0, 3.2005], target=[0.0, 1.0, 0.0], fov_y=np.deg2rad(45.0),
        width=W, height=H, device="cpu",
    )
    assert (nudged.projection_view - cam.projection_view).abs().max() <= 0.0025
    _, acc2 = render_reference(scene, nudged, acc, 4, depth=1, include_sky=False)
    assert (acc2.samples == 4).all()

    # ... and a real move resets to the one new sample
    moved = make_camera(
        eye=[0.3, 1.1, 3.0], target=[0.0, 1.0, 0.0], fov_y=np.deg2rad(45.0),
        width=W, height=H, device="cpu",
    )
    img, acc3 = render_reference(scene, moved, acc2, 5, depth=1, include_sky=False)
    assert (acc3.samples == 1).all()
    torch.testing.assert_close(img, trace_sample(scene, moved, 5, depth=1, include_sky=False))
    torch.testing.assert_close(acc3.projection_view, moved.projection_view)

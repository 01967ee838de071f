"""The port's differentiable path against the JAX package's: the
gradient rules (resampling_weight's zero derivative, the à-trous
filter's frozen-weight adjoint, the detached atlas corner table), the
trainable parameters and their carry-over, render_loss's gradients
against jax.grad, and the realtime frame's gradients against the port's
own finite differences (strolle_tpu_torch/models/train.py against
strolle_tpu/models/train.py; tests/test_grad.py and
tests/test_grad_restir.py hold the JAX package the same way)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_arrays  # noqa: F401  (one torch thread per test process)
from torch_port_arrays import np_tree, scene_arrays, tt

from strolle_tpu.denoise.svgf import _wavelet_core as jax_wavelet_core
from strolle_tpu.models import train as jax_train
from strolle_tpu.models.reference import trace_sample as jax_trace_sample
from strolle_tpu.restir.reservoir import resampling_weight as jax_resampling_weight
from strolle_tpu.scene.cornell import cornell_box as jax_cornell_box
from strolle_tpu.scene.cornell import cornell_camera as jax_cornell_camera
from strolle_tpu_torch import convert
from strolle_tpu_torch.denoise import svgf
from strolle_tpu_torch.models import train
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
from strolle_tpu_torch.ops.texture import sample_atlas_bilinear
from strolle_tpu_torch.restir.reservoir import resampling_weight
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.scene.types import make_atlas
from tests.test_grad_restir import _wavelet_fields

# --- the gradient rules ------------------------------------------------------

RW_ARGS = {"w": [2.0, 3.0, 1.0, 0.5], "pdf": [0.5, 0.0, 2.0, 1e-20],
           "norm_num": [1.0, 1.0, 1.0, 2.0], "norm_denom": [1.0, 1.0, 2.0, 1e-10]}


@pytest.mark.parametrize("arg", list(RW_ARGS))
def test_resampling_weight_forward_and_zero_grad(arg):
    """The JAX package's value (0 where the denominator is), and zero
    gradient in each argument, also where pdf * denom is 0 or tiny."""
    args = {k: torch.tensor(v, requires_grad=k == arg) for k, v in RW_ARGS.items()}
    out = resampling_weight(**args)
    want = jax_resampling_weight(*(jnp.asarray(v, jnp.float32) for v in RW_ARGS.values()))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    assert not out.requires_grad
    jgrad = jax.grad(lambda x: jnp.sum(jax_resampling_weight(
        **{k: (x if k == arg else jnp.asarray(v, jnp.float32)) for k, v in RW_ARGS.items()})))(
        jnp.asarray(RW_ARGS[arg], jnp.float32))
    assert (np.asarray(jgrad) == 0.0).all()
    # inside a differentiable expression: d(out * x)/dx flows, d/d arg is 0
    x = args[arg]
    (g,) = torch.autograd.grad((out * x).sum(), x)
    np.testing.assert_array_equal(g.numpy(), out.detach().numpy())


def _port_wavelet_fields(radius: int, dtype=torch.float32):
    """tests/test_grad_restir.py's 16x24 fields as the port's à-trous
    pass takes them (the jitter as integer offsets; none at radius 0)."""
    color, var, depth, normal, skyf, jy, jx = (np.asarray(x) for x in _wavelet_fields())
    jitter = None if radius == 0 else (tt(jy).to(torch.int64), tt(jx).to(torch.int64))
    return (tt(color).to(dtype), tt(var).to(dtype), tt(depth).to(dtype), tt(normal).to(dtype),
            tt(skyf).to(dtype), jitter)


@pytest.mark.parametrize("stride,radius", [(1, 0), (4, 2)])
def test_wavelet_forward_and_vjp_match_jax(stride, radius):
    """The à-trous Function against the JAX package's custom-VJP core
    (``_wavelet_core``): forward colour and variance, and the colour
    cotangent pulled back through the frozen-weight adjoint, on
    tests/test_grad_restir.py's fields and cotangent."""
    jfields = _wavelet_fields()
    statics = (stride, 2.0, radius, (2.5, 0.5))
    color, var, depth, normal, skyf, jitter = _port_wavelet_fields(radius)
    cot = np.random.RandomState(1).randn(*color.shape).astype(np.float32)
    c = color.clone().requires_grad_()
    out_c, out_v = svgf._wavelet(stride, 2.0, (2.5, 0.5), c, var, depth, normal, skyf, jitter)
    (g,) = torch.autograd.grad((out_c * tt(cot)).sum(), c)
    core = jax.jit(jax_wavelet_core, static_argnums=(0, 1, 2, 3))
    want_c, want_v = core(*statics, *jfields)
    np.testing.assert_allclose(out_c.detach().numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_v.detach().numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-6)
    want_g = jax.jit(jax.grad(lambda cc: jnp.sum(core(*statics, cc, *jfields[1:])[0]
                                                 * jnp.asarray(cot))))(jfields[0])
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)
    # the frozen weights: the gradient is not autograd's through them
    c2 = color.clone().requires_grad_()
    free = svgf._wavelet_impl(stride, 2.0, (2.5, 0.5), c2, c2, var, depth, normal, skyf,
                              jitter)[0]
    (g_free,) = torch.autograd.grad((free * tt(cot)).sum(), c2)
    assert (g_free - g).abs().max() > 1e-3


@pytest.mark.parametrize("stride,radius", [(1, 0), (4, 2)])
def test_wavelet_adjoint_gradcheck(stride, radius):
    """In float64: torch.autograd.gradcheck of the frozen-weight filter
    (linear in the colour it filters), and the Function's VJP equal to
    that filter's for the same cotangent; variance, depth, normal and sky
    get no gradient."""
    color, var, depth, normal, skyf, jitter = _port_wavelet_fields(radius, torch.float64)
    sl = (slice(0, 8), slice(0, 10))
    color, var, depth, normal, skyf = (x[sl] for x in (color, var, depth, normal, skyf))
    if jitter is not None:
        jitter = tuple(j[sl] for j in jitter)
    statics = (stride, 2.0, (2.5, 0.5))

    def frozen(cc):
        return svgf._wavelet_impl(*statics, cc, color, var, depth, normal, skyf, jitter)[0]

    c = color.clone().requires_grad_()
    assert torch.autograd.gradcheck(frozen, (c,))
    cot = torch.randn(color.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    inputs = [c, var.clone().requires_grad_(), depth.clone().requires_grad_(),
              normal.clone().requires_grad_()]
    out_c, out_v = svgf._wavelet(stride, 2.0, (2.5, 0.5), inputs[0], *inputs[1:], skyf, jitter)
    grads = torch.autograd.grad((out_c * cot).sum() + out_v.sum(), inputs, allow_unused=True)
    (want,) = torch.autograd.grad((frozen(c) * cot).sum(), c)
    assert torch.equal(grads[0], want)
    assert all(g is None for g in grads[1:])


def test_atlas_corner_table_carries_no_gradient():
    """Atlas sampling differentiates through the bilinear weights (uv)
    only: the corner table is built from the detached image."""
    rs = np.random.RandomState(0)
    image = torch.tensor(rs.rand(8, 8, 4).astype(np.float32), requires_grad=True)
    atlas = make_atlas(image)
    assert not atlas.corners.requires_grad and atlas.corners.dtype == torch.int32
    uv = torch.tensor(rs.uniform(0.1, 0.9, (32, 2)).astype(np.float32), requires_grad=True)
    out = sample_atlas_bilinear(atlas, uv)
    g_uv, g_img = torch.autograd.grad(out.sum(), (uv, image), allow_unused=True)
    assert g_img is None
    assert torch.isfinite(g_uv).all() and g_uv.abs().max() > 0


# --- the trainable parameters ------------------------------------------------


@functools.cache
def _cornell():
    """Cornell in both packages."""
    js = jax_cornell_box()
    return js, convert.scene_from_arrays(scene_arrays(js), device="cpu")


@pytest.mark.parametrize("field", train.FIELDS)
def test_params_from_scene_apply_params_and_converter_match_jax(field):
    """params_from_scene, the converter and apply_params of a perturbed
    field against the JAX package's: the same parameters, and the same
    scene after they are applied."""
    js, scene = _cornell()
    jp = jax_train.params_from_scene(js)
    port = train.params_from_scene(scene)
    carried = convert.params_from_arrays(np_tree(jp), device="cpu")
    for k in train.FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(jp, k)))
        assert torch.equal(getattr(carried, k), getattr(port, k))
    for k, v in convert.params_to_arrays(carried).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jp, k)))
    delta = np.random.RandomState(2).normal(0.0, 0.1, np.shape(getattr(jp, field)))
    new = np.asarray(getattr(jp, field)) + delta.astype(np.float32)
    jscene = jax_train.apply_params(js, jp.replace(**{field: jnp.asarray(new)}))
    pscene = train.apply_params(scene, port.replace(**{field: tt(new)}))
    got, want = convert.scene_to_arrays(pscene), scene_arrays(jscene)
    for part in ("geometry", "materials", "lights"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(np.asarray(got[part][k]), np.asarray(v),
                                          err_msg=f"{part}.{k}")
    assert scene.materials.base_color is port.base_color  # the scene is not changed


# --- render_loss against jax.grad --------------------------------------------

N, DEPTH, TARGET_SEED, SEED = 16, 2, 123, 7


def test_render_loss_grads_match_jax():
    """The staged loop's gradients on Cornell at 16x16, depth 2, against
    one jax.vjp of the JAX package's (its one backward compile here).
    The forward samples agree on all but a rare pixel, whose shading
    rounds otherwise on its last bits and flips a decision
    (tests/test_torch_reference.py). So render_loss's gradients (train_step)
    are held to the JAX package's render_loss gradients within 5% of each
    field's largest component (the finite-difference tolerance of
    tests/test_grad.py), and the gradients of the loss over the pixels
    where both samples agree within 0.1%; position gradients per point of
    the mesh (``_per_vertex``)."""
    js, scene = _cornell()
    jcam = jax_cornell_camera(N, N)
    cam = cornell_camera(N, N, device="cpu")
    sample = jax.jit(jax_trace_sample, static_argnames=("depth", "include_sky"))
    target = sample(js, jcam, jnp.uint32(TARGET_SEED), depth=DEPTH, include_sky=False) * 0.8
    jp = jax_train.params_from_scene(js)

    @jax.jit
    def image_and_vjp(p, ct):
        img, vjp = jax.vjp(lambda q: jax_trace_sample(
            jax_train.apply_params(js, q), jcam, jnp.uint32(SEED), DEPTH, False,
            use_pallas=False), p)
        return img, vjp(ct)[0]

    params = convert.params_from_arrays(np_tree(jp), device="cpu")
    tgt = tt(target)
    loss, new, grads = train.train_step(params, scene, cam, tgt, SEED, depth=DEPTH)
    assert torch.isfinite(loss)
    leaves = [getattr(params, f).clone().requires_grad_() for f in train.FIELDS]
    img = trace_sample(train.apply_params(scene, train.TrainableParams(*leaves)), cam, SEED,
                       DEPTH, False, use_pallas=False)
    jimg, _ = image_and_vjp(jp, jnp.zeros((N, N, 3), jnp.float32))
    jimg = np.asarray(jimg)
    agree = np.abs(img.detach().numpy() - jimg).max(-1) <= 1e-4
    assert agree.mean() > 0.99, agree.mean()
    n = img.numel()
    np.testing.assert_allclose(loss.item(), float(jnp.mean((jimg - target) ** 2)), rtol=0.05)
    _, jgrads = image_and_vjp(jp, 2.0 * (jnp.asarray(jimg) - target) / n)
    ct = 2.0 * (img.detach() - tgt) / n * tt(agree)[..., None]
    masked = torch.autograd.grad(img, leaves, ct)
    _, jmasked = image_and_vjp(jp, jnp.asarray(ct.numpy()))
    for k, g, gm in zip(train.FIELDS, (getattr(grads, f) for f in train.FIELDS), masked):
        g, gm = g.numpy(), gm.numpy()
        want, want_m = np.asarray(getattr(jgrads, k)), np.asarray(getattr(jmasked, k))
        assert np.isfinite(g).all() and np.abs(want).max() > 0, k
        if k == "positions":
            g, gm, want, want_m = (_per_vertex(x) for x in (g, gm, want, want_m))
        np.testing.assert_allclose(g, want, rtol=0, atol=0.05 * np.abs(want).max(), err_msg=k)
        np.testing.assert_allclose(gm, want_m, rtol=0, atol=1e-3 * np.abs(want_m).max(),
                                   err_msg=k)


def _per_vertex(g):
    """Position gradients [T, 3, 3] summed over the corners that share a
    point of Cornell's mesh. A ray that meets a quad on its diagonal hits
    either of its two triangles at the same t (the winner can change with
    the last bit of the bounce's origin), so its gradient reaches the same
    two points through either triangle's corners."""
    pos = np.asarray(jax_cornell_box().geometry.positions).reshape(-1, 3)
    _, vertex = np.unique(pos, axis=0, return_inverse=True)
    out = np.zeros((vertex.max() + 1, 3), np.float64)
    np.add.at(out, vertex.reshape(-1), np.asarray(g).reshape(-1, 3))
    return out


def test_train_step_is_sgd():
    """train_step returns (loss, params - lr * grads, grads), and the
    scene's own tensors stay as they were."""
    _, scene = _cornell()
    cam = cornell_camera(8, 8, device="cpu")
    params = train.params_from_scene(scene)
    before = params.base_color.clone()
    target = torch.full((8, 8, 3), 0.3)
    loss, new, grads = train.train_step(params, scene, cam, target, 3, lr=0.5, depth=1)
    assert loss.ndim == 0 and not loss.requires_grad
    for f in train.FIELDS:
        p, g, q = getattr(params, f), getattr(grads, f), getattr(new, f)
        assert not q.requires_grad and not g.requires_grad
        torch.testing.assert_close(q, p - 0.5 * g, rtol=0, atol=0)
    assert torch.equal(params.base_color, before)
    for f in ("base_color", "light_color"):
        assert getattr(grads, f).abs().max() > 0, f


# --- the realtime frame's gradients against finite differences ---------------


@functools.cache
def _restir_setup():
    """Cornell at 16x16 after 3 differentiable warm-up frames, as
    tests/test_grad_restir.py sets up."""
    scene = cornell_box(device="cpu")
    cam = cornell_camera(N, N, device="cpu")
    state = init_state(cam, device="cpu")
    cfg = RenderConfig(differentiable=True)
    for f in range(3):
        _, state = render_frame(scene, cam, state, f, cfg)
    return scene, cam, state, torch.full((N, N, 3), 0.25)


def _fd(loss_fn, params, index, eps=2e-3):
    def at(step):
        bc = params.base_color.clone()
        bc[index] += step
        return loss_fn(params.replace(base_color=bc)).item()

    return (at(eps) - at(-eps)) / (2 * eps)


@pytest.mark.parametrize("denoise", [False, True], ids=["di", "di_denoised"])
def test_restir_base_color_grads_match_fd(denoise):
    """DI-only realtime frame, without and with SVGF: the base colour's
    gradients against central differences of the port's own loss
    (tests/test_grad_restir.py's cases and tolerance)."""
    scene, cam, state, target = _restir_setup()
    cfg = RenderConfig(differentiable=True, needs_gi=False, denoise=denoise)
    params = train.params_from_scene(scene)
    loss, _, grads = train.restir_train_step(params, scene, cam, state, target, 9, config=cfg)
    assert torch.isfinite(loss)

    def loss_fn(p):
        return train.restir_render_loss(p, scene, cam, state, target, 9, cfg)

    for index in ((0, 0), (0, 2)) if not denoise else ((0, 1),):
        g = grads.base_color[index].item()
        fd = _fd(loss_fn, params, index)
        assert abs(g) > 0
        assert np.isclose(g, fd, rtol=0.05, atol=1e-4), (index, g, fd)


def test_restir_train_step_full_frame():
    """The whole frame (DI + GI + SVGF): finite gradients in every field,
    nonzero for the materials and the light, and params - lr * grads."""
    scene, cam, state, target = _restir_setup()
    params = train.params_from_scene(scene)
    loss, new, grads = train.restir_train_step(params, scene, cam, state, target, 9, lr=0.1)
    assert torch.isfinite(loss)
    for f in train.FIELDS:
        g = getattr(grads, f)
        assert torch.isfinite(g).all(), f
        torch.testing.assert_close(getattr(new, f), getattr(params, f) - 0.1 * g, rtol=0, atol=0)
    for f in ("base_color", "emissive", "light_color"):
        assert getattr(grads, f).abs().max() > 0, f
    assert dataclasses.is_dataclass(new) and isinstance(new, train.TrainableParams)

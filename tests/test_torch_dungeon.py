"""The textured dungeon (8,393 triangles, a 2048x2048 atlas, the sun at
altitude 0.35) in the port against the JAX package on the CPU: loading,
PNG decoding, atlas sampling, the textured surface, the realtime
prelude with the sky, reference-mode samples with the sky (one at 32x24,
one at 16x12 through both routes of the staged loop), and a
free-running realtime frame. The JAX dungeon is built once per test
process and handed over through convert.py; three JAX programs are
compiled (the prelude and two reference samples)."""

import dataclasses
import io
import json
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_arrays import np_tree, scene_arrays

from strolle_tpu.bvh import scene_with_bvh as jax_scene_with_bvh
from strolle_tpu.models import restir as jr
from strolle_tpu.models.reference import trace_sample as jax_trace_sample
from strolle_tpu.ops.hit import TriangleHit as JaxHit
from strolle_tpu.ops.hit import surface_at as jax_surface_at
from strolle_tpu.ops.texture import sample_atlas_bilinear as jax_sample_atlas
from strolle_tpu.scene.demo import dungeon as jax_dungeon
from strolle_tpu.scene.demo import dungeon_camera as jax_dungeon_camera
from strolle_tpu.sky.atmosphere import AtmosphereLuts as JaxLuts
from strolle_tpu_torch import convert
from strolle_tpu_torch.bvh import scene_with_bvh
from strolle_tpu_torch.models import restir as tr
from strolle_tpu_torch.models.reference import trace_sample
from strolle_tpu_torch.ops.hit import TriangleHit, surface_at
from strolle_tpu_torch.ops.kernels import stream_kernels as sk
from strolle_tpu_torch.ops.texture import sample_atlas_bilinear
from strolle_tpu_torch.scene.demo import ASSETS, dungeon
from strolle_tpu_torch.scene.png import decode_png
from strolle_tpu_torch.sky.atmosphere import luts_for

W, H = 32, 24
SUN = 0.35
#: Floats of one function on the same inputs: a few float32 ulps of
#: unfused against fused multiply-adds.
ATOL, RTOL = 1e-5, 1e-4
#: Pixels whose integers may differ between the packages on a full
#: pass: a ray that meets a shared edge may pick the other triangle.
MIN_AGREE = 0.99


@pytest.fixture(scope="module")
def dg():
    """(JAX dungeon, the port's copy of it, JAX camera, port camera, port
    LUTs, the same LUTs for JAX): the sun at 0.35 as bench.py sets it."""
    jscene = jax_scene_with_bvh(jax_dungeon()).replace(
        sun_altitude=jnp.asarray(SUN, jnp.float32))
    scene = convert.scene_from_arrays(scene_arrays(jscene), device="cpu")
    jcam = jax_dungeon_camera(W, H)
    cam = convert.camera_from_arrays(np_tree(jcam), device="cpu")
    # both packages take the port's LUTs (held against the JAX LUT
    # generators in test_torch_restir_ops.py)
    luts = luts_for(SUN, "cpu")
    jluts = JaxLuts(**{k: jnp.asarray(getattr(luts, k).numpy()) for k in
                       ("transmittance", "scattering", "sky")})
    return jscene, scene, jcam, cam, luts, jluts


def _flat(x, prefix=""):
    if isinstance(x, torch.Tensor):
        return {prefix: x.numpy()}
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: v for n, a in x.items() for k, v in _flat(a, f"{prefix}.{n}").items()}
    if isinstance(x, (tuple, list)):
        return {k: v for i, a in enumerate(x) for k, v in _flat(a, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(x)}


def _assert_fields(got, want, n_pixels: int, only=None):
    """Integers equal and floats allclose on >= MIN_AGREE of the pixels
    (``only``: a mask of the pixels to compare)."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        a, b = g[k].reshape(n_pixels, -1), w[k].reshape(n_pixels, -1)
        if b.dtype == np.bool_ or np.issubdtype(b.dtype, np.integer):
            ok = (a.astype(np.int64) == b.astype(np.int64)).all(-1)
        else:
            ok = (np.abs(a - b) <= ATOL + RTOL * np.abs(b)).all(-1)
        if only is not None:
            ok = ok[only.reshape(-1)]
        assert ok.mean() >= MIN_AGREE, f"{k}: {ok.mean():.4f} agree"


def test_port_loader_matches_jax(dg):
    """The port's own load + BVH build of the dungeon equals the JAX
    package's, bit for bit."""
    jscene = dg[0]
    scene = scene_with_bvh(dungeon(device="cpu"))
    want = scene_arrays(jscene)
    got = convert.scene_to_arrays(scene)
    for group in ("geometry", "materials", "lights", "bvh"):
        for k, v in want[group].items():
            if k in ("tex_channels", "max_depth", "count"):
                assert got[group][k] == v, k
            else:
                np.testing.assert_array_equal(got[group][k], v, err_msg=f"{group}.{k}")
    assert scene.materials.tex_channels == (True, False, False)
    assert scene.geometry.num_triangles == 8393 and scene.clusters.shape == (33, 8)
    np.testing.assert_array_equal(got["atlas"], want["atlas"])
    assert got["atlas"].shape == (2048, 2048, 4)
    np.testing.assert_array_equal(got["clusters"], want["clusters"])
    assert not scene.has_alpha and not jscene.has_alpha


def test_png_decoder_matches_pil():
    """scene/png.py against PIL's convert("RGBA") on all 45 dungeon images
    (64x64 palette images at 1 and 2 bits)."""
    data = zipfile.ZipFile(ASSETS / "demo.zip").read("demo/level.glb")
    off, js, blob = 12, None, b""
    while off < len(data):
        n, kind = struct.unpack("<II", data[off : off + 8])
        if kind == 0x4E4F534A:
            js = json.loads(data[off + 8 : off + 8 + n])
        else:
            blob = data[off + 8 : off + 8 + n]
        off += 8 + n
    assert len(js["images"]) == 45
    for im in js["images"]:
        bv = js["bufferViews"][im["bufferView"]]
        start = bv.get("byteOffset", 0)
        raw = bytes(blob[start : start + bv["byteLength"]])
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
        np.testing.assert_array_equal(decode_png(raw), want)


def test_atlas_sampling_and_textured_surface_match_jax(dg):
    jscene, scene, *_ = dg
    rs = np.random.RandomState(5)
    uv = rs.uniform(-0.01, 1.01, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sample_atlas_bilinear(scene.atlas, torch.tensor(uv)).numpy(),
        np.asarray(jax_sample_atlas(jscene.atlas.image, jnp.asarray(uv))),
        rtol=RTOL, atol=ATOL,
    )
    # seeded hits: triangles, barycentrics and rays toward them
    n = 400
    tri = rs.randint(-1, scene.geometry.num_triangles, n).astype(np.int32)
    u = rs.uniform(0, 0.5, n).astype(np.float32)
    v = rs.uniform(0, 0.5, n).astype(np.float32)
    t = rs.uniform(0.5, 9.0, n).astype(np.float32)
    o = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.where(tri >= 0, t, np.inf).astype(np.float32)
    for regularize in (False, True):
        got = surface_at(scene, torch.tensor(o), torch.tensor(d),
                         TriangleHit(*(torch.tensor(x) for x in (t, tri, u, v))), regularize)
        want = jax_surface_at(jscene, jnp.asarray(o), jnp.asarray(d),
                              JaxHit(*(jnp.asarray(x) for x in (t, tri, u, v))), regularize)
        for k, a in _flat(got).items():
            b = _flat(want)[k]
            if b.dtype == np.bool_ or np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)
        assert np.ptp(got.base_color.numpy()[tri >= 0], axis=0).max() > 0.05  # textured


def test_prelude_with_sky_matches_jax(dg):
    """The realtime prelude (primary trace through kernel 5's plain
    version, reprojection, the sky on miss pixels) of the first frame."""
    jscene, scene, jcam, cam, luts, jluts = dg
    js = jr.init_state(jcam)
    state = tr.init_state(cam, device="cpu")
    want = jr._stage_prelude(jscene, jcam, js.prev_camera, js.prev_surface, js.frame, jluts,
                             True, None, None)
    got = tr._stage_prelude(scene, cam, state.prev_camera, state.prev_surface, 0, luts, True)
    same_tri = got[0].tri.numpy() == np.asarray(want[0].tri)
    assert same_tri.mean() >= MIN_AGREE
    _assert_fields(got, want, W * H, only=same_tri)
    sky = got[2].numpy()
    assert sky.max() > 0.0 and np.isfinite(sky).all()


def test_trace_sample_with_sky_matches_jax(dg):
    """One reference-mode sample, depth 1, with the sky: the port's staged
    loop (kernels 5 and 6's plain versions) against the JAX package's
    (its torch-free BVH traversal on the CPU)."""
    jscene, scene, jcam, cam, luts, jluts = dg
    want = np.asarray(jax_trace_sample(jscene, jcam, jnp.uint32(5), depth=1, include_sky=True,
                                       luts=jluts))
    got = trace_sample(scene, cam, 5, depth=1, include_sky=True, luts=luts).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    # the same PCG stream over the same hits; shading rounds without
    # fused multiply-adds here, so a rare pixel flips a binary decision
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-3).mean() >= MIN_AGREE, (diff > 1e-3).mean()
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert got.mean() > 1e-3


def test_staged_loop_fused_route_matches_jax(dg, monkeypatch):
    """The staged loop with use_pallas=None, the JAX package's default:
    every surface takes the fused route (kernel 5 + surface_at under
    "stream"), none trace_closest, and the sample (16x12, depth 1, the
    sky) is the JAX package's staged loop's (jitted; on the CPU it takes
    its BVH traversal) within the tolerances above; use_pallas=False
    takes trace_closest for both bounces and gives the same image."""
    from strolle_tpu_torch.ops import trace as trace_mod

    jscene, scene, _, _, luts, jluts = dg
    jcam = jax_dungeon_camera(16, 12)
    cam = convert.camera_from_arrays(np_tree(jcam), device="cpu")
    closest = []
    real = trace_mod.trace_closest

    def record(*args):
        closest.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(trace_mod, "trace_closest", record)
    got = trace_sample(scene, cam, 5, depth=1, include_sky=True, luts=luts, use_pallas=None)
    assert closest == []
    split = trace_sample(scene, cam, 5, depth=1, include_sky=True, luts=luts, use_pallas=False)
    assert len(closest) == 2
    want = np.asarray(jax.jit(
        lambda s, c, l: jax_trace_sample(s, c, jnp.uint32(5), depth=1, include_sky=True,
                                         use_pallas=None, luts=l)
    )(jscene, jcam, jluts))
    for img in (got.numpy(), split.numpy()):
        assert img.shape == (12, 16, 3) and np.isfinite(img).all()
        diff = np.abs(img - want).max(axis=-1)
        assert (diff <= 1e-3).mean() >= MIN_AGREE, (diff > 1e-3).mean()
        assert abs(img.mean() - want.mean()) <= 0.01 * want.mean()
    assert got.mean() > 1e-3


def test_realtime_frame_runs_on_dungeon(dg, monkeypatch):
    """One GI cycle of the port's free-running frame with the sky: every
    channel finite, and the compacted half-width ray sets and the paired
    visibility launches reach the stream kernels: kernel 5 once for the
    primaries and once on GI-sampling frames (0, 2, 4, 5), kernel 6 four
    times a frame (DI sampling, DI spatial's paired rays, DI resolve, and
    GI sampling's shadow rays or GI spatial's paired rays)."""
    _, scene, _, cam, luts, _ = dg
    shapes = []

    def record(fn):
        def wrapper(clus, rows, o, *args, **kwargs):
            shapes.append((fn.__name__, tuple(o.shape[:-1])))
            return fn(clus, rows, o, *args, **kwargs)
        return wrapper

    for name in ("stream_trace_surface", "stream_trace_anyhit"):
        monkeypatch.setattr(sk, name, record(getattr(sk, name)))
    state = tr.init_state(cam, device="cpu")
    cfg = tr.RenderConfig(include_sky=True)
    for f in range(6):
        before = len(shapes)
        ch, state = tr.render_frame_fused(scene, cam, state, 11 * f + 5, cfg, luts=luts)
        names = [name for name, _ in shapes[before:]]
        assert names.count("stream_trace_surface") == 1 + (f not in (1, 3)), (f, names)
        assert names.count("stream_trace_anyhit") == 4, (f, names)
        for k, x in ch.items():
            assert bool(torch.isfinite(x).all()), (f, k)
    assert ch["image"].shape == (H, W, 3) and float(ch["image"].mean()) > 1e-3
    seen = set(shapes)
    assert ("stream_trace_surface", (H, W)) in seen  # primaries
    assert ("stream_trace_surface", (H, W // 2)) in seen  # compacted GI bounces
    assert ("stream_trace_anyhit", (H, W // 2)) in seen  # compacted GI shadow rays
    assert ("stream_trace_anyhit", (H, W)) in seen  # DI rays and the paired launches


def test_small_textured_scene_routes_agree():
    """A scene of up to 1024 triangles with an atlas: kernel 4's route
    (the winner resolved in the kernel, then the textured material fetch)
    against trace_closest + surface_at. Cornell with every material
    textured from a seeded atlas; and the Cornell glTF asset, read out of
    its zip, equal to the JAX package's load of it."""
    from strolle_tpu.scene.demo import cornell_gltf as jax_cornell_gltf
    from strolle_tpu_torch.camera import pixel_rays, screen_grid
    from strolle_tpu_torch.ops.trace import trace_surface
    from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
    from strolle_tpu_torch.scene.demo import cornell_gltf
    from strolle_tpu_torch.scene.types import make_atlas

    rs = np.random.RandomState(9)
    scene = cornell_box(device="cpu")
    m = scene.materials.num_materials
    rects = torch.tensor(rs.uniform(0.0, 0.5, (m, 4)).astype(np.float32))
    mats = dataclasses.replace(scene.materials, base_color_tex=rects, emissive_tex=rects,
                               metallic_roughness_tex=rects, tex_channels=(True, True, True))
    scene = scene.replace(materials=mats, atlas=make_atlas(
        torch.tensor(rs.uniform(0, 1, (64, 64, 4)).astype(np.float32))))
    cam = cornell_camera(W, H, device="cpu")
    o, d = pixel_rays(cam, screen_grid(cam))
    for regularize in (False, True):
        fused = trace_surface(scene, o, d, regularize)
        split = trace_surface(scene, o, d, regularize, use_pallas=False)
        assert torch.equal(fused.tri, split.tri)
        for k in ("base_color", "emissive", "metallic", "roughness", "reflectance", "uv"):
            torch.testing.assert_close(getattr(fused, k), getattr(split, k), rtol=RTOL, atol=ATOL)
    assert fused.base_color[fused.is_some].std(0).max() > 0.05

    got = convert.scene_to_arrays(cornell_gltf(device="cpu"))
    want = scene_arrays(jax_cornell_gltf())
    for group in ("geometry", "materials"):
        for k, v in want[group].items():
            np.testing.assert_array_equal(np.asarray(got[group][k]), np.asarray(v), err_msg=k)

"""The port's host surface against the JAX package: the loader's PIL
paths, metrics, checkpoints, the Renderer and the viewer.

- Loader: glTFs written to a temporary directory whose textures the
  port's own PNG decoder refuses (JPEG, a 16-bit PNG, an interlaced PNG,
  an RGB PNG with a tRNS colour key) or that exceed ``max_texture_size``
  (resized): atlas and material rects equal to the JAX loader's, exactly.
- Metrics and the viewer's display chain (tonemap, FXAA, upscale) are
  host numpy: equal to the JAX package's. OrbitCamera: matrices within
  1e-6.
- Renderer: the invalidation rules of ``update_camera`` against the JAX
  Renderer's, on a sentinel state (no JAX frame is compiled); each mode's
  image against the port's own ``render_frame`` / ``render_reference`` /
  ``render_heatmap`` on the same seed, exactly.
- Checkpoints: a RenderState after one 8x8 frame round-trips bit-equal,
  and the next frame from the restored state equals the live one's.

Images are 16x16 or smaller, so nothing here costs more than a few
seconds of CPU.
"""

import base64
import io
import json
import logging
import struct
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_engine import loaded_jax_native
from torch_port_arrays import np_tree

from strolle_tpu import renderer as jrenderer
from strolle_tpu import viewer as jviewer
from strolle_tpu.camera import make_camera as jmake_camera
from strolle_tpu.scene.gltf import load_gltf as jload_gltf
from strolle_tpu.utils import metrics as jmetrics
from strolle_tpu_torch import CameraSettings, Renderer, SceneEditor, convert, viewer
from strolle_tpu_torch.camera import make_camera
from strolle_tpu_torch.models.heatmap import render_heatmap
from strolle_tpu_torch.models.reference import init_accumulator, render_reference
from strolle_tpu_torch.models.restir import RenderConfig, init_state, render_frame
from strolle_tpu_torch.scene.cornell import cornell_box, cornell_camera
from strolle_tpu_torch.scene.gltf import load_gltf
from strolle_tpu_torch.scene.png import decode_png
from strolle_tpu_torch.utils import checkpoint, metrics



@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    loaded_jax_native()


# --- the loader ------------------------------------------------------------


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _interlaced_png(rgb: np.ndarray) -> bytes:
    """An Adam7-interlaced 8-bit RGB PNG (filter 0 on every row)."""
    h, w, _ = rgb.shape
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                           (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)):
        sub = rgb[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def _encoded(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _textures() -> list[bytes]:
    rs = np.random.RandomState(0)
    rgb = rs.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    rgb[::3, ::2] = [10, 20, 30]  # the tRNS colour key's pixels
    grey16 = rs.randint(0, 65536, (9, 7)).astype(np.uint16)
    big = rs.randint(0, 256, (24, 40, 4)).astype(np.uint8)
    return [
        _encoded(Image.fromarray(rgb), "JPEG", quality=90),
        _encoded(Image.fromarray(grey16), "PNG"),  # mode I;16
        _interlaced_png(rgb),
        _encoded(Image.fromarray(rgb), "PNG", transparency=(10, 20, 30)),
        _encoded(Image.fromarray(big), "PNG"),  # 40 wide > max_texture_size
    ]


def _write_gltf(path, textures) -> None:
    """One textured quad per texture, each with its own material."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    n = len(textures)
    js = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode(), "byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 32},
                        {"buffer": 0, "byteOffset": 80, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "images": [{"uri": "data:image/x;base64," + base64.b64encode(t).decode()}
                   for t in textures],
        "textures": [{"source": i} for i in range(n)],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": i}}}
                      for i in range(n)],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": i}]} for i in range(n)],
        "nodes": [{"mesh": i, "translation": [2.0 * i, 0, 0]} for i in range(n)],
        "scenes": [{"nodes": list(range(n))}],
        "scene": 0,
    }
    path.write_text(json.dumps(js))


def test_loader_pil_textures_match_jax(tmp_path):
    textures = _textures()
    for t in textures[:4]:  # what the port's own decoder refuses
        with pytest.raises((NotImplementedError, ValueError)):
            decode_png(t)
    path = tmp_path / "textures.gltf"
    _write_gltf(path, textures)
    kw = dict(atlas_size=128, max_texture_size=16)
    got = load_gltf(str(path), device="cpu", **kw)
    want = jload_gltf(str(path), **kw)
    np.testing.assert_array_equal(got.atlas.image.numpy(), np.asarray(want.atlas.image))
    np.testing.assert_array_equal(got.materials.base_color_tex.numpy(),
                                  np.asarray(want.materials.base_color_tex))
    np.testing.assert_array_equal(got.geometry.positions.numpy(),
                                  np.asarray(want.geometry.positions))
    rects = got.materials.base_color_tex.numpy() * 128
    assert rects[4, 2] == 16 and rects[4, 3] == 9  # 40x24 shrunk to 16x9


# --- metrics -------------------------------------------------------------


def test_metrics_match_jax(monkeypatch, caplog):
    for m in (metrics, jmetrics):
        monkeypatch.setattr(m, "totals", type(m.totals)(lambda: [0.0, 0]))
        monkeypatch.setattr(m, "_STATS", True)
        m.enable(True, threshold=0.0)
    try:
        with caplog.at_level(logging.DEBUG):
            for m in (metrics, jmetrics):
                for _ in range(2):
                    with m.measure("test.stage"):
                        time.sleep(0.002)
                m.metric("test.manual", time.perf_counter())
        ours, theirs = metrics.summary(), jmetrics.summary()
        assert ours.keys() == theirs.keys() == {"test.stage", "test.manual"}
        for k in ours:
            assert ours[k]["calls"] == theirs[k]["calls"]
        assert ours["test.stage"]["total_s"] >= 0.004
        assert any("metric(test.stage)" in r.getMessage() and r.name == "strolle_tpu_torch"
                   for r in caplog.records)
    finally:
        metrics.enable(False)
        jmetrics.enable(False)
    with metrics.measure("off.stage"):
        pass
    assert "off.stage" not in metrics.totals

    from strolle_tpu.scene.dynamics import SceneEditor as JEditor

    stats = []
    for ed, m in ((SceneEditor(device="cpu"), metrics), (JEditor(), jmetrics)):
        ed.insert_instance("tri", np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32))
        ed.insert_light("l", pos=[0, 1, 0])
        stats.append(m.scene_stats(ed.tick(), 0))
    assert stats[0] == stats[1] and stats[0]["lights"] == 2
    monkeypatch.setattr(metrics, "_STATS", False)
    assert metrics.scene_stats(None) is None


# --- checkpoints ------------------------------------------------------------


def test_checkpoint_round_trip_after_a_frame(tmp_path):
    scene, cam = cornell_box(device="cpu"), cornell_camera(8, 8, device="cpu")
    _, state = render_frame(scene, cam, init_state(cam, device="cpu"), 5)
    path = tmp_path / "ckpt" / "3"
    checkpoint.save(path, {"render": state, "step": 7})
    with pytest.raises(FileExistsError):
        checkpoint.save(path, {"render": state, "step": 7}, force=False)
    restored = checkpoint.restore(path, {"render": init_state(cam, device="cpu"), "step": 0})
    assert restored["step"] == 7 and restored["render"].frame == state.frame == 1
    flat = checkpoint._leaves(state)
    back = checkpoint._leaves(restored["render"])
    assert len(flat) == len(back) > 20
    for a, b in zip(flat, back):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert checkpoint.latest_step(tmp_path / "ckpt") == 3
    live, _ = render_frame(scene, cam, state, 6)
    again, _ = render_frame(scene, cam, restored["render"], 6)
    for k in live:
        assert torch.equal(live[k], again[k]), k
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"render": init_state(cam, device="cpu")})


# --- the renderer -----------------------------------------------------------


def test_renderer_invalidation_matches_jax():
    """update_camera drops the state exactly where the JAX Renderer does."""
    sentinel = object()
    jcams = [jmake_camera((0, 1, 3), (0, 0, 0), width=w, height=h)
             for w, h in ((16, 16), (16, 16), (16, 8))]
    cams = [convert.camera_from_arrays(np_tree(c), "cpu") for c in jcams]
    jr, r = jrenderer.Renderer(), Renderer()
    jr.create_camera("c", jcams[0])
    r.create_camera("c", cams[0])
    steps = [
        {"camera": 1},  # same size
        {"camera": 2},  # another size
        {"settings": dict(mode="image", include_sky=True)},
        {"settings": dict(mode="image", include_sky=True, reference_depth=2)},
        {"settings": dict(mode="albedo", include_sky=True)},
        {"settings": dict(mode="albedo", denoise=False, include_sky=True)},
        {"settings": dict(mode="albedo", denoise=False, include_sky=True)},
        {"camera": 0, "settings": dict(mode="reference")},
    ]
    for step in steps:
        jr._cameras["c"].state = r._cameras["c"].state = sentinel
        jkw, kw = {}, {}
        if "camera" in step:
            jkw["camera"], kw["camera"] = jcams[step["camera"]], cams[step["camera"]]
        if "settings" in step:
            jkw["settings"] = jrenderer.CameraSettings(**step["settings"])
            kw["settings"] = CameraSettings(**step["settings"])
        jr.update_camera("c", **jkw)
        r.update_camera("c", **kw)
        assert (r._cameras["c"].state is None) == (jr._cameras["c"].state is None), step
    r.delete_camera("c")
    assert not r.has_camera("c")


@pytest.fixture(scope="module")
def cornell16():
    return cornell_box(device="cpu"), cornell_camera(16, 16, device="cpu")


@pytest.mark.parametrize("mode", ["image", "di_diffuse", "gi_specular", "albedo", "depth"])
def test_renderer_modes_pick_their_channel(cornell16, mode):
    scene, cam = cornell16
    r = Renderer()
    r.create_camera("c", cam, CameraSettings(mode=mode, denoise=True))
    got = [r.render_camera("c", scene, s) for s in (3, 4)]
    cfg = RenderConfig(mode=mode, needs_gi=mode in ("image", "gi_diffuse", "gi_specular"))
    state = init_state(cam, device="cpu")
    for img, s in zip(got, (3, 4)):
        ch, state = render_frame(scene, cam, state, s, cfg)
        want = ch[mode]
        want = want if want.ndim == 3 else want[..., None].expand(-1, -1, 3)
        assert img.shape == (16, 16, 3) and torch.equal(img, want), mode


def test_renderer_reference_and_heatmap(cornell16):
    scene, cam = cornell16
    r = Renderer()
    r.create_camera("c", cam, CameraSettings(mode="reference", reference_depth=2))
    got = [r.render_camera("c", scene, s) for s in (1, 2)]
    acc = init_accumulator(cam)
    for img, s in zip(got, (1, 2)):
        want, acc = render_reference(scene, cam, acc, s, depth=2, include_sky=False)
        assert torch.equal(img, want)
    r.update_camera("c", settings=CameraSettings(mode="bvh_heatmap"))
    assert torch.equal(r.render_camera("c", scene, 0), render_heatmap(scene, cam))


# --- the viewer ---------------------------------------------------------------


def test_display_chain_matches_jax():
    rs = np.random.RandomState(1)
    hdr = rs.exponential(0.5, (12, 14, 3)).astype(np.float32)
    hdr[0, 0] = np.nan
    for img in (hdr, hdr[..., 0]):
        np.testing.assert_array_equal(viewer.tonemap_u8(img), jviewer.tonemap_u8(img))
    u8 = viewer.tonemap_u8(hdr)
    np.testing.assert_array_equal(viewer.fxaa(u8), jviewer.fxaa(u8))
    for f in (1.0, 1.5, 0.5):
        np.testing.assert_array_equal(viewer.upscale(u8, f), jviewer.upscale(u8, f))
    assert viewer.MODES == jviewer.MODES


def test_orbit_camera_matches_jax():
    jcam = jmake_camera((0.5, 1.0, 3.0), (0, 1, 0), width=16, height=12)
    cam = convert.camera_from_arrays(np_tree(jcam), "cpu")
    jo = jviewer.OrbitCamera.from_camera(jcam, target=(0, 1, 0))
    o = viewer.OrbitCamera.from_camera(cam, target=(0, 1, 0))
    for step in (lambda x: None, lambda x: x.orbit(0.3, -0.2), lambda x: x.dolly(1.3),
                 lambda x: x.orbit(-2.0, 3.0)):
        step(o)
        step(jo)
        a, b = o.camera(), jo.camera()
        for f in ("projection_view", "ndc_to_world", "origin"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                       rtol=1e-6, atol=1e-6)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_viewer_static_scene_controls_and_http(cornell16):
    scene, cam = cornell16
    v = viewer.Viewer(scene, cam, target=(0.0, 1.0, 0.0))
    try:
        img = v.render_one(seed=0)
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.max() > 0
        v.push_control({"mode": "albedo", "denoise": False})
        v.push_control({"dolly": "far"})  # malformed: dropped
        v.render_one(seed=1)
        st = v.state()
        assert (st["mode"], st["denoise"], st["frame"]) == ("albedo", False, 2)
        eye = v.orbit.camera().origin.clone()
        v.push_control({"orbit": [0.5, 0.1], "dolly": 1.2, "light_scale": 2.0,
                        "fxaa": True, "upscale": 2.0})
        big = v.render_one(seed=2)
        assert big.shape == (32, 32, 3)
        assert not torch.allclose(v.orbit.camera().origin, eye)
        port = v.start_server("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        code, ctype, page = _get(base + "/")
        assert code == 200 and b"albedo" in page and ctype == "text/html"
        code, ctype, jpg = _get(base + "/frame.jpg")
        assert ctype == "image/jpeg" and Image.open(io.BytesIO(jpg)).size == (32, 32)
        code, _, body = _get(base + "/state")
        assert json.loads(body)["light_scale"] == 2.0
        req = urllib.request.Request(base + "/control", data=b'{"mode": "depth"}',
                                     method="POST")
        assert urllib.request.urlopen(req, timeout=10).status == 200
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/missing")
        v.render_one(seed=3)
        assert v.state()["mode"] == "depth"
        # a switch into reference mode drops the realtime state
        v.push_control({"mode": "reference"})
        v.render_one(seed=4)
        v.render_one(seed=5)
        assert bool((v.renderer._cameras["view"].state.samples == 2).all())
    finally:
        v.stop_server()


def test_viewer_editor_scene():
    ed = SceneEditor(device="cpu", light_capacity=4)
    ed.insert_instance("floor", np.asarray(
        [[[-2, 0, -2], [2, 0, 2], [2, 0, -2]], [[-2, 0, -2], [-2, 0, 2], [2, 0, 2]]],
        np.float32))
    ed.insert_light("l", pos=[0, 1.5, 0], color=[4, 4, 4])
    cam = make_camera((0, 2, 3), (0, 0, 0), width=8, height=8, device="cpu")
    v = viewer.Viewer(ed, cam, include_sky=False)
    v.push_control({"sun_azimuth": 0.5, "sun_altitude": -0.8})
    img = v.render_one(seed=0)
    assert img.shape == (8, 8, 3) and img.max() > 0
    assert ed.sun_azimuth == 0.5 and v.state()["stats"]["bvh_rebuilds"] == 1
    v.run(max_frames=2)
    assert v.state()["frame"] == 3 and ed.frame == 3
    with pytest.raises(TypeError):
        viewer.Viewer(object(), cam)

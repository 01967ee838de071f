"""Interactive viewer and debug UI (port of strolle_tpu/viewer.py).

The render loop runs on the host beside the card, and the UI is a page
served by the standard library's HTTP server (a <canvas> fed by an MJPEG
stream), so it works through an SSH tunnel to the card's machine.

Controls served at http://host:port/ :
  keys 0-8     camera modes (image, di/gi diffuse/specular, albedo,
               depth, reference, bvh_heatmap)
  drag / wheel orbit and dolly the camera
  sliders      sun azimuth and altitude (new LUTs), light intensity
               scale, denoise switch
  overlay      FPS, frame ms, frame counter, the editor's stats

Frames are encoded as JPEG with PIL, a host dependency of the viewer.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .camera import Camera, make_camera
from .renderer import CameraSettings, Renderer

log = logging.getLogger("strolle_tpu_torch.viewer")

MODES = [
    "image",
    "di_diffuse",
    "di_specular",
    "gi_diffuse",
    "gi_specular",
    "albedo",
    "depth",
    "reference",
    "bvh_heatmap",
]


def tonemap_u8(img: np.ndarray) -> np.ndarray:
    """Linear HDR -> u8 through gamma 2.2; a 2-D channel (depth) is
    scaled by its maximum and shown grey."""
    a = np.asarray(img, np.float32)
    if a.ndim == 2:
        mx = float(a.max()) or 1.0
        a = np.repeat((a / mx)[..., None], 3, axis=-1)
    a = np.clip(np.nan_to_num(a), 0.0, 1.0) ** (1.0 / 2.2)
    return (a * 255.0 + 0.5).astype(np.uint8)


def fxaa(img_u8: np.ndarray) -> np.ndarray:
    """Luma-directed anti-aliasing of the tonemapped u8 image: where the
    local luma contrast passes FXAA 3.11's thresholds, blend toward the
    3x3 neighbourhood's mean in proportion to the contrast."""
    f = img_u8.astype(np.float32)
    luma = f @ np.asarray([0.299, 0.587, 0.114], np.float32)
    p = np.pad(luma, 1, mode="edge")
    lo = np.minimum.reduce(
        [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:], luma]
    )
    hi = np.maximum.reduce(
        [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:], luma]
    )
    contrast = hi - lo
    # FXAA 3.11 thresholds: relative 1/8 of max luma, absolute 1/16
    edge = contrast > np.maximum(255.0 / 16.0, hi * 0.125)
    pf = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = (
        pf[:-2, 1:-1] + pf[2:, 1:-1] + pf[1:-1, :-2] + pf[1:-1, 2:]
        + pf[:-2, :-2] + pf[:-2, 2:] + pf[2:, :-2] + pf[2:, 2:] + f
    ) / 9.0
    amount = np.clip(contrast / np.maximum(hi, 1e-3), 0.0, 0.75)[..., None]
    out = np.where(edge[..., None], f + (blur - f) * amount, f)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def upscale(img_u8: np.ndarray, factor: float) -> np.ndarray:
    """Bilinear upscale of the u8 display image by ``factor``."""
    if factor == 1.0:
        return img_u8
    h, w = img_u8.shape[:2]
    oh, ow = int(round(h * factor)), int(round(w * factor))
    ys = (np.arange(oh, dtype=np.float32) + 0.5) / factor - 0.5
    xs = (np.arange(ow, dtype=np.float32) + 0.5) / factor - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = img_u8.astype(np.float32)
    top = f[y0][:, x0] * (1 - fx) + f[y0][:, x1] * fx
    bot = f[y1][:, x0] * (1 - fx) + f[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def encode_jpeg(img_u8: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class OrbitCamera:
    """Spherical-orbit camera state driving make_camera (cameras on
    ``device``)."""

    def __init__(self, eye, target, fov_y, width, height, device=None):
        self.target = np.asarray(target, np.float64)
        off = np.asarray(eye, np.float64) - self.target
        self.radius = float(np.linalg.norm(off))
        self.azimuth = float(np.arctan2(off[0], off[2]))
        self.altitude = float(np.arcsin(np.clip(off[1] / self.radius, -1, 1)))
        self.fov_y = fov_y
        self.width, self.height = width, height
        self.device = device

    def orbit(self, d_az: float, d_alt: float):
        self.azimuth += d_az
        lim = np.pi / 2 - 1e-3
        self.altitude = float(np.clip(self.altitude + d_alt, -lim, lim))

    def dolly(self, factor: float):
        self.radius = float(np.clip(self.radius * factor, 1e-2, 1e4))

    def camera(self) -> Camera:
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        ch, sh = np.cos(self.altitude), np.sin(self.altitude)
        eye = self.target + self.radius * np.array([sa * ch, sh, ca * ch])
        return make_camera(
            eye=eye,
            target=self.target,
            fov_y=self.fov_y,
            width=self.width,
            height=self.height,
            device=self.device,
        )

    @classmethod
    def from_camera(cls, cam: Camera, target=(0.0, 0.0, 0.0), fov_y=np.pi / 4):
        eye = cam.origin.detach().cpu().numpy()
        return cls(eye, target, fov_y, cam.width, cam.height, cam.device)


_PAGE = """<!doctype html>
<html><head><title>strolle viewer</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;display:flex}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 img{image-rendering:pixelated;max-width:100%;max-height:100vh}
 #panel{width:260px;padding:10px;background:#1a1a1f}
 label{display:block;margin-top:8px}
 input[type=range]{width:100%}
 .stat{color:#8f8}
 kbd{background:#333;padding:0 4px;border-radius:3px}
</style></head><body>
<div id=view><img id=frame src=/stream draggable=false></div>
<div id=panel>
 <b>strolle (PyTorch)</b>
 <div id=stats class=stat>—</div>
 <label>mode <select id=mode></select></label>
 <label><input type=checkbox id=denoise checked> denoise</label>
 <label>sun altitude <input type=range id=sunalt min=-0.5 max=1.5 step=0.01></label>
 <label>sun azimuth <input type=range id=sunaz min=-3.14 max=3.14 step=0.01></label>
 <label>light intensity ×<span id=livval>1.0</span>
   <input type=range id=liv min=0 max=3 step=0.05 value=1></label>
 <p>keys <kbd>0</kbd>–<kbd>8</kbd> switch modes; drag = orbit,
 wheel = dolly</p>
</div>
<script>
const MODES=%MODES%;
const sel=document.getElementById('mode');
MODES.forEach((m,i)=>{const o=document.createElement('option');
  o.value=m;o.text=i+': '+m;sel.add(o);});
function ctl(body){fetch('/control',{method:'POST',body:JSON.stringify(body)});}
sel.onchange=()=>ctl({mode:sel.value});
document.getElementById('denoise').onchange=e=>ctl({denoise:e.target.checked});
document.getElementById('sunalt').oninput=e=>ctl({sun_altitude:+e.target.value});
document.getElementById('sunaz').oninput=e=>ctl({sun_azimuth:+e.target.value});
document.getElementById('liv').oninput=e=>{
  document.getElementById('livval').textContent=e.target.value;
  ctl({light_scale:+e.target.value});};
document.addEventListener('keydown',e=>{
  const i=+e.key; if(!isNaN(i)&&i<MODES.length){sel.value=MODES[i];ctl({mode:MODES[i]});}});
const img=document.getElementById('frame');
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  ctl({orbit:[(e.clientX-drag[0])*0.01,(e.clientY-drag[1])*0.01]});
  drag=[e.clientX,e.clientY];};
img.onwheel=e=>{ctl({dolly:e.deltaY>0?1.1:0.9});e.preventDefault();};
setInterval(async()=>{
  const s=await (await fetch('/state')).json();
  document.getElementById('stats').textContent=
    `${s.fps.toFixed(1)} fps  ${s.frame_ms.toFixed(2)} ms  frame ${s.frame}`+
    (s.stats?`\\n${JSON.stringify(s.stats)}`:'');
},500);
</script></body></html>"""


class Viewer:
    """Owns a Renderer camera, a control queue, and the HTTP UI.

    ``source`` is a static Scene or a SceneEditor (ticked every frame, so
    that edits and the sun control reach the frame through the editor's
    kill/remap protocol). Frames render on ``camera``'s device."""

    def __init__(
        self,
        source,
        camera: Camera,
        mode: str = "image",
        target=(0.0, 0.0, 0.0),
        fov_y: float = np.pi / 4,
        include_sky: bool | None = None,
        use_fxaa: bool = False,
        upscale_factor: float = 1.0,
    ):
        from .scene.dynamics import SceneEditor
        from .scene.types import Scene

        self._editor = source if isinstance(source, SceneEditor) else None
        self._static_scene = source if isinstance(source, Scene) else None
        if self._editor is None and self._static_scene is None:
            raise TypeError("source must be a Scene or SceneEditor")

        self.orbit = OrbitCamera.from_camera(camera, target, fov_y)
        self.renderer = Renderer()
        if include_sky is None:
            include_sky = self._editor is not None
        self.settings = CameraSettings(mode=mode, include_sky=include_sky)
        self.renderer.create_camera("view", camera, self.settings)

        self.use_fxaa = use_fxaa
        self.upscale_factor = float(upscale_factor)
        self._controls: list[dict] = []
        self._lock = threading.Lock()
        self._frame_jpg = encode_jpeg(
            np.zeros((camera.height, camera.width, 3), np.uint8)
        )
        self._frame_event = threading.Event()
        self._fps = 0.0
        self._frame_ms = 0.0
        self._frame_no = 0
        self._light_scale = 1.0
        self._camera_dirty = False
        self._server: ThreadingHTTPServer | None = None
        self.running = True

    # -- control plane ----------------------------------------------------

    def push_control(self, msg: dict):
        with self._lock:
            self._controls.append(dict(msg))

    def _apply_controls(self):
        with self._lock:
            msgs, self._controls = self._controls, []
        for m in msgs:
            try:
                self._apply_one_control(m)
            except (TypeError, ValueError, KeyError) as e:
                # a malformed /control payload (a non-numeric dolly, a
                # 1-element orbit) is dropped, not raised in the loop
                log.warning("ignoring malformed control %r: %s", m, e)
        if self._camera_dirty:
            self.renderer.update_camera("view", camera=self.orbit.camera())
            self._camera_dirty = False

    def _apply_one_control(self, m: dict):
        # new settings objects, not edits of the renderer's own: it drops
        # the camera's state by comparing the old settings with the new
        # (the JAX viewer edits them in place, so a switch into or out of
        # reference mode keeps the other mode's state)
        if "mode" in m and m["mode"] in MODES:
            self.settings = dataclasses.replace(self.settings, mode=m["mode"])
            self.renderer.update_camera("view", settings=self.settings)
        if "denoise" in m:
            self.settings = dataclasses.replace(self.settings, denoise=bool(m["denoise"]))
            self.renderer.update_camera("view", settings=self.settings)
        if "orbit" in m:
            dx, dy = m["orbit"]
            self.orbit.orbit(-float(dx), float(dy))
            self._camera_dirty = True
        if "dolly" in m:
            self.orbit.dolly(float(m["dolly"]))
            self._camera_dirty = True
        if "sun_altitude" in m and self._editor is not None:
            self._editor.update_sun(altitude=float(m["sun_altitude"]))
        if "sun_azimuth" in m and self._editor is not None:
            self._editor.update_sun(azimuth=float(m["sun_azimuth"]))
        if "light_scale" in m:
            self._light_scale = float(m["light_scale"])
        if "pause" in m:
            self.running = not bool(m.get("pause"))
        if "fxaa" in m:
            self.use_fxaa = bool(m["fxaa"])
        if "upscale" in m:
            self.upscale_factor = max(0.25, min(4.0, float(m["upscale"])))

    # -- render loop -------------------------------------------------------

    def _scene(self):
        if self._editor is not None:
            return self._editor.tick()
        return self._static_scene

    def render_one(self, seed: int | None = None):
        """Applies queued controls and renders one frame; returns the
        tonemapped u8 image (also published to the HTTP clients)."""
        self._apply_controls()
        t0 = time.perf_counter()
        scene = self._scene()
        if self._light_scale != 1.0:
            scene = scene.replace(lights=dataclasses.replace(
                scene.lights, color=scene.lights.color * self._light_scale))
        luts = None
        if self.settings.include_sky:
            from .sky.atmosphere import luts_for

            luts = luts_for(float(scene.sun_altitude), self.orbit.device)
        img = self.renderer.render_camera(
            "view", scene, self._frame_no if seed is None else seed, luts=luts
        )
        u8 = tonemap_u8(img.detach().cpu().numpy())
        # the display chain: fxaa, then upscale
        if self.use_fxaa:
            u8 = fxaa(u8)
        if self.upscale_factor != 1.0:
            u8 = upscale(u8, self.upscale_factor)
        dt = time.perf_counter() - t0
        with self._lock:
            self._frame_jpg = encode_jpeg(u8)
            self._frame_ms = dt * 1e3
            self._fps = 0.9 * self._fps + 0.1 / max(dt, 1e-6) if self._fps else 1 / max(dt, 1e-6)
            self._frame_no += 1
        self._frame_event.set()
        self._frame_event.clear()
        return u8

    def state(self) -> dict:
        with self._lock:
            st = {
                "fps": self._fps,
                "frame_ms": self._frame_ms,
                "frame": self._frame_no,
                "mode": self.settings.mode,
                "denoise": self.settings.denoise,
                "light_scale": self._light_scale,
            }
        if self._editor is not None:
            st["stats"] = dict(self._editor.stats)
        return st

    # -- HTTP --------------------------------------------------------------

    def start_server(self, host: str = "127.0.0.1", port: int = 0) -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    page = _PAGE.replace("%MODES%", json.dumps(MODES))
                    self._send(200, "text/html", page.encode())
                elif self.path == "/frame.jpg":
                    with viewer._lock:
                        jpg = viewer._frame_jpg
                    self._send(200, "image/jpeg", jpg)
                elif self.path == "/state":
                    self._send(
                        200, "application/json",
                        json.dumps(viewer.state()).encode(),
                    )
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f",
                    )
                    self.end_headers()
                    try:
                        while True:
                            viewer._frame_event.wait(timeout=1.0)
                            with viewer._lock:
                                jpg = viewer._frame_jpg
                            self.wfile.write(
                                b"--f\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                            )
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/control":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                        viewer.push_control(msg)
                        self._send(200, "application/json", b"{}")
                    except (ValueError, TypeError):
                        self._send(400, "text/plain", b"bad control")
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address[1]

    def stop_server(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def run(self, max_frames: int | None = None, target_fps: float | None = None):
        """Blocking render loop (Ctrl-C to stop)."""
        n = 0
        try:
            while max_frames is None or n < max_frames:
                if self.running:
                    t0 = time.perf_counter()
                    self.render_one()
                    n += 1
                    if target_fps:
                        dt = time.perf_counter() - t0
                        time.sleep(max(0.0, 1.0 / target_fps - dt))
                else:
                    self._apply_controls()
                    time.sleep(0.05)
        except KeyboardInterrupt:
            pass

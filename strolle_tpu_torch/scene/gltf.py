"""Minimal glTF 2.0 / GLB loader -> Scene (port of strolle_tpu/scene/gltf.py).

Node-hierarchy transforms with inverse-transpose normals,
pbrMetallicRoughness -> Material (perceptual roughness squared to
linear), and base-colour textures packed into one atlas with normalised
rects by the native guillotine allocator (``strolle_tpu_torch.native``,
the JAX package's allocator, so rects match). Textures are decoded by
``scene/png.py`` (its own PNG decoder, PIL for JPEG and the PNGs that
decoder refuses) and taken to linear colour with the JAX loader's
``** 2.2``; a texture larger than ``max_texture_size`` is resized with
PIL in the JAX loader's arithmetic.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from .build import MeshBuilder
from .png import decode_rgba8
from .types import Scene, compute_static_flags, make_atlas, make_lights, make_materials

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(data: bytes):
    magic, _version, _ = struct.unpack("<III", data[:12])
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    js = None
    bin_chunk = b""
    while offset < len(data):
        clen, ctype = struct.unpack("<II", data[offset : offset + 8])
        chunk = data[offset + 8 : offset + 8 + clen]
        if ctype == 0x4E4F534A:  # JSON
            js = json.loads(chunk)
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + clen
    return js, bin_chunk


class _Gltf:
    def __init__(self, js, buffers):
        self.js = js
        self.buffers = buffers

    def buffer_view(self, idx):
        bv = self.js["bufferViews"][idx]
        buf = self.buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0)
        return buf[off : off + bv["byteLength"]], bv.get("byteStride")

    def accessor(self, idx):
        acc = self.js["accessors"][idx]
        data, stride = self.buffer_view(acc["bufferView"])
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        n_comp = _TYPE_SIZES[acc["type"]]
        count = acc["count"]
        item = np.dtype(dtype).itemsize * n_comp
        off = acc.get("byteOffset", 0)
        if stride and stride != item:
            arr = np.stack(
                [np.frombuffer(data, dtype, n_comp, off + i * stride) for i in range(count)]
            )
        else:
            arr = np.frombuffer(data, dtype, count * n_comp, off).reshape(count, n_comp)
        if acc.get("normalized") and dtype in (np.uint8, np.uint16):
            arr = arr.astype(np.float32) / np.iinfo(dtype).max
        return np.array(arr)

    def image_bytes(self, idx):
        img = self.js["images"][idx]
        if "bufferView" in img:
            data, _ = self.buffer_view(img["bufferView"])
            return bytes(data)
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        raise ValueError(f"external image uri not supported: {uri}")


def _node_transform(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    x, y, z, w = q
    rot = np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def decode_image(raw: bytes, srgb: bool) -> np.ndarray:
    """Image bytes -> f32 RGBA [H, W, 4] in [0, 1], RGB raised to 2.2 when
    ``srgb`` (the JAX loader's linearisation)."""
    a = decode_rgba8(raw).astype(np.float32) / 255.0
    if srgb:
        a[..., :3] = a[..., :3] ** 2.2
    return a


def fit_texture(img: np.ndarray, max_texture_size: int) -> np.ndarray:
    """``img`` shrunk with PIL's ``resize`` so that its longer side is
    at most ``max_texture_size``, in the JAX loader's arithmetic (clip,
    x255, uint8, resize, /255); smaller images as they are."""
    if max(img.shape[:2]) <= max_texture_size:
        return img
    from PIL import Image

    scale = max_texture_size / max(img.shape[:2])
    nh = max(1, int(img.shape[0] * scale))
    nw = max(1, int(img.shape[1] * scale))
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).resize((nw, nh))
    return np.asarray(pil, np.float32) / 255.0


class AtlasPacker:
    """A texture atlas being filled: the [size, size, 4] image, the
    normalised rect [x, y, w, h] of each key, and the native guillotine
    allocator behind them (the JAX package's, so rects match)."""

    def __init__(self, size: int):
        self.size = size
        self.image = np.zeros((size, size, 4), np.float32)
        self.rects: dict = {}
        self.alloc = native.AtlasAllocator(size, size)

    def add(self, key, img: np.ndarray) -> None:
        """Packs ``img`` [h, w, 4] under ``key``; ValueError when full."""
        h, w = img.shape[:2]
        pos = self.alloc.alloc(w, h)
        if pos is None:
            raise ValueError("atlas full")
        x, y = pos
        self.image[y : y + h, x : x + w] = img
        s = self.size
        self.rects[key] = np.asarray([x / s, y / s, w / s, h / s], np.float32)


def load_gltf(
    source: str | Path | bytes,
    atlas_size: int = 2048,
    lights: list[dict] | None = None,
    light_capacity: int = 16,
    sun_altitude: float = -1.0,
    sun_azimuth: float = 0.0,
    max_texture_size: int = 512,
    read_uri: Callable[[str], bytes] | None = None,
    device=None,
) -> Scene:
    """Loads a .glb / .gltf file (a path, or its bytes) into a Scene (no
    BVH: call ``bvh.scene_with_bvh`` afterwards). ``read_uri`` reads a
    .gltf file's external buffers by their relative uri; it defaults to
    the file's directory when ``source`` is a path."""
    device = resolve_device(device)
    if isinstance(source, (str, Path)):
        path = Path(source)
        data = path.read_bytes()
        if read_uri is None:
            read_uri = lambda uri: (path.parent / uri).read_bytes()  # noqa: E731
    else:
        data = bytes(source)
    if data[:4] == b"glTF":
        js, bin_chunk = _load_glb(data)
        buffers = [bin_chunk]
    else:
        js = json.loads(data)
        buffers = []
        for buf in js.get("buffers", []):
            uri = buf["uri"]
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            elif read_uri is None:
                raise ValueError(f"external buffer {uri!r} needs read_uri")
            else:
                buffers.append(read_uri(uri))
    g = _Gltf(js, buffers)

    # --- materials + textures ----------------------------------------
    packer = AtlasPacker(atlas_size)
    mat_records = []
    for mat in js.get("materials", [{}]):
        pbr = mat.get("pbrMetallicRoughness", {})
        rec = {
            "base_color": list(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            "emissive": list(mat.get("emissiveFactor", [0, 0, 0])) + [1.0],
            # perceptual -> linear roughness
            "roughness": float(pbr.get("roughnessFactor", 1.0)) ** 2,
            "metallic": float(pbr.get("metallicFactor", 1.0)),
            "reflectance": 0.5,
            "alpha_blend": 1 if mat.get("alphaMode") == "BLEND" else 0,
        }
        tex = pbr.get("baseColorTexture")
        src = None if tex is None else js["textures"][tex["index"]].get("source")
        if src is not None:
            if src not in packer.rects:
                img = decode_image(g.image_bytes(src), srgb=True)
                packer.add(src, fit_texture(img, max_texture_size))
            rec["base_color_tex"] = list(map(float, packer.rects[src]))
        mat_records.append(rec)
    packer.alloc.close()
    if not mat_records:
        mat_records = [{}]

    # --- geometry ----------------------------------------------------
    b = MeshBuilder()
    roots = js["scenes"][js.get("scene", 0)]["nodes"]

    def walk(node_idx, parent):
        node = js["nodes"][node_idx]
        xform = parent @ _node_transform(node)
        if "mesh" in node:
            for prim in js["meshes"][node["mesh"]]["primitives"]:
                attrs = prim["attributes"]
                pos = g.accessor(attrs["POSITION"]).astype(np.float32)
                nrm = g.accessor(attrs["NORMAL"]).astype(np.float32) if "NORMAL" in attrs else None
                uv = (
                    g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else None
                )
                if "indices" in prim:
                    idx = g.accessor(prim["indices"]).reshape(-1, 3)
                else:
                    idx = np.arange(len(pos)).reshape(-1, 3)
                b.add_mesh(pos, idx, material_id=prim.get("material", 0), normals=nrm, uvs=uv,
                           transform=xform)
        for child in node.get("children", []):
            walk(child, xform)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))

    geometry = b.build(device)
    materials = make_materials(mat_records, device=device)
    return Scene(
        geometry=geometry,
        materials=materials,
        lights=make_lights(lights or [], capacity=light_capacity, device=device),
        atlas=make_atlas(torch.tensor(packer.image, device=device)) if packer.rects else None,
        sun_azimuth=float(sun_azimuth),
        sun_altitude=float(sun_altitude),
        has_alpha=any(r.get("alpha_blend") for r in mat_records),
        **compute_static_flags(geometry, materials),
    )


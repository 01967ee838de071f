"""Minimal glTF 2.0 / GLB loader -> Scene (port of strolle_tpu/scene/gltf.py).

Node-hierarchy transforms with inverse-transpose normals,
pbrMetallicRoughness -> Material (perceptual roughness squared to
linear), and base-colour textures packed into one atlas with normalised
rects by the native guillotine allocator (``strolle_tpu_torch.native``,
the JAX package's allocator, so rects match). Textures are decoded by
``scene/png.py`` and taken to linear colour with the JAX loader's
``** 2.2``. Textures larger than ``max_texture_size`` would need a
resize, which is not ported: they raise NotImplementedError.
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
from .png import decode_png
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
    """PNG bytes -> f32 RGBA [H, W, 4] in [0, 1], RGB raised to 2.2 when
    ``srgb`` (the JAX loader's linearisation)."""
    a = decode_png(raw).astype(np.float32) / 255.0
    if srgb:
        a[..., :3] = a[..., :3] ** 2.2
    return a


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
    image = np.zeros((atlas_size, atlas_size, 4), np.float32)
    rects: dict = {}
    mat_records = []
    with native.AtlasAllocator(atlas_size, atlas_size) as alloc:
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
                if src not in rects:
                    img = decode_image(g.image_bytes(src), srgb=True)
                    if max(img.shape[:2]) > max_texture_size:
                        raise NotImplementedError(
                            f"texture {img.shape[1]}x{img.shape[0]} > max_texture_size="
                            f"{max_texture_size}: resizing is not ported"
                        )
                    h, w = img.shape[:2]
                    pos = alloc.alloc(w, h)
                    if pos is None:
                        raise ValueError("atlas full")
                    x, y = pos
                    image[y : y + h, x : x + w] = img
                    rects[src] = np.asarray(
                        [x / atlas_size, y / atlas_size, w / atlas_size, h / atlas_size],
                        np.float32,
                    )
                rec["base_color_tex"] = list(map(float, rects[src]))
            mat_records.append(rec)
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
        atlas=make_atlas(torch.as_tensor(image, device=device)) if rects else None,
        sun_azimuth=float(sun_azimuth),
        sun_altitude=float(sun_altitude),
        has_alpha=any(r.get("alpha_blend") for r in mat_records),
        **compute_static_flags(geometry, materials),
    )


"""Texture decoding for the glTF loader: a small PNG decoder (zlib +
numpy) and PIL for the rest.

``decode_png`` covers non-interlaced images of colour type 0 (grey,
1/2/4/8 bits), 2 (RGB, 8 bits), 3 (palette, 1/2/4/8 bits, with tRNS
alpha), 4 (grey + alpha, 8 bits) and 6 (RGBA, 8 bits), with the five
scanline filters, and returns RGBA8 as PIL's ``convert("RGBA")`` does;
anything else raises NotImplementedError. ``decode_rgba8``, the loader's
entry, hands what ``decode_png`` refuses (JPEG, 16-bit and interlaced
PNGs, tRNS colour keys) to PIL's ``Image.open(...).convert("RGBA")``, as
the JAX loader decodes every texture. PIL is imported on that path
only: it is a host dependency of those textures (and of the viewer's
JPEG stream), not of the port's PNGs.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undoes the per-scanline filters: [height, stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        kind = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # sub: running sum along each byte lane of a pixel
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.int64)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) % 256).reshape(-1)[:stride]
        elif kind == 2:  # up
            cur = (line + prior) % 256
        elif kind in (3, 4):  # average, paeth: sequential along the line
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prior[i])
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    pred = _paeth(a, b, int(prior[i - bpp]) if i >= bpp else 0)
                cur[i] = (int(line[i]) + pred) % 256
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Packed scanlines -> [height, width * channels] sample values."""
    if depth == 8:
        return rows[:, : width * channels]
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per_byte)[:, : width * channels]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGBA [height, width, 4]."""
    header = None
    palette = None
    trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _compression, _filter, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise NotImplementedError(f"PNG colour type {color} at {depth} bits is not supported")
    if interlace:
        raise NotImplementedError("interlaced PNG is not supported")
    if trns is not None and color != 3:
        raise NotImplementedError("PNG tRNS colour keys on grey or RGB images are not supported")
    channels = _CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, bpp)
    s = _samples(rows, width, channels, depth).reshape(height, width, channels)
    rgba = np.empty((height, width, 4), np.uint8)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        alpha = np.full(palette.shape[0], 255, np.uint8)
        if trns is not None:
            alpha[: trns.shape[0]] = trns[: palette.shape[0]]
        idx = s[..., 0]
        rgba[..., :3] = palette[idx]
        rgba[..., 3] = alpha[idx]
    elif color in (0, 4):
        grey = s[..., 0].astype(np.int64) * 255 // ((1 << depth) - 1)
        rgba[..., :3] = grey[..., None].astype(np.uint8)
        rgba[..., 3] = s[..., 1] if color == 4 else 255
    else:
        rgba[..., :3] = s[..., :3]
        rgba[..., 3] = s[..., 3] if color == 6 else 255
    return rgba


def decode_rgba8(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 RGBA [height, width, 4]: ``decode_png`` where
    it takes the image, else PIL's ``convert("RGBA")``."""
    if data[:8] == _SIGNATURE:
        try:
            return decode_png(data)
        except NotImplementedError:
            pass
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGBA"), np.uint8)

"""ctypes bindings to the C++ host runtime (port of
strolle_tpu/native/__init__.py, for the two pieces the port uses: the
binned-SAH BVH builder and the guillotine atlas allocator).

``native/strolle_native.cpp`` is compiled as it stands with ONE ``g++``
command (the flags of ``native/Makefile``) into ``strolle_tpu_torch/_build/``
under a name that hashes the source and the flags, so an edited source is
never served by a stale build. Nothing is built when this module is
imported, and nothing is written outside ``_build/``. A failed build
raises: the port has no numpy fallback builder yet.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "strolle_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"

#: The flags of native/Makefile: the same compiler and flags give the same
#: floating-point BVH as the JAX package's build of the same source.
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fvisibility=hidden", "-Wall"]


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    return found


def build() -> Path:
    """Compiles the native host library (reused when it already exists)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libstrolle_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_gxx(), *GXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32 = ctypes.c_int32
    p = ctypes.c_void_p
    lib.strolle_bvh_build.restype = ctypes.c_int
    lib.strolle_bvh_build.argtypes = [
        f32p, ctypes.c_int, f32p, f32p, i32p, i32p, i32p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.strolle_atlas_new.restype = p
    lib.strolle_atlas_new.argtypes = [i32, i32]
    lib.strolle_atlas_free.restype = None
    lib.strolle_atlas_free.argtypes = [p]
    lib.strolle_atlas_alloc.restype = ctypes.c_int
    lib.strolle_atlas_alloc.argtypes = [p, i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    return lib


def bvh_build(positions: np.ndarray):
    """Binned-SAH build over ``positions`` [T, 3, 3] f32. Returns
    (child_min, child_max, child, child_count, order, max_depth) as numpy
    arrays trimmed to the node count; ``order`` is the int64 permutation
    the caller applies to its triangle arrays."""
    lib = library()
    positions = np.ascontiguousarray(positions, np.float32)
    t = positions.shape[0]
    max_nodes = max(2 * t, 16)
    cmin = np.empty((max_nodes, 2, 3), np.float32)
    cmax = np.empty((max_nodes, 2, 3), np.float32)
    child = np.empty((max_nodes, 2), np.int32)
    count = np.empty((max_nodes, 2), np.int32)
    order = np.empty((t,), np.int32)
    depth = ctypes.c_int(0)
    n = lib.strolle_bvh_build(
        positions.reshape(-1, 9), t, cmin.reshape(-1, 6), cmax.reshape(-1, 6),
        child, count, order, max_nodes, ctypes.byref(depth),
    )
    if n < 0:
        raise RuntimeError(f"strolle_bvh_build failed ({n}) on {t} triangles")
    return (
        cmin[:n].copy(), cmax[:n].copy(), child[:n].copy(), count[:n].copy(),
        order.astype(np.int64), int(depth.value),
    )


class AtlasAllocator:
    """2-D guillotine allocator for the texture atlas (the native one the
    JAX package's glTF loader packs with, so rects match exactly)."""

    def __init__(self, width: int, height: int):
        self._lib = library()
        self._h = self._lib.strolle_atlas_new(width, height)

    def close(self) -> None:
        if self._h is not None:
            self._lib.strolle_atlas_free(self._h)
            self._h = None

    def __enter__(self) -> "AtlasAllocator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def alloc(self, w: int, h: int) -> tuple[int, int] | None:
        """Top-left corner of a free w x h rect, or None when full."""
        x = ctypes.c_int32(0)
        y = ctypes.c_int32(0)
        ok = self._lib.strolle_atlas_alloc(self._h, w, h, ctypes.byref(x), ctypes.byref(y))
        return None if ok != 0 else (int(x.value), int(y.value))

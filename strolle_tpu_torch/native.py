"""ctypes bindings to the C++ host runtime (port of
strolle_tpu/native/__init__.py): the binned-SAH BVH builder, its
incremental form with cross-frame subtree reuse, the in-place BVH refit,
the range allocator, the guillotine atlas allocator and the instance
triangle transform.

``native/strolle_native.cpp`` is compiled as it stands with ONE ``g++``
command (the flags of ``native/Makefile``) into ``strolle_tpu_torch/_build/``
under a name that hashes the source and the flags, so an edited source is
never served by a stale build. Nothing is built when this module is
imported, and nothing is written outside ``_build/``. A failed build
raises: unlike the JAX package, the port has no pure-Python fallbacks
(``bvh.builder.build_bvh_numpy`` is the SAH-quality oracle, never a
substitute).
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
    lib.strolle_atlas_dealloc.restype = None
    lib.strolle_atlas_dealloc.argtypes = [p, i32, i32, i32, i32]
    lib.strolle_bvh_refit.restype = ctypes.c_int
    lib.strolle_bvh_refit.argtypes = [f32p, ctypes.c_int, f32p, f32p, i32p, i32p, ctypes.c_int]
    lib.strolle_bvh_ctx_new.restype = p
    lib.strolle_bvh_ctx_new.argtypes = []
    lib.strolle_bvh_ctx_free.restype = None
    lib.strolle_bvh_ctx_free.argtypes = [p]
    lib.strolle_bvh_build_incremental.restype = ctypes.c_int
    lib.strolle_bvh_build_incremental.argtypes = [
        p, f32p, ctypes.c_int, f32p, f32p, i32p, i32p, i32p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    i64 = ctypes.c_int64
    lib.strolle_alloc_new.restype = p
    lib.strolle_alloc_new.argtypes = []
    lib.strolle_alloc_free.restype = None
    lib.strolle_alloc_free.argtypes = [p]
    lib.strolle_alloc_take.restype = i64
    lib.strolle_alloc_take.argtypes = [p, i64]
    lib.strolle_alloc_give.restype = None
    lib.strolle_alloc_give.argtypes = [p, i64, i64]
    lib.strolle_alloc_free_ranges.restype = i64
    lib.strolle_alloc_free_ranges.argtypes = [p]
    lib.strolle_transform_triangles.restype = ctypes.c_int
    lib.strolle_transform_triangles.argtypes = [f32p, f32p, ctypes.c_int, f32p]
    return lib


def available() -> bool:
    """Whether the host library builds and loads here (``library``
    raises where it does not)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _node_buffers(t: int):
    max_nodes = max(2 * t, 16)
    return (
        np.empty((max_nodes, 2, 3), np.float32), np.empty((max_nodes, 2, 3), np.float32),
        np.empty((max_nodes, 2), np.int32), np.empty((max_nodes, 2), np.int32),
        np.empty((t,), np.int32), max_nodes,
    )


def _trimmed(n, cmin, cmax, child, count, order, depth):
    return (
        cmin[:n].copy(), cmax[:n].copy(), child[:n].copy(), count[:n].copy(),
        order.astype(np.int64), int(depth.value),
    )


def bvh_build(positions: np.ndarray):
    """Binned-SAH build over ``positions`` [T, 3, 3] f32. Returns
    (child_min, child_max, child, child_count, order, max_depth) as numpy
    arrays trimmed to the node count; ``order`` is the int64 permutation
    the caller applies to its triangle arrays."""
    lib = library()
    positions = np.ascontiguousarray(positions, np.float32)
    t = positions.shape[0]
    cmin, cmax, child, count, order, max_nodes = _node_buffers(t)
    depth = ctypes.c_int(0)
    n = lib.strolle_bvh_build(
        positions.reshape(-1, 9), t, cmin.reshape(-1, 6), cmax.reshape(-1, 6),
        child, count, order, max_nodes, ctypes.byref(depth),
    )
    if n < 0:
        raise RuntimeError(f"strolle_bvh_build failed ({n}) on {t} triangles")
    return _trimmed(n, cmin, cmax, child, count, order, depth)


class BvhContext:
    """Stateful incremental builder: subtrees whose triangles hash the same
    as in the previous build are copied instead of re-split. ``build``
    keeps ``bvh_build``'s contract; ``last_reused`` is the number of node
    rows the last build copied."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.strolle_bvh_ctx_new()
        self.last_reused = 0

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.strolle_bvh_ctx_free(self._h)
            self._h = None

    def build(self, positions: np.ndarray):
        positions = np.ascontiguousarray(positions, np.float32)
        t = positions.shape[0]
        cmin, cmax, child, count, order, max_nodes = _node_buffers(t)
        depth = ctypes.c_int(0)
        reused = ctypes.c_int(0)
        n = self._lib.strolle_bvh_build_incremental(
            self._h, positions.reshape(-1, 9), t, cmin.reshape(-1, 6), cmax.reshape(-1, 6),
            child, count, order, max_nodes, ctypes.byref(depth), ctypes.byref(reused),
        )
        if n < 0:
            raise RuntimeError(f"strolle_bvh_build_incremental failed ({n}) on {t} triangles")
        self.last_reused = int(reused.value)
        return _trimmed(n, cmin, cmax, child, count, order, depth)


def bvh_refit(positions, child_min, child_max, child, child_count) -> None:
    """Recomputes the child boxes of a BVH in place (``child_min``,
    ``child_max`` numpy f32 [N, 2, 3]) for moved vertices, topology
    unchanged. ``positions`` is the reordered [T, 3, 3] array the leaf
    ranges index."""
    positions = np.ascontiguousarray(positions, np.float32)
    library().strolle_bvh_refit(
        positions.reshape(-1, 9), positions.shape[0], child_min.reshape(-1, 6),
        child_max.reshape(-1, 6), np.ascontiguousarray(child, np.int32),
        np.ascontiguousarray(child_count, np.int32), child.shape[0],
    )


class RangeAllocator:
    """Free-range recycling for slot or triangle storage: ``take`` a run
    of ``length`` ids, ``give`` one back; free ranges merge on a miss."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.strolle_alloc_new()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.strolle_alloc_free(self._h)
            self._h = None

    def take(self, length: int) -> int | None:
        r = self._lib.strolle_alloc_take(self._h, length)
        return None if r < 0 else int(r)

    def give(self, start: int, length: int) -> None:
        self._lib.strolle_alloc_give(self._h, start, length)

    def num_free_ranges(self) -> int:
        return int(self._lib.strolle_alloc_free_ranges(self._h))


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

    def __del__(self):
        self.close()

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

    def dealloc(self, x: int, y: int, w: int, h: int) -> None:
        """Frees the w x h rect at (x, y) for later allocations."""
        self._lib.strolle_atlas_dealloc(self._h, x, y, w, h)


def transform_triangles(positions: np.ndarray, normals: np.ndarray, matrix: np.ndarray):
    """Applies the row-major 4x4 affine ``matrix`` to [T, 3, 3] positions
    and normals (inverse-transpose, renormalised, for normals). Returns
    new arrays. A matrix whose 3x3 determinant is below 1e-30, which the
    library refuses, takes numpy's inverse as the JAX package's does."""
    positions = np.ascontiguousarray(positions, np.float32).copy()
    normals = np.ascontiguousarray(normals, np.float32).copy()
    m = np.ascontiguousarray(matrix, np.float32)
    if not positions.size:
        return positions, normals
    rc = library().strolle_transform_triangles(
        positions.reshape(-1, 9), normals.reshape(-1, 9), positions.shape[0], m.reshape(-1)
    )
    if rc == 0:
        return positions, normals
    positions = positions @ m[:3, :3].T + m[:3, 3]
    nm = np.linalg.inv(m[:3, :3]).T
    normals = normals @ nm.T
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    return positions, normals

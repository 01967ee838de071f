"""Host-side dynamic scene management: the engine facade (port of
strolle_tpu/scene/dynamics.py).

A ``SceneEditor`` holds the scene as host records that the caller edits
between frames: meshes and their instances, triangle-soup instances,
materials in stable slots, images in a shared texture atlas, and lights,
with the sun in the reserved slot 0 (its colour the transmittance LUT's,
read on the host). ``tick()`` turns the edits into the next frame's
``Scene``:

- geometry changes rebuild the BVH through the native incremental
  builder (subtrees whose triangles did not change are copied);
  transform-only edits refit the boxes in place instead, up to
  ``max_refit_streak`` refits in a row, then a full rebuild restores the
  split quality;
- triangles are padded with zero-area rows up to a bucket (at least 256,
  doubling) and nodes with empty leaves, and ``max_depth`` is pinned to
  at least 48, so the shapes the kernels see change rarely;
- a removed light compacts the slots behind it and marks the dead slot
  ``killed`` and each moved slot's old id with its new one (``remap``)
  for exactly one frame, so that the reservoirs in flight stay valid;
- each instance's previous transform gives ``Scene.motion``, the
  previous-of-current affine that the primary pass's velocity uses.

The host records stay numpy; every tensor of an emitted Scene is a copy
on the editor's device, so the in-place refits and the dynamic images'
rewrites of later ticks never reach a Scene already handed out.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Hashable

import numpy as np
import torch

from .. import native
from ..bvh.builder import BvhArrays, build_bvh, pad_nodes
from ..device import resolve_device
from ..sky.atmosphere import SUN_DISTANCE, luts_for, sun_color, sun_direction
from ..utils import metrics
from .gltf import AtlasPacker
from .types import (
    LIGHT_POINT,
    Geometry,
    Lights,
    Motion,
    Scene,
    compute_static_flags,
    make_atlas,
    make_materials,
)

_SUN_HANDLE = "__sun__"
#: The traversal stack depth the editor's BVHs promise at least.
MIN_MAX_DEPTH = 48
_LIGHT_FIELDS = ("pos", "radius", "color", "range", "kind", "spot_dir", "spot_angle")
_IMAGE_TEXTURES = (
    ("base_color_image", "base_color_tex"),
    ("emissive_image", "emissive_tex"),
    ("metallic_roughness_image", "metallic_roughness_tex"),
    ("normal_map_image", "normal_map_tex"),
)


@dataclasses.dataclass
class _LightRec:
    pos: np.ndarray
    radius: float
    color: np.ndarray
    range: float
    kind: int
    spot_dir: np.ndarray
    spot_angle: float
    #: last frame's values of the fields that changed this frame
    prev: dict = dataclasses.field(default_factory=dict)

    def as_prev(self) -> dict:
        return {k: getattr(self, k) for k in _LIGHT_FIELDS}


@dataclasses.dataclass
class _InstanceRec:
    """A triangle-soup instance, baked to world space at insertion."""

    positions: np.ndarray  # [T, 3, 3] world space
    normals: np.ndarray
    uvs: np.ndarray
    material_id: int
    #: the transform the positions were baked with (None = identity) and
    #: the one in effect last frame
    transform: np.ndarray | None = None
    prev_transform: np.ndarray | None = None


@dataclasses.dataclass
class _MeshRec:
    positions: np.ndarray  # [T, 3, 3] object space
    normals: np.ndarray
    uvs: np.ndarray


@dataclasses.dataclass
class _MeshInstanceRec:
    """An instance of a mesh asset, resolved to world space at tick;
    skipped (and retried next tick) while its mesh or material is
    missing."""

    mesh: Hashable
    material: Hashable | int
    transform: np.ndarray | None
    prev_transform: np.ndarray | None = None


@dataclasses.dataclass
class _ImageRec:
    source: np.ndarray  # [H, W, 4] linear f32, the caller's array
    rect: np.ndarray  # normalised atlas rect [x, y, w, h]
    xy: tuple[int, int]
    dynamic: bool = False


def _prev_of_curr_affine(prev: np.ndarray | None, curr: np.ndarray | None) -> np.ndarray:
    """Row-major 3x4 affine taking a current world position to the
    previous one: prev_xform @ inv(curr_xform)."""
    ident = np.eye(3, 4, dtype=np.float32)
    if prev is None and curr is None:
        return ident
    p = np.eye(4, dtype=np.float32) if prev is None else np.asarray(prev)
    c = np.eye(4, dtype=np.float32) if curr is None else np.asarray(curr)
    if p.shape == c.shape and np.allclose(p, c):
        return ident
    return (p @ np.linalg.inv(c)).astype(np.float32)[:3, :4]


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _face_normals(positions: np.ndarray) -> np.ndarray:
    n = np.cross(positions[:, 1] - positions[:, 0], positions[:, 2] - positions[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return np.repeat(n[:, None, :], 3, axis=1)


class SceneEditor:
    """The scene as edits between frames; ``tick()`` emits each frame's
    Scene on ``device`` (the CUDA card unless given, as every entry
    point)."""

    def __init__(
        self,
        materials: list[dict] | None = None,
        light_capacity: int = 16,
        sun_azimuth: float = 0.0,
        sun_altitude: float = -1.0,
        atlas: np.ndarray | None = None,
        atlas_size: int = 2048,
        device=None,
    ):
        self.device = resolve_device(device)
        self._materials = materials or [{}]
        self._atlas = atlas
        self._light_capacity = light_capacity
        self.sun_azimuth = sun_azimuth
        self.sun_altitude = sun_altitude

        self._instances: dict[Hashable, _InstanceRec] = {}
        self._geometry_dirty = True
        #: transform-only edits take the refit path instead of a rebuild
        self._transforms_dirty = False
        self._refit_streak = 0
        #: refits in a row before a full rebuild restores the SAH quality
        #: (refitted boxes only grow)
        self.max_refit_streak = 15
        self.stats = {"bvh_rebuilds": 0, "bvh_refits": 0, "bvh_nodes_reused": 0}
        self._bvh_ctx: native.BvhContext | None = None
        self._bvh: BvhArrays | None = None
        self._geometry: Geometry | None = None
        self._clusters = None

        self._meshes: dict[Hashable, _MeshRec] = {}
        self._mesh_instances: dict[Hashable, _MeshInstanceRec] = {}

        # material handle -> stable slot, so ids baked into instances hold
        self._material_index: dict[Hashable, int] = {}
        self._material_free: list[int] = []
        self._materials_dirty = True
        self._materials_dev = None

        self._images: dict[Hashable, _ImageRec] = {}
        self._atlas_packer: AtlasPacker | None = None
        self._atlas_size = atlas_size
        self._atlas_dirty = True
        self._atlas_dev = None

        # light slots: slot 0 is the sun's
        self._light_slots: list[tuple[Hashable, _LightRec]] = [(_SUN_HANDLE, self._make_sun())]
        self._light_index: dict[Hashable, int] = {_SUN_HANDLE: 0}
        self._killed: set[int] = set()
        self._remapped: dict[Hashable, int] = {}  # handle -> old slot
        self.frame = 0

    # -- lights ---------------------------------------------------------

    def _make_sun(self) -> _LightRec:
        sun_dir = sun_direction(self.sun_azimuth, self.sun_altitude, device="cpu").numpy()
        if self.sun_altitude > -0.3:
            luts = luts_for(self.sun_altitude, self.device)
            d = torch.tensor(sun_dir, device=self.device)[None]
            color = sun_color(luts, d)[0].cpu().numpy()
        else:
            color = np.zeros(3, np.float32)
        return _LightRec(
            pos=(sun_dir * SUN_DISTANCE).astype(np.float32),
            radius=25.0,
            color=color.astype(np.float32),
            range=np.inf,
            kind=LIGHT_POINT,
            spot_dir=np.asarray([0, -1, 0], np.float32),
            spot_angle=0.0,
        )

    def update_sun(self, azimuth: float | None = None, altitude: float | None = None):
        if azimuth is not None:
            self.sun_azimuth = float(azimuth)
        if altitude is not None:
            self.sun_altitude = float(altitude)
        new = self._make_sun()
        new.prev = self._light_slots[0][1].as_prev()
        self._light_slots[0] = (_SUN_HANDLE, new)

    def insert_light(self, handle: Hashable, **kw):
        """Adds a light, or updates it (keeping last frame's values as its
        previous copy); fields as ``make_lights`` takes them."""
        rec = _LightRec(
            pos=np.asarray(kw.get("pos", [0, 0, 0]), np.float32),
            radius=float(kw.get("radius", 0.1)),
            color=np.asarray(kw.get("color", [1, 1, 1]), np.float32),
            range=float(kw.get("range", np.inf)),
            kind=int(kw.get("kind", LIGHT_POINT)),
            spot_dir=np.asarray(kw.get("spot_dir", [0, -1, 0]), np.float32),
            spot_angle=float(kw.get("spot_angle", 0.0)),
        )
        if handle in self._light_index:
            slot = self._light_index[handle]
            rec.prev = self._light_slots[slot][1].as_prev()
            self._light_slots[slot] = (handle, rec)
        else:
            slot = len(self._light_slots)
            if slot >= self._light_capacity:
                raise ValueError(f"light capacity {self._light_capacity} exceeded")
            self._light_slots.append((handle, rec))
            self._light_index[handle] = slot

    def remove_light(self, handle: Hashable):
        """Compacting removal: the dead slot is marked killed and every
        slot behind it moves down one, its old id remapped, for one
        frame. The sun cannot be removed."""
        if handle not in self._light_index or handle == _SUN_HANDLE:
            return
        slot = self._light_index.pop(handle)
        self._light_slots.pop(slot)
        self._killed.add(slot)
        for h, s in list(self._light_index.items()):
            if s > slot:
                self._remapped.setdefault(h, s)
                self._light_index[h] = s - 1

    def _build_lights(self) -> Lights:
        cap = self._light_capacity

        def col(name, shape, dtype=np.float32, prev=False):
            out = np.zeros((cap,) + shape, dtype)
            for i, (_, rec) in enumerate(self._light_slots):
                cur = getattr(rec, name)
                out[i] = rec.prev.get(name, cur) if prev else cur
            return torch.tensor(out, device=self.device)

        remap = np.full((cap,), -1, np.int32)
        killed = np.zeros((cap,), np.int32)
        for h, old_slot in self._remapped.items():
            if old_slot < cap and h in self._light_index:
                remap[old_slot] = self._light_index[h]
        for s in self._killed:
            if s < cap:
                killed[s] = 1
        shapes = {"pos": (3,), "color": (3,), "spot_dir": (3,)}
        fields = {}
        for name in _LIGHT_FIELDS:
            dtype = np.int32 if name == "kind" else np.float32
            shape = shapes.get(name, ())
            fields[name] = col(name, shape, dtype)
            fields["prev_" + name] = col(name, shape, dtype, prev=True)
        return Lights(
            **fields,
            remap=torch.tensor(remap, device=self.device),
            killed=torch.tensor(killed, device=self.device),
            count=len(self._light_slots),
        )

    # -- meshes ---------------------------------------------------------

    def insert_mesh(self, handle: Hashable, positions: np.ndarray,
                    normals: np.ndarray | None = None, uvs: np.ndarray | None = None):
        """Adds or replaces a mesh asset ([T, 3, 3] object-space
        positions; face normals and zero uvs by default)."""
        positions = np.asarray(positions, np.float32)
        if normals is None:
            normals = _face_normals(positions)
        uvs = (np.zeros((positions.shape[0], 3, 2), np.float32) if uvs is None
               else np.asarray(uvs, np.float32))
        self._meshes[handle] = _MeshRec(positions, np.asarray(normals, np.float32), uvs)
        # instances of this mesh resolve (again) next tick
        if any(r.mesh == handle for r in self._mesh_instances.values()):
            self._geometry_dirty = True

    def remove_mesh(self, handle: Hashable):
        if self._meshes.pop(handle, None) is not None and any(
            r.mesh == handle for r in self._mesh_instances.values()
        ):
            self._geometry_dirty = True

    # -- materials ------------------------------------------------------

    def insert_material(self, handle: Hashable, **props) -> int:
        """Adds or updates a material; returns its stable slot (a freed
        slot is reused first)."""
        if handle in self._material_index:
            slot = self._material_index[handle]
            self._materials[slot] = props
        elif self._material_free:
            slot = self._material_free.pop()
            self._materials[slot] = props
            self._material_index[handle] = slot
        else:
            slot = len(self._materials)
            self._materials.append(props)
            self._material_index[handle] = slot
        self._materials_dirty = True
        return slot

    def has_material(self, handle: Hashable) -> bool:
        return handle in self._material_index

    def remove_material(self, handle: Hashable):
        slot = self._material_index.pop(handle, None)
        if slot is not None:
            self._materials[slot] = {}
            self._material_free.append(slot)
            self._materials_dirty = True

    def _material_slot(self, ref: Hashable | int) -> int | None:
        if isinstance(ref, int):
            return ref
        return self._material_index.get(ref)

    # -- images in the texture atlas ------------------------------------

    def _packer(self) -> AtlasPacker:
        if self._atlas_packer is None:
            self._atlas_packer = AtlasPacker(self._atlas_size)
        return self._atlas_packer

    def insert_image(self, handle: Hashable, image: np.ndarray, dynamic: bool = False):
        """Packs an [H, W, 4] linear-f32 image into the atlas (a full
        atlas logs a warning and skips it). A ``dynamic`` image is copied
        from the caller's array again every tick, so in-place edits show
        up next frame."""
        img = np.asarray(image, np.float32)
        if handle in self._images:
            self.remove_image(handle)
        packer = self._packer()
        try:
            packer.add(handle, img)
        except ValueError:
            logging.getLogger(__name__).warning("atlas full; skipping image %r", handle)
            return
        rect = packer.rects[handle]
        x = int(round(rect[0] * self._atlas_size))
        y = int(round(rect[1] * self._atlas_size))
        self._images[handle] = _ImageRec(source=image, rect=rect, xy=(x, y), dynamic=dynamic)
        self._atlas_dirty = True
        self._materials_dirty = True  # rects may resolve differently

    def remove_image(self, handle: Hashable):
        rec = self._images.pop(handle, None)
        if rec is None:
            return
        packer = self._packer()
        x, y = rec.xy
        h, w = rec.source.shape[:2]
        packer.alloc.dealloc(x, y, w, h)
        packer.image[y : y + h, x : x + w] = 0.0
        packer.rects.pop(handle, None)
        self._atlas_dirty = True
        self._materials_dirty = True

    def mark_image_dynamic(self, handle: Hashable):
        if handle in self._images:
            self._images[handle].dynamic = True

    def _resolve_material_textures(self) -> list[dict]:
        """Material records with image handles resolved to atlas rects."""
        out = []
        for rec in self._materials:
            rec = dict(rec)
            for img_key, tex_key in _IMAGE_TEXTURES:
                handle = rec.pop(img_key, None)
                if handle is not None and handle in self._images:
                    rec[tex_key] = self._images[handle].rect
            out.append(rec)
        return out

    # -- instances ------------------------------------------------------

    def insert_instance(
        self,
        handle: Hashable,
        positions: np.ndarray | None = None,
        material_id: int = 0,
        normals: np.ndarray | None = None,
        uvs: np.ndarray | None = None,
        transform: np.ndarray | None = None,
        mesh: Hashable | None = None,
        material: Hashable | int | None = None,
    ):
        """Adds or replaces an instance: a triangle soup (``positions``
        [T, 3, 3], baked now through ``transform``, normals by its
        inverse transpose), or a reference to a mesh asset (``mesh=``)
        resolved at tick. Re-inserting a mesh instance with the same mesh
        and material is a transform-only edit (the refit path); a
        re-inserted instance keeps last frame's transform as its previous
        one, a new one starts at rest."""
        if mesh is not None:
            old = self._mesh_instances.get(handle)
            curr = None if transform is None else np.asarray(transform, np.float32)
            mat_ref = material if material is not None else material_id
            self._mesh_instances[handle] = _MeshInstanceRec(
                mesh=mesh, material=mat_ref, transform=curr,
                prev_transform=old.transform if old is not None else curr,
            )
            self._instances.pop(handle, None)
            if old is not None and old.mesh == mesh and old.material == mat_ref:
                self._transforms_dirty = True
            else:
                self._geometry_dirty = True
            return
        positions = np.asarray(positions, np.float32)
        normals = _face_normals(positions) if normals is None else normals
        normals = np.asarray(normals, np.float32)
        uvs = (np.zeros((positions.shape[0], 3, 2), np.float32) if uvs is None
               else np.asarray(uvs, np.float32))
        curr_xf = None
        if transform is not None:
            curr_xf = np.asarray(transform, np.float32)
            positions, normals = native.transform_triangles(positions, normals, curr_xf)
        old = self._instances.get(handle)
        self._instances[handle] = _InstanceRec(
            positions, normals, uvs, material_id, transform=curr_xf,
            prev_transform=old.transform if old is not None else curr_xf,
        )
        self._geometry_dirty = True

    def remove_instance(self, handle: Hashable):
        a = self._instances.pop(handle, None) is not None
        b = self._mesh_instances.pop(handle, None) is not None
        if a or b:
            self._geometry_dirty = True

    def _resolved_mesh_instances(self):
        """(handle, world positions, normals, uvs, material slot) of the
        mesh instances whose mesh and material are present."""
        for handle, rec in self._mesh_instances.items():
            mesh = self._meshes.get(rec.mesh)
            mat = self._material_slot(rec.material)
            if mesh is None or mat is None:
                continue
            pos, nrm = mesh.positions, mesh.normals
            if rec.transform is not None:
                pos, nrm = native.transform_triangles(pos, nrm, rec.transform)
            yield handle, pos, nrm, mesh.uvs, mat

    def _build_geometry(self):
        parts_p, parts_n, parts_u, parts_m, parts_i = [], [], [], [], []
        motion_handles: list[tuple[str, Hashable]] = []

        def add(kind, handle, pos, nrm, uv, mat):
            parts_p.append(pos)
            parts_n.append(nrm)
            parts_u.append(uv)
            parts_m.append(np.full(len(pos), mat, np.int32))
            parts_i.append(np.full(len(pos), len(motion_handles), np.int32))
            motion_handles.append((kind, handle))

        for handle, rec in self._instances.items():
            add("soup", handle, rec.positions, rec.normals, rec.uvs, rec.material_id)
        resolved = list(self._resolved_mesh_instances())
        for handle, pos, nrm, uv, mat in resolved:
            add("mesh", handle, pos, nrm, uv, mat)
        # an instance whose mesh or material is missing retries next tick
        pending = len(resolved) < len(self._mesh_instances)
        if not parts_p:
            parts_p = [np.zeros((1, 3, 3), np.float32)]
            parts_n = [np.zeros((1, 3, 3), np.float32)]
            parts_u = [np.zeros((1, 3, 2), np.float32)]
            parts_m = [np.zeros(1, np.int32)]
            parts_i = [np.zeros(1, np.int32)]
        pos = np.concatenate(parts_p)
        nrm = np.concatenate(parts_n)
        uv = np.concatenate(parts_u)
        mid = np.concatenate(parts_m)
        iid = np.concatenate(parts_i)

        if self._bvh_ctx is None:
            self._bvh_ctx = native.BvhContext()
        arrays, order = build_bvh(pos, "cpu", ctx=self._bvh_ctx)
        self.stats["bvh_nodes_reused"] += self._bvh_ctx.last_reused
        pos, nrm, uv, mid, iid = pos[order], nrm[order], uv[order], mid[order], iid[order]

        # zero-area rows up to the bucket; they map to the trailing
        # identity motion slot
        cap = _bucket(len(pos))
        pad = cap - len(pos)
        if pad:
            pos = np.concatenate([pos, np.zeros((pad, 3, 3), np.float32)])
            nrm = np.concatenate([nrm, np.zeros((pad, 3, 3), np.float32)])
            uv = np.concatenate([uv, np.zeros((pad, 3, 2), np.float32)])
            mid = np.concatenate([mid, np.zeros(pad, np.int32)])
            iid = np.concatenate([iid, np.full(pad, len(motion_handles), np.int32)])

        dev = self.device
        self._motion_handles = motion_handles
        self._instance_ids = iid
        self._geometry = Geometry(
            positions=torch.tensor(pos, device=dev),
            normals=torch.tensor(nrm, device=dev),
            uvs=torch.tensor(uv, device=dev),
            tangents=torch.zeros((cap, 3, 4), dtype=torch.float32, device=dev),
            material_id=torch.tensor(mid, device=dev),
        )
        # the refit path's state: the order and host copies of the nodes
        self._tri_order = np.asarray(order)
        self._live_tris = int(self._tri_order.shape[0])
        self._geom_cap = cap
        self._node_cap = _bucket(arrays.num_nodes)
        self._bvh_np = tuple(
            np.array(x.numpy())
            for x in (arrays.child_min, arrays.child_max, arrays.child, arrays.child_count)
        )
        self._bvh_max_depth = max(arrays.max_depth, MIN_MAX_DEPTH)
        self._refit_streak = 0
        self.stats["bvh_rebuilds"] += 1
        self._bvh = self._device_bvh()
        self._clusters = None  # rebuilt in tick, for big scenes
        self._geometry_dirty = pending

    def _device_bvh(self) -> BvhArrays:
        """The host nodes copied to the device and padded to the bucket."""
        cmin, cmax, child, ccount = (torch.tensor(x, device=self.device) for x in self._bvh_np)
        return pad_nodes(BvhArrays(cmin, cmax, child, ccount, self._bvh_max_depth),
                         self._node_cap)

    def _refit_geometry(self):
        """Transform-only update: the triangles re-transformed, the node
        boxes refitted in place (native ``bvh_refit``), topology and order
        kept. After ``max_refit_streak`` refits in a row, or when the
        triangle count changed after all, a full rebuild."""
        if self._refit_streak >= self.max_refit_streak:
            self._build_geometry()
            return
        parts_p = [rec.positions for rec in self._instances.values()]
        parts_n = [rec.normals for rec in self._instances.values()]
        for _, p, n, _, _ in self._resolved_mesh_instances():
            parts_p.append(p)
            parts_n.append(n)
        pos = np.concatenate(parts_p) if parts_p else np.zeros((1, 3, 3), np.float32)
        nrm = np.concatenate(parts_n) if parts_n else np.zeros((1, 3, 3), np.float32)
        if len(pos) != self._live_tris:
            self._build_geometry()
            return
        pos = pos[self._tri_order]
        nrm = nrm[self._tri_order]
        native.bvh_refit(pos, *self._bvh_np)
        self._refit_streak += 1
        self.stats["bvh_refits"] += 1

        pad = self._geom_cap - len(pos)
        if pad:
            pos = np.concatenate([pos, np.zeros((pad, 3, 3), np.float32)])
            nrm = np.concatenate([nrm, np.zeros((pad, 3, 3), np.float32)])
        self._geometry = dataclasses.replace(
            self._geometry,
            positions=torch.tensor(pos, device=self.device),
            normals=torch.tensor(nrm, device=self.device),
        )
        self._bvh = self._device_bvh()
        self._clusters = None

    def _clusters_for_scene(self):
        """The big-scene kernels' cluster rows, rebuilt only when the BVH
        changed; None for scenes the brute-force kernels take."""
        from ..ops.kernels.cluster_kernels import clusterize_bvh
        from ..ops.trace import BRUTE_FORCE_MAX_TRIS

        n = self._geometry.num_triangles
        if n <= BRUTE_FORCE_MAX_TRIS:
            return None
        if self._clusters is None:
            self._clusters = clusterize_bvh(self._bvh, n, self._geometry.positions)
        return self._clusters

    def _build_motion(self) -> Motion:
        """Per-instance previous-of-current affines and per-triangle slot
        ids (the trailing slot, the identity, for padded rows)."""
        n = len(self._motion_handles)
        mats = np.tile(np.eye(3, 4, dtype=np.float32).reshape(12), (n + 1, 1))
        for slot, (kind, handle) in enumerate(self._motion_handles):
            rec = (self._instances if kind == "soup" else self._mesh_instances).get(handle)
            if rec is not None:
                mats[slot] = _prev_of_curr_affine(rec.prev_transform, rec.transform).reshape(12)
        return Motion(
            instance_id=torch.tensor(self._instance_ids, device=self.device),
            prev_of_curr=torch.tensor(mats, device=self.device),
        )

    # -- tick -----------------------------------------------------------

    def tick(self) -> Scene:
        """The next frame's Scene: rebuilds or refits what changed, emits
        this frame's kill/remap markers, then commits the previous copies
        of lights and transforms and clears the markers."""
        if self._geometry_dirty:
            with metrics.measure("tick.bvh"):
                self._build_geometry()
        elif self._transforms_dirty:
            with metrics.measure("tick.bvh.refit"):
                self._refit_geometry()
        self._transforms_dirty = False
        with metrics.measure("tick.lights"):
            lights = self._build_lights()

        # dynamic images are copied again every tick; the atlas goes to
        # the device only when it changed
        with metrics.measure("tick.images"):
            for rec in self._images.values():
                if rec.dynamic:
                    x, y = rec.xy
                    src = np.asarray(rec.source, np.float32)
                    h, w = src.shape[:2]
                    self._atlas_packer.image[y : y + h, x : x + w] = src
                    self._atlas_dirty = True
            if self._atlas_dirty:
                if self._images:
                    image = self._atlas_packer.image
                else:
                    image = self._atlas
                self._atlas_dev = (None if image is None else
                                   make_atlas(torch.tensor(image, dtype=torch.float32,
                                                           device=self.device)))
                self._atlas_dirty = False

        if self._materials_dirty:
            with metrics.measure("tick.materials"):
                self._materials_dev = make_materials(self._resolve_material_textures(),
                                                     device=self.device)
            self._materials_dirty = False
        materials = self._materials_dev

        scene = Scene(
            geometry=self._geometry,
            materials=materials,
            lights=lights,
            atlas=self._atlas_dev,
            sun_azimuth=float(self.sun_azimuth),
            sun_altitude=float(self.sun_altitude),
            bvh=self._bvh,
            motion=self._build_motion(),
            clusters=self._clusters_for_scene(),
            has_alpha=any(m.get("alpha_blend") for m in self._materials),
            **compute_static_flags(self._geometry, materials),
        )
        metrics.scene_stats(scene, self.frame)
        # commit: the markers live for exactly one frame
        self._killed.clear()
        self._remapped.clear()
        for _, rec in self._light_slots:
            rec.prev = {}
        for rec in (*self._instances.values(), *self._mesh_instances.values()):
            rec.prev_transform = rec.transform
        self.frame += 1
        return scene

"""Host-side mesh assembly in numpy, feeding Geometry tensors (port of
strolle_tpu/scene/build.py): positions transformed by the model matrix,
normals by its inverse-transpose."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .types import Geometry


class MeshBuilder:
    def __init__(self) -> None:
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.tangents: list[np.ndarray] = []
        self.material_ids: list[int] = []

    def add_triangle(
        self,
        p0, p1, p2,
        material_id: int,
        normals=None,
        uvs=None,
        tangents=None,
    ) -> None:
        p = np.asarray([p0, p1, p2], np.float32)
        if normals is None:
            n = np.cross(p[1] - p[0], p[2] - p[0])
            norm = np.linalg.norm(n)
            n = n / norm if norm > 0 else np.array([0.0, 1.0, 0.0], np.float32)
            normals = np.repeat(n[None, :], 3, axis=0)
        if uvs is None:
            uvs = np.zeros((3, 2), np.float32)
        if tangents is None:
            tangents = np.zeros((3, 4), np.float32)
        self.positions.append(p)
        self.normals.append(np.asarray(normals, np.float32))
        self.uvs.append(np.asarray(uvs, np.float32))
        self.tangents.append(np.asarray(tangents, np.float32))
        self.material_ids.append(material_id)

    def add_quad(self, p0, p1, p2, p3, material_id: int, uvs=None) -> None:
        """Two triangles (p0,p1,p2) and (p0,p2,p3); CCW front face."""
        if uvs is None:
            uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        else:
            uv = np.asarray(uvs, np.float32)
        self.add_triangle(p0, p1, p2, material_id, uvs=uv[[0, 1, 2]])
        self.add_triangle(p0, p2, p3, material_id, uvs=uv[[0, 2, 3]])

    def add_mesh(
        self,
        positions: np.ndarray,  # [V, 3]
        indices: np.ndarray,  # [F, 3]
        material_id: int,
        normals: np.ndarray | None = None,  # [V, 3]
        uvs: np.ndarray | None = None,  # [V, 2]
        tangents: np.ndarray | None = None,  # [V, 4]
        transform: np.ndarray | None = None,  # [4, 4]
    ) -> None:
        positions = np.asarray(positions, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if transform is not None:
            m = np.asarray(transform, np.float32)
            positions = positions @ m[:3, :3].T + m[:3, 3]
            if normals is not None:
                nrm_m = np.linalg.inv(m[:3, :3]).T
                normals = np.asarray(normals, np.float32) @ nrm_m.T
                normals /= np.maximum(
                    np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20
                )
        for tri in indices:
            i0, i1, i2 = (int(i) for i in tri)
            self.add_triangle(
                positions[i0],
                positions[i1],
                positions[i2],
                material_id,
                normals=None
                if normals is None
                else np.asarray([normals[i0], normals[i1], normals[i2]]),
                uvs=None if uvs is None else np.asarray([uvs[i0], uvs[i1], uvs[i2]]),
                tangents=None
                if tangents is None
                else np.asarray([tangents[i0], tangents[i1], tangents[i2]]),
            )

    def build(self, device=None) -> Geometry:
        if not self.positions:
            raise ValueError("empty geometry")
        device = resolve_device(device)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return Geometry(
            positions=t(np.stack(self.positions)),
            normals=t(np.stack(self.normals)),
            uvs=t(np.stack(self.uvs)),
            tangents=t(np.stack(self.tangents)),
            material_id=t(np.asarray(self.material_ids, np.int32), torch.int32),
        )

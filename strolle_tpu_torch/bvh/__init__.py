"""BVH construction (port of strolle_tpu/bvh/__init__.py); the torch
traversal is in bvh/traverse.py."""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import Scene
from .builder import BvhArrays, build_bvh  # noqa: F401


def scene_with_bvh(scene: Scene) -> Scene:
    """Builds the BVH and reorders the geometry so that leaf triangle
    ranges are contiguous, then builds the cluster rows of the big-scene
    kernels."""
    geom = scene.geometry
    arrays, order = build_bvh(geom.positions.detach().cpu().numpy(), geom.positions.device)
    idx = torch.as_tensor(order, device=geom.positions.device)
    geom = dataclasses.replace(
        geom,
        positions=geom.positions[idx],
        normals=geom.normals[idx],
        uvs=geom.uvs[idx],
        tangents=geom.tangents[idx],
        material_id=geom.material_id[idx],
    )
    scene = scene.replace(geometry=geom, bvh=arrays)
    return scene.replace(clusters=build_clusters(scene))


def build_clusters(scene: Scene):
    """Cluster AABB rows [K, 8] of the big-scene kernels, built once per
    BVH; None for scenes the brute-force kernels take."""
    from ..ops.kernels.cluster_kernels import clusterize_bvh
    from ..ops.trace import BRUTE_FORCE_MAX_TRIS

    geom = scene.geometry
    if scene.bvh is None or geom.num_triangles <= BRUTE_FORCE_MAX_TRIS:
        return None
    return clusterize_bvh(scene.bvh, geom.num_triangles, geom.positions.detach())

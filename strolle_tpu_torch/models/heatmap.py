"""The BVH heatmap view (port of strolle_tpu/models/heatmap.py).

One primary ray per pixel, coloured by the bytes its traversal fetched,
on the reference's 4-stop gradient (blue, green, red, black), saturating
at HEATMAP_SCALE bytes per ray.
"""

from __future__ import annotations

import torch

from ..bvh.traverse import TRIANGLE_BYTES, trace_cost_bvh
from ..camera import Camera, pixel_rays, screen_grid
from ..scene.types import Scene

#: The gradient's saturation point, bytes per ray.
HEATMAP_SCALE = 8192.0

_STOPS = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 0.0))


def heatmap_gradient(progress: torch.Tensor) -> torch.Tensor:
    """The 4-stop linear gradient at ``progress`` in [0, 1]: [..., 3]."""
    stops = torch.tensor(_STOPS, dtype=torch.float32, device=progress.device)
    n = stops.shape[0]
    x = torch.clamp(progress, 0.0, 1.0) * (n - 1)
    i = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 2).long()
    f = (x - i.to(torch.float32))[..., None]
    return stops[i] * (1.0 - f) + stops[i + 1] * f


def trace_cost(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bytes each ray's traversal fetches (float32 over o's batch shape):
    the BVH walk's node and triangle fetches where the scene has a BVH;
    else every triangle, which the brute-force trace reads for each ray."""
    if scene.bvh is not None:
        return trace_cost_bvh(scene, o, d).to(torch.float32)
    n = scene.geometry.num_triangles
    return torch.full(o.shape[:-1], float(n * TRIANGLE_BYTES), dtype=torch.float32,
                      device=o.device)


def render_heatmap(scene: Scene, camera: Camera) -> torch.Tensor:
    """The heatmap view: float32 [H, W, 3]."""
    o, d = pixel_rays(camera, screen_grid(camera))
    return heatmap_gradient(trace_cost(scene, o, d) / HEATMAP_SCALE)

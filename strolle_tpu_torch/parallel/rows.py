"""The block of image rows one rank computes in a row-split realtime
frame (``frame_sharding.render_frame_sharded``).

A ``RowBlock`` is passed explicitly through the frame's stages. Every
per-pixel value that derives from a pixel's row (the screen grid, the
RNG streams, the blue noise, the checkerboard parity) takes the global
row ``y0 + i``, and every cross-pixel read (the reprojected history, the
spatial taps, the à-trous stencils) first gathers the whole height of
the arrays it taps (``whole``) and then taps them at global coordinates
for the block's own pixels. ``rows=None`` is the whole image on one
device: no gather, and the stages launch what they always did.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """Rows ``y0 .. y0 + rows - 1`` of an image ``height`` rows high."""

    y0: int
    rows: int
    height: int

    @staticmethod
    def of(mesh, height: int) -> "RowBlock":
        """This rank's block of ``height`` rows over ``mesh``: the blocks
        split host-major in rank order (``sharding.mesh_block``); the
        height must divide by the mesh size."""
        from .sharding import mesh_block

        n = mesh.size()
        if height % n:
            raise ValueError(f"height {height} not divisible by mesh size {n}")
        rows = height // n
        return RowBlock(mesh_block(mesh) * rows, rows, height)

    @property
    def split(self) -> bool:
        """Does the block hold fewer rows than the image?"""
        return self.rows != self.height


def span(rows: RowBlock | None, height: int) -> tuple[int, int]:
    """(first row, number of rows) of ``rows``, or of the whole image of
    ``height`` rows where it is None."""
    return (0, height) if rows is None else (rows.y0, rows.rows)


def whole(rows: RowBlock | None, tree):
    """Every tensor of ``tree`` (the block's [rows, ...] arrays) at the
    whole image height: one all-gather over the ranks
    (``sharding.gather_rows``) where the block is split, else ``tree``
    itself."""
    if rows is None or not rows.split:
        return tree
    from .sharding import gather_rows

    return gather_rows(tree)

"""2D / 3D bounding-box cropping of point arrays (host, numpy).

Parity with reference utils/crop_cloud.py:8-75 (strict inequalities so that
normalized points always land strictly inside the open unit square, keeping
``floor(x * reso)`` in range).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


_NATIVE_MIN_POINTS = 50_000  # below this numpy wins on call overhead


def crop_pc_2d_index(points: np.ndarray, p_min, p_max) -> np.ndarray:
    """Indices of points strictly inside the (x, y) bbox.

    Parity: reference utils/crop_cloud.py:8-29 (strict ``>`` / ``<``).
    Large float64 arrays route through the C++ runtime (native/tomosar_native.cpp
    ``ts_crop_pc_2d``); numpy otherwise.
    """
    p = np.asarray(points)
    if p.dtype == np.float64 and p.shape[0] >= _NATIVE_MIN_POINTS and p.flags.c_contiguous:
        from tomosar2height_jax import native

        idx = native.crop_pc_2d_index(p, p_min, p_max)
        if idx is not None:
            return idx
    mask = (
        (p[:, 0] > p_min[0]) & (p[:, 0] < p_max[0])
        & (p[:, 1] > p_min[1]) & (p[:, 1] < p_max[1])
    )
    return np.nonzero(mask)[0]


def crop_pc_2d(points: np.ndarray, p_min, p_max) -> Tuple[np.ndarray, np.ndarray]:
    """Crop points to the open 2D bbox; returns (cropped_points, indices).

    Parity: reference utils/crop_cloud.py:32-50.
    """
    idx = crop_pc_2d_index(points, p_min, p_max)
    return np.asarray(points)[idx], idx


class GridIndex2D:
    """Uniform-grid spatial index for repeated 2D bbox crops of one cloud.

    The reference pipeline rescans the whole chunk cloud per patch
    (reference utils/crop_cloud.py:8-29 inside dataset.py:211-235); on the
    bench city that scan IS the serving loader's cost (~13 ms/patch on one
    host core). This index pays one argsort at build, then answers each
    bbox query by touching only the grid cells overlapping the box.

    Queries return exactly ``crop_pc_2d_index``'s result: ascending indices
    of points STRICTLY inside the open box (the candidate set is a superset
    by construction — cell boundaries are floor-aligned — and the exact
    strict filter runs on the gathered candidates).
    """

    def __init__(self, points: np.ndarray, cell_size: float):
        xy = np.asarray(points)[:, :2]
        self.cell = float(cell_size)
        self.x0 = float(xy[:, 0].min()) if len(xy) else 0.0
        self.y0 = float(xy[:, 1].min()) if len(xy) else 0.0
        if len(xy) == 0:
            self.nx = self.ny = 1
            self.order = np.zeros(0, np.int64)
            self.starts = np.zeros(2, np.int64)
            return
        ix = np.floor((xy[:, 0] - self.x0) / self.cell).astype(np.int64)
        iy = np.floor((xy[:, 1] - self.y0) / self.cell).astype(np.int64)
        self.nx = int(ix.max()) + 1
        self.ny = int(iy.max()) + 1
        code = ix * self.ny + iy
        self.order = np.argsort(code, kind="stable")
        counts = np.bincount(code, minlength=self.nx * self.ny)
        self.starts = np.concatenate(
            ([0], np.cumsum(counts))).astype(np.int64)

    def query_index(self, p_min, p_max) -> np.ndarray:
        """Ascending indices of points strictly inside the open bbox."""
        ix0 = max(0, int(np.floor((p_min[0] - self.x0) / self.cell)))
        ix1 = min(self.nx - 1, int(np.floor((p_max[0] - self.x0) / self.cell)))
        iy0 = max(0, int(np.floor((p_min[1] - self.y0) / self.cell)))
        iy1 = min(self.ny - 1, int(np.floor((p_max[1] - self.y0) / self.cell)))
        if ix1 < ix0 or iy1 < iy0:
            return np.zeros(0, np.int64)
        cols = [
            self.order[self.starts[ix * self.ny + iy0]:
                       self.starts[ix * self.ny + iy1 + 1]]
            for ix in range(ix0, ix1 + 1)
        ]
        cand = cols[0] if len(cols) == 1 else np.concatenate(cols)
        cand.sort()
        return cand

    def query(self, points: np.ndarray, p_min, p_max):
        """(cropped_points, indices) — drop-in for ``crop_pc_2d`` on the
        indexed cloud."""
        cand = self.query_index(p_min, p_max)
        p = np.asarray(points)[cand]
        keep = (
            (p[:, 0] > p_min[0]) & (p[:, 0] < p_max[0])
            & (p[:, 1] > p_min[1]) & (p[:, 1] < p_max[1])
        )
        return p[keep], cand[keep]


def crop_pc_3d(points: np.ndarray, p_min, p_max) -> Tuple[np.ndarray, np.ndarray]:
    """Crop points to a closed 3D axis-aligned bbox; returns (points, indices).

    Capability parity with reference utils/crop_cloud.py:53-75 (which delegates to
    open3d's AxisAlignedBoundingBox — inclusive bounds), without the open3d dependency.
    """
    p = np.asarray(points)
    mask = np.ones(p.shape[0], dtype=bool)
    for d in range(3):
        mask &= (p[:, d] >= p_min[d]) & (p[:, d] <= p_max[d])
    idx = np.nonzero(mask)[0]
    return p[idx], idx

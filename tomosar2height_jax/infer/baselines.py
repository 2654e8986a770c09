"""Classical nDSM interpolation baselines from max-z-per-pixel points.

Parity: reference scripts/interpolate_bilinear.py:22-58 (scipy griddata linear),
scripts/interpolate_idw.py:9-27 (KD-tree inverse-distance weighting, k=8, p=2),
scripts/interpolate_nearest.py:32-36 (KD-tree nearest). All operate on the
highest point per XY pixel and write a georeferenced GeoTIFF.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.interpolate import griddata
from scipy.spatial import cKDTree

from tomosar2height_jax.geo.raster import RasterData, RasterWriter


def max_z_per_pixel(points: np.ndarray, bl_bound, tr_bound, pixel_size) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce the cloud to the highest z per raster cell; returns (xy centers, z)."""
    ps = np.asarray(pixel_size, dtype=np.float64)
    cols = np.floor((points[:, 0] - bl_bound[0]) / ps[0]).astype(np.int64)
    rows = np.floor((tr_bound[1] - points[:, 1]) / ps[1]).astype(np.int64)
    n_rows = int(np.floor((tr_bound[1] - bl_bound[1]) / ps[1]))
    n_cols = int(np.floor((tr_bound[0] - bl_bound[0]) / ps[0]))
    ok = (cols >= 0) & (cols < n_cols) & (rows >= 0) & (rows < n_rows)
    cols, rows, z = cols[ok], rows[ok], points[ok, 2]
    flat = rows * n_cols + cols
    best = np.full(n_rows * n_cols, -np.inf)
    np.maximum.at(best, flat, z)
    occ = np.isfinite(best)
    idx = np.nonzero(occ)[0]
    rr, cc = idx // n_cols, idx % n_cols
    xs = bl_bound[0] + (cc + 0.5) * ps[0]
    ys = tr_bound[1] - (rr + 0.5) * ps[1]
    return np.stack([xs, ys], axis=1), best[idx]


def _grid_centers(bl_bound, tr_bound, pixel_size):
    ps = np.asarray(pixel_size, dtype=np.float64)
    n_rows = int(np.floor((tr_bound[1] - bl_bound[1]) / ps[1]))
    n_cols = int(np.floor((tr_bound[0] - bl_bound[0]) / ps[0]))
    xs = bl_bound[0] + (np.arange(n_cols) + 0.5) * ps[0]
    ys = tr_bound[1] - (np.arange(n_rows) + 0.5) * ps[1]
    gx, gy = np.meshgrid(xs, ys)
    return gx, gy, (n_rows, n_cols)


def interpolate_ndsm(
    points: np.ndarray,
    bl_bound,
    tr_bound,
    pixel_size=(1.0, 1.0),
    method: str = "idw",
    k: int = 8,
    p: float = 2.0,
    fill_value: float = 0.0,
) -> np.ndarray:
    """Interpolate an nDSM grid from a point cloud.

    method: 'bilinear' (griddata linear), 'idw' (k-NN inverse distance, power p),
    or 'nearest'.
    """
    xy, z = max_z_per_pixel(points, bl_bound, tr_bound, pixel_size)
    gx, gy, shape = _grid_centers(bl_bound, tr_bound, pixel_size)
    if xy.shape[0] == 0:
        return np.full(shape, fill_value, dtype=np.float32)

    if method == "bilinear":
        grid = griddata(xy, z, (gx, gy), method="linear", fill_value=np.nan)
        nearest = griddata(xy, z, (gx, gy), method="nearest")
        grid = np.where(np.isnan(grid), nearest, grid)
    elif method == "idw":
        tree = cKDTree(xy)
        q = np.stack([gx.ravel(), gy.ravel()], axis=1)
        dist, idx = tree.query(q, k=min(k, len(xy)))
        dist = np.atleast_2d(dist.T).T
        idx = np.atleast_2d(idx.T).T
        w = 1.0 / np.maximum(dist, 1e-12) ** p
        exact = dist[:, 0] < 1e-12
        grid = (w * z[idx]).sum(axis=1) / w.sum(axis=1)
        grid[exact] = z[idx[exact, 0]]
        grid = grid.reshape(shape)
    elif method == "nearest":
        tree = cKDTree(xy)
        q = np.stack([gx.ravel(), gy.ravel()], axis=1)
        _, idx = tree.query(q, k=1)
        grid = z[idx].reshape(shape)
    else:
        raise ValueError(f"Unknown method {method}")
    return grid.astype(np.float32)


def write_interpolated_ndsm(
    out_path: str,
    points: np.ndarray,
    bl_bound,
    tr_bound,
    pixel_size=(1.0, 1.0),
    method: str = "idw",
    crs_epsg: Optional[int] = 25832,
    **kwargs,
) -> RasterWriter:
    grid = interpolate_ndsm(points, bl_bound, tr_bound, pixel_size, method, **kwargs)
    rd = RasterData()
    rd.set_transform(bl_bound, tr_bound, pixel_size, crs_epsg)
    rd.set_data(grid)
    w = RasterWriter(rd)
    w.write_to_file(out_path)
    return w

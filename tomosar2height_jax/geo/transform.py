"""Coordinate transforms and grid-index math (host, float64 numpy).

Capability parity with reference utils/coordinate.py (coordinate2index :12-28,
apply_transform/invert_transform :102-140, make_3d_grid :45-65) and the
augmentation matrices of reference dataset.py:30-42 (built there via the
``transformations`` package). The JAX variant of ``coordinate2index`` used inside
the model lives in :mod:`tomosar2height_jax.ops.scatter`.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


class Affine:
    """2D affine geo-transform ``(x, y) = T @ (col, row, 1)``.

    Coefficient order matches the GDAL/rasterio convention::

        x = a * col + b * row + c
        y = d * col + e * row + f

    Only what the pipeline needs: application to pixel indices, inversion (``~T``),
    equality, and GeoTIFF tag round-trip. Reference counterpart:
    rasterio.transform.Affine as used in utils/io_raster.py.
    """

    __slots__ = ("a", "b", "c", "d", "e", "f")

    def __init__(self, a: float, b: float, c: float, d: float, e: float, f: float):
        self.a, self.b, self.c = float(a), float(b), float(c)
        self.d, self.e, self.f = float(d), float(e), float(f)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        """North-up transform with top-left corner (west, north) and pixel size (xsize, ysize)."""
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    def coefficients(self):
        return (self.a, self.b, self.c, self.d, self.e, self.f)

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0.0:
            raise ValueError("Affine transform is not invertible")
        ia = self.e / det
        ib = -self.b / det
        id_ = -self.d / det
        ie = self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def __mul__(self, other):
        if isinstance(other, Affine):
            return Affine(
                self.a * other.a + self.b * other.d,
                self.a * other.b + self.b * other.e,
                self.a * other.c + self.b * other.f + self.c,
                self.d * other.a + self.e * other.d,
                self.d * other.b + self.e * other.e,
                self.d * other.c + self.e * other.f + self.f,
            )
        # apply to a single (x, y) pair
        x, y = other
        return (self.a * x + self.b * y + self.c, self.d * x + self.e * y + self.f)

    def apply(self, xy: np.ndarray) -> np.ndarray:
        """Apply to an (N, 2) float64 array of coordinates; returns (N, 2)."""
        xy = np.asarray(xy, dtype=np.float64)
        out = np.empty_like(xy)
        out[:, 0] = self.a * xy[:, 0] + self.b * xy[:, 1] + self.c
        out[:, 1] = self.d * xy[:, 0] + self.e * xy[:, 1] + self.f
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, Affine):
            return NotImplemented
        return all(
            math.isclose(p, q, rel_tol=1e-12, abs_tol=1e-9)
            for p, q in zip(self.coefficients(), other.coefficients())
        )

    def __hash__(self):
        return hash(self.coefficients())

    def __repr__(self):
        return f"Affine(a={self.a}, b={self.b}, c={self.c}, d={self.d}, e={self.e}, f={self.f})"


def coordinate2index(x: np.ndarray, reso: int, coord_type: str = "2d") -> np.ndarray:
    """Flattened grid cell id of points normalized to [0, 1]: ``id = x + reso * y``.

    Numpy twin of reference utils/coordinate.py:12-28 (truncation toward zero via
    integer cast, same flattening order). Accepts (..., N, 2); returns (..., 1, N)
    int64 to match the reference's index shape.
    """
    xi = (np.asarray(x) * reso).astype(np.int64)
    if coord_type != "2d":
        raise NotImplementedError(f"coord_type {coord_type!r}")
    index = xi[..., 0] + reso * xi[..., 1]
    return index[..., None, :]


def rotation_matrix_z(angle_rad: float) -> np.ndarray:
    """4x4 homogeneous rotation about the +z axis (right-handed, CCW positive)."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def reflection_matrix(normal: Sequence[float]) -> np.ndarray:
    """4x4 householder reflection through the plane with unit ``normal`` at the origin."""
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] -= 2.0 * np.outer(n, n)
    return m


# 90-degree clockwise rotations about z (k quarter turns), reference dataset.py:30-35
ROT_MATRICES: Dict[int, np.ndarray] = {
    k: rotation_matrix_z(-k * math.pi / 2.0) for k in range(4)
}

# Axis flips: -1 identity, 0 -> x := -x, 1 -> y := -y, reference dataset.py:38-42
FLIP_MATRICES: Dict[int, np.ndarray] = {
    -1: np.eye(4, dtype=np.float64),
    0: reflection_matrix([1.0, 0.0, 0.0]),
    1: reflection_matrix([0.0, 1.0, 0.0]),
}


def normalize_pc(points: np.ndarray, scales, center_shift) -> np.ndarray:
    """(points - center_shift) / scales (reference utils/coordinate.py:68-83)."""
    return (np.asarray(points, dtype=np.float64) - np.asarray(center_shift)) / np.asarray(scales)


def invert_normalize_pc(points: np.ndarray, scales, center_shift) -> np.ndarray:
    """points * scales + center_shift (reference utils/coordinate.py:86-99)."""
    return np.asarray(points, dtype=np.float64) * np.asarray(scales) + np.asarray(center_shift)


def apply_transform(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points (with w-divide).

    Parity: reference utils/coordinate.py:102-121.
    """
    p = np.asarray(points, dtype=np.float64)
    hom = np.concatenate([p, np.ones((p.shape[0], 1), dtype=np.float64)], axis=1)
    out = hom @ np.asarray(m, dtype=np.float64).T
    return out[:, :3] / out[:, 3:4]


def invert_transform(m: np.ndarray) -> np.ndarray:
    """Invert a 4x4 homogeneous transform (reference utils/coordinate.py:125-140)."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))


def stack_transforms(ms: Sequence[np.ndarray]) -> np.ndarray:
    """Left-to-right composition of transforms (reference utils/coordinate.py:143-156)."""
    out = np.asarray(ms[0], dtype=np.float64)
    for m in ms[1:]:
        out = out @ np.asarray(m, dtype=np.float64)
    return out


def make_3d_grid(bb_min: Sequence[float], bb_max: Sequence[float], shape: Sequence[int]) -> np.ndarray:
    """Dense 3D lattice of points covering the bbox (reference utils/coordinate.py:45-65)."""
    axes = [np.linspace(bb_min[i], bb_max[i], shape[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(axes[0], axes[1], axes[2], indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

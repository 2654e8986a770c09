#!/usr/bin/env python
"""Per-building LAS extraction from 3D building models.

Capability parity: reference scripts/extract_las.py:26-78, which is an ArcPy/
Windows-only pipeline (per-building OBJ -> footprint -> 2 m buffer -> LAS clip,
multiprocessing pool). This is a portable reimplementation: OBJ vertices ->
2D convex-hull footprint -> outward buffer -> half-plane point-in-polygon clip
-> per-building LAS, with an optional process pool.
"""

from __future__ import annotations

import argparse
import os
import sys
from multiprocessing import Pool

import numpy as np
from scipy.spatial import ConvexHull

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo.cloud import load_pc, save_las  # noqa: E402


def load_obj_vertices(path: str) -> np.ndarray:
    """Vertex positions from a Wavefront OBJ (x, y, z)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, dtype=np.float64)


def footprint_hull(verts: np.ndarray, buffer_m: float = 2.0) -> np.ndarray:
    """2D convex-hull footprint, buffered outward by ``buffer_m`` (CCW)."""
    hull = ConvexHull(verts[:, :2])
    poly = verts[hull.vertices, :2]
    centroid = poly.mean(axis=0)
    d = poly - centroid
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    return poly + d / np.maximum(norm, 1e-9) * buffer_m


def points_in_convex_polygon(points_xy: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Boolean mask: inside a CCW convex polygon (vectorized half-plane tests)."""
    inside = np.ones(points_xy.shape[0], dtype=bool)
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        edge = b - a
        rel = points_xy - a
        inside &= (edge[0] * rel[:, 1] - edge[1] * rel[:, 0]) >= 0
    return inside


def extract_one(args):
    obj_path, cloud, out_dir, buffer_m = args
    name = os.path.splitext(os.path.basename(obj_path))[0]
    verts = load_obj_vertices(obj_path)
    if len(verts) < 3:
        return name, 0
    poly = footprint_hull(verts, buffer_m)
    # ensure CCW orientation (shoelace)
    area2 = np.sum(poly[:, 0] * np.roll(poly[:, 1], -1) - np.roll(poly[:, 0], -1) * poly[:, 1])
    if area2 < 0:
        poly = poly[::-1]
    mask = points_in_convex_polygon(cloud[:, :2], poly)
    pts = cloud[mask]
    if len(pts):
        save_las(os.path.join(out_dir, f"{name}.las"), pts)
    return name, int(len(pts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj-dir", required=True, help="folder of per-building OBJ models")
    ap.add_argument("--cloud", required=True, help="city point cloud (las/npy/npz)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--buffer", type=float, default=2.0, help="footprint buffer [m]")
    ap.add_argument("--workers", type=int, default=1)
    a = ap.parse_args()

    os.makedirs(a.out, exist_ok=True)
    cloud = load_pc(a.cloud)
    objs = sorted(
        os.path.join(a.obj_dir, f) for f in os.listdir(a.obj_dir) if f.lower().endswith(".obj")
    )
    tasks = [(o, cloud, a.out, a.buffer) for o in objs]
    if a.workers > 1:
        with Pool(a.workers) as pool:
            results = pool.map(extract_one, tasks)
    else:
        results = [extract_one(t) for t in tasks]
    total = sum(n for _, n in results)
    print(f"extracted {total} points into {len(results)} building clouds at {a.out}")


if __name__ == "__main__":
    main()

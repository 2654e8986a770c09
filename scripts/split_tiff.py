#!/usr/bin/env python
"""Split a GeoTIFF into chunk-aligned and patch-aligned tiles.

Capability parity: reference scripts/split_tiff.py:9-73 (rasterio windowed
reads -> per-chunk / per-patch GeoTIFFs), using the in-tree codec.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo import RasterData, RasterReader, RasterWriter  # noqa: E402


def _write_window(src: RasterReader, r0: int, r1: int, c0: int, c1: int, out_path: str):
    window = src.get_data(1)[r0:r1, c0:c1]
    rd = RasterData()
    x, y = src.T * (c0, r0)  # top-left corner of the window
    rd.pixel_size = src.pixel_size
    from tomosar2height_jax.geo.transform import Affine

    rd.T = Affine(src.T.a, src.T.b, x, src.T.d, src.T.e, y)
    rd.T_inv = ~rd.T
    rd.crs_epsg = src.crs_epsg
    rd.set_data(window.astype(np.float32))
    RasterWriter(rd).write_to_file(out_path)


def split_chunks(tiff_path: str, chunk_x, chunk_y, out_dir: str, prefix: str = "chunk"):
    """One tile per chunk-grid cell (reference split_tiff.py:9-37)."""
    src = RasterReader(tiff_path)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i in range(len(chunk_x) - 1):
        for j in range(len(chunk_y) - 1):
            # exact fractional pixel indices of the chunk corners (edges land
            # on pixel boundaries; floor-based point queries would be off by one)
            bl = src.T_inv.apply(np.array([[chunk_x[i], chunk_y[j]]]))[0]
            tr = src.T_inv.apply(np.array([[chunk_x[i + 1], chunk_y[j + 1]]]))[0]
            c0, r1 = int(round(bl[0])), int(round(bl[1]))
            c1, r0 = int(round(tr[0])), int(round(tr[1]))
            r0, r1 = max(r0, 0), min(r1, src.height)
            c0, c1 = max(c0, 0), min(c1, src.width)
            _write_window(src, r0, r1, c0, c1,
                          os.path.join(out_dir, f"{prefix}_{n:03d}.tif"))
            n += 1
    return n


def split_patches(tiff_path: str, patch_px: int, out_dir: str, prefix: str = "patch"):
    """Regular patch tiling in pixel space (reference split_tiff.py:40-73)."""
    src = RasterReader(tiff_path)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for r0 in range(0, src.height - patch_px + 1, patch_px):
        for c0 in range(0, src.width - patch_px + 1, patch_px):
            _write_window(src, r0, r0 + patch_px, c0, c0 + patch_px,
                          os.path.join(out_dir, f"{prefix}_{n:05d}.tif"))
            n += 1
    return n


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("tiff")
    ap.add_argument("--out", required=True)
    ap.add_argument("--patch-px", type=int, help="patch tiling in pixels")
    ap.add_argument("--chunk-x", type=float, nargs="+", help="chunk grid x edges")
    ap.add_argument("--chunk-y", type=float, nargs="+", help="chunk grid y edges")
    a = ap.parse_args()
    if a.patch_px:
        n = split_patches(a.tiff, a.patch_px, a.out)
    else:
        n = split_chunks(a.tiff, a.chunk_x, a.chunk_y, a.out)
    print(f"wrote {n} tiles to {a.out}")

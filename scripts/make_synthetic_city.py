#!/usr/bin/env python
"""Generate a synthetic mini-city (point cloud + GT nDSM + masks + RGB) so the
full pipeline — builder, sampler, training, DSM generation, evaluation — runs
end-to-end without the (unavailable) Berlin/Munich TomoSAR data.

Layout matches conf/dataset/synthetic.yaml: extent [0, 1280] x [5000000, 5000640],
1 m rasters, LAS point cloud with building roofs + ground + noise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo import RasterData, RasterWriter  # noqa: E402
from tomosar2height_jax.geo.cloud import save_las  # noqa: E402

X0, Y0 = 0.0, 5000000.0
W, H = 1280, 640  # meters == pixels at 1 m (defaults; --width/--height scale)


def build_city(seed: int = 0, density: float = 0.6, n_buildings: int = 90,
               W: int = W, H: int = H):
    rng = np.random.default_rng(seed)
    ndsm = np.zeros((H, W), dtype=np.float32)
    footprint = np.zeros((H, W), dtype=np.uint8)
    btype = np.zeros((H, W), dtype=np.uint8)

    for _ in range(n_buildings):
        bw = rng.integers(12, 60)
        bh = rng.integers(12, 60)
        cx = rng.integers(5, W - bw - 5)
        cy = rng.integers(5, H - bh - 5)
        height = rng.uniform(4.0, 55.0)
        ndsm[cy:cy + bh, cx:cx + bw] = np.maximum(ndsm[cy:cy + bh, cx:cx + bw], height)
        footprint[cy:cy + bh, cx:cx + bw] = 1
        btype[cy:cy + bh, cx:cx + bw] = 1 if height < 25 else 2

    # TomoSAR-like point cloud: roofs + ground, gaussian z noise, some outliers
    n_pts = int(density * W * H)
    xs = rng.uniform(0, W, n_pts)
    ys = rng.uniform(0, H, n_pts)
    # raster row 0 is north (max y): world y = Y0 + (H - row)
    cols = np.clip(xs.astype(int), 0, W - 1)
    rows = np.clip(H - 1 - ys.astype(int), 0, H - 1)
    z = ndsm[rows, cols].astype(np.float64)
    z += rng.normal(0, 0.8, n_pts)  # phase-noise like vertical scatter
    out = rng.random(n_pts) < 0.01  # 1% gross outliers
    z[out] += rng.uniform(-15, 30, out.sum())
    pts = np.stack([X0 + xs, Y0 + ys, z], axis=1)

    # RGB "satellite" image loosely correlated with height + texture
    rgb = np.zeros((3, H, W), dtype=np.float32)
    rgb[0] = 90 + 2.2 * ndsm + rng.normal(0, 12, (H, W))
    rgb[1] = 110 + 1.5 * ndsm + rng.normal(0, 12, (H, W))
    rgb[2] = 120 - 0.8 * ndsm + rng.normal(0, 12, (H, W))
    # integral u8-range values: real satellite sources are u8, and the uint8
    # image wire (dataset satellite_image.wire) is lossless only then
    rgb = np.round(np.clip(rgb, 0, 255))
    return ndsm, footprint, btype, pts, rgb


def write_raster(path: str, data: np.ndarray, epsg: int = 25832,
                 W: int = W, H: int = H):
    rd = RasterData()
    rd.set_transform([X0, Y0], [X0 + W, Y0 + H], [1, 1], epsg)
    if data.ndim == 2:
        rd.set_data(data)
    else:
        for b in range(data.shape[0]):
            rd.set_data(data[b], band=b + 1)
    RasterWriter(rd).write_to_file(path)


def main(out_root: str, seed: int = 0, density: float = 0.6,
         width: int = W, height: int = H):
    raster_dir = os.path.join(out_root, "raster")
    cloud_dir = os.path.join(out_root, "cloud")
    os.makedirs(raster_dir, exist_ok=True)
    os.makedirs(cloud_dir, exist_ok=True)

    n_b = max(90 * (width * height) // (1280 * 640), 10)
    ndsm, footprint, btype, pts, rgb = build_city(seed, density, n_b,
                                                  width, height)
    wr = lambda path, data: write_raster(path, data, W=width, H=height)
    wr(os.path.join(raster_dir, "ndsm.tif"), ndsm)
    wr(os.path.join(raster_dir, "footprint.tif"), footprint.astype(np.float32))
    wr(os.path.join(raster_dir, "building_class.tif"), btype.astype(np.float32))
    wr(os.path.join(raster_dir, "rgb.tif"), rgb)
    save_las(os.path.join(cloud_dir, "city.las"), pts)
    print(f"synthetic city written to {out_root}: {len(pts)} points, "
          f"{int(footprint.sum())} building px, max height {ndsm.max():.1f} m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/synthetic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--density", type=float, default=0.6)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    a = ap.parse_args()
    main(a.out, a.seed, a.density, a.width, a.height)

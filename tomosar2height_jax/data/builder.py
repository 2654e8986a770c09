"""Offline dataset builder: grid the city into chunks, crop per-chunk clouds,
derive 3D bounds from the GT nDSM, write chunk_info.yaml.

Parity: reference scripts/build_dataset.py:30-200 — chunk grid from
chunk_x x chunk_y (:59-67), safe-padded windowed GT-DSM read with nodata
filtering (|z| > 1000) for z-bounds (:139-167), per-chunk
``input_point_cloud.npz`` with key 'pts' (:184-190), optional PLY visualization,
``chunk_info.yaml`` {idx: {name, min_bound[3], max_bound[3]}} (:196-200).
Differences: non-interactive (``overwrite`` flag instead of an input() prompt).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from tomosar2height_jax.config import yaml_subset
from tomosar2height_jax.geo import RasterReader, crop_pc_2d, dilate_mask, load_pc, save_pc_to_ply
from tomosar2height_jax.utils.seeding import lock_seed

log = logging.getLogger(__name__)


def build_dataset(cfg, overwrite: bool = False) -> Dict[int, dict]:
    """Run the offline build from the composed config. Returns chunk_info."""
    build_training_data = bool(cfg.get("build_training_data", False))
    cfg_chunk = cfg["chunk"]

    input_pc_merged = cfg.get("input_pointcloud_merged")
    input_pc_folder = cfg.get("input_pointcloud_folder")
    if input_pc_merged is not None:
        input_pc_paths: List[str] = [input_pc_merged]
    elif input_pc_folder is not None:
        input_pc_paths = [
            os.path.join(input_pc_folder, p) for p in sorted(os.listdir(input_pc_folder))
        ]
    else:
        raise IOError("No input point cloud.")

    cfg_output = cfg["output"]
    output_folder = cfg_output["output_folder"]
    save_vis = bool(cfg_output.get("save_visualization_pc", False))

    if cfg.get("lock_seed", True):
        lock_seed(0)

    # chunk grid
    chunk_x = list(cfg_chunk["chunk_x"])
    chunk_y = list(cfg_chunk["chunk_y"])
    chunk_bound = np.array([min(chunk_x), min(chunk_y), max(chunk_x), max(chunk_y)])
    chunks: Dict[int, dict] = {}
    for i, x_l in enumerate(chunk_x[:-1]):
        for j, y_b in enumerate(chunk_y[:-1]):
            chunks[len(chunks)] = {
                "min_bound": np.array([x_l, y_b], dtype=np.float64),
                "max_bound": np.array([chunk_x[i + 1], chunk_y[j + 1]], dtype=np.float64),
            }

    if os.path.exists(output_folder):
        if not overwrite:
            raise FileExistsError(
                f"Output folder exists at '{output_folder}' (pass overwrite=True / --overwrite)"
            )
        shutil.rmtree(output_folder)
    os.makedirs(output_folder)
    log.info("Output folder ready at: '%s'", output_folder)

    # load + merge clouds
    parts = [load_pc(p) for p in input_pc_paths]
    merged_pts = np.concatenate(parts, axis=0) if parts else np.empty((0, 3))
    log.info("Point clouds merged: %d points from %d files", len(merged_pts), len(parts))

    # masks + GT DSM
    raster_masks: Dict[str, RasterReader] = {}
    cfg_masks = cfg.get("mask_files", {}) or {}
    if cfg_masks.get("building"):
        raster_masks["building"] = RasterReader(cfg_masks["building"])
    dsm_gt = RasterReader(cfg["gt_dsm"])

    dilate_build: Optional[int] = cfg.get("dilate_building")
    if dilate_build is not None and "building" in raster_masks:
        m = raster_masks["building"].get_data()
        raster_masks["building"]._editable = True
        raster_masks["building"].set_data(dilate_mask(m, iterations=dilate_build).astype(m.dtype))

    chunk_safe_padding = float(cfg_chunk.get("chunk_safe_padding", 0))
    chunk_info: Dict[int, dict] = {}

    for idx, ch in chunks.items():
        chunk_name = f"chunk_{idx:03d}"
        chunk_dir = os.path.join(output_folder, chunk_name)
        os.makedirs(chunk_dir)
        p1, p2 = ch["min_bound"], ch["max_bound"]
        info = {"name": chunk_name}

        if build_training_data:
            # safe-padded window clipped to the full grid extent
            p1_pad = np.maximum(p1 - chunk_safe_padding, chunk_bound[:2])
            p2_pad = np.minimum(p2 + chunk_safe_padding, chunk_bound[2:])
            r_max, c_min = dsm_gt.index(p1_pad[0], p1_pad[1])
            r_min, c_max = dsm_gt.index(p2_pad[0], p2_pad[1])
            assert r_min >= 0 and c_min >= 0, "GT DSM must cover all chunks"
            assert r_max <= dsm_gt.height and c_max <= dsm_gt.width, "GT DSM must cover all chunks"
            window = dsm_gt.read_window((r_min, r_max), (c_min, c_max))
            zmin, zmax = float(window.min()), float(window.max())
            if zmin < -1000 or zmax > 1000:  # nodata sentinel filtering
                log.warning("invalid elevation value %s ignored", zmin)
                valid = window[(window > -1000) & (window < 1000)]
                zmin, zmax = float(valid.min()), float(valid.max())
            info["min_bound"] = [float(p1[0]), float(p1[1]), zmin]
            info["max_bound"] = [float(p2[0]), float(p2[1]), zmax]
        else:
            info["min_bound"] = [float(p1[0]), float(p1[1])]
            info["max_bound"] = [float(p2[0]), float(p2[1])]

        chunk_pts, _ = crop_pc_2d(merged_pts, p1, p2)
        np.savez(os.path.join(chunk_dir, "input_point_cloud.npz"), pts=chunk_pts)

        if save_vis:
            vis_dir = os.path.join(chunk_dir, "vis")
            os.makedirs(vis_dir, exist_ok=True)
            save_pc_to_ply(
                os.path.join(vis_dir, f"{chunk_name}-input_point_cloud.ply"), chunk_pts
            )
        chunk_info[idx] = info

    info_path = os.path.join(output_folder, "chunk_info.yaml")
    with open(info_path, "w") as f:
        f.write(yaml_subset.dump({int(k): v for k, v in chunk_info.items()}))
    log.info("chunk_info saved to: '%s'", info_path)
    return chunk_info

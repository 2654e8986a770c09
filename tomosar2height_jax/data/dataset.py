"""Patch sampler over the chunked dataset (host, numpy; float64 geo-math).

Parity: reference dataset.py:45-330 — in-RAM chunk store, random / sliding-window
anchors, float64 world->unit-cube normalization with per-patch z-shift, consistent
90-deg rotation/flip augmentation of points + image + DSM, per-patch image/DSM
crops with a final vertical flip into y-up orientation (:310, :328).

Deviations:
- returns numpy patches; padding to static point buckets happens in
  :mod:`tomosar2height_jax.data.pipeline` (masked, SURVEY.md §7.2);
- images stored channel-normalized float32 HWC (the model is NHWC).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from tomosar2height_jax.config import yaml_subset
from tomosar2height_jax.geo import (
    FLIP_MATRICES,
    GridIndex2D,
    ROT_MATRICES,
    RasterReader,
    apply_transform,
    crop_pc_2d,
    invert_transform,
)

log = logging.getLogger(__name__)

INPUT_POINT_CLOUD = "input_point_cloud.npz"
CHUNK_INFO = "chunk_info.yaml"


class TomoSARDataset:
    """Iterable patch source for one split ('train'/'val'/'test'/'vis')."""

    def __init__(
        self,
        split: str,
        cfg_dataset: Dict,
        random_sample: bool = False,
        random_length: Optional[int] = None,
        flip_augm: bool = False,
        rotate_augm: bool = False,
        load_target: bool = True,
        load_image: bool = True,
    ):
        """``load_target=False`` skips the per-patch GT-nDSM crop/copy —
        inference loaders (DSMGenerator) never consume the target, and the
        copy is a measurable share of the serving loader's critical path.
        ``load_image=False`` likewise skips satellite-image loading and the
        per-patch 512x512x3 crop (~1.6 ms/patch) for cloud-only runs."""
        self.split = split
        self.load_target = bool(load_target)
        self.load_image = bool(load_image)
        self._cfg_data = cfg_dataset
        self.patch_size = np.asarray(cfg_dataset["patch_size"], dtype=np.float64)
        self.dataset_chunk_idx_ls: List[int] = list(cfg_dataset[f"{split}_chunks"])

        dataset_dir = cfg_dataset["path"]
        self.chunk_info: Dict[int, dict] = yaml_subset.load_file(
            os.path.join(dataset_dir, CHUNK_INFO))
        self.chunk_info_ls = [self.chunk_info[i] for i in self.dataset_chunk_idx_ls]

        # satellite images (optional): normalize once, keep HWC float32
        self.images: List[RasterReader] = []
        images_dic = cfg_dataset.get("satellite_image") if self.load_image else None
        self.norm_image_data: Optional[np.ndarray] = None
        self.image_norm = None  # (mean, std) f32 when crops ship un-normalized
        self.wire_image = "float32"
        if images_dic is not None:
            folder = images_dic["folder"]
            for image_name in images_dic["pairs"]:
                self.images.append(RasterReader(os.path.join(folder, image_name)))
                log.debug("Satellite image loaded: %s", image_name)
            assert len(self.images) <= 2, "Only support single image or stereo image"
            assert self.images[-1].T == self.images[0].T
            chans = []
            for img in self.images:
                for b in (1, 2, 3):
                    chans.append(img.get_data(b).astype(np.float64))
            stack = np.stack(chans, axis=0)  # (3*n_img, H, W)
            mean = np.asarray(images_dic["normalize"]["mean"], dtype=np.float64)
            std = np.asarray(images_dic["normalize"]["std"], dtype=np.float64)
            if mean.shape[0] != stack.shape[0]:  # stereo: repeat stats per image
                mean = np.tile(mean, len(self.images))
                std = np.tile(std, len(self.images))
            # wire: 'float32' (default) pre-normalizes on host, crops ship as
            # f32 (the reference's numerics, dataset.py:86-113). 'uint8' keeps
            # the RAW u8 pixels (source satellite imagery is u8) and ships
            # THOSE — 4x less upload per patch (a 512^2x3 crop: 3 MB ->
            # 768 KB) and 4x less RAM; the (x-mean)/std
            # normalization runs on device inside the jitted forward
            # (Trainer/DSMGenerator read `image_norm`). Lossless for integral
            # u8-range sources (asserted), so serving/training numerics match
            # the f32 wire to f32 rounding.
            self.wire_image = str(images_dic.get("wire", "float32"))
            if self.wire_image == "uint8":
                if not (stack.min() >= 0 and stack.max() <= 255
                        and np.allclose(stack, np.round(stack), atol=1e-3)):
                    raise ValueError(
                        "satellite_image.wire=uint8 needs integral u8-range "
                        "source imagery; this source is not (use float32)")
                self.norm_image_data = np.round(stack).astype(np.uint8)
                self.image_norm = (mean.astype(np.float32),
                                   std.astype(np.float32))
            elif self.wire_image == "float32":
                stack = (stack - mean[:, None, None]) / std[:, None, None]
                self.norm_image_data = stack.astype(np.float32)
                self.image_norm = None
            else:
                raise ValueError(f"Invalid satellite_image.wire: "
                                 f"{self.wire_image}")

        # crop: 'host' (default) ships a per-patch crop over the wire.
        # 'device' ships only the (row0, col0) SCENE-PIXEL ORIGIN of each
        # crop — the DSMGenerator uploads the whole scene image to device
        # memory once and slices per tile inside the jitted forward (the
        # image is static across tiles; per-tile crops are 0.8-3 MB of
        # upload each). Applies only to
        # generator-feeding loaders (regular patching, no augmentation,
        # load_target=False); train/val loaders keep host crops so the
        # trainer's batch contract is unchanged.
        crop_mode = (str(images_dic.get("crop", "host"))
                     if images_dic is not None else "host")
        if crop_mode not in ("host", "device"):
            raise ValueError(f"Invalid satellite_image.crop: {crop_mode}")
        self.image_crop_device = (
            crop_mode == "device" and len(self.images) > 0
            and not random_sample and not flip_augm and not rotate_augm
            and not self.load_target)
        self._scene_image_hwc: Optional[np.ndarray] = None

        self.n_images = len(self.images)
        if self.n_images > 0:
            self._image_pixel_size = np.asarray(self.images[0].pixel_size, dtype=np.float64)
            shape = self.patch_size / self._image_pixel_size
            assert np.all(np.floor(shape) == shape), \
                "Patch size should be integer multiple of image pixel size"
            self._image_patch_shape = np.floor(shape).astype(np.int64)

        # GT nDSM in RAM
        dsm_path = cfg_dataset.get("dsm_gt_path")
        self.dsm = RasterReader(dsm_path)
        self._dsm_pixel_size = np.asarray(self.dsm.pixel_size, dtype=np.float64)
        self.dsm_data = self.dsm.get_data(1).astype(np.float32)
        shape = self.patch_size / self._dsm_pixel_size
        assert np.all(np.floor(shape) == shape), \
            "Patch size should be integer multiple of DSM pixel size"
        self._dsm_patch_shape = np.floor(shape).astype(np.int64)

        # per-chunk point clouds in RAM (float64 world coordinates)
        self.data_dic: Dict[int, dict] = {}
        for chunk_idx in self.dataset_chunk_idx_ls:
            info = self.chunk_info[chunk_idx]
            path = os.path.join(dataset_dir, info["name"], INPUT_POINT_CLOUD)
            with np.load(path) as z:
                pts = z["pts"].astype(np.float64)
            # one-argsort spatial index: bbox crops touch only overlapping
            # grid cells instead of rescanning the chunk per patch (the
            # serving loader's dominant host cost at city scale)
            index = GridIndex2D(pts, cell_size=float(self.patch_size[0]) / 2.0)
            self.data_dic[chunk_idx] = {
                "name": info["name"], "inputs": pts, "index": index}

        self.random_sample = random_sample
        self.random_length = random_length
        if self.random_sample and random_length is None:
            log.warning("random_length not provided when random_sample = True")
            self.random_length = 10
        self.flip_augm = flip_augm
        self.rotate_augm = rotate_augm

        # sliding-window anchors for deterministic splits (reference dataset.py:160-181)
        self.anchor_points: List[dict] = []
        if not self.random_sample:
            strip = np.asarray(
                cfg_dataset["sliding_window"][f"{split}_strip"], dtype=np.float64
            )
            for chunk_idx in self.dataset_chunk_idx_ls:
                info = self.chunk_info[chunk_idx]
                mn = np.asarray(info["min_bound"], dtype=np.float64)
                mx = np.asarray(info["max_bound"], dtype=np.float64)
                px = np.arange(mn[0], mx[0] - self.patch_size[0], strip[0])
                px = np.concatenate([px, [mx[0] - self.patch_size[0]]])
                py = np.arange(mn[1], mx[1] - self.patch_size[1], strip[1])
                py = np.concatenate([py, [mx[1] - self.patch_size[1]]])
                xv, yv = np.meshgrid(px, py)
                for anchor in np.stack([xv.ravel(), yv.ravel()], axis=1):
                    self.anchor_points.append({"chunk_idx": chunk_idx, "anchor": anchor})

        # normalization factors (reference dataset.py:183-196)
        xr = cfg_dataset["normalize"]["x_range"]
        yr = cfg_dataset["normalize"]["y_range"]
        self._min_norm_bound = [xr[0], yr[0]]
        self._max_norm_bound = [xr[1], yr[1]]
        self.z_bound = cfg_dataset["normalize"]["z_bound"]
        self.scale_mat = np.diag(
            [
                self.patch_size[0] / (xr[1] - xr[0]),
                self.patch_size[1] / (yr[1] - yr[0]),
                self.z_bound[1] - self.z_bound[0],
                1.0,
            ]
        ).astype(np.float64)
        # shift [-0.5, 0.5] -> [0, 1]
        self.shift_norm = np.eye(4, dtype=np.float64)
        self.shift_norm[0, 3] = (xr[1] - xr[0]) / 2.0
        self.shift_norm[1, 3] = (yr[1] - yr[0]) / 2.0

    def __len__(self) -> int:
        return self.random_length if self.random_sample else len(self.anchor_points)

    def scene_image_hwc(self) -> np.ndarray:
        """Whole-scene satellite image as one HWC array (u8 or f32 per the
        wire), for the device-crop serving path: the generator uploads it to
        the device once and per-tile crops become ``dynamic_slice``s there.
        ``scene[r0:r0+h, c0:c0+w][::-1]`` equals the host crop's HWC output
        for an un-augmented patch. Lazily built and cached."""
        assert self.image_crop_device, "scene_image_hwc needs crop='device'"
        if self._scene_image_hwc is None:
            self._scene_image_hwc = np.ascontiguousarray(
                np.moveaxis(self.norm_image_data, 0, -1))
        return self._scene_image_hwc

    def _normalize_points(self, inputs, min_bound, max_bound, normalize_mat):
        """World points -> float32 points strictly inside the unit square
        (reference dataset.py:274-278). The C++ runtime fuses transform + recrop
        into one pass for large patches; numpy is the fallback/oracle."""
        if inputs.shape[0] >= 4_096 and inputs.flags.c_contiguous:
            from tomosar2height_jax import native

            out = native.crop_transform_patch(inputs, min_bound, max_bound, normalize_mat)
            if out is not None:
                return out
        inputs_norm = apply_transform(inputs, normalize_mat).astype(np.float32)
        inputs_norm, _ = crop_pc_2d(inputs_norm, self._min_norm_bound, self._max_norm_bound)
        return inputs_norm

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        # ``rng``: explicit per-item generator (PatchLoader det_stream). Makes
        # the patch a pure function of (seed, epoch, stream position) so a
        # killed run resumes on the EXACT patch stream it left; None keeps the
        # reference's global-RNG sampling (dataset.py:211-263).
        r = rng if rng is not None else np.random
        # anchor (reference dataset.py:211-225)
        if self.random_sample:
            chunk_idx = self.dataset_chunk_idx_ls[idx % len(self.dataset_chunk_idx_ls)]
            info = self.chunk_info[chunk_idx]
            mn = np.asarray(info["min_bound"], dtype=np.float64)
            mx = np.asarray(info["max_bound"], dtype=np.float64)
            rand = r.random(2)
            anchor = rand * (mx[:2] - mn[:2] - self.patch_size[:2])
            if self.n_images > 0:  # snap to the image pixel grid
                anchor = np.floor(anchor / self._image_pixel_size) * self._image_pixel_size
            anchor = anchor + mn[:2]
        else:
            a = self.anchor_points[idx]
            chunk_idx, anchor = a["chunk_idx"], a["anchor"]

        min_bound = anchor.astype(np.float64)
        max_bound = min_bound + self.patch_size
        chunk_data = self.data_dic[chunk_idx]
        inputs, _ = chunk_data["index"].query(
            chunk_data["inputs"], min_bound, max_bound)
        if len(inputs) == 0:
            return {
                "name": f"{chunk_data['name']}-patch{idx}",
                "min_bound": min_bound.copy(),
                "max_bound": max_bound.copy(),
                "is_valid": False,
            }

        # z-shift strategy (reference dataset.py:244-250)
        strategy = self._cfg_data["normalize"]["z_shift"]
        if strategy == "local_min":
            z_shift = float(inputs[:, 2].min())
        elif strategy == "global_min":
            z_shift = float(self.z_bound[0])
        else:
            raise ValueError(f"Unknown shift strategy: {strategy}")

        # augmentation draws (reference dataset.py:253-263)
        rot_times = int(r.choice(4)) if self.rotate_augm else 0
        flip_dim = int(r.choice([-1, 0, 1])) if self.flip_augm else -1
        rot_mat = ROT_MATRICES[rot_times]
        flip_mat = FLIP_MATRICES[flip_dim]

        # world -> [0, 1]^2 x [0, 1] normalization (reference dataset.py:265-271)
        transform_mat = self.scale_mat.copy()
        transform_mat[0:2, 3] = (min_bound + max_bound) / 2.0
        transform_mat[2, 3] = z_shift
        normalize_mat = self.shift_norm @ flip_mat @ rot_mat @ invert_transform(transform_mat)
        transform_mat = invert_transform(normalize_mat)

        inputs_norm = self._normalize_points(inputs, min_bound, max_bound, normalize_mat)

        out = {
            "name": f"{chunk_data['name']}-patch{idx}",
            "inputs": inputs_norm,
            "transform": transform_mat,
            "min_bound": min_bound.copy(),
            "max_bound": max_bound.copy(),
            "flip": flip_dim,
            "rotate": rot_times,
            "is_valid": True,
        }

        # satellite image patch (reference dataset.py:292-310): anchor names the
        # bottom-left pixel; crop rows north of it, augment, flip to y-up, HWC
        if self.n_images > 0:
            center = min_bound + self._image_pixel_size / 2.0
            col, row = self.images[0].query_col_row(center[0], center[1])
            h, w = self._image_patch_shape
            if self.image_crop_device:
                # device-crop wire: scene-pixel origin of the (un-flipped)
                # crop window; the generator slices + y-up-flips on device
                r0, c0 = int(row - h + 1), int(col)
                sh, sw = self.norm_image_data.shape[1:]
                assert 0 <= r0 and r0 + h <= sh and 0 <= c0 and c0 + w <= sw, \
                    f"chunk_idx:{chunk_idx}"
                out["image_origin"] = np.array([r0, c0], dtype=np.int32)
                return out  # image_crop_device implies load_target=False
            img = self.norm_image_data[:, row - h + 1: row + 1, col: col + w]
            img = _augment_raster(img, rot_times, flip_dim)
            assert img.shape == (self.norm_image_data.shape[0], h, w), f"chunk_idx:{chunk_idx}"
            out["image"] = np.ascontiguousarray(
                np.moveaxis(img[:, ::-1, :], 0, -1),
                dtype=self.norm_image_data.dtype,  # f32, or u8 on the u8 wire
            )

        # GT nDSM patch (reference dataset.py:313-328)
        if not self.load_target:
            return out
        center = min_bound + self._dsm_pixel_size / 2.0
        col, row = self.dsm.query_col_row(center[0], center[1])
        h, w = self._dsm_patch_shape
        dsm = self.dsm_data[None, row - h + 1: row + 1, col: col + w]
        dsm = _augment_raster(dsm, rot_times, flip_dim)
        assert dsm.shape == (1, h, w), f"chunk_idx:{chunk_idx}"
        out["dsm"] = np.ascontiguousarray(dsm[0, ::-1, :], dtype=np.float32)
        return out


def _augment_raster(chw: np.ndarray, rot_times: int, flip_dim: int) -> np.ndarray:
    """Rotate clockwise k quarter-turns, then flip — identical to the reference's
    torch ``rot90(k, [-1, -2])`` / ``flip`` calls on CHW tensors (dataset.py:300-307)."""
    out = chw
    if rot_times > 0:
        out = np.rot90(out, rot_times, axes=(2, 1))  # clockwise in (H, W)
    if flip_dim == 0:  # points flipped along x -> image flips columns
        out = out[:, :, ::-1]
    elif flip_dim == 1:  # points flipped along y -> image flips rows
        out = out[:, ::-1, :]
    return out

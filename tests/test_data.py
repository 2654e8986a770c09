"""Dataset builder + patch sampler + batcher tests on a synthetic mini-city."""

import os
import sys

import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import PatchLoader, TomoSARDataset, build_dataset, pick_bucket
from tomosar2height_jax.data.pipeline import pad_points
from tomosar2height_jax.geo import RasterReader


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """Build the synthetic city + chunked dataset once per module."""
    import make_synthetic_city as msc

    root = tmp_path_factory.mktemp("city")
    msc.main(str(root), seed=0, density=0.3)
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=synthetic",
        f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"dataset.satellite_image.folder={root}/raster",
    ])
    info = build_dataset(cfg, overwrite=True)
    return cfg, root, info


class TestBuilder:
    def test_chunk_layout(self, city):
        cfg, root, info = city
        assert len(info) == 2  # 2x1 grid from synthetic chunk_x/chunk_y
        with open(f"{root}/generated/chunk_info.yaml") as f:
            on_disk = yaml.safe_load(f)
        assert on_disk[0]["name"] == "chunk_000"
        assert len(on_disk[0]["min_bound"]) == 3  # z bounds derived from GT DSM
        assert on_disk[0]["max_bound"][2] <= 60.0 + 35.0  # height + outlier slack
        npz = np.load(f"{root}/generated/chunk_000/input_point_cloud.npz")
        pts = npz["pts"]
        assert len(pts) > 1000
        # all chunk points inside the chunk bbox (strict crop)
        assert pts[:, 0].min() > 0.0 and pts[:, 0].max() < 640.0

    def test_refuses_overwrite(self, city):
        cfg, root, info = city
        with pytest.raises(FileExistsError):
            build_dataset(cfg, overwrite=False)


class TestDataset:
    def test_sliding_anchors(self, city):
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        # chunk 640 m, patch 512 m, strip 256 -> anchors {0, 128} per axis = 4
        assert len(ds) == 4

    def test_patch_contents(self, city):
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        p = ds[0]
        assert p["is_valid"]
        pts = p["inputs"]
        assert pts.dtype == np.float32
        assert (pts[:, :2] > 0).all() and (pts[:, :2] < 1).all()
        assert p["dsm"].shape == (512, 512)
        assert p["image"].shape == (512, 512, 3)
        assert p["transform"].dtype == np.float64

    def test_normalization_roundtrip(self, city):
        """transform maps normalized points back to world coordinates
        (reference dataset.py:265-275: transform = inv(normalize))."""
        from tomosar2height_jax.geo import apply_transform

        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        p = ds[0]
        world = apply_transform(p["inputs"].astype(np.float64), p["transform"])
        assert (world[:, 0] >= p["min_bound"][0] - 1e-3).all()
        assert (world[:, 0] <= p["max_bound"][0] + 1e-3).all()
        assert (world[:, 1] >= p["min_bound"][1] - 1e-3).all()

    def test_dsm_alignment_with_points(self, city):
        """y-up orientation: the DSM row for a point's y must match after the
        final vertical flip (reference dataset.py:328)."""
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        p = ds[0]
        pts, dsm = p["inputs"], p["dsm"]
        # pick high points (on roofs, z noise << height); check dsm nearby is high
        zs = pts[:, 2] * (cfg["dataset"]["normalize"]["z_bound"][1] -
                          cfg["dataset"]["normalize"]["z_bound"][0])
        hi = zs > 20
        if hi.sum() == 0:
            pytest.skip("no tall points in patch")
        sel = np.flatnonzero(hi)[:50]
        rows = (pts[sel, 1] * 512).astype(int).clip(0, 511)
        cols = (pts[sel, 0] * 512).astype(int).clip(0, 511)
        vals = dsm[rows, cols]
        assert (vals > 3).mean() > 0.8  # most tall points sit on tall DSM cells

    def test_augmentation_consistency(self, city):
        """Rotating/flipping must keep point/DSM alignment (dataset.py:300-328)."""
        cfg, root, _ = city
        np.random.seed(3)
        ds = TomoSARDataset("train", cfg["dataset"], random_sample=True,
                            random_length=8, flip_augm=True, rotate_augm=True)
        zb = cfg["dataset"]["normalize"]["z_bound"]
        checked = 0
        for i in range(8):
            p = ds[i]
            if not p["is_valid"] or (p["rotate"] == 0 and p["flip"] == -1):
                continue
            pts, dsm = p["inputs"], p["dsm"]
            zs = pts[:, 2] * (zb[1] - zb[0])
            hi = np.flatnonzero(zs > 20)[:50]
            if len(hi) < 10:
                continue
            rows = (pts[hi, 1] * 512).astype(int).clip(0, 511)
            cols = (pts[hi, 0] * 512).astype(int).clip(0, 511)
            assert (dsm[rows, cols] > 3).mean() > 0.7, (p["rotate"], p["flip"])
            checked += 1
        assert checked >= 2

    def test_empty_patch_invalid(self, city):
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        # fabricate an empty region query by cropping far corner of chunk 1 where
        # density 0.3 still has points; instead test the flag machinery directly
        # (inputs and the spatial index are a paired invariant — replace both)
        from tomosar2height_jax.geo.crop import GridIndex2D

        chunk = ds.data_dic[ds.dataset_chunk_idx_ls[0]]
        chunk["inputs"] = np.empty((0, 3))
        chunk["index"] = GridIndex2D(chunk["inputs"],
                                     cell_size=float(ds.patch_size[0]) / 2.0)
        p = ds[0]
        assert p["is_valid"] is False


class TestBatcher:
    def test_pick_bucket(self):
        assert pick_bucket(100, [1024, 2048]) == 1024
        assert pick_bucket(1500, [1024, 2048]) == 2048
        assert pick_bucket(99999, [1024, 2048]) == 2048

    def test_pad_points(self):
        pts = np.ones((10, 3), dtype=np.float32)
        out, mask = pad_points(pts, 16)
        assert out.shape == (16, 3) and mask.sum() == 10
        out, mask = pad_points(pts, 4, np.random.default_rng(0))
        assert out.shape == (4, 3) and mask.all()

    def test_loader_batches(self, city):
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        loader = PatchLoader(ds, batch_size=2,
                             bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"])
        batches = list(loader)
        assert len(batches) == 2
        b = batches[0]
        assert b["points"].shape[0] == 2
        assert b["points"].shape[1] in cfg["dataset"]["points"]["bucket_sizes"]
        assert b["point_mask"].shape == b["points"].shape[:2]
        assert b["dsm"].shape == (2, 512, 512)
        assert b["image"].shape == (2, 512, 512, 3)
        assert b["patch_valid"].all()

    def test_fixed_bucket_training(self, city):
        cfg, root, _ = city
        np.random.seed(0)
        ds = TomoSARDataset("train", cfg["dataset"], random_sample=True, random_length=4)
        loader = PatchLoader(ds, batch_size=2, bucket_sizes=[4096], fixed_bucket=4096,
                             shuffle=True)
        for b in loader:
            assert b["points"].shape[1] == 4096

    def test_prefetch_thread(self, city):
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        loader = PatchLoader(ds, batch_size=2,
                             bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"],
                             prefetch=2)
        assert len(list(loader)) == 2

    def test_n_workers_matches_sync(self, city):
        """Threaded patch fetch must preserve order and content exactly."""
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        kw = dict(bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"])
        sync = list(PatchLoader(ds, batch_size=2, **kw))
        par = list(PatchLoader(ds, batch_size=2, n_workers=4, prefetch=2, **kw))
        assert len(sync) == len(par)
        for a, b in zip(sync, par):
            assert a["name"] == b["name"]
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["dsm"], b["dsm"])

    def test_overflow_counters(self, city):
        """Bucket-overflow subsampling is counted and logged, never silent."""
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        # force overflow with a tiny bucket
        loader = PatchLoader(ds, batch_size=2, bucket_sizes=[64])
        list(loader)
        assert loader.overflow_patches > 0
        assert loader.overflow_points > 0
        # counts reset per epoch
        big = PatchLoader(ds, batch_size=2, bucket_sizes=[1 << 20])
        list(big)
        assert big.overflow_patches == 0 and big.overflow_points == 0

    def test_uint8_image_wire_matches_f32_normalization(self, city):
        """satellite_image.wire=uint8 ships RAW u8 crops (4x less upload /
        RAM); normalizing them with the dataset's (mean, std) must reproduce
        the f32 wire's host-normalized crops exactly (integral u8 source)."""
        import copy

        cfg, root, _ = city
        ds_f = TomoSARDataset("vis", cfg["dataset"])
        d8 = copy.deepcopy(dict(cfg["dataset"]))
        d8["satellite_image"]["wire"] = "uint8"
        ds_8 = TomoSARDataset("vis", d8)
        assert ds_8.image_norm is not None and ds_f.image_norm is None
        mean, std = ds_8.image_norm
        for i in (0, len(ds_f) // 2):
            pf, p8 = ds_f[i], ds_8[i]
            assert p8["image"].dtype == np.uint8
            assert pf["image"].dtype == np.float32
            norm = (p8["image"].astype(np.float32) - mean) / std
            np.testing.assert_allclose(norm, pf["image"], atol=1e-5, rtol=0)

    def test_regular_loader_deterministic_across_iterations(self, city):
        """Serving/eval loaders (regular patching, no shuffle) must yield
        bit-identical batches on re-iteration even when over-bucket patches
        are subsampled — repeated generate_dsm calls see the same points."""
        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        loader = PatchLoader(ds, batch_size=2, bucket_sizes=[64])  # overflow
        first = [b["points"].copy() for b in loader]
        second = [b["points"].copy() for b in loader]
        assert loader.overflow_patches > 0, "test needs subsampled patches"
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        # a fresh identically-constructed loader matches too
        third = [b["points"].copy()
                 for b in PatchLoader(ds, batch_size=2, bucket_sizes=[64])]
        for a, b in zip(first, third):
            np.testing.assert_array_equal(a, b)


class TestPointDensityTool:
    def test_report(self, city):
        import point_density

        cfg, root, _ = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        counts = point_density.patch_point_counts(ds)
        assert (counts > 0).any()
        text = point_density.report(counts, [64], bins=5)
        assert "overflow at largest bucket 64" in text
        assert "recommended" in text
        # no overflow case
        text2 = point_density.report(counts, [1 << 20], bins=5)
        assert "0 patches (0.00%)" in text2

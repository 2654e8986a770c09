"""Instance evaluator, interpolation baselines, FLT parser, split_tiff tests."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from tomosar2height_jax.geo import RasterData, RasterReader, RasterWriter
from tomosar2height_jax.infer.baselines import interpolate_ndsm, max_z_per_pixel
from tomosar2height_jax.infer.instance import (
    buildingwise_errors,
    label_buildings,
    median_height_per_building,
    pointcloud_median_baseline,
)


def _raster(data, bl=(0, 0), tr=None, epsg=25832):
    tr = tr or (data.shape[1], data.shape[0])
    rd = RasterData()
    rd.set_transform(bl, tr, [1, 1], epsg)
    rd.set_data(np.asarray(data, dtype=np.float32))
    return rd


class TestInstanceEval:
    def test_labeling_8conn(self):
        m = np.zeros((5, 5))
        m[0, 0] = 1
        m[1, 1] = 1  # diagonal touch -> same building with 8-connectivity
        m[4, 4] = 1
        labels, n = label_buildings(m)
        assert n == 2
        assert labels[0, 0] == labels[1, 1]

    def test_median_heights(self):
        m = np.zeros((5, 5))
        m[:2, :2] = 1
        m[3:, 3:] = 1  # separated: 8-connectivity must NOT merge
        h = np.zeros((5, 5))
        h[:2, :2] = [[10, 10], [20, 20]]
        h[3:, 3:] = 5
        labels, n = label_buildings(m)
        med = median_height_per_building(h, labels, n)
        assert sorted(med.tolist()) == [5.0, 15.0]

    def test_buildingwise_errors_zero_for_perfect(self):
        m = np.zeros((8, 8))
        m[1:3, 1:3] = 1
        m[5:7, 5:7] = 1
        gt = np.where(m > 0, 12.0, 0.0)
        out = buildingwise_errors(gt, gt, m)
        assert out["RMSE_B"] == 0 and out["n_buildings"] == 2

    def test_buildingwise_known_error(self):
        m = np.zeros((8, 8))
        m[1:3, 1:3] = 1
        gt = np.where(m > 0, 10.0, 0.0)
        pred = np.where(m > 0, 13.0, 0.0)
        out = buildingwise_errors(pred, gt, m)
        assert out["RMSE_B"] == pytest.approx(3.0)
        assert out["MAE_B"] == pytest.approx(3.0)

    def test_pointcloud_baseline(self):
        mask = np.zeros((10, 10))
        mask[2:5, 2:5] = 1  # rows 2-4, cols 2-4 -> world y in [5, 8), x in [2, 5)
        gt = np.where(mask > 0, 20.0, 0.0)
        gt_r, mask_r = _raster(gt), _raster(mask)
        pts = np.array([[3.5, 6.5, 21.0], [3.0, 6.0, 19.0], [3.2, 6.2, 20.0]])
        out = pointcloud_median_baseline(pts, gt_r, mask_r)
        assert out["n_buildings"] == 1
        assert out["MAE_B"] == pytest.approx(0.0)

    def test_pointcloud_baseline_empty_building(self):
        mask = np.zeros((10, 10))
        mask[2:4, 2:4] = 1
        mask[7:9, 7:9] = 1
        gt = np.where(mask > 0, 10.0, 0.0)
        pts = np.array([[2.5, 6.8, 10.0]])  # inside first building only
        out_all = pointcloud_median_baseline(pts, _raster(gt), _raster(mask),
                                             include_empty=True)
        out_valid = pointcloud_median_baseline(pts, _raster(gt), _raster(mask),
                                               include_empty=False)
        assert out_all["n_buildings"] == 2  # empty scored as 0 (MAE 5)
        assert out_valid["n_buildings"] == 1
        assert out_all["MAE_B"] > out_valid["MAE_B"]


class TestBaselines:
    def test_max_z_per_pixel(self):
        pts = np.array([[0.5, 0.5, 1.0], [0.6, 0.6, 3.0], [1.5, 0.5, 2.0]])
        xy, z = max_z_per_pixel(pts, [0, 0], [2, 1], [1, 1])
        assert len(z) == 2
        assert set(z.tolist()) == {3.0, 2.0}

    @pytest.mark.parametrize("method", ["bilinear", "idw", "nearest"])
    def test_interpolation_recovers_plane(self, rng, method):
        # points on the plane z = x + 2y; all methods should reproduce it closely
        n = 4000
        pts = np.stack([
            rng.uniform(0, 32, n), rng.uniform(0, 32, n), np.zeros(n)
        ], axis=1)
        pts[:, 2] = pts[:, 0] + 2 * pts[:, 1]
        grid = interpolate_ndsm(pts, [0, 0], [32, 32], [1, 1], method=method)
        assert grid.shape == (32, 32)
        # expected value at pixel center (r, c): x=c+0.5, y=31.5-r
        cc, rr = np.meshgrid(np.arange(32), np.arange(32))
        expect = (cc + 0.5) + 2 * (31.5 - rr)
        err = np.abs(grid - expect)[4:-4, 4:-4]  # ignore borders
        assert err.mean() < 1.5, (method, err.mean())


class TestFLT:
    def test_roundtrip_3d(self, tmp_path, rng):
        from read_flt import read_flt_3d, write_flt_3d

        pts = rng.normal(size=(100, 3)).astype(np.float32)
        p = str(tmp_path / "a.flt")
        write_flt_3d(p, pts)
        out = read_flt_3d(p)
        np.testing.assert_allclose(out, pts, atol=1e-6)


class TestSplitTiff:
    def test_split_chunks_georef(self, tmp_path, rng):
        from split_tiff import split_chunks

        rd = RasterData()
        rd.set_transform([0, 0], [64, 32], [1, 1], 25832)
        arr = rng.normal(size=(32, 64)).astype(np.float32)
        rd.set_data(arr)
        src_path = str(tmp_path / "full.tif")
        RasterWriter(rd).write_to_file(src_path)

        n = split_chunks(src_path, [0.0, 32.0, 64.0], [0.0, 32.0], str(tmp_path / "out"))
        assert n == 2
        t0 = RasterReader(str(tmp_path / "out" / "chunk_000.tif"))
        assert t0.shape == (32, 32)
        np.testing.assert_array_equal(t0.get_data(), arr[:, :32])
        assert t0.T.c == 0.0 and t0.T.f == 32.0
        t1 = RasterReader(str(tmp_path / "out" / "chunk_001.tif"))
        np.testing.assert_array_equal(t1.get_data(), arr[:, 32:])
        assert t1.T.c == 32.0

import numpy as np
import pytest

from tomosar2height_jax.geo import RasterData, RasterReader, RasterWriter
from tomosar2height_jax.geo.cloud import load_pc, save_las, save_pc_to_ply, load_ply, load_las_as_numpy
from tomosar2height_jax.geo.tiff import read_tiff, write_tiff


class TestTiffCodec:
    @pytest.mark.parametrize("compress", [None, "deflate"])
    @pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32])
    def test_roundtrip(self, tmp_path, rng, compress, dtype):
        if np.dtype(dtype).kind == "f":
            data = rng.normal(size=(2, 37, 53)).astype(dtype)
        else:
            data = rng.integers(0, 100, size=(2, 37, 53)).astype(dtype)
        path = str(tmp_path / "t.tif")
        write_tiff(path, data, transform=(2.0, 0.0, 100.0, 0.0, -2.0, 500.0),
                   crs_epsg=25832, nodata=-9999.0, compress=compress, dtype=dtype)
        out, info = read_tiff(path)
        np.testing.assert_array_equal(out, data)
        assert info.crs_epsg == 25832
        assert info.nodata == -9999.0
        np.testing.assert_allclose(info.transform, (2.0, 0.0, 100.0, 0.0, -2.0, 500.0))

    def test_single_band_2d(self, tmp_path):
        data = np.arange(12, dtype=np.float32).reshape(3, 4)
        path = str(tmp_path / "s.tif")
        write_tiff(path, data)
        out, info = read_tiff(path)
        assert out.shape == (1, 3, 4)
        np.testing.assert_array_equal(out[0], data)

    def test_large_multistrip(self, tmp_path, rng):
        # force several strips (strip target is ~1 MiB)
        data = rng.normal(size=(1, 700, 701)).astype(np.float32)
        path = str(tmp_path / "big.tif")
        write_tiff(path, data)
        out, _ = read_tiff(path)
        np.testing.assert_array_equal(out, data)

    def test_read_pil_written(self, tmp_path):
        """Cross-validate the reader against an independent TIFF producer."""
        PIL = pytest.importorskip("PIL.Image")
        arr = (np.arange(64 * 48, dtype=np.uint8).reshape(48, 64) % 251)
        p = str(tmp_path / "pil.tif")
        PIL.fromarray(arr).save(p)
        out, info = read_tiff(p)
        np.testing.assert_array_equal(out[0], arr)

    def test_read_pil_lzw_and_rgb(self, tmp_path, rng):
        PIL = pytest.importorskip("PIL.Image")
        arr = rng.integers(0, 255, size=(40, 60, 3)).astype(np.uint8)
        p = str(tmp_path / "pil_lzw.tif")
        PIL.fromarray(arr).save(p, compression="tiff_lzw")
        out, info = read_tiff(p)
        assert out.shape == (3, 40, 60)
        np.testing.assert_array_equal(np.moveaxis(out, 0, -1), arr)

    @pytest.mark.parametrize("compress", [None, "deflate"])
    def test_bigtiff_roundtrip(self, tmp_path, rng, compress):
        data = rng.normal(size=(2, 137, 211)).astype(np.float32)
        path = str(tmp_path / "bt.tif")
        write_tiff(path, data, transform=(0.5, 0.0, 7.0, 0.0, -0.5, 42.0),
                   crs_epsg=32633, nodata=-9999.0, compress=compress,
                   bigtiff=True)
        with open(path, "rb") as f:
            assert f.read(4) == b"II" + b"\x2b\x00"  # magic 43
        out, info = read_tiff(path)
        np.testing.assert_array_equal(out, data)
        assert info.crs_epsg == 32633
        assert info.nodata == -9999.0
        np.testing.assert_allclose(info.transform, (0.5, 0.0, 7.0, 0.0, -0.5, 42.0))

    def test_bigtiff_single_strip_inline_offsets(self, tmp_path):
        # 1 strip -> offsets fit the 8-byte inline field (exercises that path)
        data = np.arange(12, dtype=np.float32).reshape(3, 4)
        path = str(tmp_path / "bt1.tif")
        write_tiff(path, data, bigtiff=True)
        out, _ = read_tiff(path)
        np.testing.assert_array_equal(out[0], data)

    def test_bigtiff_auto_and_classic_guard(self, tmp_path, monkeypatch):
        """Over-limit rasters auto-select BigTIFF; forcing classic raises early.

        Shrinks the module's offset ceiling so a small array stands in for a
        >4 GB one (allocating 4 GB in the test is not an option).
        """
        import tomosar2height_jax.geo.tiff as tiff_mod

        data = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)  # 16 KiB
        monkeypatch.setattr(tiff_mod, "_CLASSIC_OFFSET_LIMIT", 1 << 10)
        p = str(tmp_path / "auto.tif")
        tiff_mod.write_tiff(p, data)  # auto: must pick BigTIFF
        with open(p, "rb") as f:
            assert f.read(4) == b"II\x2b\x00"
        out, _ = read_tiff(p)
        np.testing.assert_array_equal(out[0], data)
        # forcing classic past the ceiling must raise, not write garbage
        with pytest.raises(ValueError, match="classic TIFF"):
            tiff_mod.write_tiff(str(tmp_path / "x.tif"), data, bigtiff=False)

    def test_pil_reads_our_bigtiff(self, tmp_path):
        PIL = pytest.importorskip("PIL.Image")
        data = np.linspace(0, 5, 24 * 17, dtype=np.float32).reshape(24, 17)
        p = str(tmp_path / "ours_bt.tif")
        write_tiff(p, data, bigtiff=True)
        img = np.array(PIL.open(p))
        np.testing.assert_array_equal(img, data)

    def test_pil_can_read_ours(self, tmp_path):
        PIL = pytest.importorskip("PIL.Image")
        data = np.linspace(0, 1, 30 * 20, dtype=np.float32).reshape(30, 20)
        p = str(tmp_path / "ours.tif")
        write_tiff(p, data)
        img = np.array(PIL.open(p))
        np.testing.assert_array_equal(img, data)


class TestRaster:
    def test_cal_dsm_shape(self):
        # reference io_raster.py:77-95 floor semantics
        assert RasterData.cal_dsm_shape([0, 0], [100, 50], [1, 1]) == (50, 100)
        assert RasterData.cal_dsm_shape([0, 0], [101.5, 50.7], [2, 2]) == (25, 50)

    def test_set_transform_and_queries(self):
        rd = RasterData()
        rd.set_transform(bl_bound=[100, 0], tr_bound=[200, 50], pixel_size=[1, 1], crs_epsg=25832)
        rd.set_data(np.zeros((50, 100), dtype=np.float32))
        # top-left pixel center
        col, row = rd.query_col_row(100.5, 49.5)
        assert (col, row) == (0, 0)
        col, row = rd.query_col_row(199.5, 0.5)
        assert (col, row) == (99, 49)
        assert rd.is_in(99, 49) and not rd.is_in(100, 49)

    def test_query_values_outer(self):
        rd = RasterData()
        rd.set_transform([0, 0], [4, 4], [1, 1], 25832)
        rd.set_data(np.arange(16, dtype=np.float32).reshape(4, 4))
        vals = rd.query_values(np.array([[0.5, 3.5], [10.0, 10.0]]), outer_value=-1)
        assert vals[0] == 0.0 and vals[1] == -1

    def test_writer_reader_roundtrip(self, tmp_path, rng):
        rd = RasterData()
        rd.set_transform([384590.0, 5819040.0], [384690.0, 5819140.0], [1, 1], 25833)
        arr = rng.normal(size=(100, 100)).astype(np.float32)
        rd.set_data(arr)
        w = RasterWriter(rd)
        path = str(tmp_path / "dsm.tiff")
        assert w.write_to_file(path)
        r = RasterReader(path)
        np.testing.assert_array_equal(r.get_data(1), arr)
        assert r.pixel_size == [1.0, 1.0]
        assert r.crs_epsg == 25833
        assert r.T == rd.T
        # rasterio-style index()
        row, col = r.index(384590.5, 5819139.5)
        assert (row, col) == (0, 0)

    def test_set_data_shape_guard(self):
        rd = RasterData()
        rd.set_data(np.zeros((4, 4)))
        rd.set_data(np.zeros((5, 5)), band=2)  # inconsistent -> ignored
        assert rd.get_data(2) is None


class TestCloudIO:
    def test_las_roundtrip(self, tmp_path, rng):
        pts = rng.normal(size=(100, 3)) * 100 + np.array([686167.0, 5331627.0, 500.0])
        path = str(tmp_path / "c.las")
        save_las(path, pts)
        out = load_las_as_numpy(path)
        np.testing.assert_allclose(out, pts, atol=1e-3)
        out2 = load_pc(path)
        np.testing.assert_allclose(out2, pts, atol=1e-3)

    def test_ply_roundtrip(self, tmp_path, rng):
        pts = rng.normal(size=(50, 3))
        path = str(tmp_path / "c.ply")
        save_pc_to_ply(path, pts)
        out = load_ply(path)
        np.testing.assert_allclose(out, pts, atol=1e-12)
        assert load_pc(path).shape == (50, 3)

    def test_ply_with_colors(self, tmp_path, rng):
        pts = rng.normal(size=(10, 3))
        colors = rng.uniform(size=(10, 3))
        path = str(tmp_path / "col.ply")
        save_pc_to_ply(path, pts, colors)
        out = load_ply(path)
        np.testing.assert_allclose(out, pts, atol=1e-12)

    def test_npz_npy_xyz(self, tmp_path, rng):
        pts = rng.normal(size=(20, 3))
        np.save(tmp_path / "a.npy", pts)
        np.savez(tmp_path / "a.npz", pts=pts)
        np.savetxt(tmp_path / "a.xyz", pts)
        np.testing.assert_allclose(load_pc(str(tmp_path / "a.npy")), pts)
        np.testing.assert_allclose(load_pc(str(tmp_path / "a.npz")), pts)
        np.testing.assert_allclose(load_pc(str(tmp_path / "a.xyz")), pts, atol=1e-12)

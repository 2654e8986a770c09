"""C++ runtime parity tests vs the numpy oracles (native/tomosar_native.cpp)."""

import numpy as np
import pytest

from tomosar2height_jax import native
from tomosar2height_jax.geo.cloud import save_las
from tomosar2height_jax.geo.transform import apply_transform

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib unavailable")


class TestCrop:
    def test_matches_numpy(self, rng):
        pts = rng.uniform(0, 100, (50000, 3))
        idx = native.crop_pc_2d_index(pts, [20, 30], [70, 80])
        want = np.nonzero((pts[:, 0] > 20) & (pts[:, 0] < 70)
                          & (pts[:, 1] > 30) & (pts[:, 1] < 80))[0]
        np.testing.assert_array_equal(idx, want)

    def test_strict_boundary(self):
        pts = np.array([[0.0, 5.0, 0], [10.0, 5.0, 0], [5.0, 5.0, 0]])
        idx = native.crop_pc_2d_index(pts, [0, 0], [10, 10])
        assert idx.tolist() == [2]


class TestTransform:
    def test_matches_numpy(self, rng):
        pts = rng.uniform(-10, 10, (1000, 3))
        m = np.eye(4)
        m[:3, :3] = rng.normal(size=(3, 3))
        m[:3, 3] = rng.normal(size=3)
        got = native.transform_points_f32(pts, m)
        want = apply_transform(pts, m).astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_fused_crop_transform(self, rng):
        pts = rng.uniform(0, 100, (30000, 3))
        # normalize [20, 70] x [30, 80] to the unit square
        m = np.diag([1 / 50.0, 1 / 50.0, 1.0, 1.0])
        m[0, 3], m[1, 3] = -20 / 50.0, -30 / 50.0
        got = native.crop_transform_patch(pts, [20, 30], [70, 80], m)
        # oracle: crop -> transform -> unit recrop
        sel = (pts[:, 0] > 20) & (pts[:, 0] < 70) & (pts[:, 1] > 30) & (pts[:, 1] < 80)
        t = apply_transform(pts[sel], m).astype(np.float32)
        inside = (t[:, 0] > 0) & (t[:, 0] < 1) & (t[:, 1] > 0) & (t[:, 1] < 1)
        want = t[inside]
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestLas:
    def test_matches_python_parser(self, tmp_path, rng):
        pts = rng.uniform([384590, 5819040, 30], [385102, 5819552, 80], (5000, 3))
        p = str(tmp_path / "c.las")
        save_las(p, pts)
        got = native.las_read(p)
        np.testing.assert_allclose(got, pts, atol=1e-3)

    def test_error_codes(self, tmp_path):
        p = str(tmp_path / "junk.las")
        open(p, "wb").write(b"NOPE" * 100)
        with pytest.raises(ValueError):
            native.las_read(p)


class TestBucket:
    def test_cells_and_order(self, rng):
        from tomosar2height_jax.ops.scatter import cell_index
        import jax.numpy as jnp

        pts = rng.uniform(0.01, 0.99, (10000, 2)).astype(np.float32)
        cells, order = native.bucket_points(pts, 64)
        want = np.asarray(cell_index(jnp.asarray(pts[None]), 64))[0]
        np.testing.assert_array_equal(cells, want)
        # order is a permutation making cells non-decreasing
        assert np.array_equal(np.sort(order), np.arange(10000))
        assert (np.diff(cells[order]) >= 0).all()


class TestMaxZGrid:
    def test_matches_numpy(self, rng):
        from tomosar2height_jax.infer.baselines import max_z_per_pixel

        pts = rng.uniform([0, 0, 0], [32, 16, 50], (5000, 3))
        grid = native.max_z_grid(pts, [0, 0], [32, 16], [1, 1])
        assert grid.shape == (16, 32)
        xy, z = max_z_per_pixel(pts, [0, 0], [32, 16], [1, 1])
        # every occupied pixel must agree
        cols = np.floor(xy[:, 0]).astype(int)
        rows = np.floor(16 - xy[:, 1]).astype(int)
        np.testing.assert_allclose(grid[rows, cols], z, rtol=1e-6)


class TestBlend:
    def test_matches_numpy(self, rng):
        H, W, ph, pw = 64, 64, 16, 16
        dsm_n = np.zeros((H, W)); wgt_n = np.zeros((H, W))
        dsm_c = np.zeros((H, W)); wgt_c = np.zeros((H, W))
        for _ in range(5):
            patch = rng.normal(size=(ph, pw))
            w = rng.uniform(0.1, 1, (ph, pw))
            r0, c0 = rng.integers(-4, H - 8), rng.integers(-4, W - 8)
            rs, cs = slice(max(r0, 0), min(r0 + ph, H)), slice(max(c0, 0), min(c0 + pw, W))
            prs = slice(max(-r0, 0), max(-r0, 0) + (rs.stop - rs.start))
            pcs = slice(max(-c0, 0), max(-c0, 0) + (cs.stop - cs.start))
            dsm_n[rs, cs] += patch[prs, pcs] * w[prs, pcs]
            wgt_n[rs, cs] += w[prs, pcs]
            assert native.blend_accumulate(dsm_c, wgt_c, patch, w, int(r0), int(c0))
        np.testing.assert_allclose(dsm_c, dsm_n, atol=1e-12)
        np.testing.assert_allclose(wgt_c, wgt_n, atol=1e-12)

    @pytest.mark.parametrize("nthreads", [1, 4])
    def test_batch_matches_per_patch(self, rng, nthreads):
        """Threaded banded batch blend == sequential per-patch blends, with
        overlapping patches, out-of-range offsets, and invalid entries."""
        H, W, ph, pw, B = 48, 80, 16, 16, 7
        dsm_s = np.zeros((H, W)); wgt_s = np.zeros((H, W))
        dsm_b = np.zeros((H, W)); wgt_b = np.zeros((H, W))
        patches = rng.normal(size=(B, ph, pw))
        w = rng.uniform(0.1, 1, (ph, pw))
        rows0 = rng.integers(-4, H - 8, B)
        cols0 = rng.integers(-4, W - 8, B)
        rows0[2] = rows0[3]  # force overlap
        cols0[3] = cols0[2] + 4
        valid = np.ones(B, bool)
        valid[5] = False
        for i in range(B):
            if valid[i]:
                assert native.blend_accumulate(dsm_s, wgt_s, patches[i], w,
                                               int(rows0[i]), int(cols0[i]))
        assert native.blend_accumulate_batch(dsm_b, wgt_b, patches, w,
                                             rows0, cols0, valid, nthreads)
        np.testing.assert_allclose(dsm_b, dsm_s, atol=1e-12)
        np.testing.assert_allclose(wgt_b, wgt_s, atol=1e-12)


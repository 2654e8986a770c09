"""Golden-parity tests for device ops vs torch-CPU oracles (SURVEY.md §7.3)."""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from tomosar2height_jax.ops import (  # noqa: E402
    cell_index,
    segment_mean,
    segment_max,
    scatter_mean_to_plane,
    pool_local_max,
    grid_sample_2d,
    resize_bilinear,
)


def torch_scatter_mean(values, index, num_segments):
    """Oracle for torch_scatter.scatter_mean with zero-filled empty cells."""
    b, n, c = values.shape
    out = torch.zeros(b, num_segments, c, dtype=values.dtype)
    cnt = torch.zeros(b, num_segments, 1, dtype=values.dtype)
    idx = index[..., None].expand(-1, -1, c)
    out.scatter_add_(1, idx, values)
    cnt.scatter_add_(1, index[..., None], torch.ones(b, n, 1, dtype=values.dtype))
    return out / cnt.clamp(min=1.0)


def torch_scatter_max(values, index, num_segments):
    b, n, c = values.shape
    out = torch.full((b, num_segments, c), -torch.inf, dtype=values.dtype)
    idx = index[..., None].expand(-1, -1, c)
    out = out.scatter_reduce(1, idx, values, reduce="amax", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros(()))


class TestCellIndex:
    def test_matches_reference_formula(self, rng):
        pts = rng.uniform(1e-4, 1 - 1e-4, size=(2, 100, 2)).astype(np.float32)
        idx = np.asarray(cell_index(jnp.asarray(pts), 16))
        expect = (pts[..., 0] * 16).astype(np.int64) + 16 * (pts[..., 1] * 16).astype(np.int64)
        np.testing.assert_array_equal(idx, expect)

    def test_clips_boundary(self):
        pts = jnp.array([[[1.0, 1.0], [0.0, 0.0]]])
        idx = np.asarray(cell_index(pts, 4))
        assert idx.tolist() == [[15, 0]]


class TestSegmentOps:
    @pytest.mark.parametrize("num_segments", [4, 64])
    def test_mean_vs_torch(self, rng, num_segments):
        b, n, c = 3, 200, 8
        vals = rng.normal(size=(b, n, c)).astype(np.float32)
        idx = rng.integers(0, num_segments, size=(b, n))
        got = np.asarray(segment_mean(jnp.asarray(vals), jnp.asarray(idx), num_segments))
        want = torch_scatter_mean(torch.tensor(vals), torch.tensor(idx), num_segments).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_max_vs_torch(self, rng):
        b, n, c, s = 2, 150, 4, 16
        vals = rng.normal(size=(b, n, c)).astype(np.float32)
        idx = rng.integers(0, s, size=(b, n))
        got = np.asarray(segment_max(jnp.asarray(vals), jnp.asarray(idx), s))
        want = torch_scatter_max(torch.tensor(vals), torch.tensor(idx), s).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_mask_excludes_padding(self, rng):
        b, n, c, s = 1, 50, 3, 8
        vals = rng.normal(size=(b, n, c)).astype(np.float32)
        idx = rng.integers(0, s, size=(b, n))
        mask = np.zeros((b, n), dtype=bool)
        mask[:, :30] = True
        got = np.asarray(segment_mean(jnp.asarray(vals), jnp.asarray(idx), s, jnp.asarray(mask)))
        want = torch_scatter_mean(
            torch.tensor(vals[:, :30]), torch.tensor(idx[:, :30]), s
        ).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        # padded garbage must not leak even with extreme values
        vals2 = vals.copy()
        vals2[:, 30:] = 1e30
        got2 = np.asarray(segment_mean(jnp.asarray(vals2), jnp.asarray(idx), s, jnp.asarray(mask)))
        np.testing.assert_allclose(got2, want, atol=1e-5)

    def test_masked_max(self, rng):
        b, n, c, s = 1, 40, 2, 4
        vals = rng.normal(size=(b, n, c)).astype(np.float32)
        vals[:, 20:] = 1e30
        idx = rng.integers(0, s, size=(b, n))
        mask = np.arange(n)[None, :] < 20
        got = np.asarray(segment_max(jnp.asarray(vals), jnp.asarray(idx), s, jnp.asarray(mask)))
        want = torch_scatter_max(torch.tensor(vals[:, :20]), torch.tensor(idx[:, :20]), s).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_empty_cells_are_zero(self):
        vals = jnp.ones((1, 3, 2))
        idx = jnp.zeros((1, 3), dtype=jnp.int32)
        mean = np.asarray(segment_mean(vals, idx, 4))
        mx = np.asarray(segment_max(vals, idx, 4))
        assert (mean[0, 1:] == 0).all() and (mx[0, 1:] == 0).all()
        assert (mean[0, 0] == 1).all() and (mx[0, 0] == 1).all()

    def test_pool_local_gather_back(self, rng):
        # reference pointnet.py:92-99: pooled value of a point's own cell
        b, n, c, reso = 1, 30, 4, 4
        vals = rng.normal(size=(b, n, c)).astype(np.float32)
        coords = rng.uniform(0.01, 0.99, size=(b, n, 2)).astype(np.float32)
        idx = cell_index(jnp.asarray(coords), reso)
        out = np.asarray(pool_local_max(jnp.asarray(vals), idx, reso))
        idx_np = np.asarray(idx)
        for p in range(n):
            same_cell = idx_np[0] == idx_np[0, p]
            np.testing.assert_allclose(out[0, p], vals[0, same_cell].max(axis=0), atol=1e-6)

    def test_plane_orientation(self):
        # point at (x=0.9, y=0.1) must land at row 0 (y), col 3 (x) for reso 4
        coords = jnp.array([[[0.9, 0.1]]])
        vals = jnp.ones((1, 1, 1))
        plane = np.asarray(scatter_mean_to_plane(coords, vals, 4))
        assert plane.shape == (1, 4, 4, 1)
        assert plane[0, 0, 3, 0] == 1.0
        assert plane.sum() == 1.0


class TestGridSample:
    @pytest.mark.parametrize("mode", ["bilinear", "nearest"])
    def test_vs_torch(self, rng, mode):
        b, h, w, c, n = 2, 16, 16, 5, 200
        plane = rng.normal(size=(b, h, w, c)).astype(np.float32)
        xy = rng.uniform(0, 1, size=(b, n, 2)).astype(np.float32)
        got = np.asarray(grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy), mode=mode))
        # torch oracle: NCHW, vgrid = 2*xy - 1 (reference alto.py:90-95)
        tp = torch.tensor(plane).permute(0, 3, 1, 2)
        grid = torch.tensor(xy)[:, :, None] * 2.0 - 1.0
        want = F.grid_sample(tp, grid, padding_mode="border", align_corners=True, mode=mode)
        want = want.squeeze(-1).permute(0, 2, 1).numpy()
        atol = 1e-5 if mode == "bilinear" else 0
        np.testing.assert_allclose(got, want, atol=atol)

    def test_border_clamp(self, rng):
        plane = rng.normal(size=(1, 4, 4, 1)).astype(np.float32)
        xy = np.array([[[-0.5, -0.5], [1.5, 1.5], [0.0, 0.0], [1.0, 1.0]]], dtype=np.float32)
        got = np.asarray(grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy)))
        np.testing.assert_allclose(got[0, 0, 0], plane[0, 0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(got[0, 1, 0], plane[0, 3, 3, 0], atol=1e-6)
        np.testing.assert_allclose(got[0, 2, 0], plane[0, 0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(got[0, 3, 0], plane[0, 3, 3, 0], atol=1e-6)


class TestResize:
    @pytest.mark.parametrize("hw", [(16, 16), (8, 8), (32, 32), (31, 17)])
    def test_vs_torch_interpolate(self, rng, hw):
        b, h, w, c = 2, 16, 16, 3
        x = rng.normal(size=(b, h, w, c)).astype(np.float32)
        got = np.asarray(resize_bilinear(jnp.asarray(x), hw))
        tx = torch.tensor(x).permute(0, 3, 1, 2)
        want = F.interpolate(tx, size=hw, mode="bilinear", align_corners=True)
        want = want.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_identity(self, rng):
        x = rng.normal(size=(1, 8, 8, 2)).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(resize_bilinear(jnp.asarray(x), (8, 8))), x)

    @pytest.mark.parametrize("hw", [(16, 16), (32, 32), (12, 20)])
    def test_cubic_vs_torch_bicubic(self, rng, hw):
        """resize_cubic == F.interpolate(mode='bicubic', align_corners=True)
        (the hourglass upsample, reference hourglass.py:126)."""
        from tomosar2height_jax.ops.resize import resize_cubic

        b, h, w, c = 2, 8, 8, 3
        x = rng.normal(size=(b, h, w, c)).astype(np.float32)
        got = np.asarray(resize_cubic(jnp.asarray(x), hw))
        tx = torch.tensor(x).permute(0, 3, 1, 2)
        want = F.interpolate(tx, size=hw, mode="bicubic", align_corners=True)
        want = want.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

"""Morton-sorted scatter path vs the unsorted reference ops (property parity)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tomosar2height_jax.ops.scatter import cell_index, pool_local_max, scatter_mean_to_plane
from tomosar2height_jax.ops.sorted_scatter import (
    coarsen_offsets,
    gather_cells_sorted,
    host_morton_bucket,
    morton_interleave_np,
    morton_to_plane,
    plane_to_morton,
    run_starts,
    sorted_segment_max,
    sorted_segment_mean,
)


def _bucketed(rng, n_valid=700, n_pad=1024, reso=16, c=5):
    pts = rng.uniform(0.001, 0.999, (n_pad, 3)).astype(np.float32)
    mask = np.arange(n_pad) < n_valid
    feats = rng.normal(size=(n_pad, c)).astype(np.float32)
    order, cells, offsets = host_morton_bucket(pts, mask, reso)
    return pts, mask, feats, order, cells, offsets


class TestHostBucket:
    def test_order_and_offsets(self, rng):
        pts, mask, feats, order, cells, offsets = _bucketed(rng)
        assert (np.diff(cells) >= 0).all()
        # padded points sort last with sentinel id
        assert (cells[mask.sum():] == 16 * 16).all()
        # offsets partition exactly the valid points
        assert offsets[0] == 0 and offsets[-1] == mask.sum()
        counts = np.diff(offsets)
        assert counts.sum() == mask.sum()

    def test_morton_code(self):
        # (x=1, y=0) -> 1; (x=0, y=1) -> 2; (x=1, y=1) -> 3; (x=2, y=0) -> 4
        x = np.array([1, 0, 1, 2])
        y = np.array([0, 1, 1, 0])
        np.testing.assert_array_equal(morton_interleave_np(x, y, 2), [1, 2, 3, 4])


class TestMortonPlane:
    @pytest.mark.parametrize("reso", [2, 8, 32])
    def test_roundtrip(self, rng, reso):
        vec = jnp.asarray(rng.normal(size=(2, reso * reso, 3)).astype(np.float32))
        plane = morton_to_plane(vec, reso)
        back = plane_to_morton(plane)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(vec))

    def test_known_layout(self):
        # morton id of (x, y): plane[y, x] must pick morton_vec[interleave(x, y)]
        reso = 4
        vec = jnp.arange(16, dtype=jnp.float32).reshape(1, 16, 1)
        plane = np.asarray(morton_to_plane(vec, reso))[0, :, :, 0]
        for y in range(4):
            for x in range(4):
                assert plane[y, x] == morton_interleave_np(np.array([x]), np.array([y]), 2)[0]


class TestSortedReductions:
    def test_mean_matches_unsorted_plane(self, rng):
        pts, mask, feats, order, cells, offsets = _bucketed(rng)
        reso = 16
        want = np.asarray(scatter_mean_to_plane(
            jnp.asarray(pts[None, :, :2]), jnp.asarray(feats[None]), reso,
            jnp.asarray(mask[None])))
        vec = sorted_segment_mean(jnp.asarray(feats[order][None]),
                                  jnp.asarray(offsets[None]))
        got = np.zeros_like(want)
        # morton vec -> row-major plane
        got = np.asarray(morton_to_plane(vec, reso))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_max_matches_unsorted(self, rng):
        pts, mask, feats, order, cells, offsets = _bucketed(rng)
        reso = 16
        idx = cell_index(jnp.asarray(pts[None, :, :2]), reso)
        want_pts = np.asarray(pool_local_max(jnp.asarray(feats[None]), idx, reso,
                                             jnp.asarray(mask[None])))
        starts = run_starts(jnp.asarray(cells[None]))
        mx = sorted_segment_max(jnp.asarray(feats[order][None]),
                                jnp.asarray(offsets[None]), starts)
        back = gather_cells_sorted(mx, jnp.asarray(cells[None]))
        # compare per-point values in the sorted frame (valid points only)
        nv = mask.sum()
        got_sorted = np.asarray(back)[0][:nv]
        want_sorted = want_pts[0][order][:nv]
        np.testing.assert_allclose(got_sorted, want_sorted, atol=1e-6)

    def test_empty_cells_zero(self):
        feats = jnp.ones((1, 4, 2))
        offsets = jnp.asarray(np.array([[0, 4, 4, 4, 4]], dtype=np.int32))  # all in cell 0
        mean = np.asarray(sorted_segment_mean(feats, offsets))
        assert mean[0, 0].tolist() == [1.0, 1.0]
        assert (mean[0, 1:] == 0).all()
        starts = jnp.asarray(np.array([[True, False, False, False]]))
        mx = np.asarray(sorted_segment_max(feats, offsets, starts))
        assert (mx[0, 1:] == 0).all()

    def test_coarsen_offsets(self, rng):
        pts, mask, feats, order, cells, offsets = _bucketed(rng, reso=16)
        # level-1 (reso 8) mean via coarsened offsets == recomputed bucket at 8
        vec16 = sorted_segment_mean(jnp.asarray(feats[order][None]), jnp.asarray(offsets[None]))
        off8 = coarsen_offsets(jnp.asarray(offsets[None]), 1)
        vec8 = sorted_segment_mean(jnp.asarray(feats[order][None]), off8)
        want = np.asarray(scatter_mean_to_plane(
            jnp.asarray(pts[None, :, :2]), jnp.asarray(feats[None]), 8,
            jnp.asarray(mask[None])))
        got = np.asarray(morton_to_plane(vec8, 8))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_sum_precision_many_points(self, rng):
        # cumsum-diff must stay accurate over long runs (f32 cumsum of 50k)
        n = 50000
        pts = np.full((n, 3), 0.5, dtype=np.float32)
        mask = np.ones(n, dtype=bool)
        feats = rng.normal(size=(n, 1)).astype(np.float32)
        order, cells, offsets = host_morton_bucket(pts, mask, 4)
        mean = np.asarray(sorted_segment_mean(jnp.asarray(feats[None]),
                                              jnp.asarray(offsets[None])))
        cell = morton_interleave_np(np.array([2]), np.array([2]), 2)[0]
        np.testing.assert_allclose(mean[0, cell, 0], feats.mean(), atol=1e-4)

"""GridIndex2D must reproduce crop_pc_2d_index exactly (the dataset's
patch sampler switched to it for the serving loader's hot path)."""

import numpy as np
import pytest

from tomosar2height_jax.geo.crop import GridIndex2D, crop_pc_2d, crop_pc_2d_index


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_full_scan(seed):
    rng = np.random.default_rng(seed)
    n = 50_000
    pts = np.column_stack([
        rng.uniform(1000.0, 2280.0, n),
        rng.uniform(5_000_000.0, 5_000_640.0, n),
        rng.uniform(0.0, 60.0, n),
    ])
    idx = GridIndex2D(pts, cell_size=256.0)
    for _ in range(20):
        x0 = rng.uniform(900.0, 2000.0)
        y0 = rng.uniform(4_999_900.0, 5_000_200.0)
        p_min = np.array([x0, y0])
        p_max = p_min + 512.0
        ref = crop_pc_2d_index(pts, p_min, p_max)
        got_pts, got_idx = idx.query(pts, p_min, p_max)
        np.testing.assert_array_equal(got_idx, ref)
        np.testing.assert_array_equal(got_pts, pts[ref])


def test_boundary_points_excluded():
    # points exactly ON the open box boundary are excluded (strict < / >),
    # including when they sit exactly on a grid-cell edge
    pts = np.array([
        [10.0, 10.0, 1.0],   # exactly min corner -> out
        [20.0, 20.0, 1.0],   # exactly max corner -> out
        [10.0, 15.0, 1.0],   # on min x edge -> out
        [15.0, 20.0, 1.0],   # on max y edge -> out
        [15.0, 15.0, 1.0],   # inside -> in
        [10.0 + 1e-12, 10.0 + 1e-12, 1.0],  # just inside -> in
    ])
    idx = GridIndex2D(pts, cell_size=5.0)
    ref = crop_pc_2d_index(pts, (10.0, 10.0), (20.0, 20.0))
    _, got = idx.query(pts, (10.0, 10.0), (20.0, 20.0))
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) == {4, 5}


def test_empty_and_degenerate():
    idx = GridIndex2D(np.zeros((0, 3)), cell_size=64.0)
    assert idx.query_index((0, 0), (10, 10)).size == 0
    pts = np.array([[5.0, 5.0, 1.0]])
    idx = GridIndex2D(pts, cell_size=64.0)
    _, got = idx.query(pts, (0.0, 0.0), (10.0, 10.0))
    np.testing.assert_array_equal(got, [0])
    # box entirely outside the indexed extent
    assert idx.query_index((1000.0, 1000.0), (2000.0, 2000.0)).size == 0
    ref = crop_pc_2d(pts, (1000.0, 1000.0), (2000.0, 2000.0))[1]
    assert ref.size == 0

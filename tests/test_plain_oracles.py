"""The plain point<->grid path against float64 numpy oracles.

This XLA path (``jax.ops.segment_*`` scatters, gathers, the cumsum segment
means of the Morton-sorted layout) replaces the removed Pallas kernels, so it
is checked at the shapes those kernels were: plane resolutions 32-256, empty
cells and empty tiles, padded points, max and mean, float32 and bfloat16, and
the gradient rule of each op and of one ALTO level round trip.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.test_util import check_grads

from tomosar2height_jax.models.alto import AltoUNet
from tomosar2height_jax.ops.sampling import grid_sample_2d
from tomosar2height_jax.ops.scatter import (
    cell_index,
    gather_cells,
    pool_local_max,
    pool_local_mean,
    scatter_mean_to_plane,
    segment_max,
    segment_mean,
)
from tomosar2height_jax.ops.sorted_scatter import (
    gather_cells_sorted,
    host_morton_bucket,
    scatter_mean_plane_morton,
    sorted_segment_mean,
)

RESOS = [32, 64, 128, 256]


def _points(b, n, seed, frac_pad=0.2, extent=0.6):
    """Points in [0, extent)^2 (so whole tiles of the plane stay empty),
    with a fraction of padded (masked) rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, extent, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) > frac_pad
    return pts, mask


def _np_cells(pts, reso):
    """Cell ids exactly as the device computes them (f32 multiply, trunc)."""
    xi = np.clip((pts[..., :2] * np.float32(reso)).astype(np.int32), 0, reso - 1)
    return xi[..., 0] + reso * xi[..., 1]


def _np_reduce(values, cells, mask, num_segments, op):
    """float64 per-cell mean/max; empty cells 0."""
    b, _, c = values.shape
    out = np.zeros((b, num_segments, c), np.float64)
    v = values.astype(np.float64)
    for i in range(b):
        for s in np.unique(cells[i][mask[i]]):
            sel = v[i][(cells[i] == s) & mask[i]]
            out[i, s] = sel.mean(0) if op == "mean" else sel.max(0)
    return out


def _round(x, dtype):
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["mean", "max"])
@pytest.mark.parametrize("reso", RESOS)
def test_segment_reduce_vs_numpy(reso, op, dtype):
    pts, mask = _points(2, 1500, seed=reso)
    vals = np.random.default_rng(1).normal(size=(2, 1500, 5)).astype(np.float32)
    vals = _round(vals, dtype)  # the oracle sees the same rounded inputs
    cells = _np_cells(pts, reso)
    fn = segment_mean if op == "mean" else segment_max
    got = fn(jnp.asarray(vals, dtype), jnp.asarray(cells), reso * reso, jnp.asarray(mask))
    want = _np_reduce(vals, cells, mask, reso * reso, op)
    assert got.dtype == jnp.dtype(dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2  # bf16 sums round per add
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol, atol=tol)
    # whole empty region (x or y >= extent) reduces to exactly 0
    assert not np.asarray(got, np.float32).reshape(2, reso, reso, 5)[:, -reso // 4:].any()


@pytest.mark.parametrize("op", ["mean", "max"])
@pytest.mark.parametrize("reso", RESOS)
def test_pool_local_vs_numpy(reso, op):
    pts, mask = _points(2, 1200, seed=100 + reso)
    vals = np.random.default_rng(2).normal(size=(2, 1200, 4)).astype(np.float32)
    idx = cell_index(jnp.asarray(pts[..., :2]), reso)
    fn = pool_local_mean if op == "mean" else pool_local_max
    got = np.asarray(fn(jnp.asarray(vals), idx, reso, jnp.asarray(mask)))
    cells = _np_cells(pts, reso)
    pooled = _np_reduce(vals, cells, mask, reso * reso, op)
    want = np.take_along_axis(pooled, cells[..., None], axis=1)
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reso", RESOS)
def test_scatter_mean_to_plane_vs_numpy(reso):
    pts, mask = _points(2, 1000, seed=200 + reso)
    vals = np.random.default_rng(3).normal(size=(2, 1000, 3)).astype(np.float32)
    got = np.asarray(scatter_mean_to_plane(jnp.asarray(pts[..., :2]), jnp.asarray(vals),
                                           reso, jnp.asarray(mask)))
    want = _np_reduce(vals, _np_cells(pts, reso), mask, reso * reso, "mean")
    # plane row = y cell, column = x cell
    np.testing.assert_allclose(got, want.reshape(2, reso, reso, 3), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reso", RESOS)
def test_sorted_path_vs_numpy(reso):
    """Morton-sorted layout: cumsum segment means, the Morton->row-major
    plane and the per-point gather-back, all against the unsorted oracle."""
    pts, mask = _points(2, 1500, seed=300 + reso)
    vals = np.random.default_rng(4).normal(size=(2, 1500, 4)).astype(np.float32)
    rows = [host_morton_bucket(pts[i], mask[i], reso) for i in range(2)]
    order = np.stack([r[0] for r in rows])
    scell = np.stack([r[1] for r in rows])
    soff = np.stack([r[2] for r in rows])
    svals = np.take_along_axis(vals, order[..., None], axis=1)
    smask = np.take_along_axis(mask, order, axis=1)
    svals = np.where(smask[..., None], svals, 0.0)
    plane = np.asarray(scatter_mean_plane_morton(jnp.asarray(svals), jnp.asarray(soff), reso))
    want = _np_reduce(vals, _np_cells(pts, reso), mask, reso * reso, "mean")
    np.testing.assert_allclose(plane, want.reshape(2, reso, reso, 4), rtol=1e-4, atol=1e-4)
    morton = np.asarray(sorted_segment_mean(jnp.asarray(svals), jnp.asarray(soff)))
    back = np.asarray(gather_cells_sorted(jnp.asarray(morton), jnp.asarray(scell)))
    valid_cells = np.minimum(scell, reso * reso - 1)  # padded rows: masked anyway
    np.testing.assert_allclose(back[smask], morton[np.arange(2)[:, None], valid_cells][smask])


@pytest.mark.parametrize("case", ["all_padded", "single_cell", "edge_coords"])
def test_segment_edge_cases(case):
    reso, n = 32, 64
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(1, n, 2)).astype(np.float32)
    pts = rng.uniform(0.1, 0.9, (1, n, 3)).astype(np.float32)
    mask = np.ones((1, n), bool)
    if case == "all_padded":
        mask[:] = False
    elif case == "single_cell":
        pts[..., :2] = 0.5
    else:  # 0 and 1 clip into the first and last cell
        pts[0, : n // 2, :2] = 0.0
        pts[0, n // 2:, :2] = 1.0
    cells = _np_cells(pts, reso)
    for op, fn in (("mean", segment_mean), ("max", segment_max)):
        got = np.asarray(fn(jnp.asarray(vals), jnp.asarray(cells), reso * reso,
                            jnp.asarray(mask)))
        np.testing.assert_allclose(got, _np_reduce(vals, cells, mask, reso * reso, op),
                                   rtol=1e-6, atol=1e-6)
    if case == "all_padded":
        assert not got.any()


def _np_grid_sample(plane, xy, mode):
    b, h, w, c = plane.shape
    x = np.clip(xy[..., 0] * (w - 1), 0, w - 1)
    y = np.clip(xy[..., 1] * (h - 1), 0, h - 1)
    out = np.zeros(xy.shape[:2] + (c,))
    for i in range(b):
        for k in range(xy.shape[1]):
            if mode == "nearest":
                out[i, k] = plane[i, int(np.round(y[i, k])), int(np.round(x[i, k]))]
                continue
            x0, y0 = int(np.floor(x[i, k])), int(np.floor(y[i, k]))
            x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
            fx, fy = x[i, k] - x0, y[i, k] - y0
            out[i, k] = ((1 - fx) * (1 - fy) * plane[i, y0, x0] + fx * (1 - fy) * plane[i, y0, x1]
                         + (1 - fx) * fy * plane[i, y1, x0] + fx * fy * plane[i, y1, x1])
    return out


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("reso", [32, 64])
def test_grid_sample_vs_numpy(reso, mode):
    rng = np.random.default_rng(6)
    plane = rng.normal(size=(2, reso, reso, 3)).astype(np.float32)
    xy = rng.uniform(-0.05, 1.05, (2, 300, 2)).astype(np.float32)  # border clamp
    got = np.asarray(grid_sample_2d(jnp.asarray(plane), jnp.asarray(xy), mode=mode))
    np.testing.assert_allclose(got, _np_grid_sample(plane, xy, mode), rtol=1e-5, atol=1e-5)


def _grad_inputs(reso, n=96, c=3, seed=7):
    pts, mask = _points(1, n, seed=seed, extent=1.0)
    vals = np.random.default_rng(seed).normal(size=(1, n, c))
    return pts, mask, vals, _np_cells(pts, reso)


@pytest.mark.parametrize("op", ["segment_mean", "segment_max"])
@pytest.mark.parametrize("reso", [4, 8])
def test_segment_grads(op, reso):
    pts, mask, vals, cells = _grad_inputs(reso)
    fn = segment_mean if op == "segment_mean" else segment_max
    with jax.enable_x64(True):
        check_grads(lambda v: fn(v, jnp.asarray(cells), reso * reso, jnp.asarray(mask)),
                    (jnp.asarray(vals, jnp.float64),), order=1, modes=["rev"])


def test_gather_cells_grads():
    pts, mask, vals, cells = _grad_inputs(8)
    plane = np.random.default_rng(8).normal(size=(1, 64, 3))
    with jax.enable_x64(True):
        check_grads(lambda p: gather_cells(p, jnp.asarray(cells)),
                    (jnp.asarray(plane, jnp.float64),), order=1, modes=["rev"])


def test_sorted_segment_mean_grads():
    pts, mask, vals, _ = _grad_inputs(8)
    order, _, offsets = host_morton_bucket(pts[0], mask[0], 8)
    svals = np.where(mask[0][order][:, None], vals[0][order], 0.0)[None]
    with jax.enable_x64(True):
        check_grads(lambda v: sorted_segment_mean(v, jnp.asarray(offsets[None])),
                    (jnp.asarray(svals, jnp.float64),), order=1, modes=["rev"])


def test_grid_sample_grads():
    rng = np.random.default_rng(9)
    plane = rng.normal(size=(1, 8, 8, 2))
    xy = rng.uniform(0.05, 0.95, (1, 40, 2))
    with jax.enable_x64(True):
        check_grads(lambda p: grid_sample_2d(p, jnp.asarray(xy)),
                    (jnp.asarray(plane, jnp.float64),), order=1, modes=["rev"])


def test_alto_level_round_trip_grads():
    """Gradient of a depth-2 ALTO U-Net (one grid -> points -> grid round trip
    per level: bilinear gather, fc_comm MLP, scatter-mean) with respect to
    its plane and point-feature inputs, against finite differences."""
    reso, n, c = 8, 48, 2
    rng = np.random.default_rng(10)
    pts = rng.uniform(0.02, 0.98, (1, n, 3))
    mask = rng.random((1, n)) > 0.2
    plane = rng.normal(size=(1, reso, reso, c))
    feats = rng.normal(size=(1, n, c))
    with jax.enable_x64(True):
        net = AltoUNet(num_classes=2, depth=2, start_filts=2, dtype=jnp.float64)
        args = (jnp.asarray(pts), jnp.asarray(plane), jnp.asarray(feats), jnp.asarray(mask))
        params = net.init(jax.random.PRNGKey(0), *args)
        params = jax.tree.map(lambda p: p.astype(jnp.float64), params)
        check_grads(jax.jit(lambda p, f: net.apply(params, args[0], p, f, args[3])),
                    (args[1], args[2]), order=1, modes=["rev"], eps=1e-4)

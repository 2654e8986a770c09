"""wire_cells='device': the model recomputes Morton cell ids on device
bit-exactly, so the trainer can drop the (B, Npad) int32 upload."""

import numpy as np

import jax
import jax.numpy as jnp

from tomosar2height_jax.ops.sorted_scatter import (
    host_morton_bucket,
    morton_cells_device,
)


def _rand_points(n, seed, frac_pad=0.2):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(1e-6, 1.0 - 1e-6, (n, 3)).astype(np.float32)
    mask = rng.random(n) > frac_pad
    pts[~mask] = 0.5
    return pts, mask


def test_matches_plain_sorted_layout():
    reso = 64
    pts, mask = _rand_points(2000, seed=1)
    order, cells_sorted, _ = host_morton_bucket(pts, mask, reso)
    dev = morton_cells_device(jnp.asarray(pts[order]),
                              jnp.asarray(mask[order]), reso)
    np.testing.assert_array_equal(np.asarray(dev), cells_sorted)


def test_boundary_quantization_exact():
    # coordinates straddling cell boundaries: x*reso landing exactly on an
    # integer must truncate identically to the host layout
    reso = 128
    xs = np.array([1.0 / reso, 2.0 / reso, 0.9999999, 1e-7,
                   63.5 / reso, 63.49999 / reso], dtype=np.float32)
    pts = np.stack([xs, xs, xs], axis=1)
    mask = np.ones(len(xs), bool)
    order, cells_sorted, _ = host_morton_bucket(pts, mask, reso)
    dev = morton_cells_device(jnp.asarray(pts[order]),
                              jnp.asarray(mask[order]), reso)
    np.testing.assert_array_equal(np.asarray(dev), cells_sorted)


def test_trainer_drops_cell_upload_same_loss():
    """The sorted-path encoder gives the same plane whether the cell ids are
    uploaded or recomputed on device from points + mask."""
    from tomosar2height_jax.models.pointnet import LocalPoolPointnet

    reso, n, b = 32, 600, 2
    rows = []
    for i in range(b):
        pts, mask = _rand_points(n, seed=10 + i)
        order, cells, offsets = host_morton_bucket(pts, mask, reso)
        rows.append((pts[order], mask[order], cells, offsets))
    spts, smask, scell, soff = (jnp.asarray(np.stack(c)) for c in zip(*rows))
    model = LocalPoolPointnet(
        feature_dim=8, hidden_dim=8, plane_resolution=reso,
        scatter_type="max", unet_type="alto",
        unet_kwargs={"depth": 2, "start_filts": 8, "merge_mode": "concat"},
        dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), spts[:1], smask[:1], scell[:1], soff[:1])
    with_cells = model.apply(params, spts, smask, scell, soff)["xy"]
    without = model.apply(params, spts, smask, None, soff)["xy"]
    np.testing.assert_array_equal(np.asarray(with_cells), np.asarray(without))

"""Morton-sorted segmented reductions: scatter without scatters.

The reference-style point->grid transfer (torch_scatter; pointnet.py:92-111,
alto.py:76-95) is a scatter with duplicate indices, which the device resolves
with atomics. This module is the alternative sort-once design
(``dataset.points.sort: true``):

1. The HOST sorts each patch's points by their Morton (z-order) cell id at the
   finest plane resolution and ships per-cell segment offsets
   (:func:`host_morton_bucket`).
2. On device, a segment reduction over sorted points is a cumulative sum, two
   monotonic gathers, and a difference — pure vector ops, no scatter
   (:func:`sorted_segment_mean`). Max-reductions use a segmented
   ``associative_scan`` (:func:`sorted_segment_max`).
3. Morton order makes EVERY coarser resolution's cells contiguous too: parent
   cell i spans children 4i..4i+3, so level-d offsets are just
   ``offsets[::4**d]`` (:func:`coarsen_offsets`) — one host sort serves the
   whole ALTO pyramid.
4. A Morton-ordered cell vector becomes a row-major NHWC plane with a static
   reshape/transpose chain (:func:`morton_to_plane`) — no gather.

Empty cells reduce to 0, matching torch_scatter's zero-init semantics.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --- host side -------------------------------------------------------------------


def morton_interleave_np(x: np.ndarray, y: np.ndarray, bits: int) -> np.ndarray:
    """Interleave bits of (x, y) -> z-order code (y high bits), vectorized numpy."""
    code = np.zeros_like(x, dtype=np.int64)
    for b in range(bits):
        code |= ((x >> b) & 1) << (2 * b)
        code |= ((y >> b) & 1) << (2 * b + 1)
    return code


def host_morton_bucket(points: np.ndarray, mask: np.ndarray, reso: int):
    """Sort padded points by Morton cell id; padded points sort to the end.

    Args:
        points: (N, 3) float32 normalized to [0, 1].
        mask: (N,) bool validity.
        reso: finest plane resolution (power of two).

    Returns:
        order (N,) int64 permutation, cell (N,) int32 Morton ids (sorted order;
        padded entries get 4**bits i.e. one-past-last), offsets (reso*reso + 1,)
        int32 segment starts into the sorted arrays.
    """
    bits = int(reso).bit_length() - 1
    assert (1 << bits) == reso, "plane resolution must be a power of two"
    xi = np.clip((points[:, 0] * reso).astype(np.int64), 0, reso - 1)
    yi = np.clip((points[:, 1] * reso).astype(np.int64), 0, reso - 1)
    code = morton_interleave_np(xi, yi, bits)
    ncell = reso * reso
    code = np.where(mask, code, ncell)  # padding sorts last
    order = np.argsort(code, kind="stable")
    code_sorted = code[order]
    offsets = np.searchsorted(code_sorted, np.arange(ncell + 1)).astype(np.int32)
    return order, code_sorted.astype(np.int32), offsets


def morton_cells_device(points: jnp.ndarray, mask: jnp.ndarray,
                        reso: int) -> jnp.ndarray:
    """Recompute the sorted layout's per-row Morton cell ids ON DEVICE.

    Bit-exact with :func:`host_morton_bucket` (same IEEE f32 multiply,
    truncation and clip; padding rows get ``reso*reso``), so the training and
    serving batches can skip the (B, Npad) int32 ``cells`` array — points and
    mask already determine it.
    """
    bits = int(reso).bit_length() - 1
    assert (1 << bits) == reso, "plane resolution must be a power of two"
    xy = points.astype(jnp.float32)  # host quantized on f32 coords
    xi = jnp.clip((xy[..., 0] * reso).astype(jnp.int32), 0, reso - 1)
    yi = jnp.clip((xy[..., 1] * reso).astype(jnp.int32), 0, reso - 1)
    code = jnp.zeros_like(xi)
    for b in range(bits):
        code = code | (((xi >> b) & 1) << (2 * b))
        code = code | (((yi >> b) & 1) << (2 * b + 1))
    return jnp.where(mask, code, jnp.int32(reso * reso))


def coarsen_offsets(offsets: jnp.ndarray, levels: int) -> jnp.ndarray:
    """Offsets for a 2^levels-coarser resolution: stride-4^levels subsample
    (Morton parents cover contiguous child ranges)."""
    stride = 4 ** levels
    return offsets[..., ::stride]


def _plane_axes(bits: int) -> Tuple[tuple, tuple]:
    # morton vector dims after reshape to [2]*2b (+C): (y_{b-1}, x_{b-1}, ... y_0, x_0)
    # target row-major: (y_{b-1..0}, x_{b-1..0})
    ys = tuple(2 * i for i in range(bits))        # positions of y bits (msb first)
    xs = tuple(2 * i + 1 for i in range(bits))    # positions of x bits
    return ys, xs


def morton_to_plane(vec: jnp.ndarray, reso: int) -> jnp.ndarray:
    """(B, reso*reso, C) Morton-ordered -> (B, reso, reso, C) row-major,
    via reshape/transpose only (zero-copy for XLA layout assignment)."""
    b, n, c = vec.shape
    bits = int(reso).bit_length() - 1
    x = vec.reshape((b,) + (2,) * (2 * bits) + (c,))
    ys, xs = _plane_axes(bits)
    perm = (0,) + tuple(1 + a for a in ys) + tuple(1 + a for a in xs) + (2 * bits + 1,)
    return x.transpose(perm).reshape(b, reso, reso, c)


def plane_to_morton(plane: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`morton_to_plane`: (B, R, R, C) -> (B, R*R, C) Morton order."""
    b, r, _, c = plane.shape
    bits = int(r).bit_length() - 1
    ys, xs = _plane_axes(bits)
    x = plane.reshape((b,) + (2,) * (2 * bits) + (c,))
    # current dims (after reshape): (y_{b-1..0}, x_{b-1..0}); want interleaved
    inv = np.empty(2 * bits, dtype=int)
    for i, a in enumerate(ys):
        inv[a] = i
    for i, a in enumerate(xs):
        inv[a] = bits + i
    perm = (0,) + tuple(1 + v for v in inv) + (2 * bits + 1,)
    return x.transpose(perm).reshape(b, r * r, c)


# --- device side ----------------------------------------------------------------


def sorted_segment_sum_counts(values: jnp.ndarray, offsets: jnp.ndarray):
    """Per-segment (sum, count) for cell-sorted values.

    Args:
        values: (B, N, C) sorted by cell; padded rows must be zero or be
            excluded by offsets (padding sorts past the last cell).
        offsets: (B, S+1) int32 segment starts.

    Returns:
        sums (B, S, C), counts (B, S, 1).
    """
    csum = jnp.cumsum(values, axis=1, dtype=jnp.promote_types(values.dtype, jnp.float32))
    zero = jnp.zeros_like(csum[:, :1])
    csum = jnp.concatenate([zero, csum], axis=1)  # (B, N+1, C)
    starts = offsets[:, :-1].astype(jnp.int32)
    ends = offsets[:, 1:].astype(jnp.int32)
    take = lambda idx: jnp.take_along_axis(csum, idx[..., None], axis=1)
    sums = (take(ends) - take(starts)).astype(values.dtype)
    counts = (ends - starts)[..., None].astype(values.dtype)
    return sums, counts


def sorted_segment_mean(values: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """Masked per-cell mean over sorted points; empty cells are 0."""
    sums, counts = sorted_segment_sum_counts(values, offsets)
    return sums / jnp.maximum(counts, 1.0)


def scatter_mean_plane_morton(values: jnp.ndarray, offsets: jnp.ndarray,
                              reso: int) -> jnp.ndarray:
    """Morton-sorted points -> row-major NHWC plane (B, reso, reso, C):
    :func:`sorted_segment_mean` + :func:`morton_to_plane`."""
    return morton_to_plane(sorted_segment_mean(values, offsets), reso)


def _segmented_max_op(a, b):
    """Associative segmented-max combine on (value, start_flag) pairs."""
    va, fa = a
    vb, fb = b
    return jnp.where(fb, vb, jnp.maximum(va, vb)), fa | fb


def sorted_segment_max(values: jnp.ndarray, offsets: jnp.ndarray,
                       starts_mask: jnp.ndarray, empty_value: float = 0.0) -> jnp.ndarray:
    """Per-cell max over sorted points via a segmented associative scan.

    Args:
        values: (B, N, C) sorted by cell.
        offsets: (B, S+1).
        starts_mask: (B, N) bool, True where a new cell's run begins
            (ship from host or derive from the sorted cell ids).

    Returns:
        (B, S, C); empty cells get ``empty_value``.
    """
    flags = starts_mask[..., None]
    flags = jnp.broadcast_to(flags, values.shape)
    run_max, _ = jax.lax.associative_scan(_segmented_max_op, (values, flags), axis=1)
    # segment's max sits at its last element (index end-1); empty -> end == start
    ends = offsets[:, 1:].astype(jnp.int32)
    starts = offsets[:, :-1].astype(jnp.int32)
    idx = jnp.maximum(ends - 1, 0)
    gathered = jnp.take_along_axis(run_max, idx[..., None], axis=1)
    empty = (ends == starts)[..., None]
    return jnp.where(empty, jnp.asarray(empty_value, values.dtype), gathered)


def gather_cells_sorted(cell_values: jnp.ndarray, cell_ids: jnp.ndarray) -> jnp.ndarray:
    """Per-point gather-back from Morton-ordered cell values.

    Args:
        cell_values: (B, S, C).
        cell_ids: (B, N) sorted Morton ids (padded entries == S are clipped —
            their gathered value is garbage and must be masked downstream,
            identical to the unsorted path's contract).
    """
    s = cell_values.shape[1]
    idx = jnp.minimum(cell_ids.astype(jnp.int32), s - 1)
    return jnp.take_along_axis(cell_values, idx[..., None], axis=1)


def run_starts(cell_ids: jnp.ndarray) -> jnp.ndarray:
    """(B, N) bool start-of-run flags from sorted cell ids (device-side helper)."""
    first = jnp.ones_like(cell_ids[:, :1], dtype=bool)
    rest = cell_ids[:, 1:] != cell_ids[:, :-1]
    return jnp.concatenate([first, rest], axis=1)

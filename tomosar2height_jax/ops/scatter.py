"""Masked point->grid segment reductions (the framework's core op).

The reference's single most important primitive is torch_scatter's
``scatter_mean`` / ``scatter_max`` pooling ragged per-point features into the
cells of a regular feature plane (reference pointnet.py:92-111, alto.py:76-95).
Here points arrive padded to a static bucket size with a boolean validity mask,
and the reductions are expressed as flat ``jax.ops.segment_*`` calls, which XLA
lowers to scatters (atomic on the GPU, like torch_scatter). Batch entries are folded into the segment axis
(segment id = ``b * num_segments + cell``) so one scatter covers the batch.

Semantics matched to the reference:
- cell id of a point at normalized (x, y) is ``floor(x*reso) + reso*floor(y*reso)``
  (utils/coordinate.py:12-28); callers guarantee points lie strictly inside (0, 1)
  (dataset.py:278), ids are clipped defensively here.
- mean over an empty cell is 0 (torch_scatter zero-init; pointnet.py:107-109).
- masked (padded) points contribute nothing to any cell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cell_index(coords: jnp.ndarray, reso: int) -> jnp.ndarray:
    """Flattened grid cell id for points normalized to [0, 1].

    Args:
        coords: (..., 2) xy in [0, 1].
        reso: plane resolution.

    Returns:
        (...,) int32 cell ids in [0, reso**2).
    """
    xi = jnp.clip((coords * reso).astype(jnp.int32), 0, reso - 1)
    return xi[..., 0] + reso * xi[..., 1]


def _flat_segments(index: jnp.ndarray, mask: jnp.ndarray | None, num_segments: int):
    """Fold batch into the segment axis; masked points map to segment id
    ``B*num_segments`` (a trash row dropped after the reduction)."""
    b, n = index.shape
    offset = (jnp.arange(b, dtype=jnp.int32) * num_segments)[:, None]
    seg = index.astype(jnp.int32) + offset
    if mask is not None:
        seg = jnp.where(mask, seg, b * num_segments)
    return seg.reshape(-1), b, n


def segment_counts(
    index: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(B, num_segments, 1) per-cell point counts — precompute once and pass
    to :func:`segment_mean` when the same (index, mask) reduces repeatedly
    (the ALTO pyramid scatters at each level with identical cells)."""
    b, n = index.shape
    seg, _, _ = _flat_segments(index, mask, num_segments)
    ones = jnp.ones((b * n, 1), dtype=jnp.float32)
    counts = jax.ops.segment_sum(ones, seg, num_segments=b * num_segments + 1)
    return counts[: b * num_segments].reshape(b, num_segments, 1)


def segment_mean(
    values: jnp.ndarray,
    index: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
    counts: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Masked per-cell mean.

    Args:
        values: (B, N, C) per-point features.
        index: (B, N) int cell ids in [0, num_segments).
        num_segments: number of cells per batch entry.
        mask: (B, N) bool validity; padded points are ignored.
        counts: optional precomputed :func:`segment_counts` (skips the
            second scatter).

    Returns:
        (B, num_segments, C); empty cells are 0.
    """
    b, n, c = values.shape
    seg, _, _ = _flat_segments(index, mask, num_segments)
    flat = values.reshape(b * n, c)
    total = b * num_segments + 1
    sums = jax.ops.segment_sum(flat, seg, num_segments=total)
    sums = sums[: b * num_segments].reshape(b, num_segments, c)
    if counts is None:
        counts = segment_counts(index, num_segments, mask)
    return sums / jnp.maximum(counts.astype(sums.dtype), 1.0)


def segment_max(
    values: jnp.ndarray,
    index: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray | None = None,
    empty_value: float = 0.0,
) -> jnp.ndarray:
    """Masked per-cell max; empty cells get ``empty_value``.

    Same shapes as :func:`segment_mean`.
    """
    b, n, c = values.shape
    seg, _, _ = _flat_segments(index, mask, num_segments)
    flat = values.reshape(b * n, c)
    total = b * num_segments + 1
    maxs = jax.ops.segment_max(flat, seg, num_segments=total)
    # segment_max yields -inf for empty segments
    maxs = jnp.where(jnp.isfinite(maxs), maxs, jnp.asarray(empty_value, values.dtype))
    return maxs[: b * num_segments].reshape(b, num_segments, c)


def gather_cells(planes_flat: jnp.ndarray, index: jnp.ndarray) -> jnp.ndarray:
    """Per-point gather-back from flattened planes.

    Args:
        planes_flat: (B, S, C) per-cell features.
        index: (B, N) cell ids.

    Returns:
        (B, N, C).
    """
    return jnp.take_along_axis(planes_flat, index[..., None].astype(jnp.int32), axis=1)


def pool_local_max(
    values: jnp.ndarray, index: jnp.ndarray, reso: int, mask: jnp.ndarray | None = None
) -> jnp.ndarray:
    """scatter_max into reso**2 cells then gather back per point.

    Parity: reference pointnet.py:92-99 (``pool_local`` with scatter_type='max').
    """
    pooled = segment_max(values, index, reso * reso, mask)
    return gather_cells(pooled, index)


def pool_local_mean(
    values: jnp.ndarray, index: jnp.ndarray, reso: int, mask: jnp.ndarray | None = None
) -> jnp.ndarray:
    """scatter_mean variant of :func:`pool_local_max` (pointnet.py:55-58)."""
    pooled = segment_mean(values, index, reso * reso, mask)
    return gather_cells(pooled, index)


def scatter_mean_to_plane(
    coords: jnp.ndarray,
    values: jnp.ndarray,
    reso: int,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Scatter per-point features into a (reso, reso) NHWC plane by cell mean.

    Plane layout: row = floor(y*reso), col = floor(x*reso) — identical to the
    reference's ``reshape(B, C, reso, reso)`` of the ``x + reso*y`` flat index
    (pointnet.py:101-111, alto.py:77-88).

    Args:
        coords: (B, N, 2) normalized xy.
        values: (B, N, C).
        mask: (B, N) bool.

    Returns:
        (B, reso, reso, C).
    """
    idx = cell_index(coords, reso)
    plane = segment_mean(values, idx, reso * reso, mask)
    b, _, c = values.shape
    return plane.reshape(b, reso, reso, c)

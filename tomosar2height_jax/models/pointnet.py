"""LocalPoolPointnet: per-point ResNet-FC MLP with interleaved local pooling,
then scatter to a feature plane refined by a (plain or ALTO) U-Net.

Parity: reference tomosar2height/encoder/pointnet.py:13-111. Design changes:
padded points + validity mask, NHWC plane, cell ids computed once.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.alto import AltoUNet
from tomosar2height_jax.models.blocks import ResnetBlockFC, kernel_init
from tomosar2height_jax.models.unet import UNet
from tomosar2height_jax.ops.scatter import (
    cell_index,
    pool_local_max,
    pool_local_mean,
    segment_max,
    segment_mean,
)
from tomosar2height_jax.ops.sorted_scatter import (
    gather_cells_sorted,
    morton_cells_device,
    scatter_mean_plane_morton,
    sorted_segment_mean,
)


class LocalPoolPointnet(nn.Module):
    """Point encoder producing a dict of feature planes (key 'xy').

    Args mirror the reference ctor (pointnet.py:29-58): ``feature_dim``,
    ``hidden_dim``, ``plane_resolution``, ``scatter_type`` ('max'/'mean'),
    ``unet_type`` ('unet'/'alto'), ``unet_kwargs``, ``n_blocks``.
    """

    feature_dim: int = 32
    dim: int = 3
    hidden_dim: int = 32
    scatter_type: str = "max"
    unet_type: str = "alto"
    unet_kwargs: Optional[dict] = None
    plane_resolution: int = 256
    n_blocks: int = 5
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        points: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        cells: Optional[jnp.ndarray] = None,
        offsets: Optional[jnp.ndarray] = None,
    ) -> dict:
        """
        Args:
            points: (B, N, 3) normalized to [0, 1] (padded to bucket size N).
            mask: (B, N) bool validity of each point.
            cells: (B, N) Morton cell ids at ``plane_resolution`` — when given
                (with ``offsets``), points must be cell-sorted and all
                point->grid reductions take the scatter-free sorted path
                (ops/sorted_scatter.py).
            offsets: (B, R*R + 1) Morton segment offsets.

        Returns:
            {'xy': (B, R, R, feature_dim)} refined feature plane.
        """
        reso = self.plane_resolution
        xy = points[..., :2]
        if cells is None and offsets is not None:
            # cell ids are fully determined by the (already host-sorted)
            # points + mask, so callers may skip shipping the (B, N) int32
            # array and let the device recompute it bit-exactly
            cells = morton_cells_device(points, mask, reso)
        use_sorted = cells is not None and offsets is not None

        if self.scatter_type not in ("max", "mean"):
            raise ValueError(f"Invalid scatter type: {self.scatter_type}")

        if use_sorted:
            def pool(values):
                if self.scatter_type == "max":
                    pooled = segment_max(values, cells, reso * reso, mask)
                else:
                    pooled = sorted_segment_mean(values, offsets)
                return gather_cells_sorted(pooled, cells)
        else:
            index = cell_index(xy, reso)
            local = pool_local_max if self.scatter_type == "max" else pool_local_mean

            def pool(values):
                return local(values, index, reso, mask)

        def pool_fn(values):
            with jax.named_scope("point_pool"):
                return pool(values)

        net = nn.Dense(2 * self.hidden_dim, kernel_init=kernel_init, dtype=self.dtype,
                       name="fc_pos")(points)
        net = ResnetBlockFC(self.hidden_dim, dtype=self.dtype, name="block0")(net)
        for i in range(1, self.n_blocks):
            pooled = pool_fn(net)
            net = jnp.concatenate([net, pooled], axis=-1)
            net = ResnetBlockFC(self.hidden_dim, dtype=self.dtype, name=f"block{i}")(net)

        net = nn.relu(net)
        net = nn.Dense(self.feature_dim, kernel_init=kernel_init, dtype=self.dtype,
                       name="fc_c")(net)

        with jax.named_scope("plane_scatter"):
            if use_sorted:
                plane = scatter_mean_plane_morton(net, offsets, reso)
                buckets = {"offsets": offsets}
            else:
                plane = segment_mean(net, index, reso * reso, mask)
                plane = plane.reshape(points.shape[0], reso, reso, self.feature_dim)
                buckets = None

        unet_kwargs = dict(self.unet_kwargs or {})
        if self.unet_type == "unet":
            fea = UNet(self.feature_dim, dtype=self.dtype, name="unet", **unet_kwargs)(plane)
        elif self.unet_type == "alto":
            fea = AltoUNet(self.feature_dim, dtype=self.dtype, name="unet", **unet_kwargs)(
                points, plane, net, mask, buckets
            )
        else:
            raise ValueError(f"Unknown unet_type: {self.unet_type}")
        return {"xy": fea}

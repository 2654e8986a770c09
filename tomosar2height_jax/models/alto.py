"""ALTO dual-topology U-Net: a grid U-Net where every level round-trips
grid <-> points (the paper's core idea; reference tomosar2height/encoder/alto.py).

Per Down/Up level (reference alto.py:97-138, 207-257):

1. two 3x3 convs (ReLU) on the feature plane,
2. residual from the previous level's post-conv plane via 1x1 conv
   (pooled first on deeper encoder levels),
3. bilinear-sample the plane at the point coordinates (grid_sample, border,
   align_corners=True),
4. per-point communication MLP ``fc_comm`` + linear skip ``fc_c`` from the
   previous level's point features,
5. scatter_mean the point features back into the plane at the current
   resolution, then pool (down) / transpose-conv upsample (up) with grid-space
   skip connections ('concat' merge).

Design: NHWC planes, points padded to a static bucket with a validity mask
(masked segment reductions), per-resolution cell ids computed once per
forward and reused across levels.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.blocks import (
    MLP2,
    conv1x1,
    conv3x3,
    kernel_init,
    max_pool_2x2,
    upconv2x2,
)
from tomosar2height_jax.ops.sampling import grid_sample_2d
from tomosar2height_jax.ops.scatter import cell_index, segment_counts, segment_mean
from tomosar2height_jax.ops.sorted_scatter import (
    coarsen_offsets,
    scatter_mean_plane_morton,
)


def _scatter_plane(xy, c, reso, mask, cell_cache):
    """scatter_mean point features into a (reso, reso) NHWC plane
    (reference alto.py:76-88).

    With Morton-sorted metadata (``cell_cache['offsets']``) the cumsum
    segment mean runs; coarser levels reuse the finest sort: offsets
    stride-subsampled, Morton ids bit-truncated.
    """
    offsets = cell_cache.get("offsets")
    if offsets is not None:
        finest = cell_cache["finest"]
        level = int(finest).bit_length() - int(reso).bit_length()
        off = coarsen_offsets(offsets, level) if level else offsets
        return scatter_mean_plane_morton(c, off, reso)
    idx = cell_cache.get(reso)
    if idx is None:
        idx = cell_index(xy, reso)
        cell_cache[reso] = idx
    # per-cell counts are identical for every scatter at this resolution
    # (same cells, same mask) — compute once per forward, not per level
    counts = cell_cache.get(("counts", reso))
    if counts is None:
        counts = segment_counts(idx, reso * reso, mask)
        cell_cache[("counts", reso)] = counts
    plane = segment_mean(c, idx, reso * reso, mask, counts=counts)
    b = c.shape[0]
    return plane.reshape(b, reso, reso, c.shape[-1])


def _round_trip(module, x, xy, c_last, mask, cell_cache):
    """Grid -> points -> grid: bilinear-sample the plane at the points, run
    ``fc_comm`` (+ ``fc_c`` from the previous level's point features) and
    scatter-mean back (reference alto.py:90-95,117-138). Named scopes
    ``alto_round_trip/{gather,mlp,scatter_mean}`` label the device time."""
    with jax.named_scope("alto_round_trip"):
        with jax.named_scope("gather"):
            c = grid_sample_2d(x, xy, mode=module.sample_mode)
        with jax.named_scope("mlp"):
            c = MLP2(module.features, module.dtype, name="fc_comm")(c)
            if c_last is not None:
                c = c + nn.Dense(module.features, kernel_init=kernel_init,
                                 dtype=module.dtype, name="fc_c")(c_last)
        with jax.named_scope("scatter_mean"):
            return _scatter_plane(xy, c, x.shape[1], mask, cell_cache), c


def _conv_pair(module, x):
    """The level-opening conv3x3(relu) x2 (reference alto.py:97-138)."""
    x = conv3x3(module.features, "conv1", module.dtype, relu=True)(x)
    return conv3x3(module.features, "conv2", module.dtype, relu=True)(x)


class AltoDownConv(nn.Module):
    """Encoder level with grid<->point communication (reference alto.py:48-138)."""

    features: int
    level: int
    pooling: bool
    depth: int
    sample_mode: str = "bilinear"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, xy, x, x_after_conv, c_last, mask, cell_cache):
        x = _conv_pair(self, x)

        if x_after_conv is not None:
            if self.level >= 2:
                # deeper levels: previous plane is one pooling step behind
                res = conv1x1(self.features, "res1x1", self.dtype)(max_pool_2x2(x_after_conv))
            else:  # level == 1: same resolution as level 0 (which never pools)
                res = conv1x1(self.features, "res1x1", self.dtype)(x_after_conv)
            x = x + res
        x_after_conv = x

        x, c = _round_trip(self, x, xy, c_last, mask, cell_cache)
        before_pool = x
        if self.pooling:
            x = max_pool_2x2(x)
        return x, before_pool, x_after_conv, c


class AltoUpConv(nn.Module):
    """Decoder level with grid<->point communication (reference alto.py:141-257)."""

    features: int
    level: int
    depth: int
    merge_mode: str = "concat"
    sample_mode: str = "bilinear"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, xy, from_down, from_up, x_after_conv, c_last, mask, cell_cache):
        last = self.level == self.depth - 2
        if last:
            # final level: encoder level 0 never pooled, so no upsampling needed
            from_up = conv1x1(self.features, "upconv_noup", self.dtype)(from_up)
        else:
            from_up = upconv2x2(self.features, "upconv", self.dtype)(from_up)

        if self.merge_mode == "concat":
            x = jnp.concatenate([from_up, from_down], axis=-1)
        else:
            x = from_up + from_down
        x = _conv_pair(self, x)

        if x_after_conv is not None:
            if last:
                res = conv1x1(self.features, "res1x1", self.dtype)(x_after_conv)
            else:
                res = upconv2x2(self.features, "res_up", self.dtype)(x_after_conv)
            x = x + res
        x_after_conv = x

        if last:
            # reference alto.py:241-242: no point round-trip on the final level
            return x, x_after_conv, c_last

        x, c = _round_trip(self, x, xy, c_last, mask, cell_cache)
        return x, x_after_conv, c


class AltoUNet(nn.Module):
    """Dual-topology U-Net over an NHWC plane + point set (alto.py:260-382).

    Channel/resolution schedule for depth=5 on a 256^2 plane:
    down 32@256 -> 64@256(pool) -> 128@128(pool) -> 256@64(pool) -> 512@32;
    up 256@64 -> 128@128 -> 64@256 -> 32@256 (no point round-trip on the last).
    """

    num_classes: int
    depth: int = 5
    start_filts: int = 32
    merge_mode: str = "concat"
    up_mode: str = "transpose"
    sample_mode: str = "bilinear"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        points: jnp.ndarray,
        plane: jnp.ndarray,
        c: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        buckets: Optional[Dict] = None,
    ) -> jnp.ndarray:
        """
        Args:
            points: (B, N, >=2) normalized point coordinates (xy used). When
                ``buckets`` is given, points/c/mask must be Morton-cell-sorted.
            plane: (B, R, R, C_in) initial feature plane.
            c: (B, N, C_in) initial per-point features.
            mask: (B, N) validity of padded points.
            buckets: optional {'offsets': (B, R*R+1)} Morton segment offsets
                enabling the scatter-free path.

        Returns:
            (B, R, R, num_classes) output plane.
        """
        xy = points[..., :2]
        cell_cache: Dict = {}
        if buckets is not None:
            cell_cache.update(buckets)
            cell_cache["finest"] = plane.shape[1]

        encoder_outs = []
        x, x_after_conv = plane, None
        outs = self.start_filts
        for i in range(self.depth):
            outs = self.start_filts * (2 ** i)
            pooling = 0 < i < self.depth - 1
            x, before_pool, x_after_conv, c = AltoDownConv(
                outs, i, pooling, self.depth, self.sample_mode, self.dtype,
                name=f"down{i}"
            )(xy, x, x_after_conv, c, mask, cell_cache)
            encoder_outs.append(before_pool)

        for i in range(self.depth - 1):
            outs = outs // 2
            from_down = encoder_outs[-(i + 2)]
            x, x_after_conv, c = AltoUpConv(
                outs, i, self.depth, self.merge_mode, self.sample_mode, self.dtype,
                name=f"up{i}",
            )(xy, from_down, x, x_after_conv, c, mask, cell_cache)

        return conv1x1(self.num_classes, "conv_final", self.dtype)(x)

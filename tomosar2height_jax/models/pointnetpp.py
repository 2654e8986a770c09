"""PointNet++ (SSG) point encoder — the alternative to LocalPoolPointnet.

Capability parity with reference tomosar2height/encoder/pointnetpp.py:111-173:
3 set-abstraction levels (FPS 512 -> ball query r=0.2 k=32 -> [64,64,128];
FPS 128 -> r=0.4 k=64 -> [128,128,256]; group-all -> [256,512,1024]), 3 feature
propagations (3-NN inverse-distance interpolation + per-point MLPs), scatter to
the 'xy' plane + U-Net refinement.

Design:
- FPS as a `lax.fori_loop` of masked min-distance/argmax updates (no host loop,
  reference :220-241), deterministic start at the first valid point;
- ball query via matmul-based pairwise distances + `top_k` selection of
  the lowest-index in-radius neighbors (same semantics as the reference's
  sort-and-clip :244-264) — no N-length sorts;
- GroupNorm instead of BatchNorm (stateless, SPMD-safe — the deliberate
  deviation called out in SURVEY.md §7 hard part 6);
- padded points participate via a validity mask at every stage.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.alto import AltoUNet
from tomosar2height_jax.models.blocks import kernel_init
from tomosar2height_jax.models.unet import UNet
from tomosar2height_jax.ops.scatter import cell_index, segment_mean

BIG = 1e10


def square_distance(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared distances (B, N, M) via one matmul
    (reference pointnetpp.py:176-197)."""
    cross = jnp.einsum("bnc,bmc->bnm", src, dst,
                       preferred_element_type=jnp.float32)
    s2 = jnp.sum(src ** 2, axis=-1)[:, :, None]
    d2 = jnp.sum(dst ** 2, axis=-1)[:, None, :]
    return s2 + d2 - 2.0 * cross


def farthest_point_sample(xyz: jnp.ndarray, npoint: int,
                          mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Indices (B, npoint) of an FPS subset, ignoring masked points.

    Iterative masked min-distance update (reference pointnetpp.py:220-241) under
    ``fori_loop``; starts from the first valid point (deterministic).
    """
    b, n, _ = xyz.shape
    if mask is None:
        mask = jnp.ones((b, n), dtype=bool)
    start = jnp.argmax(mask, axis=1)  # first valid point per batch

    def body(i, carry):
        centroids, distance, farthest = carry
        centroids = centroids.at[:, i].set(farthest)
        centroid = jnp.take_along_axis(xyz, farthest[:, None, None], axis=1)
        dist = jnp.sum((xyz - centroid) ** 2, axis=-1)
        distance = jnp.minimum(distance, dist)
        # masked points can never be farthest
        farthest = jnp.argmax(jnp.where(mask, distance, -BIG), axis=1)
        return centroids, distance, farthest

    centroids = jnp.zeros((b, npoint), dtype=jnp.int32)
    distance = jnp.full((b, n), BIG)
    out, _, _ = jax.lax.fori_loop(0, npoint, body, (centroids, distance, start.astype(jnp.int32)))
    return out


def index_points(points: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Batched gather: points (B, N, C), idx (B, ...) -> (B, ..., C)
    (reference pointnetpp.py:200-217)."""
    flat = idx.reshape(idx.shape[0], -1)
    out = jnp.take_along_axis(points, flat[..., None], axis=1)
    return out.reshape(*idx.shape, points.shape[-1])


def query_ball_point(radius: float, nsample: int, xyz: jnp.ndarray,
                     new_xyz: jnp.ndarray,
                     mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(B, S, nsample) neighbor indices: lowest-index valid points within the
    radius, padded with each group's first hit (reference pointnetpp.py:244-264)."""
    b, n, _ = xyz.shape
    d2 = square_distance(new_xyz, xyz)  # (B, S, N)
    in_ball = d2 <= radius ** 2
    if mask is not None:
        in_ball = in_ball & mask[:, None, :]
    # score: in-ball points ranked by ascending index; out-of-ball -> -1
    idx_rank = jnp.arange(n, dtype=jnp.int32)[None, None, :]
    score = jnp.where(in_ball, n - idx_rank, -1)
    top, _ = jax.lax.top_k(score, nsample)  # (B, S, nsample), descending
    group_idx = jnp.where(top > 0, n - top, n)  # sentinel n = no hit
    first = group_idx[:, :, :1]
    return jnp.where(group_idx == n, first, group_idx).astype(jnp.int32)


class SetAbstraction(nn.Module):
    """FPS + ball grouping + shared MLP + max pool (reference pointnetpp.py:16-57)."""

    npoint: Optional[int]
    radius: Optional[float]
    nsample: Optional[int]
    mlp: Sequence[int]
    group_all: bool = False
    norm: str = "group"  # 'group' (the BatchNorm substitution) | 'none'
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, xyz, points, mask):
        """xyz (B, N, 3); points (B, N, D) or None; mask (B, N).

        Returns (new_xyz (B, S, 3), new_points (B, S, mlp[-1]), new_mask (B, S)).
        """
        b, n, _ = xyz.shape
        if self.group_all:
            grouped_xyz = xyz[:, None]  # (B, 1, N, 3)
            grouped = (
                jnp.concatenate([grouped_xyz, points[:, None]], axis=-1)
                if points is not None else grouped_xyz
            )
            new_xyz = jnp.zeros((b, 1, 3), xyz.dtype)
            valid = mask[:, None, :]  # (B, 1, N)
            new_mask = jnp.ones((b, 1), dtype=bool)
        else:
            fps_idx = farthest_point_sample(xyz, self.npoint, mask)
            new_xyz = index_points(xyz, fps_idx)
            new_mask = jnp.take_along_axis(mask, fps_idx, axis=1)
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz, mask)
            grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = jnp.concatenate([grouped_xyz, index_points(points, idx)], axis=-1)
            else:
                grouped = grouped_xyz
            valid = jnp.take_along_axis(
                jnp.broadcast_to(mask[:, None, :], (b, self.npoint, n)), idx, axis=2
            )

        h = grouped
        for i, f in enumerate(self.mlp):
            h = nn.Dense(f, kernel_init=kernel_init, dtype=self.dtype, name=f"mlp{i}")(h)
            if self.norm == "group":
                h = nn.GroupNorm(num_groups=min(8, f), dtype=self.dtype, name=f"gn{i}")(h)
            h = nn.relu(h)
        # masked max over the group dimension
        h = jnp.where(valid[..., None], h, -BIG)
        h = h.max(axis=2)
        h = jnp.where(jnp.isfinite(h) & (h > -BIG / 2), h, 0.0)
        return new_xyz, h, new_mask


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling + per-point MLP (pointnetpp.py:59-109)."""

    mlp: Sequence[int]
    norm: str = "group"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, xyz1, xyz2, points1, points2, mask2=None):
        b, n, _ = xyz1.shape
        s = xyz2.shape[1]
        if s == 1:
            interpolated = jnp.repeat(points2, n, axis=1)
        else:
            d2 = square_distance(xyz1, xyz2)  # (B, N, S)
            if mask2 is not None:
                d2 = jnp.where(mask2[:, None, :], d2, BIG)
            neg, idx = jax.lax.top_k(-d2, 3)
            dists = -neg
            recip = 1.0 / (dists + 1e-8)
            weight = recip / recip.sum(axis=2, keepdims=True)
            gathered = index_points(points2, idx)  # (B, N, 3, C)
            interpolated = (gathered * weight[..., None]).sum(axis=2)

        h = (
            jnp.concatenate([points1, interpolated], axis=-1)
            if points1 is not None else interpolated
        )
        for i, f in enumerate(self.mlp):
            h = nn.Dense(f, kernel_init=kernel_init, dtype=self.dtype, name=f"mlp{i}")(h)
            if self.norm == "group":
                h = nn.GroupNorm(num_groups=min(8, f), dtype=self.dtype, name=f"gn{i}")(h)
            h = nn.relu(h)
        return h


class PointNetPlusPlus(nn.Module):
    """Full SSG encoder -> 'xy' feature plane (reference pointnetpp.py:111-173)."""

    feature_dim: int = 32
    dim: int = 3
    hidden_dim: Optional[int] = None   # unused; parity with the registry signature
    scatter_type: Optional[str] = None  # unused; plane scatter is always mean
    unet_type: str = "alto"
    unet_kwargs: Optional[dict] = None
    plane_resolution: int = 256
    n_blocks: int = 5  # unused; parity with the registry signature
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, points: jnp.ndarray, mask: Optional[jnp.ndarray] = None) -> dict:
        b, n, _ = points.shape
        if mask is None:
            mask = jnp.ones((b, n), dtype=bool)
        reso = self.plane_resolution
        index = cell_index(points[..., :2], reso)

        l0_xyz, l0_points = points, points
        l1_xyz, l1_points, m1 = SetAbstraction(
            512, 0.2, 32, (64, 64, 128), dtype=self.dtype, name="sa1"
        )(l0_xyz, l0_points, mask)
        l2_xyz, l2_points, m2 = SetAbstraction(
            128, 0.4, 64, (128, 128, 256), dtype=self.dtype, name="sa2"
        )(l1_xyz, l1_points, m1)
        l3_xyz, l3_points, m3 = SetAbstraction(
            None, None, None, (256, 512, 1024), group_all=True, dtype=self.dtype, name="sa3"
        )(l2_xyz, l2_points, m2)

        l2_points = FeaturePropagation((256, 256), self.dtype, name="fp3")(
            l2_xyz, l3_xyz, l2_points, l3_points, m3)
        l1_points = FeaturePropagation((256, 128), self.dtype, name="fp2")(
            l1_xyz, l2_xyz, l1_points, l2_points, m2)
        l0_points = FeaturePropagation((128, 128, self.feature_dim), self.dtype, name="fp1")(
            l0_xyz, l1_xyz, None, l1_points, m1)

        plane = segment_mean(l0_points, index, reso * reso, mask)
        plane = plane.reshape(b, reso, reso, self.feature_dim)

        unet_kwargs = dict(self.unet_kwargs or {})
        if self.unet_type == "unet":
            fea = UNet(self.feature_dim, dtype=self.dtype, name="unet", **unet_kwargs)(plane)
        elif self.unet_type == "alto":
            fea = AltoUNet(self.feature_dim, dtype=self.dtype, name="unet", **unet_kwargs)(
                points, plane, l0_points, mask
            )
        else:
            raise ValueError(f"Unknown unet_type: {self.unet_type}")
        return {"xy": fea}

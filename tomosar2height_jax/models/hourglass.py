"""Stacked-hourglass image feature extractor (alternative image encoder).

Capability parity with reference tomosar2height/encoder/hourglass.py:134-218:
7x7 stride-2 stem, ConvBlock residual units (3-conv pyramid with dense concat,
group/batch norm), recursive hourglass modules with avg-pool down / bicubic
align-corners up, num_stack stacked modules with intermediate supervision
wiring, final per-stack 1x1 head; returns the last stack's feature plane.
NHWC; norm='group' is the default (the reference's shipped choice, :139).
Output resolution is input/4 (stem stride 2 + one pool) like the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.blocks import kernel_init


def _norm(norm: str, channels: int, dtype, name: str):
    if norm == "group":
        return nn.GroupNorm(num_groups=min(32, channels), dtype=dtype, name=name)
    if norm == "batch":
        # stateless SPMD-safe substitution (GroupNorm) — BatchNorm's running
        # stats are unsound under data-parallel jit without cross-replica sync
        return nn.GroupNorm(num_groups=min(32, channels), dtype=dtype, name=name)
    raise ValueError(f"Unknown norm {norm}")


class ConvBlock(nn.Module):
    """Residual 3-conv pyramid: out = concat(c1, c2, c3) + shortcut
    (reference hourglass.py:25-82)."""

    out_planes: int
    norm: str = "group"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        inp = x.shape[-1]
        half, quarter = self.out_planes // 2, self.out_planes // 4

        def conv(f, n):
            return nn.Conv(f, (3, 3), padding="SAME", use_bias=False,
                           kernel_init=kernel_init, dtype=self.dtype, name=n)

        o1 = conv(half, "conv1")(nn.relu(_norm(self.norm, inp, self.dtype, "bn1")(x)))
        o2 = conv(quarter, "conv2")(nn.relu(_norm(self.norm, half, self.dtype, "bn2")(o1)))
        o3 = conv(quarter, "conv3")(nn.relu(_norm(self.norm, quarter, self.dtype, "bn3")(o2)))
        out = jnp.concatenate([o1, o2, o3], axis=-1)

        if inp != self.out_planes:
            res = nn.Conv(self.out_planes, (1, 1), use_bias=False,
                          kernel_init=kernel_init, dtype=self.dtype, name="down1x1")(
                nn.relu(_norm(self.norm, inp, self.dtype, "bn4")(x))
            )
        else:
            res = x
        return out + res


def _bicubic_up2(x: jnp.ndarray) -> jnp.ndarray:
    """2x upsample, cubic, align_corners=True (reference hourglass.py:126);
    exact torch parity via the separable a=-0.75 matmul resize."""
    from tomosar2height_jax.ops.resize import resize_cubic

    b, h, w, c = x.shape
    return resize_cubic(x, (2 * h, 2 * w))


class HourGlass(nn.Module):
    """Recursive hourglass (reference hourglass.py:85-131)."""

    depth: int
    features: int
    norm: str = "group"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        def level(lv, inp):
            up1 = ConvBlock(self.features, self.norm, self.dtype, name=f"b1_{lv}")(inp)
            low1 = nn.avg_pool(inp, (2, 2), strides=(2, 2))
            low1 = ConvBlock(self.features, self.norm, self.dtype, name=f"b2_{lv}")(low1)
            if lv > 1:
                low2 = level(lv - 1, low1)
            else:
                low2 = ConvBlock(self.features, self.norm, self.dtype, name=f"b2_plus_{lv}")(low1)
            low3 = ConvBlock(self.features, self.norm, self.dtype, name=f"b3_{lv}")(low2)
            return up1 + _bicubic_up2(low3)

        return level(self.depth, x)


class HGFilter(nn.Module):
    """Stacked hourglass feature network (reference hourglass.py:134-218).

    Args mirror the reference ctor: feature_dim output channels, num_hourglass
    recursion depth, num_stack stacked modules, norm, hg_down.
    """

    feature_dim: int = 256
    num_hourglass: int = 2
    num_stack: int = 4
    norm: str = "group"
    hg_down: str = "ave_pool"
    num_classes: int = None  # alias: registry passes num_classes like UNet
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        out_dim = self.num_classes or self.feature_dim
        # torch Conv2d(padding=3) pads symmetrically; XLA 'SAME' at stride 2
        # would pad (2, 3) and shift every window by one pixel
        x = nn.Conv(64, (7, 7), strides=(2, 2), padding=((3, 3), (3, 3)),
                    kernel_init=kernel_init, dtype=self.dtype, name="conv1")(x)
        x = nn.relu(_norm(self.norm, 64, self.dtype, "bn1")(x))

        if self.hg_down == "ave_pool":
            x = ConvBlock(128, self.norm, self.dtype, name="conv2")(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
        elif self.hg_down == "conv64":
            x = ConvBlock(64, self.norm, self.dtype, name="conv2")(x)
            x = nn.Conv(128, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                        kernel_init=kernel_init, dtype=self.dtype, name="down_conv2")(x)
        elif self.hg_down == "conv128":
            x = ConvBlock(128, self.norm, self.dtype, name="conv2")(x)
            x = nn.Conv(128, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                        kernel_init=kernel_init, dtype=self.dtype, name="down_conv2")(x)
        else:
            raise ValueError("Unknown HGFilter downsampling method!")

        x = ConvBlock(128, self.norm, self.dtype, name="conv3")(x)
        x = ConvBlock(256, self.norm, self.dtype, name="conv4")(x)

        previous = x
        out = None
        for i in range(self.num_stack):
            hg = HourGlass(self.num_hourglass, 256, self.norm, self.dtype, name=f"m{i}")(previous)
            ll = ConvBlock(256, self.norm, self.dtype, name=f"top_m_{i}")(hg)
            ll = nn.Conv(256, (1, 1), kernel_init=kernel_init, dtype=self.dtype,
                         name=f"conv_last{i}")(ll)
            ll = nn.relu(_norm(self.norm, 256, self.dtype, f"bn_end{i}")(ll))
            out = nn.Conv(out_dim, (1, 1), kernel_init=kernel_init, dtype=self.dtype,
                          name=f"l{i}")(ll)
            if i < self.num_stack - 1:
                ll2 = nn.Conv(256, (1, 1), kernel_init=kernel_init, dtype=self.dtype,
                              name=f"bl{i}")(ll)
                tmp = nn.Conv(256, (1, 1), kernel_init=kernel_init, dtype=self.dtype,
                              name=f"al{i}")(out)
                previous = previous + ll2 + tmp
        return out

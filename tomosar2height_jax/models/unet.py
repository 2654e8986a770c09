"""Plain 2D U-Net (image encoder / alternative plane net).

Capability parity with reference tomosar2height/encoder/unet.py:112-187:
``depth`` levels of (conv3x3-ReLU x2 [+ 2x2 maxpool]), channels doubling from
``start_filts``; decoder with 2x2 transpose-conv (or bilinear upsample + 1x1)
and concat/add merge; final 1x1 conv to ``num_classes``. NHWC throughout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.blocks import conv1x1, conv3x3, max_pool_2x2, upconv2x2


class DownConv(nn.Module):
    """(conv3x3 + ReLU) x2, optional 2x2 maxpool (reference unet.py:48-73)."""

    features: int
    pooling: bool = True
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = conv3x3(self.features, "conv1", self.dtype, relu=True)(x)
        x = conv3x3(self.features, "conv2", self.dtype, relu=True)(x)
        before_pool = x
        if self.pooling:
            x = max_pool_2x2(x)
        return x, before_pool


class UpConv(nn.Module):
    """Upsample + merge + (conv3x3 + ReLU) x2 (reference unet.py:76-109)."""

    features: int
    merge_mode: str = "concat"
    up_mode: str = "transpose"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, from_down, from_up):
        if self.up_mode == "transpose":
            from_up = upconv2x2(self.features, "upconv", self.dtype)(from_up)
        else:
            b, h, w, c = from_up.shape
            from_up = jax.image.resize(from_up, (b, 2 * h, 2 * w, c), method="bilinear")
            from_up = conv1x1(self.features, "upconv_1x1", self.dtype)(from_up)
        if self.merge_mode == "concat":
            x = jnp.concatenate([from_up, from_down], axis=-1)
        else:
            x = from_up + from_down
        x = conv3x3(self.features, "conv1", self.dtype, relu=True)(x)
        x = conv3x3(self.features, "conv2", self.dtype, relu=True)(x)
        return x


class UNet(nn.Module):
    """Encoder-decoder over an NHWC plane (reference unet.py:112-187).

    Args mirror the reference ctor: ``num_classes`` output channels,
    ``depth`` levels, ``start_filts`` base width, ``up_mode`` in
    {'transpose', 'upsample'}, ``merge_mode`` in {'concat', 'add'}.
    ``in_channels`` is inferred from the input (NHWC).
    """

    num_classes: int
    depth: int = 5
    start_filts: int = 64
    up_mode: str = "transpose"
    merge_mode: str = "concat"
    dtype: jnp.dtype = jnp.float32

    def __post_init__(self):
        super().__post_init__()
        if self.up_mode not in ("transpose", "upsample"):
            raise ValueError(f"Invalid up_mode: {self.up_mode}")
        if self.merge_mode not in ("concat", "add"):
            raise ValueError(f"Invalid merge_mode: {self.merge_mode}")
        if self.up_mode == "upsample" and self.merge_mode == "add":
            raise ValueError("up_mode 'upsample' is incompatible with merge_mode 'add'")

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        encoder_outs = []
        outs = self.start_filts
        for i in range(self.depth):
            outs = self.start_filts * (2 ** i)
            pooling = i < self.depth - 1
            x, before_pool = DownConv(outs, pooling, self.dtype,
                                      name=f"down{i}")(x)
            encoder_outs.append(before_pool)

        for i in range(self.depth - 1):
            outs = outs // 2
            before_pool = encoder_outs[-(i + 2)]
            x = UpConv(outs, self.merge_mode, self.up_mode, self.dtype,
                       name=f"up{i}")(
                before_pool, x
            )

        return conv1x1(self.num_classes, "conv_final", self.dtype)(x)

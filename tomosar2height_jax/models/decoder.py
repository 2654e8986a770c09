"""Pixelwise decoders: align feature planes to the output raster, sum, decode.

Parity: reference tomosar2height/decoder/pixel.py — ConvDecoder (:8-32) with
dense skip-concat 1x1, FCDecoder (:35-58), PixelwiseDecoder (:61-125) fusing the
'xy' (point) and 'image' planes by align_corners bilinear upsample + summation.
NHWC throughout (outputs already (B, H, W, out_dim); the reference permutes).
"""

from __future__ import annotations

import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.blocks import ResnetBlockFC, conv3x3, kernel_init
from tomosar2height_jax.ops.resize import resize_bilinear


class ConvDecoder(nn.Module):
    """conv3x3 chain 32->64->128->64 + 1x1 over the dense concat (288 ch)
    (reference pixel.py:8-32).

    Mixed-precision policy: the trunk convs run in ``dtype`` (bf16 under the
    fast policy) but the final 1x1 head always computes in float32 — the
    output is a height in [-0.5, 0.5] z-units scaled by ~190 m, and bf16's
    ~2^-8 relative resolution would quantize it to ~0.4 m steps.
    """

    out_channels: int = 1
    leaky: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.leaky:  # leaky act applied after the conv
            act = nn.leaky_relu
            c3 = lambda f, n: conv3x3(f, n, self.dtype)
            x1 = act(c3(64, "conv1")(x))
            x2 = act(c3(128, "conv2")(x1))
            x3 = act(c3(64, "conv3")(x2))
        else:
            x1 = conv3x3(64, "conv1", self.dtype, relu=True)(x)
            x2 = conv3x3(128, "conv2", self.dtype, relu=True)(x1)
            x3 = conv3x3(64, "conv3", self.dtype, relu=True)(x2)
        # dense-skip 1x1 over the concat [x, x1, x2, x3] (288 ch), WITHOUT
        # materializing the concat: a 1x1 conv is linear, so apply the sliced
        # kernel to each part and sum — identical math (reference pixel.py:31),
        # and no (B, H, W, 288) concat is written to device memory
        return Conv1x1Split(self.out_channels, name="conv4")([x, x1, x2, x3])


class Conv1x1Split(nn.Module):
    """1x1 conv over a (virtual) channel concat, applied per part with sliced
    weights. Parameter tree identical to ``nn.Conv`` on the concatenated
    input ('kernel' (1, 1, sum(Ci), Cout) + 'bias'), so checkpoints and the
    torch-parity port see the reference layout. Computes in f32 (this is the
    decoder's regression head — see the mixed-precision note above)."""

    features: int

    @nn.compact
    def __call__(self, parts):
        cin = sum(p.shape[-1] for p in parts)
        kernel = self.param("kernel", kernel_init, (1, 1, cin, self.features))
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        out = bias.astype(jnp.float32)
        off = 0
        # When the trunk runs bf16, contract in bf16 with f32 ACCUMULATION:
        # the output stays f32 — the docstring's output-resolution concern is
        # about accumulation/output dtype, not operand rounding — and the
        # parts are read once instead of being materialized as f32 copies.
        # f32 parts keep full f32 math (the torch-parity configuration).
        bf16 = all(p.dtype == jnp.bfloat16 for p in parts)
        for p in parts:
            c = p.shape[-1]
            w = kernel[0, 0, off:off + c]
            w = w.astype(jnp.bfloat16 if bf16 else jnp.float32)
            out = out + jnp.einsum(
                "bhwc,cd->bhwd", p if bf16 else p.astype(jnp.float32), w,
                preferred_element_type=jnp.float32)
            off += c
        return out


class FCDecoder(nn.Module):
    """Per-pixel ResNet-FC decoder (reference pixel.py:35-58)."""

    out_channels: int = 1
    n_blocks: int = 5
    leaky: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        act = nn.leaky_relu if self.leaky else nn.relu
        for i in range(self.n_blocks):
            x = ResnetBlockFC(dtype=self.dtype, name=f"block{i}")(x)
        # f32 head: see ConvDecoder's mixed-precision note
        return nn.Dense(self.out_channels, kernel_init=kernel_init, dtype=jnp.float32,
                        name="fc_out")(act(x).astype(jnp.float32))


class PixelwiseDecoder(nn.Module):
    """Fuse feature planes into height (and optional footprint) rasters
    (reference pixel.py:61-125).

    Returns (x, x_footprint); footprint is None unless ``use_footprint``.
    """

    hidden_dim: int = 32
    out_dim: int = 1
    output_size: int = 512
    leaky: bool = False
    sample_mode: str = "bilinear"
    mode: str = "conv"
    use_footprint: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, feature_planes: dict):
        if self.mode not in ("conv", "fc"):
            raise ValueError("Invalid mode. Use 'conv' or 'fc'.")
        c = 0.0
        if "xy" in feature_planes:
            c = c + resize_bilinear(feature_planes["xy"], self.output_size)
        if "image" in feature_planes:
            c = c + resize_bilinear(feature_planes["image"], self.output_size)

        x_footprint = None
        if self.mode == "conv":
            x = ConvDecoder(self.out_dim, self.leaky, self.dtype,
                            name="conv_decoder")(c)
            if self.use_footprint:
                x_footprint = ConvDecoder(self.out_dim, False, self.dtype,
                                          name="conv_decoder_footprint")(c)
        else:
            # Reference quirk mirrored exactly (pixel.py:88): the call
            # FCDecoder(hidden_dim, out_dim, leaky) passes ``leaky`` into the
            # positional ``n_blocks`` slot, so the height head gets
            # int(leaky) ResNet blocks (0 for the shipped leaky=False) while
            # the footprint head keeps the signature default of 5.
            x = FCDecoder(self.out_dim, int(self.leaky), False, self.dtype,
                          name="fc_decoder")(c)
            if self.use_footprint:
                x_footprint = FCDecoder(self.out_dim, 5, False, self.dtype,
                                        name="fc_decoder_footprint")(c)
        return x, x_footprint

"""Shared building blocks. Parity: reference tomosar2height/block/resnet.py:4-54."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import nn

# All kernels Xavier-uniform, biases zero — the reference's model-shell init
# pass overrides every Conv/Linear this way (model.py:46-52), including the
# ResnetBlockFC zero-init of fc_1 (resnet.py:34), so Xavier is the effective init.
kernel_init = nn.initializers.xavier_uniform()


class ResnetBlockFC(nn.Module):
    """Fully-connected residual block: x_s + fc_1(relu(fc_0(relu(x)))).

    Parity: reference block/resnet.py:36-54 (pre-activation, linear shortcut when
    the width changes).
    """

    size_out: Optional[int] = None
    size_h: Optional[int] = None
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        size_in = x.shape[-1]
        size_out = self.size_out if self.size_out is not None else size_in
        size_h = self.size_h if self.size_h is not None else min(size_in, size_out)

        net = nn.Dense(size_h, kernel_init=kernel_init, dtype=self.dtype, name="fc_0")(
            nn.relu(x)
        )
        dx = nn.Dense(size_out, kernel_init=kernel_init, dtype=self.dtype, name="fc_1")(
            nn.relu(net)
        )
        if size_in != size_out:
            x_s = nn.Dense(
                size_out, use_bias=False, kernel_init=kernel_init, dtype=self.dtype,
                name="shortcut",
            )(x)
        else:
            x_s = x
        return x_s + dx


class Conv3x3(nn.Module):
    """3x3 SAME conv with optional ReLU; parameter tree identical to
    ``nn.Conv`` ('kernel' (3,3,Cin,Cout) + 'bias')."""

    features: int
    use_relu: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        cin = x.shape[-1]
        kernel = self.param("kernel", kernel_init, (3, 3, cin, self.features))
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        x = x.astype(self.dtype)
        kernel = kernel.astype(self.dtype)
        # no preferred_element_type: a mixed-dtype output breaks lax.conv's
        # transpose rule under grad
        y = jax.lax.conv_general_dilated(
            x, kernel, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = y + bias.astype(y.dtype)
        return nn.relu(y) if self.use_relu else y


def conv3x3(features: int, name: str | None = None, dtype=jnp.float32,
            relu: bool = False) -> nn.Module:
    """3x3 same-padding conv (reference unet.py:8-18 / alto.py:11-20).

    ``relu=True`` fuses the activation into the conv (numerically identical
    to ``nn.relu(conv(x))``)."""
    return Conv3x3(features, use_relu=relu, dtype=dtype, name=name)


def conv1x1(features: int, name: str | None = None, dtype=jnp.float32) -> nn.Conv:
    """1x1 conv (reference unet.py:37-45 / alto.py:38-45)."""
    return nn.Conv(features, (1, 1), kernel_init=kernel_init, dtype=dtype, name=name)


def upconv2x2(features: int, name: str | None = None, dtype=jnp.float32) -> nn.ConvTranspose:
    """2x2 stride-2 transpose conv; output is exactly 2x the spatial size
    (reference unet.py:21-34 'transpose' mode)."""
    return nn.ConvTranspose(features, (2, 2), strides=(2, 2), padding="VALID",
                            kernel_init=kernel_init, dtype=dtype, name=name)


def max_pool_2x2(x: jnp.ndarray) -> jnp.ndarray:
    return nn.max_pool(x, (2, 2), strides=(2, 2))


class MLP2(nn.Module):
    """Linear(d, 2d) -> ReLU -> Linear(2d, d): the ALTO ``fc_comm`` communication
    MLP (reference alto.py:63-67,164-168)."""

    features: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        x = nn.Dense(2 * self.features, kernel_init=kernel_init, dtype=self.dtype,
                     name="fc_in")(x)
        x = nn.relu(x)
        return nn.Dense(self.features, kernel_init=kernel_init, dtype=self.dtype,
                        name="fc_out")(x)

"""Bilinear resize with ``align_corners=True`` (torch ``F.interpolate`` parity).

Used by the pixel decoder to upsample the 256^2 point-feature plane to the
512^2 output raster and align it with the image plane before summation
(reference decoder/pixel.py:105-111). Implemented as two separable 1-D
interpolation matmuls — dense (out, in) weight matrices with two nonzeros per
row — which XLA runs as matmuls and fuses with surrounding ops.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bilinear resampling matrix."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        m[0, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(int)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (src - i0).astype(np.float32)
    rows = np.arange(n_out)
    m[rows, i0] += 1.0 - f
    m[rows, i1] += f
    return m


@lru_cache(maxsize=64)
def _interp_matrix_cubic(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bicubic resampling matrix with
    torch's cubic convolution kernel (a = -0.75; F.interpolate mode='bicubic',
    reference hourglass.py:126). Border taps clamp like torch's reflection of
    the 4-tap window at the edges (replicate, matching torch's behavior for
    align_corners=True)."""
    a = -0.75

    def k(t):
        t = np.abs(t)
        return np.where(
            t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
            np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0))

    m = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(int)
    f = src - i0
    rows = np.arange(n_out)
    for d in (-1, 0, 1, 2):
        idx = np.clip(i0 + d, 0, n_in - 1)
        m[rows, idx] += k(f - d)
    return m.astype(np.float32)


def resize_cubic(x: jnp.ndarray, out_hw) -> jnp.ndarray:
    """Bicubic align_corners=True resize (torch parity), separable matmuls."""
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    import jax

    mh = jnp.asarray(_interp_matrix_cubic(h, oh))
    mw = jnp.asarray(_interp_matrix_cubic(w, ow))
    prec = (jax.lax.Precision.HIGHEST if x.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    y = jnp.einsum("oh,bhwc->bowc", mh, x, precision=prec,
                   preferred_element_type=x.dtype)
    y = jnp.einsum("pw,bowc->bopc", mw, y, precision=prec,
                   preferred_element_type=x.dtype)
    return y


def resize_bilinear(x: jnp.ndarray, out_hw) -> jnp.ndarray:
    """Resize an NHWC tensor to ``out_hw`` with align_corners=True semantics.

    Args:
        x: (B, H, W, C).
        out_hw: int or (H_out, W_out).

    Returns:
        (B, H_out, W_out, C).
    """
    if isinstance(out_hw, int):
        out_hw = (out_hw, out_hw)
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    mh = jnp.asarray(_interp_matrix(h, oh))
    mw = jnp.asarray(_interp_matrix(w, ow))
    # (B,H,W,C) -> (B,OH,W,C) -> (B,OH,OW,C) as two matmuls.
    # f32 inputs use HIGHEST so interpolation weights are not bf16-truncated
    # (sample positions would shift ~1e-2 px); bf16 inputs already quantize
    # the features themselves, so the multi-pass upcast buys nothing.
    import jax

    prec = (jax.lax.Precision.HIGHEST if x.dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    y = jnp.einsum("oh,bhwc->bowc", mh, x, precision=prec,
                   preferred_element_type=x.dtype)
    y = jnp.einsum("pw,bowc->bopc", mw, y, precision=prec,
                   preferred_element_type=x.dtype)
    return y

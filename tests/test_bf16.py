"""bf16 compute-policy numerics gate: the flagship forward in bfloat16 must
track the f32 output within a few decimeters (heights span ~60-190 m)."""

import numpy as np

import jax
import jax.numpy as jnp

from tomosar2height_jax.geo import normalize_pc, invert_normalize_pc
from tomosar2height_jax.models import TomoSAR2Height


class TestBF16Policy:
    def test_forward_close_to_f32(self, rng):
        kwargs = dict(
            encoder_kwargs={
                "feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "start_filts": 8, "merge_mode": "concat"},
            },
            decoder_kwargs={"hidden_dim": 8, "output_size": 64},
            z_scale=60.0,
        )
        pts = jnp.asarray(rng.uniform(0.01, 0.99, (1, 512, 3)).astype(np.float32))
        mask = jnp.ones((1, 512), bool)
        m32 = TomoSAR2Height(dtype=jnp.float32, **kwargs)
        m16 = TomoSAR2Height(dtype=jnp.bfloat16, **kwargs)
        params = m32.init(jax.random.PRNGKey(0), pts, mask, None)
        pa32, _ = m32.apply(params, pts, mask, None)
        pa16, _ = m16.apply(params, pts, mask, None)
        a, b = np.asarray(pa32), np.asarray(pa16, dtype=np.float32)
        scale = max(np.abs(a).max(), 1.0)
        rel = np.abs(a - b).max() / scale
        # bf16 has ~3 significant digits; activations pass through ~20 layers
        assert rel < 0.15, rel
        # and the two agree in structure, not just magnitude
        corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        assert corr > 0.99, corr


class TestNormalizePC:
    def test_roundtrip(self, rng):
        pts = rng.normal(size=(50, 3)) * 100
        n = normalize_pc(pts, scales=[10, 10, 5], center_shift=[1, 2, 3])
        back = invert_normalize_pc(n, scales=[10, 10, 5], center_shift=[1, 2, 3])
        np.testing.assert_allclose(back, pts, atol=1e-9)

"""Model tests: shapes, the reference's NaN-propagation probe (alto.py:415-427,
unet.py:216-229), padded-point invariance, and end-to-end forward."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import (
    AltoUNet,
    LocalPoolPointnet,
    PixelwiseDecoder,
    ResnetBlockFC,
    TomoSAR2Height,
    UNet,
)

RESO = 64  # small plane for CPU-speed tests (reference uses 256)


def _rand_points(rng, b=1, n=512):
    pts = rng.uniform(0.01, 0.99, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), dtype=bool)
    return jnp.asarray(pts), jnp.asarray(mask)


class TestResnetBlockFC:
    def test_shapes_and_shortcut(self, rng):
        x = jnp.asarray(rng.normal(size=(4, 16)).astype(np.float32))
        m = ResnetBlockFC(size_out=8)
        params = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(params, x)
        assert y.shape == (4, 8)
        assert "shortcut" in params["params"]
        m2 = ResnetBlockFC()
        p2 = m2.init(jax.random.PRNGKey(0), x)
        assert "shortcut" not in p2["params"]
        assert m2.apply(p2, x).shape == (4, 16)


class TestUNet:
    def test_shape_depth6(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
        m = UNet(num_classes=32, depth=6, start_filts=8)
        params = m.init(jax.random.PRNGKey(0), x)
        y = m.apply(params, x)
        assert y.shape == (1, 64, 64, 32)

    def test_nan_probe_full_receptive_field(self, rng):
        """Reference unet.py:216-229: NaN injected at the center must reach every
        output pixel of a depth-6 U-Net on a 64^2 plane (global receptive field)."""
        x = np.zeros((1, 64, 64, 8), dtype=np.float32)
        x[0, 31, 31, :] = np.nan
        m = UNet(num_classes=1, depth=6, start_filts=8)
        params = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 8)))
        y = np.asarray(m.apply(params, jnp.asarray(x)))
        nan_ratio = np.isnan(y).sum() / (64 * 64)
        assert nan_ratio == 1.0

    def test_add_merge(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 32, 32, 4)).astype(np.float32))
        m = UNet(num_classes=4, depth=3, start_filts=4, merge_mode="add")
        params = m.init(jax.random.PRNGKey(0), x)
        assert m.apply(params, x).shape == (1, 32, 32, 4)

    def test_invalid_modes(self):
        with pytest.raises(ValueError):
            UNet(num_classes=1, up_mode="bogus")
        with pytest.raises(ValueError):
            UNet(num_classes=1, up_mode="upsample", merge_mode="add")


class TestAlto:
    def _build(self, depth=5, reso=RESO, n=256, sf=4):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, n)
        plane = jnp.asarray(rng.normal(size=(1, reso, reso, 8)).astype(np.float32))
        c = jnp.asarray(rng.normal(size=(1, n, 8)).astype(np.float32))
        m = AltoUNet(num_classes=8, depth=depth, start_filts=sf)
        params = m.init(jax.random.PRNGKey(0), pts, plane, c, mask)
        return m, params, pts, plane, c, mask

    @pytest.mark.parametrize("depth", [5, 6])
    def test_shape(self, depth):
        reso = RESO if depth == 5 else 128
        m, params, pts, plane, c, mask = self._build(depth=depth, reso=reso)
        y = m.apply(params, pts, plane, c, mask)
        assert y.shape == (1, reso, reso, 8)

    def test_padded_points_do_not_change_output(self):
        """Bucketed padding must be a no-op: doubling the buffer with garbage
        masked points keeps the output identical."""
        m, params, pts, plane, c, mask = self._build()
        y1 = np.asarray(m.apply(params, pts, plane, c, mask))
        pad_pts = jnp.concatenate([pts, jnp.full_like(pts, 0.123)], axis=1)
        pad_c = jnp.concatenate([c, jnp.full_like(c, 77.0)], axis=1)
        pad_mask = jnp.concatenate([mask, jnp.zeros_like(mask)], axis=1)
        y2 = np.asarray(m.apply(params, pad_pts, plane, pad_c, pad_mask))
        np.testing.assert_allclose(y1, y2, atol=1e-5)


class TestLocalPoolPointnet:
    @pytest.mark.parametrize("unet_type", ["unet", "alto"])
    def test_forward(self, unet_type):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 256)
        m = LocalPoolPointnet(
            feature_dim=8, hidden_dim=8, plane_resolution=RESO, unet_type=unet_type,
            unet_kwargs={"depth": 4, "start_filts": 4, "merge_mode": "concat"},
        )
        params = m.init(jax.random.PRNGKey(0), pts, mask)
        out = m.apply(params, pts, mask)
        assert out["xy"].shape == (1, RESO, RESO, 8)

    def test_scatter_mean_type(self):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 128)
        m = LocalPoolPointnet(
            feature_dim=4, hidden_dim=4, plane_resolution=32, unet_type="unet",
            scatter_type="mean", unet_kwargs={"depth": 3, "start_filts": 4},
        )
        params = m.init(jax.random.PRNGKey(0), pts, mask)
        assert m.apply(params, pts, mask)["xy"].shape == (1, 32, 32, 4)


class TestPixelwiseDecoder:
    def test_fusion_and_shapes(self, rng):
        planes = {
            "xy": jnp.asarray(rng.normal(size=(1, 32, 32, 8)).astype(np.float32)),
            "image": jnp.asarray(rng.normal(size=(1, 64, 64, 8)).astype(np.float32)),
        }
        m = PixelwiseDecoder(hidden_dim=8, output_size=64, use_footprint=True)
        params = m.init(jax.random.PRNGKey(0), planes)
        pa, pb = m.apply(params, planes)
        assert pa.shape == (1, 64, 64, 1)
        assert pb.shape == (1, 64, 64, 1)

    def test_fc_mode(self, rng):
        planes = {"xy": jnp.asarray(rng.normal(size=(1, 16, 16, 8)).astype(np.float32))}
        m = PixelwiseDecoder(hidden_dim=8, output_size=32, mode="fc")
        params = m.init(jax.random.PRNGKey(0), planes)
        pa, pb = m.apply(params, planes)
        assert pa.shape == (1, 32, 32, 1) and pb is None


class TestTomoSAR2Height:
    def _small_model(self, use_cloud=True, use_image=False, use_footprint=False):
        return TomoSAR2Height(
            use_cloud=use_cloud,
            use_image=use_image,
            encoder_kwargs={
                "feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 4, "start_filts": 4, "merge_mode": "concat"},
            },
            encoder2_kwargs={"num_classes": 8, "depth": 4, "start_filts": 4,
                             "merge_mode": "concat"},
            decoder_kwargs={"hidden_dim": 8, "output_size": 64,
                            "use_footprint": use_footprint},
            z_scale=190.2,
        )

    def test_cloud_only(self):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 256)
        m = self._small_model()
        params = m.init(jax.random.PRNGKey(0), pts, mask, None)
        pa, pb = m.apply(params, pts, mask, None)
        assert pa.shape == (1, 64, 64, 1) and pb is None

    def test_cloud_plus_image_with_footprint(self):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 256)
        img = jnp.asarray(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
        m = self._small_model(use_image=True, use_footprint=True)
        params = m.init(jax.random.PRNGKey(0), pts, mask, img)
        pa, pb = m.apply(params, pts, mask, img)
        assert pa.shape == (1, 64, 64, 1) and pb.shape == (1, 64, 64, 1)

    def test_image_only(self):
        rng = np.random.default_rng(0)
        img = jnp.asarray(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
        m = self._small_model(use_cloud=False, use_image=True)
        params = m.init(jax.random.PRNGKey(0), None, None, img)
        pa, pb = m.apply(params, None, None, img)
        assert pa.shape == (1, 64, 64, 1)

    def test_z_rescale(self):
        """Output scales linearly with z_scale (reference model.py:39-41,67)."""
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 128)
        m1 = self._small_model()
        params = m1.init(jax.random.PRNGKey(0), pts, mask, None)
        pa1, _ = m1.apply(params, pts, mask, None)
        m2 = m1.clone(z_scale=m1.z_scale * 2)
        pa2, _ = m2.apply(params, pts, mask, None)
        np.testing.assert_allclose(np.asarray(pa2), 2 * np.asarray(pa1), rtol=1e-5)

    def test_jit_forward(self):
        rng = np.random.default_rng(0)
        pts, mask = _rand_points(rng, 1, 128)
        m = self._small_model()
        params = m.init(jax.random.PRNGKey(0), pts, mask, None)
        fn = jax.jit(lambda p, pt, mk: m.apply(p, pt, mk, None))
        pa, _ = fn(params, pts, mask)
        assert np.isfinite(np.asarray(pa)).all()


class TestParamCount:
    def test_default_config_param_count(self):
        """Full-size default config (alto depth 5, 32 filts, reso 256): parameter
        count should be in the millions, matching the reference scale
        (SURVEY.md §2.3: 'a few M params')."""
        m = TomoSAR2Height(
            encoder_kwargs={
                "feature_dim": 32, "hidden_dim": 32, "plane_resolution": 256,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 5, "start_filts": 32, "merge_mode": "concat"},
            },
            decoder_kwargs={"hidden_dim": 32, "output_size": 512},
        )
        pts = jnp.zeros((1, 64, 3))
        mask = jnp.ones((1, 64), dtype=bool)
        params = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), pts, mask, None))
        n = sum(np.prod(x.shape) for x in jax.tree.leaves(params))
        assert 5e6 < n < 30e6, n

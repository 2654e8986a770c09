"""PointNet++ / hourglass alternates + feature-map introspection tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tomosar2height_jax.models.hourglass import HGFilter
from tomosar2height_jax.models.pointnetpp import (
    PointNetPlusPlus,
    farthest_point_sample,
    index_points,
    query_ball_point,
    square_distance,
)
from tomosar2height_jax.utils.introspect import capture_feature_maps, save_feature_maps, load_feature_maps


class TestPrimitives:
    def test_square_distance(self, rng):
        a = jnp.asarray(rng.normal(size=(2, 10, 3)).astype(np.float32))
        b = jnp.asarray(rng.normal(size=(2, 7, 3)).astype(np.float32))
        d = np.asarray(square_distance(a, b))
        want = ((np.asarray(a)[:, :, None] - np.asarray(b)[:, None]) ** 2).sum(-1)
        np.testing.assert_allclose(d, want, atol=1e-4)

    def test_fps_spreads_points(self):
        # two clusters; fps with 2 samples must pick one from each
        pts = np.zeros((1, 100, 3), dtype=np.float32)
        pts[0, :50] = [0, 0, 0]
        pts[0, 50:] = [10, 10, 10]
        pts += np.random.default_rng(0).normal(0, 0.01, pts.shape)
        idx = np.asarray(farthest_point_sample(jnp.asarray(pts), 2))
        assert (idx[0, 0] < 50) != (idx[0, 1] < 50)

    def test_fps_ignores_masked(self):
        pts = np.zeros((1, 10, 3), dtype=np.float32)
        pts[0, 5:] = 100.0  # far away but masked
        mask = np.zeros((1, 10), dtype=bool)
        mask[0, :5] = True
        idx = np.asarray(farthest_point_sample(jnp.asarray(pts), 4, jnp.asarray(mask)))
        assert (idx < 5).all()

    def test_ball_query_semantics(self):
        xyz = jnp.asarray(np.array([[[0, 0, 0], [0.1, 0, 0], [5, 5, 5], [0.05, 0.05, 0]]],
                                   dtype=np.float32))
        new_xyz = xyz[:, :1]
        idx = np.asarray(query_ball_point(0.5, 3, xyz, new_xyz))
        # in-ball: 0, 1, 3 (lowest indices first); 2 excluded
        assert sorted(idx[0, 0].tolist()) == [0, 1, 3]

    def test_ball_query_pads_with_first(self):
        xyz = jnp.asarray(np.array([[[0, 0, 0], [9, 9, 9], [8, 8, 8]]], dtype=np.float32))
        idx = np.asarray(query_ball_point(0.5, 3, xyz, xyz[:, :1]))
        assert idx[0, 0].tolist() == [0, 0, 0]

    def test_index_points(self, rng):
        pts = jnp.asarray(rng.normal(size=(2, 8, 3)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 8, size=(2, 4, 2)))
        out = np.asarray(index_points(pts, idx))
        assert out.shape == (2, 4, 2, 3)
        np.testing.assert_allclose(out[1, 2, 1], np.asarray(pts)[1, int(idx[1, 2, 1])])


class TestPointNetPlusPlus:
    @pytest.mark.parametrize("unet_type", ["unet", "alto"])
    def test_forward(self, unet_type):
        rng = np.random.default_rng(0)
        n = 1024
        pts = jnp.asarray(rng.uniform(0.01, 0.99, (1, n, 3)).astype(np.float32))
        mask = jnp.asarray(np.arange(n)[None] < 900)
        m = PointNetPlusPlus(
            feature_dim=8, plane_resolution=32, unet_type=unet_type,
            unet_kwargs={"depth": 3, "start_filts": 8, "merge_mode": "concat"},
        )
        params = m.init(jax.random.PRNGKey(0), pts, mask)
        out = m.apply(params, pts, mask)
        assert out["xy"].shape == (1, 32, 32, 8)
        assert np.isfinite(np.asarray(out["xy"])).all()

    def test_in_model_shell(self):
        from tomosar2height_jax.models import TomoSAR2Height

        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(0.01, 0.99, (1, 1024, 3)).astype(np.float32))
        mask = jnp.ones((1, 1024), bool)
        m = TomoSAR2Height(
            encoder="pointnet_plus_plus",
            encoder_kwargs={"feature_dim": 8, "plane_resolution": 32,
                            "unet_type": "unet",
                            "unet_kwargs": {"depth": 3, "start_filts": 8}},
            decoder_kwargs={"hidden_dim": 8, "output_size": 64},
            z_scale=60.0,
        )
        params = m.init(jax.random.PRNGKey(0), pts, mask, None)
        pa, _ = m.apply(params, pts, mask, None)
        assert pa.shape == (1, 64, 64, 1)


class TestHourglass:
    def test_forward_shape(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
        m = HGFilter(feature_dim=8, num_hourglass=2, num_stack=2)
        params = m.init(jax.random.PRNGKey(0), x)
        out = m.apply(params, x)
        # stem stride2 + pool -> /4 resolution (reference hourglass behavior)
        assert out.shape == (1, 16, 16, 8)
        assert np.isfinite(np.asarray(out)).all()

    def test_as_image_encoder(self, rng):
        from tomosar2height_jax.models import TomoSAR2Height

        img = jnp.asarray(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
        m = TomoSAR2Height(
            use_cloud=False, use_image=True, encoder2="hourglass",
            encoder2_kwargs={"feature_dim": 8, "num_hourglass": 1, "num_stack": 1},
            decoder_kwargs={"hidden_dim": 8, "output_size": 64},
            z_scale=60.0,
        )
        params = m.init(jax.random.PRNGKey(0), None, None, img)
        pa, _ = m.apply(params, None, None, img)
        assert pa.shape == (1, 64, 64, 1)


class TestIntrospection:
    def test_capture_and_roundtrip(self, tmp_path, rng):
        from tomosar2height_jax.models.unet import UNet

        x = jnp.asarray(rng.normal(size=(1, 16, 16, 4)).astype(np.float32))
        m = UNet(num_classes=4, depth=3, start_filts=4)
        params = m.init(jax.random.PRNGKey(0), x)
        out, fmaps = capture_feature_maps(m, params, x)
        assert out.shape == (1, 16, 16, 4)
        assert len(fmaps) > 3  # per-submodule planes collected
        names = [n for n, _ in fmaps]
        assert any("down0" in n for n in names)

        p = str(tmp_path / "fm.pkl")
        save_feature_maps(p, fmaps)
        back = load_feature_maps(p)
        assert len(back) == len(fmaps)

    def test_visualizer_script(self, tmp_path, rng):
        sys_path = os.path.join(os.path.dirname(__file__), "..", "scripts")
        import sys

        sys.path.insert(0, sys_path)
        import visualize_featuremap as vf

        fmaps = [("layer_a", rng.normal(size=(1, 8, 8, 4)).astype(np.float32))]
        p = str(tmp_path / "fm.pkl")
        save_feature_maps(p, fmaps)
        out_dir = str(tmp_path / "png")
        vf.main(p, out_dir)
        assert len(os.listdir(out_dir)) == 1


import os  # noqa: E402

"""The sorted (Morton) device path must produce the same planes/outputs as the
unsorted scatter path for the full pointnet+ALTO model, and the loaders must
emit consistent bucket metadata."""

import numpy as np

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import LocalPoolPointnet, TomoSAR2Height
from tomosar2height_jax.ops.sorted_scatter import host_morton_bucket


def _sorted_inputs(rng, b=2, n=512, n_valid=450, reso=32):
    pts = rng.uniform(0.001, 0.999, (b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), dtype=bool)
    mask[:, :n_valid] = True
    cells = np.empty((b, n), np.int32)
    offs = np.empty((b, reso * reso + 1), np.int32)
    spts = pts.copy()
    for i in range(b):
        order, cells[i], offs[i] = host_morton_bucket(pts[i], mask[i], reso)
        spts[i] = pts[i][order]
        mask[i] = mask[i][order]
    return pts, spts, mask, cells, offs


class TestSortedModelParity:
    def test_pointnet_alto_same_plane(self, rng):
        reso = 32
        pts, spts, mask, cells, offs = _sorted_inputs(rng, reso=reso)
        m = LocalPoolPointnet(
            feature_dim=8, hidden_dim=8, plane_resolution=reso, unet_type="alto",
            unet_kwargs={"depth": 4, "start_filts": 8, "merge_mode": "concat"},
        )
        params = m.init(jax.random.PRNGKey(0), jnp.asarray(spts), jnp.asarray(mask))
        out_unsorted = m.apply(params, jnp.asarray(spts), jnp.asarray(mask))["xy"]
        out_sorted = m.apply(params, jnp.asarray(spts), jnp.asarray(mask),
                             jnp.asarray(cells), jnp.asarray(offs))["xy"]
        np.testing.assert_allclose(np.asarray(out_sorted), np.asarray(out_unsorted),
                                   atol=2e-4, rtol=1e-4)

    def test_pointnet_scatter_mean_variant(self, rng):
        reso = 16
        pts, spts, mask, cells, offs = _sorted_inputs(rng, reso=reso)
        m = LocalPoolPointnet(
            feature_dim=4, hidden_dim=4, plane_resolution=reso, scatter_type="mean",
            unet_type="unet", unet_kwargs={"depth": 2, "start_filts": 4},
        )
        params = m.init(jax.random.PRNGKey(0), jnp.asarray(spts), jnp.asarray(mask))
        a = m.apply(params, jnp.asarray(spts), jnp.asarray(mask))["xy"]
        b = m.apply(params, jnp.asarray(spts), jnp.asarray(mask),
                    jnp.asarray(cells), jnp.asarray(offs))["xy"]
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-4, rtol=1e-4)

    def test_full_model_with_buckets(self, rng):
        reso = 32
        pts, spts, mask, cells, offs = _sorted_inputs(rng, reso=reso)
        m = TomoSAR2Height(
            encoder_kwargs={
                "feature_dim": 8, "hidden_dim": 8, "plane_resolution": reso,
                "unet_type": "alto",
                "unet_kwargs": {"depth": 3, "start_filts": 8, "merge_mode": "concat"},
            },
            decoder_kwargs={"hidden_dim": 8, "output_size": 64},
            z_scale=60.0,
        )
        params = m.init(jax.random.PRNGKey(0), jnp.asarray(spts), jnp.asarray(mask), None)
        pa_u, _ = m.apply(params, jnp.asarray(spts), jnp.asarray(mask), None)
        pa_s, _ = m.apply(params, jnp.asarray(spts), jnp.asarray(mask), None,
                          jnp.asarray(cells), jnp.asarray(offs))
        np.testing.assert_allclose(np.asarray(pa_s), np.asarray(pa_u), atol=2e-3)

    def test_loader_emits_buckets(self, rng):
        from tomosar2height_jax.data.pipeline import PatchLoader

        class FakeDs:
            def __len__(self):
                return 2

            def __getitem__(self, i):
                return {
                    "name": f"p{i}",
                    "inputs": rng.uniform(0.01, 0.99, (300, 3)).astype(np.float32),
                    "min_bound": np.zeros(2), "max_bound": np.ones(2),
                    "is_valid": True,
                    "dsm": np.zeros((16, 16), np.float32),
                }

        loader = PatchLoader(FakeDs(), 2, [512], fixed_bucket=512, sort_reso=16)
        b = next(iter(loader))
        assert b["cell"].shape == (2, 512)
        assert b["cell_offsets"].shape == (2, 16 * 16 + 1)
        # sorted, padding last
        assert (np.diff(b["cell"], axis=1) >= 0).all()
        assert b["cell_offsets"][0, -1] == 300
        assert b["point_mask"][0, :300].all() and not b["point_mask"][0, 300:].any()

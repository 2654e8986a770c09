"""Trainer unit semantics: gradient accumulation, dynamic LR, loss masking."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tomosar2height_jax.models import TomoSAR2Height
from tomosar2height_jax.parallel.mesh import make_mesh
from tomosar2height_jax.train.trainer import Trainer, masked_patch_mean


def _tiny_model():
    return TomoSAR2Height(
        encoder_kwargs={
            "feature_dim": 4, "hidden_dim": 4, "plane_resolution": 16,
            "unet_type": "unet", "unet_kwargs": {"depth": 2, "start_filts": 4},
        },
        decoder_kwargs={"hidden_dim": 4, "output_size": 32},
        z_scale=60.0,
    )


def _batch(rng, b=2, n=128, valid=None):
    return {
        "points": rng.uniform(0.01, 0.99, (b, n, 3)).astype(np.float32),
        "point_mask": np.ones((b, n), bool),
        "patch_valid": np.array(valid if valid is not None else [True] * b),
        "dsm": rng.uniform(0, 30, (b, 32, 32)).astype(np.float32),
    }


class TestAccumulation:
    def test_multisteps_applies_every_k(self, rng):
        trainer = Trainer(_tiny_model(), {"optimize_every": 2}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        batch = _batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), batch)
        p0 = jax.tree.leaves(state.params)[0].copy()

        state = trainer.train_step(state, batch, 1e-3)
        # after 1 of 2 ministeps: parameters must be unchanged (grads held)
        np.testing.assert_array_equal(np.asarray(jax.tree.leaves(state.params)[0]),
                                      np.asarray(p0))
        assert trainer.accumulated_steps == 1
        assert trainer.last_avg_loss == 0.0  # not published yet

        state = trainer.train_step(state, batch, 1e-3)
        assert trainer.accumulated_steps == 0
        assert trainer.last_avg_loss > 0.0  # published average of 2 ministeps
        assert not np.array_equal(np.asarray(jax.tree.leaves(state.params)[0]),
                                  np.asarray(p0))

    def test_lr_scales_update(self, rng):
        trainer = Trainer(_tiny_model(), {"optimize_every": 1}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        batch = _batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), batch)
        p0 = jax.tree.leaves(state.params)[0]
        s_small = trainer.train_step(state, batch, 1e-5)
        state2 = trainer.init_state(jax.random.PRNGKey(0), batch)
        s_big = trainer.train_step(state2, batch, 1e-2)
        d_small = float(jnp.abs(jax.tree.leaves(s_small.params)[0] - p0).max())
        d_big = float(jnp.abs(jax.tree.leaves(s_big.params)[0] - p0).max())
        # adam normalizes, so the max update magnitude ~ lr
        assert d_big > 50 * d_small

    def test_invalid_patches_masked_from_loss(self, rng):
        trainer = Trainer(_tiny_model(), {"optimize_every": 1}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        b_all = _batch(rng, valid=[True, True])
        state = trainer.init_state(jax.random.PRNGKey(0), b_all)
        # poison patch 1's dsm; with patch 1 invalid, loss must equal the
        # valid-only loss
        b_poison = dict(b_all)
        b_poison["dsm"] = b_all["dsm"].copy()
        b_poison["dsm"][1] = 1e6
        b_poison["patch_valid"] = np.array([True, False])
        m_poison = trainer.eval_step(state, b_poison)
        b_single = {k: (v[:1] if isinstance(v, np.ndarray) else v) for k, v in b_all.items()}
        m_single = trainer.eval_step(state, b_single)
        assert m_poison["loss_l1"] == pytest.approx(m_single["loss_l1"], rel=1e-5)


class TestDeviceMetrics:
    def test_window_average_matches_eval(self, rng):
        """Device-side metric accumulation averages the window's losses."""
        trainer = Trainer(_tiny_model(), {"optimize_every": 2}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        b1, b2 = _batch(rng), _batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), b1)
        # losses of the two mini-steps at their pre-update params
        l1 = trainer.eval_step(state, b1)["loss"]
        state = trainer.train_step(state, b1, 0.0)  # lr=0: params frozen
        l2 = trainer.eval_step(state, b2)["loss"]
        state = trainer.train_step(state, b2, 0.0)
        assert trainer.last_avg_loss == pytest.approx((l1 + l2) / 2, rel=1e-5)
        assert trainer.last_avg_loss_dict["grad_norm"] > 0.0
        assert trainer.last_avg_loss_dict["param_norm"] > 0.0

    def test_grad_reduction_sum_scales_window(self, rng):
        """'sum' reproduces the reference's accumulated backward(): the
        effective gradient is optimize_every x the 'mean' gradient."""
        batch = _batch(rng)
        states = {}
        for mode in ("mean", "sum"):
            tr = Trainer(_tiny_model(), {"optimize_every": 2, "grad_reduction": mode},
                         use_cloud=True, mesh=make_mesh(1), donate=False)
            s = tr.init_state(jax.random.PRNGKey(0), batch)
            p0 = jnp.asarray(jax.tree.leaves(s.params)[0])
            s = tr.train_step(s, batch, 1e-3)
            s = tr.train_step(s, batch, 1e-3)
            states[mode] = float(jnp.abs(jax.tree.leaves(s.params)[0] - p0).max())
        # adam normalizes magnitude, so updates are similar but not equal;
        # both must have moved
        assert states["mean"] > 0 and states["sum"] > 0

    def test_invalid_grad_reduction_rejected(self):
        with pytest.raises(ValueError):
            Trainer(_tiny_model(), {"optimize_every": 1, "grad_reduction": "bogus"},
                    use_cloud=True, mesh=make_mesh(1), donate=False)


class TestModuleNorms:
    def test_matches_host_numpy(self, rng):
        # on-device per-module norms (the watch production path; the host
        # alternative fetches the full param tree per step)
        trainer = Trainer(_tiny_model(), {"optimize_every": 1}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        batch = _batch(rng)
        state = trainer.init_state(jax.random.PRNGKey(0), batch)
        norms = trainer.module_norms(state.params)
        tree = state.params["params"]
        assert set(norms) == set(tree)
        for name, sub in tree.items():
            expect = np.sqrt(sum(float((np.asarray(l, np.float64) ** 2).sum())
                                 for l in jax.tree.leaves(sub)))
            assert norms[name] == pytest.approx(expect, rel=1e-5)

    def test_plain_dict_and_empty(self):
        trainer = Trainer(_tiny_model(), {"optimize_every": 1}, use_cloud=True,
                          mesh=make_mesh(1), donate=False)
        assert trainer.module_norms({}) == {}
        got = trainer.module_norms({"m": {"w": jnp.full((4,), 3.0)}})
        assert got["m"] == pytest.approx(6.0)


class TestMaskedPatchMean:
    def test_weights(self):
        per_pixel = jnp.asarray(np.stack([np.full((4, 4), 2.0), np.full((4, 4), 100.0)]))
        v = jnp.asarray(np.array([True, False]))
        assert float(masked_patch_mean(per_pixel, v)) == pytest.approx(2.0)
        assert float(masked_patch_mean(per_pixel, jnp.asarray([True, True]))) == pytest.approx(51.0)
        # no valid patches -> 0, not NaN
        assert float(masked_patch_mean(per_pixel, jnp.asarray([False, False]))) == 0.0


class TestImageWire:
    def test_uint8_wire_step_matches_f32(self, rng):
        """u8 image crops + device-side (x-mean)/std (image_norm) must give
        the same loss and parameter update as host-normalized f32 crops."""
        model = TomoSAR2Height(
            use_cloud=True, use_image=True,
            encoder_kwargs={
                "feature_dim": 4, "hidden_dim": 4, "plane_resolution": 16,
                "unet_type": "unet", "unet_kwargs": {"depth": 2, "start_filts": 4},
            },
            encoder2_kwargs={"num_classes": 4, "in_channels": 3, "depth": 2,
                             "start_filts": 4},
            decoder_kwargs={"hidden_dim": 4, "output_size": 32},
            z_scale=60.0,
        )
        mean = np.full((3,), 128.0, np.float32)
        std = np.full((3,), 64.0, np.float32)
        img8 = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        imgf = ((img8.astype(np.float64) - mean) / std).astype(np.float32)
        base = _batch(rng)
        tr8 = Trainer(model, {"optimize_every": 1}, use_cloud=True,
                      use_image=True, mesh=make_mesh(1), donate=False,
                      image_norm=(mean, std))
        trf = Trainer(model, {"optimize_every": 1}, use_cloud=True,
                      use_image=True, mesh=make_mesh(1), donate=False)
        b8 = dict(base, image=img8)
        bf = dict(base, image=imgf)
        s8 = tr8.init_state(jax.random.PRNGKey(0), b8)
        sf = trf.init_state(jax.random.PRNGKey(0), bf)
        s8 = tr8.train_step(s8, b8, 1e-3)
        sf = trf.train_step(sf, bf, 1e-3)
        assert abs(tr8.last_avg_loss - trf.last_avg_loss) < 1e-5
        for a, b in zip(jax.tree.leaves(s8.params), jax.tree.leaves(sf.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5, rtol=1e-5)


class TestMeshInvariance:
    """DP sharding must be numerically transparent: the same
    global batch trained on a 1-device mesh and on the full 8-device virtual
    mesh must publish the same loss sequence and land on the same parameters
    within f32 reduction-order tolerance. This pins the core §2.3 claim that
    scaling out changes WHERE the math runs, not WHAT it computes."""

    @pytest.mark.parametrize("reduction", ["mean", "sum"])
    def test_loss_sequence_1_vs_8_devices(self, rng, reduction):
        if jax.device_count() < 8:
            pytest.skip("needs the 8-device virtual mesh")
        batches = [_batch(np.random.default_rng(100 + i), b=8) for i in range(6)]

        def run(n_dev):
            tr = Trainer(_tiny_model(),
                         {"optimize_every": 2, "grad_reduction": reduction},
                         use_cloud=True, mesh=make_mesh(n_dev), donate=False)
            state = tr.init_state(jax.random.PRNGKey(0), batches[0])
            losses, params = [], None
            for b in batches:
                state = tr.train_step(state, b, 1e-3)
                if tr.accumulated_steps == 0:
                    losses.append(tr.last_avg_loss)
            params = jax.tree.map(np.asarray, jax.device_get(state.params))
            return np.array(losses), params

        loss1, p1 = run(1)
        loss8, p8 = run(8)
        np.testing.assert_allclose(loss8, loss1, rtol=2e-5,
                                   err_msg="loss sequence diverged across mesh sizes")
        flat1 = {jax.tree_util.keystr(k): v
                 for k, v in jax.tree_util.tree_flatten_with_path(p1)[0]}
        flat8 = {jax.tree_util.keystr(k): v
                 for k, v in jax.tree_util.tree_flatten_with_path(p8)[0]}
        assert set(flat1) == set(flat8)
        for k in flat1:
            np.testing.assert_allclose(flat8[k], flat1[k], rtol=5e-4, atol=1e-6,
                                       err_msg=f"params diverged at {k}")

    def test_loss_sequence_2_vs_8_devices_with_invalid_patches(self, rng):
        """Same, across two sharded mesh sizes, with invalid patches in the
        stream — the masked-mean renormalization must also be mesh-invariant."""
        if jax.device_count() < 8:
            pytest.skip("needs the 8-device virtual mesh")
        batches = [_batch(np.random.default_rng(200 + i), b=8,
                          valid=[True] * 7 + [False]) for i in range(4)]

        def run(n_dev):
            tr = Trainer(_tiny_model(), {"optimize_every": 1},
                         use_cloud=True, mesh=make_mesh(n_dev), donate=False)
            state = tr.init_state(jax.random.PRNGKey(0), batches[0])
            losses = []
            for b in batches:
                state = tr.train_step(state, b, 1e-3)
                losses.append(tr.last_avg_loss)
            return np.array(losses)

        np.testing.assert_allclose(run(8), run(2), rtol=2e-5)

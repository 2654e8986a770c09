"""Torch parity for the config-selectable alternates.

The default path (pointnet_local_pool + ALTO + conv decoder) is pinned in
test_reference_parity.py; these tests port-and-compare the alternates the
reference exposes through its config tree:

  - FCDecoder (``decoder mode='fc'``, reference pixel.py:35-58)
  - ``scatter_type='mean'`` pooling (reference pointnet.py:55-58)
  - ALTO ``merge_mode='add'`` (reference alto.py:368-382)
  - plain-UNet ``up_mode='upsample'`` image encoder (reference unet.py:21-34)
  - HGFilter stacked-hourglass image encoder (reference hourglass.py:134-218)
  - PointNet++ set-abstraction / feature-propagation modules MODULO NORM
    (the reference uses BatchNorm; this framework deliberately substitutes
    GroupNorm for SPMD-safety — exact parity is checked with both sides'
    norms neutralized, and the deviation is documented here)
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_reference_parity import (  # noqa: E402
    _Cfg,
    _fixed_inputs,
    _flax_model,
    _ref_cfg,
    port_torch_to_flax,
    reference,  # noqa: F401  (fixture re-export)
)
from tomosar2height_jax.models import TomoSAR2Height  # noqa: E402

pytestmark = pytest.mark.usefixtures("reference")


def _run_alt(reference, rng, *, use_image=False, encoder_kwargs=None,
             encoder2_kwargs=None, decoder_kwargs=None):
    """Build reference + flax models with the given config deltas, port the
    torch weights, run both on a fixed patch, and return (flax, torch) pa."""
    cfg = _ref_cfg(True, use_image, False)
    if encoder_kwargs:
        cfg["model"]["encoder_kwargs"].update(encoder_kwargs)
    if encoder2_kwargs:
        cfg["model"]["encoder2_kwargs"].update(encoder2_kwargs)
    if decoder_kwargs:
        cfg["model"]["decoder_pixel_kwargs"].update(decoder_kwargs)
    torch.manual_seed(0)
    ref = reference.TomoSAR2Height(cfg)
    ref.eval()

    fm = _flax_model(True, use_image, False)
    fk = dict(fm.encoder_kwargs)
    fk.update(encoder_kwargs or {})
    f2 = dict(fm.encoder2_kwargs or {})
    for k, v in (encoder2_kwargs or {}).items():
        if k != "in_channels":
            f2[k] = v
    fd = dict(fm.decoder_kwargs)
    fd.update(decoder_kwargs or {})
    model = fm.clone(encoder_kwargs=fk, encoder2_kwargs=f2, decoder_kwargs=fd)

    pts, img = _fixed_inputs(rng)
    points = jnp.asarray(pts)
    mask = jnp.ones(pts.shape[:2], bool)
    image = jnp.asarray(img) if use_image else None
    params = model.init(jax.random.PRNGKey(0), points, mask, image)
    params, unused = port_torch_to_flax(ref, params)
    for k in unused:
        assert any(s in k for s in ("upconv.", "fc_comm", "fc_c")), \
            f"unexpected unported torch param: {k}"
    with torch.no_grad():
        pa_t, _ = ref(torch.from_numpy(pts),
                      torch.from_numpy(img.transpose(0, 3, 1, 2))
                      if use_image else None)
    pa_j, _ = model.apply(params, points, mask, image)
    return np.asarray(pa_j), pa_t.numpy()


class TestAlternatesParity:
    def test_fc_decoder(self, reference, rng):
        pa_j, pa_t = _run_alt(reference, rng, decoder_kwargs=dict(mode="fc"))
        assert float(np.abs(pa_t).max()) > 1e-3
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)

    def test_scatter_mean(self, reference, rng):
        pa_j, pa_t = _run_alt(reference, rng,
                              encoder_kwargs=dict(scatter_type="mean"))
        assert float(np.abs(pa_t).max()) > 1e-3
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)

    def test_alto_merge_add(self, reference, rng):
        pa_j, pa_t = _run_alt(
            reference, rng,
            encoder_kwargs=dict(unet_kwargs=dict(depth=4, start_filts=32,
                                                 merge_mode="add")))
        assert float(np.abs(pa_t).max()) > 1e-3
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)

    def test_image_unet_upsample(self, reference, rng):
        pa_j, pa_t = _run_alt(
            reference, rng, use_image=True,
            encoder2_kwargs=dict(up_mode="upsample"))
        assert float(np.abs(pa_t).max()) > 1e-3
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)


# --- HGFilter (module-level: the registry wires it identically to UNet) ----------


class TestHourglassParity:
    def test_hgfilter_matches_torch(self, reference, rng):
        from tomosar2height.encoder.hourglass import HGFilter as RefHG

        from tomosar2height_jax.models.hourglass import HGFilter

        torch.manual_seed(0)
        ref = RefHG(in_channel=3, feature_dim=16, num_hourglass=2,
                    num_stack=2, norm="group", hg_down="ave_pool")
        ref.eval()
        model = HGFilter(feature_dim=16, num_hourglass=2, num_stack=2,
                         norm="group", hg_down="ave_pool")
        img = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(img))
        params, unused = port_torch_to_flax(ref, params)
        # acceptable leftovers: the reference creates bn4 unconditionally
        # (hourglass.py:41) — unused when in==out (no downsample branch) —
        # and aliases it as downsample.0 when the branch exists (the
        # duplicate key is ported via the bn4 name)
        assert all("downsample.0" in k or ".bn4." in k for k in unused), unused
        with torch.no_grad():
            out_t = ref(torch.from_numpy(img.transpose(0, 3, 1, 2)))
        out_j = model.apply(params, jnp.asarray(img))
        out_t = out_t.numpy().transpose(0, 2, 3, 1)
        assert out_t.shape == out_j.shape
        assert float(np.abs(out_t).max()) > 1e-3
        np.testing.assert_allclose(np.asarray(out_j), out_t, atol=2e-4, rtol=0)


# --- PointNet++ modules, modulo norm ----------------------------------------------


def _neutralize_bn(module):
    """Make every BatchNorm an exact identity (eval mode, default running
    stats, eps 0): isolates the math this framework replicates from the norm
    it deliberately replaces with GroupNorm (SPMD-safe, stateless)."""
    for m in module.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.eps = 0.0
    module.eval()


def _port_pointwise_mlps(torch_mod, flax_params):
    """sa/fp module port: torch Conv1d/Conv2d 1x1 (O,I,1[,1]) -> Dense (I,O)."""
    sd = {k: v.detach().numpy() for k, v in torch_mod.state_dict().items()}
    out = {}
    for i in range(10):
        wk = f"mlp_convs.{i}.weight"
        if wk not in sd:
            break
        w = sd[wk]
        out[f"mlp{i}"] = {
            "kernel": jnp.asarray(w.reshape(w.shape[0], w.shape[1]).T.copy()),
            "bias": jnp.asarray(sd[f"mlp_convs.{i}.bias"].copy()),
        }
    assert set(flax_params["params"]) == set(out), (
        sorted(flax_params["params"]), sorted(out))
    return {"params": out}


class TestPointNetPlusPlusModuloNorm:
    def test_set_abstraction(self, reference, rng):
        from tomosar2height.encoder.pointnetpp import PointNetSetAbstraction

        from tomosar2height_jax.models.pointnetpp import SetAbstraction

        torch.manual_seed(0)
        ref = PointNetSetAbstraction(npoint=64, radius=0.2, nsample=16,
                                     in_channel=3 + 3, mlp=[16, 16, 32],
                                     group_all=False)
        _neutralize_bn(ref)
        # reference FPS seeds from torch.randint (pointnetpp.py:232); pin it
        # to 0 = this framework's deterministic first-valid start
        real_randint = torch.randint
        torch.randint = lambda *a, **k: torch.zeros(a[-1], dtype=torch.long)
        try:
            pts = rng.uniform(0, 1, (1, 256, 3)).astype(np.float32)
            xyz_t = torch.from_numpy(pts.transpose(0, 2, 1))
            with torch.no_grad():
                new_xyz_t, new_pts_t = ref(xyz_t, xyz_t)
        finally:
            torch.randint = real_randint

        model = SetAbstraction(64, 0.2, 16, (16, 16, 32), norm="none")
        xyz = jnp.asarray(pts)
        mask = jnp.ones((1, 256), bool)
        params = model.init(jax.random.PRNGKey(0), xyz, xyz, mask)
        params = _port_pointwise_mlps(ref, params)
        new_xyz_j, new_pts_j, _ = model.apply(params, xyz, xyz, mask)
        np.testing.assert_allclose(
            np.asarray(new_xyz_j), new_xyz_t.numpy().transpose(0, 2, 1),
            atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(new_pts_j), new_pts_t.numpy().transpose(0, 2, 1),
            atol=1e-5, rtol=1e-4)

    def test_feature_propagation(self, reference, rng):
        from tomosar2height.encoder.pointnetpp import PointNetFeaturePropagation

        from tomosar2height_jax.models.pointnetpp import FeaturePropagation

        torch.manual_seed(0)
        ref = PointNetFeaturePropagation(in_channel=8 + 4, mlp=[16, 8])
        _neutralize_bn(ref)
        xyz1 = rng.uniform(0, 1, (1, 128, 3)).astype(np.float32)
        xyz2 = rng.uniform(0, 1, (1, 32, 3)).astype(np.float32)
        p1 = rng.normal(size=(1, 128, 4)).astype(np.float32)
        p2 = rng.normal(size=(1, 32, 8)).astype(np.float32)
        with torch.no_grad():
            out_t = ref(torch.from_numpy(xyz1.transpose(0, 2, 1)),
                        torch.from_numpy(xyz2.transpose(0, 2, 1)),
                        torch.from_numpy(p1.transpose(0, 2, 1)),
                        torch.from_numpy(p2.transpose(0, 2, 1)))
        model = FeaturePropagation((16, 8), norm="none")
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(xyz1),
                            jnp.asarray(xyz2), jnp.asarray(p1), jnp.asarray(p2))
        params = _port_pointwise_mlps(ref, params)
        out_j = model.apply(params, jnp.asarray(xyz1), jnp.asarray(xyz2),
                            jnp.asarray(p1), jnp.asarray(p2))
        np.testing.assert_allclose(np.asarray(out_j),
                                   out_t.numpy().transpose(0, 2, 1),
                                   atol=1e-5, rtol=1e-4)

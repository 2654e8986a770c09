"""Whole-model numerical parity vs the torch reference.

Ports Xavier-initialized weights from the reference's torch modules
(/root/reference/tomosar2height/model.py:54-67) into the flax tree, then
asserts forward parity on fixed patches for cloud-only, image-only and
cloud+image(+footprint) configs. torch_scatter and open3d are not installed;
they are shimmed with the same oracles golden-tested in tests/test_ops.py.

This is the insurance layer for BASELINE.md's "RMSE parity vs reference"
north star: any drift in grid_sample semantics, scatter empty-cell handling,
plane orientation, interpolation align_corners, or weight-layout conventions
fails here before real data ever runs.
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tomosar2height_jax.models import TomoSAR2Height  # noqa: E402

REFERENCE_ROOT = "/root/reference"


# --- shims for the reference's unavailable native deps ---------------------------


def _expand(index, src):
    return index.expand_as(src) if index.shape != src.shape else index


def _shim_torch_scatter():
    """Minimal torch_scatter covering the reference's three call patterns
    (pointnet.py:95,109; alto.py:85): scatter along the last dim, index
    broadcast over channels, optional zero-filled ``out``."""
    mod = types.ModuleType("torch_scatter")

    def scatter_mean(src, index, dim=-1, out=None, dim_size=None):
        index = _expand(index, src)
        dim = dim % src.dim()
        if out is not None:
            size = out.shape[dim]
        elif dim_size is not None:
            size = dim_size
        else:
            size = int(index.max()) + 1
        shape = list(src.shape)
        shape[dim] = size
        sums = torch.zeros(shape, dtype=src.dtype).scatter_add_(dim, index, src)
        cnt = torch.zeros(shape, dtype=src.dtype).scatter_add_(
            dim, index, torch.ones_like(src))
        res = sums / cnt.clamp(min=1.0)
        if out is not None:  # reference always passes zeros
            out.add_(res)
            return out
        return res

    def scatter_max(src, index, dim=-1, dim_size=None):
        index = _expand(index, src)
        dim = dim % src.dim()
        size = dim_size if dim_size is not None else int(index.max()) + 1
        shape = list(src.shape)
        shape[dim] = size
        out = torch.full(shape, -float("inf"), dtype=src.dtype)
        out = out.scatter_reduce(dim, index, src, reduce="amax", include_self=True)
        out = torch.where(torch.isfinite(out), out,
                          torch.zeros((), dtype=src.dtype))
        return out, None  # argmax unused by the reference (takes fea[0])

    mod.scatter_mean = scatter_mean
    mod.scatter_max = scatter_max
    return mod


@pytest.fixture(scope="module")
def reference():
    """Import the reference model package with shimmed deps."""
    sys.modules.setdefault("torch_scatter", _shim_torch_scatter())
    # reference utils/__init__.py pulls io_cloud/io_raster, whose deps are
    # absent here; only utils.coordinate.coordinate2index is on the model path
    for name in ("open3d", "laspy", "rasterio"):
        sys.modules.setdefault(name, types.ModuleType(name))
    o3d = sys.modules["open3d"]
    if not hasattr(o3d, "geometry"):  # annotation in io_cloud.py:53
        o3d.geometry = types.SimpleNamespace(PointCloud=object)
        o3d.utility = types.SimpleNamespace(Vector3dVector=object)
    rio = sys.modules["rasterio"]
    rt = types.ModuleType("rasterio.transform")  # io_raster.py:9
    rt.Affine = object
    rio.transform = rt
    rio.DatasetReader = object  # annotations in io_raster.py:156,160
    rio.io = types.SimpleNamespace(DatasetWriter=object)  # io_raster.py:174
    sys.modules.setdefault("rasterio.transform", rt)
    if REFERENCE_ROOT not in sys.path:
        sys.path.append(REFERENCE_ROOT)
    ref_model = pytest.importorskip("tomosar2height.model")
    return ref_model


class _Cfg(dict):
    """dict with attribute access (the reference reads cfg.use_cloud AND
    cfg['model'], model.py:17-41)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _ref_cfg(use_cloud, use_image, use_footprint):
    return _Cfg(
        use_cloud=use_cloud,
        use_image=use_image,
        model=dict(
            data_dim=3,
            encoder="pointnet_local_pool",
            encoder_kwargs=dict(
                feature_dim=32, hidden_dim=32, scatter_type="max",
                unet_type="alto", plane_resolution=32,
                unet_kwargs=dict(depth=4, start_filts=32, merge_mode="concat"),
            ),
            encoder2="unet",
            encoder2_kwargs=dict(num_classes=32, in_channels=3, depth=3,
                                 start_filts=16),
            decoder_pixel_kwargs=dict(hidden_dim=32, out_dim=1, output_size=64,
                                      mode="conv", use_footprint=use_footprint),
        ),
        test=dict(threshold=0.5),
        dataset=dict(normalize=dict(z_bound=[0.0, 60.0])),
    )


def _flax_model(use_cloud, use_image, use_footprint):
    return TomoSAR2Height(
        use_cloud=use_cloud,
        use_image=use_image,
        encoder_kwargs=dict(
            feature_dim=32, hidden_dim=32, scatter_type="max",
            unet_type="alto", plane_resolution=32,
            unet_kwargs=dict(depth=4, start_filts=32, merge_mode="concat"),
        ),
        encoder2_kwargs=dict(num_classes=32, depth=3, start_filts=16),
        decoder_kwargs=dict(hidden_dim=32, out_dim=1, output_size=64,
                            mode="conv", use_footprint=use_footprint),
        z_scale=60.0,
    )


# --- torch state_dict -> flax param tree ------------------------------------------
# The mapping machinery lives in the package (tomosar2height_jax/utils/
# torch_port.py) so scripts/port_torch_checkpoint.py can convert real
# reference checkpoints; this harness pins it numerically.

from tomosar2height_jax.utils.torch_port import (  # noqa: E402
    flatten_tree as _flatten,
    port_torch_grads,
    port_torch_to_flax,
)

# --- the parity checks -------------------------------------------------------------


def _fixed_inputs(rng, n=512, img_size=64):
    pts = rng.uniform(0.01, 0.99, (1, n, 3)).astype(np.float32)
    img = rng.normal(size=(1, img_size, img_size, 3)).astype(np.float32)
    return pts, img


def _run_pair(reference, use_cloud, use_image, use_footprint, rng):
    torch.manual_seed(0)
    ref = reference.TomoSAR2Height(_ref_cfg(use_cloud, use_image, use_footprint))
    ref.eval()

    model = _flax_model(use_cloud, use_image, use_footprint)
    pts, img = _fixed_inputs(rng)
    points = jnp.asarray(pts) if use_cloud else None
    mask = jnp.ones(pts.shape[:2], bool) if use_cloud else None
    image = jnp.asarray(img) if use_image else None
    params = model.init(jax.random.PRNGKey(0), points, mask, image)
    params, unused = port_torch_to_flax(ref, params)
    # every unused torch param must be a known dead head of the reference
    for k in unused:
        assert any(s in k for s in ("upconv.", "fc_comm", "fc_c")), \
            f"unexpected unported torch param: {k}"

    with torch.no_grad():
        pa_t, pb_t = ref(
            torch.from_numpy(pts) if use_cloud else None,
            torch.from_numpy(img.transpose(0, 3, 1, 2)) if use_image else None,
        )
    pa_j, pb_j = model.apply(params, points, mask, image)
    return (np.asarray(pa_j), pa_t.numpy(),
            None if pb_j is None else np.asarray(pb_j),
            None if pb_t is None else pb_t.numpy())


class TestReferenceParity:
    def test_cloud_only(self, reference, rng):
        pa_j, pa_t, _, _ = _run_pair(reference, True, False, False, rng)
        assert pa_t.shape == pa_j.shape
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)

    def test_image_only(self, reference, rng):
        pa_j, pa_t, _, _ = _run_pair(reference, False, True, False, rng)
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)

    def test_cloud_image_footprint(self, reference, rng):
        pa_j, pa_t, pb_j, pb_t = _run_pair(reference, True, True, True, rng)
        np.testing.assert_allclose(pa_j, pa_t, atol=1e-4, rtol=0)
        assert pb_j is not None and pb_t is not None
        np.testing.assert_allclose(pb_j, pb_t, atol=1e-4, rtol=0)

    def test_outputs_not_trivial(self, reference, rng):
        """Guard against vacuous parity (all-zero outputs)."""
        pa_j, pa_t, _, _ = _run_pair(reference, True, False, False, rng)
        assert float(np.abs(pa_t).max()) > 1e-3

    def test_grad_parity_default_path(self, reference, rng):
        """d(loss)/d(params) matches torch autograd on the default path.
        Loss = L1 to a fixed target, the reference
        training loss (trainer.py:61-70, footprint off)."""
        torch.manual_seed(0)
        ref = reference.TomoSAR2Height(_ref_cfg(True, False, False))
        ref.eval()
        model = _flax_model(True, False, False)
        pts, _ = _fixed_inputs(rng)
        target = rng.uniform(0, 50, (1, 64, 64)).astype(np.float32)
        points = jnp.asarray(pts)
        mask = jnp.ones(pts.shape[:2], bool)
        params = model.init(jax.random.PRNGKey(0), points, mask, None)
        params, _ = port_torch_to_flax(ref, params)

        pa_t, _ = ref(torch.from_numpy(pts), None)
        loss_t = torch.nn.functional.l1_loss(pa_t, torch.from_numpy(target))
        loss_t.backward()
        g_ref, _ = port_torch_grads(ref, params)

        def loss_fn(p):
            pa, _ = model.apply(p, points, mask, None)
            return jnp.abs(pa - jnp.asarray(target)).mean()

        loss_j, g_j = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(float(loss_j), float(loss_t), rtol=1e-5)

        flat_r = _flatten(g_ref["params"])
        flat_j = _flatten(g_j["params"])
        assert set(flat_r) == set(flat_j)
        gmax = max(float(np.abs(np.asarray(v)).max()) for v in flat_r.values())
        assert gmax > 0
        worst = 0.0
        for path in flat_r:
            a = np.asarray(flat_j[path])
            b = np.asarray(flat_r[path])
            err = float(np.abs(a - b).max())
            worst = max(worst, err / gmax)
            assert err <= 1e-4 + 1e-3 * gmax, (path, err, gmax)
        assert worst < 1e-3

    def test_checkpoint_file_port(self, reference, rng, tmp_path):
        """scripts/port_torch_checkpoint.py converts a reference ``.pt``
        checkpoint FILE (reference io_checkpoint.py:38-48 layout) into a
        loadable ``.ckpt``: params bit-match the live-module port, scalar
        metadata carries over, and the result loads through CheckpointIO."""
        import os

        import torch

        from tomosar2height_jax.train import CheckpointIO

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "scripts"))
        import port_torch_checkpoint as pc

        torch.manual_seed(0)
        ref = reference.TomoSAR2Height(_ref_cfg(True, False, False))
        src = tmp_path / "model_best.pt"
        torch.save({"model": ref.state_dict(), "optimizer": {},
                    "n_iter": 123, "loss_val_best": 0.25,
                    "training_time": 7.5}, str(src))

        dst = tmp_path / "ported" / "model_best.ckpt"
        pc.main(["--src", str(src), "--dst", str(dst),
                 "dataset=synthetic", "use_cloud=true", "use_image=false",
                 "use_footprint=false",
                 "model.encoder_kwargs.plane_resolution=32",
                 "model.encoder_kwargs.unet_kwargs.depth=4",
                 "model.decoder_pixel_kwargs.output_size=64"])
        assert dst.exists()

        model = _flax_model(True, False, False)
        pts, _ = _fixed_inputs(rng)
        points = jnp.asarray(pts)
        mask = jnp.ones(pts.shape[:2], bool)
        params = model.init(jax.random.PRNGKey(0), points, mask, None)
        io = CheckpointIO(str(dst.parent), model=params)
        scalars = io.load(str(dst), resume_scheduler=False)
        assert int(scalars["n_iter"]) == 123
        assert abs(float(scalars["loss_val_best"]) - 0.25) < 1e-9
        want, _ = port_torch_to_flax(ref, params)
        got = io.module_dict["model"]
        flat_w, flat_g = _flatten(want["params"]), _flatten(got["params"])
        assert set(flat_w) == set(flat_g)
        for path in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(flat_w[path]), err_msg=str(path))

        # --reverse: .ckpt -> .pt must reproduce the ORIGINAL torch tensors
        # bit-exactly for every exported key (the permutations invert cleanly)
        back = tmp_path / "back" / "model_best.pt"
        pc.main(["--src", str(dst), "--dst", str(back), "--reverse",
                 "dataset=synthetic", "use_cloud=true", "use_image=false",
                 "use_footprint=false",
                 "model.encoder_kwargs.plane_resolution=32",
                 "model.encoder_kwargs.unet_kwargs.depth=4",
                 "model.decoder_pixel_kwargs.output_size=64"])
        rt = torch.load(str(back), map_location="cpu", weights_only=True)
        assert int(rt["n_iter"]) == 123
        orig = {k: v.numpy() for k, v in ref.state_dict().items()}
        assert set(rt["model"]).issubset(orig)
        for k, v in rt["model"].items():
            np.testing.assert_array_equal(v.numpy(), orig[k], err_msg=k)
        # and the reference model accepts it
        missing, unexpected = ref.load_state_dict(rt["model"], strict=False)
        assert not unexpected
        assert all("upconv" in k or "fc_c" in k or "fc_comm" in k
                   for k in missing), missing

    def test_training_dynamics_short(self, reference, tmp_path):
        """Short pin of scripts/parity_training_dynamics.py:
        both stacks run AdamW + CyclicLR + summed accumulation from identical
        ported init weights over an identical patch stream; the loss
        trajectories must agree within the torch-vs-perturbed-torch chaos
        floor. scripts/parity_training_dynamics.py runs the full 100 steps."""
        import json
        import os

        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "scripts"))
        import parity_training_dynamics as ptd

        out = tmp_path / "dyn.json"
        rc = ptd.main(["--steps", "10", "--accum", "2", "--points", "256",
                       "--stream", "4", "--json", str(out)])
        assert rc == 0, "training-dynamics parity gate failed"
        res = json.loads(out.read_text())
        assert res["ok"]
        assert res["loss_drop_torch"] > 1.5

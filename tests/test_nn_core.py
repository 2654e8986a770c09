"""The module core (models/nn.py) against flax.linen, kept as a test-only oracle.

The repo's model modules are executed a second time with ``nn`` bound to
``flax.linen``; the same network code must then give identical parameter
trees (names, shapes, initial values for the same key) and equal outputs
under both module systems.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.model import TomoSAR2Height
from tomosar2height_jax.models.unet import UNet

fnn = pytest.importorskip("flax.linen")

_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "tomosar2height_jax", "models")
_SHADOW = "_flax_models"
_MODULES = ("blocks", "unet", "alto", "pointnet", "pointnetpp", "hourglass",
            "decoder", "model")


def _rewrite(src: str) -> str:
    src = src.replace("from tomosar2height_jax.models import nn", "import flax.linen as nn")
    src = src.replace("from tomosar2height_jax.models import encoder_dict",
                      f"from {_SHADOW} import encoder_dict")
    return src.replace("tomosar2height_jax.models.", f"{_SHADOW}.")


def flax_models():
    """The model package re-executed under flax.linen (built once)."""
    if _SHADOW in sys.modules:
        return sys.modules[_SHADOW]
    pkg = types.ModuleType(_SHADOW)
    pkg.__path__ = []
    sys.modules[_SHADOW] = pkg
    for name in _MODULES:
        path = os.path.join(_MODELS_DIR, f"{name}.py")
        mod = types.ModuleType(f"{_SHADOW}.{name}")
        mod.__file__ = path
        sys.modules[mod.__name__] = mod
        with open(path) as f:
            exec(compile(_rewrite(f.read()), path, "exec"), mod.__dict__)
        setattr(pkg, name, mod)
    path = os.path.join(_MODELS_DIR, "__init__.py")
    with open(path) as f:
        exec(compile(_rewrite(f.read()), path, "exec"), pkg.__dict__)
    return pkg


def _assert_same_tree(ours, theirs, exact=True):
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, theirs))
    assert [jax.tree_util.keystr(p) for p, _ in a] == [jax.tree_util.keystr(p) for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert np.shape(x) == np.shape(y), jax.tree_util.keystr(path)
        if exact:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=jax.tree_util.keystr(path))


def _check(ours, theirs, *args):
    """Init both with one key: same tree and values; apply both on flax's
    params: equal outputs."""
    key = jax.random.PRNGKey(3)
    p_ours = ours.init(key, *args)
    p_flax = theirs.init(key, *args)
    _assert_same_tree(p_ours, p_flax)
    p_flax = jax.tree.map(jnp.asarray, p_flax)
    _assert_same_tree(ours.apply(p_flax, *args), theirs.apply(p_flax, *args),
                      exact=False)


def _x(shape, seed=0, dtype=jnp.float32):
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape), dtype)


def _layer_pair(kind):
    xavier = nn.initializers.xavier_uniform()
    table = {
        "dense": lambda m: m.Dense(5, kernel_init=xavier),
        "dense_nobias_bf16": lambda m: m.Dense(5, use_bias=False, dtype=jnp.bfloat16),
        "conv3x3": lambda m: m.Conv(6, (3, 3), kernel_init=xavier),
        "conv1x1": lambda m: m.Conv(6, (1, 1)),
        "conv7x7_s2_pad3": lambda m: m.Conv(4, (7, 7), strides=(2, 2),
                                            padding=((3, 3), (3, 3))),
        "conv3x3_nobias_bf16": lambda m: m.Conv(4, (3, 3), use_bias=False,
                                                dtype=jnp.bfloat16),
        "conv_transpose2x2": lambda m: m.ConvTranspose(3, (2, 2), strides=(2, 2),
                                                       padding="VALID"),
        "groupnorm": lambda m: m.GroupNorm(num_groups=4),
        "groupnorm_bf16": lambda m: m.GroupNorm(num_groups=2, dtype=jnp.bfloat16),
    }
    return table[kind](nn), table[kind](fnn)


@pytest.mark.parametrize("kind", [
    "dense", "dense_nobias_bf16", "conv3x3", "conv1x1", "conv7x7_s2_pad3",
    "conv3x3_nobias_bf16", "conv_transpose2x2", "groupnorm", "groupnorm_bf16",
])
def test_layer_matches_flax(kind):
    ours, theirs = _layer_pair(kind)
    _check(ours, theirs, _x((2, 8, 8, 8)))


def test_groupnorm_on_point_groups_matches_flax():
    # pointnetpp normalizes (B, S, K, C) groups and (B, N, C) point features
    for shape in [(2, 5, 3, 8), (2, 7, 8)]:
        _check(nn.GroupNorm(num_groups=4), fnn.GroupNorm(num_groups=4), _x(shape))


@pytest.mark.parametrize("pool", ["max_pool", "avg_pool"])
def test_pooling_matches_flax(pool):
    x = _x((2, 8, 8, 3))
    ours = getattr(nn, pool)(x, (2, 2), strides=(2, 2))
    theirs = getattr(fnn, pool)(x, (2, 2), strides=(2, 2))
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def _composite(m):
    class Block(m.Module):
        width: int

        @m.compact
        def __call__(self, x):
            x = m.relu(m.Dense(self.width)(x))  # auto-named Dense_0
            return m.Dense(self.width, name="out")(x) + m.Dense(self.width)(x)

    class Net(m.Module):
        @m.compact
        def __call__(self, x):
            x = Block(4)(x)  # Block_0
            x = m.remat(Block)(4, name="rematted")(x)
            return Block(3)(x)  # Block_1

    return Net()


def test_auto_names_and_remat_match_flax():
    x = _x((3, 6))
    _check(_composite(nn), _composite(fnn), x)
    ours = _composite(nn)
    params = ours.init(jax.random.PRNGKey(0), x)
    assert set(params["params"]) == {"Block_0", "rematted", "Block_1"}
    assert set(params["params"]["Block_0"]) == {"Dense_0", "out", "Dense_1"}
    grads = jax.grad(lambda p: ours.apply(p, x).sum())(params)
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(grads))


def test_capture_intermediates_matches_flax():
    theirs = flax_models().unet.UNet
    x = _x((1, 16, 16, 4))
    params = UNet(num_classes=4, depth=3, start_filts=4).init(jax.random.PRNGKey(0), x)
    out_a, st_a = UNet(num_classes=4, depth=3, start_filts=4).apply(
        params, x, capture_intermediates=True, mutable=["intermediates"])
    out_b, st_b = theirs(num_classes=4, depth=3, start_filts=4).apply(
        params, x, capture_intermediates=True, mutable=["intermediates"])
    _assert_same_tree(st_a["intermediates"], st_b["intermediates"], exact=False)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_b), rtol=1e-5, atol=1e-5)


def test_unbound_module_and_shape_mismatch_raise():
    with pytest.raises(RuntimeError):
        nn.Dense(3)(jnp.ones((1, 2)))
    params = nn.Dense(3).init(jax.random.PRNGKey(0), jnp.ones((1, 2)))
    with pytest.raises(ValueError):
        nn.Dense(3).apply(params, jnp.ones((1, 5)))


_ALTO = {"feature_dim": 8, "hidden_dim": 8, "plane_resolution": 16,
         "unet_type": "alto", "unet_kwargs": {"depth": 3, "start_filts": 4}}
_MODEL_CONFIGS = {
    "cloud_alto_max": dict(encoder_kwargs=_ALTO),
    "cloud_unet_mean": dict(encoder_kwargs=dict(
        _ALTO, scatter_type="mean", unet_type="unet",
        unet_kwargs={"depth": 2, "start_filts": 4})),
    "cloud_alto_remat_footprint": dict(
        encoder_kwargs=_ALTO, remat=True,
        decoder_kwargs={"hidden_dim": 8, "output_size": 32, "use_footprint": True}),
    "cloud_fc_decoder_footprint": dict(
        encoder_kwargs=_ALTO,
        decoder_kwargs={"hidden_dim": 8, "output_size": 32, "mode": "fc",
                        "use_footprint": True}),
    "pointnet_plus_plus": dict(
        encoder="pointnet_plus_plus",
        encoder_kwargs={"feature_dim": 8, "plane_resolution": 16, "unet_type": "unet",
                        "unet_kwargs": {"depth": 2, "start_filts": 4}}),
    "fusion_unet_image": dict(
        encoder_kwargs=_ALTO, use_image=True,
        encoder2_kwargs={"num_classes": 8, "depth": 2, "start_filts": 4}),
    "image_only_hourglass": dict(
        use_cloud=False, use_image=True, encoder2="hourglass",
        encoder2_kwargs={"num_classes": 8, "num_hourglass": 1, "num_stack": 2}),
    "cloud_alto_bf16": dict(encoder_kwargs=_ALTO, dtype=jnp.bfloat16),
}


@pytest.mark.parametrize("config", sorted(_MODEL_CONFIGS))
def test_model_config_matches_flax(config):
    kw = dict(use_cloud=True, z_scale=60.0,
              decoder_kwargs={"hidden_dim": 8, "output_size": 32})
    kw.update(_MODEL_CONFIGS[config])
    ours = TomoSAR2Height(**kw)
    theirs = flax_models().model.TomoSAR2Height(**kw)
    rng = np.random.default_rng(1)
    n = 1024 if kw.get("encoder") == "pointnet_plus_plus" else 256
    pts = jnp.asarray(rng.uniform(0.01, 0.99, (2, n, 3)).astype(np.float32))
    mask = jnp.asarray(rng.random((2, n)) < 0.9)
    image = _x((2, 32, 32, 3)) if kw.get("use_image") else None
    if not kw["use_cloud"]:
        pts = mask = None
    _check(ours, theirs, pts, mask, image)

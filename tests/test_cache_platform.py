"""Compile-cache placement and the device.platform check."""

import os

import pytest

import jax

from tomosar2height_jax.utils import cache


@pytest.mark.parametrize("environ, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, None),
    ({}, "checkout"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "checkout"),
])
def test_cache_dir_choice(environ, expected):
    got = cache.cache_dir_to_set(environ)
    if expected is None:
        assert got is None  # JAX's own variable: nothing set in code
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")


def _restoring_platforms(fn):
    before = jax.config.jax_platforms
    try:
        return fn()
    finally:
        jax.config.update("jax_platforms", before)


def test_platform_matching_backend_passes():
    _restoring_platforms(lambda: cache.select_platform("cpu"))
    cache.select_platform(None)  # null: JAX's default, nothing checked


@pytest.mark.parametrize("platform", ["gpu", "cuda"])
def test_platform_mismatch_raises(platform):
    with pytest.raises(RuntimeError, match="JAX runs on cpu"):
        _restoring_platforms(lambda: cache.select_platform(platform))

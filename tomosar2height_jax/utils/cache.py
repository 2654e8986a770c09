"""Persistent XLA compilation cache and backend selection.

With the on-disk cache, restarted runs (resume, eval sweeps, benches) reuse
compiled programs. Tests run on the CPU (``tests/conftest.py``); the GPU runs
through the normal entry points (``python chip_smoke.py`` checks them).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir_to_set(environ=os.environ) -> str | None:
    """The directory the program sets for the cache: none when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), else
    ``<checkout>/.jax_cache``."""
    return None if environ.get("JAX_COMPILATION_CACHE_DIR") else CHECKOUT_CACHE_DIR


def enable_compile_cache() -> None:
    """Turn on the persistent compilation cache (:func:`cache_dir_to_set`).
    Call before the first jit. CPU-only runs (tests, dry runs) skip it: their
    compiles are fast, and cached XLA:CPU executables carry host machine
    features across hosts."""
    import jax

    if jax.config.jax_platforms == "cpu":
        return
    cache_dir = cache_dir_to_set()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def select_platform(platform: str | None) -> None:
    """Require the JAX backend named by ``device.platform`` ('gpu' or 'cpu'),
    the counterpart of the reference's ``gpu_id`` device selection
    (train.py:20-21). Null leaves JAX's default.

    Before the backends start this selects the platform; afterwards it only
    checks it. Either way a run on another backend raises instead of going on.
    """
    if not platform:
        return
    import jax

    # after backend start-up this update has no effect; the check below holds
    jax.config.update("jax_platforms", {"gpu": "cuda"}.get(platform, platform))
    backend = jax.default_backend()
    if backend != platform:
        raise RuntimeError(f"device.platform={platform}, but JAX runs on {backend}")

"""Deterministic seeding (parity: reference utils/lock_seed.py:6-16).

The reference seeds python/numpy/torch globals; in JAX, device-side randomness is
explicit via PRNG keys, so ``lock_seed`` seeds the host generators (python's
``random``, numpy) — used by the patch sampler — and returns a ``jax.random`` key
for any device-side use.
"""

from __future__ import annotations

import random

import numpy as np


def lock_seed(seed: int = 0) -> int:
    """Seed the host generators. Returns the seed (make a PRNGKey from it for
    device-side use) — deliberately does NOT construct a jax key here:
    creating one initializes the device backend, a surprising side effect for
    host-only callers like the offline dataset builder (it would start the
    device backend before ``device.platform`` could be honored)."""
    random.seed(seed)
    np.random.seed(seed)
    return seed

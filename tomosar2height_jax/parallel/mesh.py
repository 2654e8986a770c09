"""Device mesh + sharding helpers (data parallelism over patches).

The reference is single-GPU (SURVEY.md §2.3) — its 64-patch gradient
accumulation is re-designed here as real data parallelism: batches shard over
the 'data' mesh axis, parameters replicate, and XLA's GSPMD partitioner inserts
the cross-device gradient all-reduce inside the jitted train step.

Multi-host scale-out: call :func:`init_distributed` before any other JAX
work; :func:`make_mesh` then spans ALL processes' devices (the GSPMD program
is identical — this model is pure data parallel, so the only cross-device
traffic is one ~11 M-param gradient reduction per optimizer step),
and :func:`shard_batch` assembles global arrays from each process's local
patches via ``jax.make_array_from_process_local_data``.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

log = logging.getLogger(__name__)

DATA_AXIS = "data"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize ``jax.distributed`` for multi-process (multi-host) runs.

    Call before any other JAX API. The cluster is given explicitly
    (``device.distributed.*``: coordinator ``host:port``, process count and
    index); without a coordinator the run stays single-process and this
    returns False at once, so entry points call it unconditionally — one
    process drives all local devices. Returns True when a multi-process
    runtime was initialized.

    SURVEY.md §2.3/§5: the reference has no distributed backend at all; this
    is the capability-equivalent entry for multi-host scale-out.
    """
    if not coordinator_address:
        if num_processes is not None and int(num_processes) > 1:
            raise ValueError("num_processes > 1 needs a coordinator_address")
        return False
    if num_processes is not None and int(num_processes) <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    log.info("jax.distributed: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices (-1/None = all).

    After :func:`init_distributed`, ``jax.devices()`` is the GLOBAL device
    list (all processes), so the mesh spans hosts; per-process limits only
    make sense single-process (asserted)."""
    if devices is None and jax.process_count() > 1:
        assert n_devices is None or n_devices <= 0 or \
            n_devices == jax.device_count(), \
            "multi-process meshes must span all global devices"
        devices = jax.devices()
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None and n_devices > 0:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (the batch of patches) across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (params / optimizer state) across the mesh."""
    s = NamedSharding(mesh, P())
    return jax.device_put(tree, s)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Device-put array leaves of a batch dict with axis-0 sharding.

    Non-array entries (names, python scalars) pass through. Batch size must be
    divisible by the mesh size — the PatchLoader emits fixed-size batches with
    invalid-patch masking, so this holds by construction.

    Multi-process: each process passes its LOCAL patches (global batch =
    local batch x process_count, assembled without any cross-host transfer —
    every process's shard lands on its own devices).
    """
    s = batch_sharding(mesh)
    multiproc = jax.process_count() > 1
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if multiproc:
                out[k] = jax.make_array_from_process_local_data(s, v)
            else:
                out[k] = jax.device_put(v, s)
        else:
            out[k] = v
    return out

"""Worker for the multi-process mesh smoke test (tests/test_distributed.py).

Each of N processes owns 4 virtual CPU devices; together they form one global
8-device data-parallel mesh. The worker assembles its local batch shard into a
global array (shard_batch's multi-process path), reduces it with a jitted
replicated-output sum (GSPMD inserts the cross-process collective), and prints the global result — every process must print the
same number, proving the mesh, sharding, and collective span processes.

Usage: dist_worker_smoke.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tomosar2height_jax.parallel import (  # noqa: E402
    init_distributed,
    make_mesh,
    shard_batch,
)


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert init_distributed(coord, nproc, pid)
    assert jax.process_count() == nproc
    mesh = make_mesh()
    assert mesh.size == 4 * nproc, mesh.size

    local = (np.arange(12, dtype=np.float32).reshape(4, 3) + 1000.0 * pid)
    batch = shard_batch({"x": local}, mesh)
    assert batch["x"].shape == (4 * nproc, 3)  # global batch
    out = jax.jit(lambda x: x.sum(),
                  out_shardings=NamedSharding(mesh, P()))(batch["x"])
    print(f"GLOBAL_SUM {float(out):.1f}", flush=True)


if __name__ == "__main__":
    main()

from tomosar2height_jax.parallel.mesh import (  # noqa: F401
    batch_sharding,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)

from tomosar2height_jax.utils.seeding import lock_seed  # noqa: F401
from tomosar2height_jax.utils.logging import setup_logging, MetricLogger  # noqa: F401
from tomosar2height_jax.utils.cache import enable_compile_cache  # noqa: F401

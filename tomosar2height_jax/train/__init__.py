from tomosar2height_jax.train.schedule import build_scheduler  # noqa: F401
from tomosar2height_jax.train.checkpoint import CheckpointIO, DEFAULT_MODEL_FILE  # noqa: F401
from tomosar2height_jax.train.trainer import Trainer, TrainState  # noqa: F401

from tomosar2height_jax.data.dataset import TomoSARDataset  # noqa: F401
from tomosar2height_jax.data.pipeline import (  # noqa: F401
    PatchLoader,
    pick_bucket,
)
from tomosar2height_jax.data.builder import build_dataset  # noqa: F401

"""Device-side primitive ops (JAX/XLA, NHWC layout, static shapes).

These replace the reference's CUDA-backed primitives with plain JAX that XLA
compiles for the device:

- :mod:`scatter`  — masked segment mean/max point->grid transfers
  (replaces torch_scatter ``scatter_mean`` / ``scatter_max``; reference
  pointnet.py:5,95,109 and alto.py:8,85,194)
- :mod:`sampling` — bilinear/nearest plane sampling at point coordinates
  (replaces ``F.grid_sample(..., padding_mode='border', align_corners=True)``;
  reference alto.py:90-95,199-205)
- :mod:`resize`   — bilinear resize with ``align_corners=True`` semantics
  (replaces ``F.interpolate``; reference decoder/pixel.py:105-111)

All ops take an explicit validity mask for the padded (bucketed) point dimension,
the static-shape stand-in for the reference's ragged point counts (SURVEY.md §7.2).
"""

from tomosar2height_jax.ops.scatter import (  # noqa: F401
    cell_index,
    segment_mean,
    segment_max,
    scatter_mean_to_plane,
    pool_local_max,
    pool_local_mean,
)
from tomosar2height_jax.ops.sampling import grid_sample_2d  # noqa: F401
from tomosar2height_jax.ops.resize import resize_bilinear  # noqa: F401

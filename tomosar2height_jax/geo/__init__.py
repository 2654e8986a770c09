"""Host-side geospatial core: raster model, GeoTIFF codec, point-cloud I/O,
coordinate transforms. All geo-coordinate arithmetic is float64 numpy on the host;
only normalized float32 data is shipped to the device.

Mirrors the capability surface of the reference's ``utils/`` package
(utils/io_raster.py, utils/io_cloud.py, utils/coordinate.py, utils/crop_cloud.py,
utils/dilate_mask.py) without GDAL/rasterio/laspy/open3d dependencies.
"""

from tomosar2height_jax.geo.transform import (  # noqa: F401
    Affine,
    apply_transform,
    invert_transform,
    stack_transforms,
    coordinate2index,
    make_3d_grid,
    normalize_pc,
    invert_normalize_pc,
    rotation_matrix_z,
    reflection_matrix,
    ROT_MATRICES,
    FLIP_MATRICES,
)
from tomosar2height_jax.geo.crop import (  # noqa: F401
    GridIndex2D,
    crop_pc_2d,
    crop_pc_2d_index,
    crop_pc_3d,
)
from tomosar2height_jax.geo.mask import dilate_mask  # noqa: F401
from tomosar2height_jax.geo.raster import RasterData, RasterReader, RasterWriter  # noqa: F401
from tomosar2height_jax.geo.cloud import load_pc, load_las_as_numpy, save_pc_to_ply, load_ply  # noqa: F401

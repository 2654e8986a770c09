"""TomoSAR2Height in JAX: building-height raster (nDSM) reconstruction from
spaceborne TomoSAR point clouds, optionally fused with optical satellite
imagery.

Capability-equivalent rebuild of the reference PyTorch/CUDA implementation
(zhu-xlab/tomosar2height):

- functional, jit-able model core (``models/nn.py``, NHWC layout)
- ragged point clouds handled via bucketed padding + masking (static shapes for XLA)
- point<->grid transfers via masked segment reductions (XLA scatter)
- data parallelism over patches with ``jax.sharding.Mesh`` + ``shard_map`` (psum grads)
- host-side geo I/O in float64 numpy (GeoTIFF codec, LAS parser — no GDAL dependency)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package must not pull in jax (host-only tools use geo/)
    if name == "TomoSAR2Height":
        from tomosar2height_jax.models.model import TomoSAR2Height

        return TomoSAR2Height
    raise AttributeError(name)

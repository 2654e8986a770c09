"""Network components (the ``nn`` module core, NHWC, static shapes, mask-aware).

Registries mirror the reference's ``encoder_dict`` (tomosar2height/encoder/__init__.py:3-8)
and ``decoder_dict`` (tomosar2height/decoder/__init__.py:4-6).
"""

from tomosar2height_jax.models.blocks import ResnetBlockFC  # noqa: F401
from tomosar2height_jax.models.unet import UNet  # noqa: F401
from tomosar2height_jax.models.alto import AltoUNet  # noqa: F401
from tomosar2height_jax.models.pointnet import LocalPoolPointnet  # noqa: F401
from tomosar2height_jax.models.decoder import PixelwiseDecoder, ConvDecoder, FCDecoder  # noqa: F401
from tomosar2height_jax.models.model import TomoSAR2Height, build_model  # noqa: F401


def encoder_dict():
    from tomosar2height_jax.models.pointnet import LocalPoolPointnet
    from tomosar2height_jax.models.pointnetpp import PointNetPlusPlus
    from tomosar2height_jax.models.unet import UNet
    from tomosar2height_jax.models.hourglass import HGFilter

    return {
        "pointnet_local_pool": LocalPoolPointnet,
        "pointnet_plus_plus": PointNetPlusPlus,
        "unet": UNet,
        "hourglass": HGFilter,
    }


def decoder_dict():
    from tomosar2height_jax.models.decoder import PixelwiseDecoder

    return {"pixel": PixelwiseDecoder}

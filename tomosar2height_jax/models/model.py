"""TomoSAR2Height model shell: encoder/decoder assembly + z-rescale.

Parity: reference tomosar2height/model.py:8-86 — config-driven encoder
(point cloud), encoder2 (image), pixel decoder, Xavier init (handled in the
blocks' initializers), and output scaling by the z-bound span (:39-41,67).

Signature: point clouds arrive as a padded (B, N, 3) bucket plus a
(B, N) validity mask (instead of the reference's ragged (1, N, 3) tensor);
images are NHWC. Everything is a pure function of (params, inputs) — jit/pjit
friendly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax.numpy as jnp

from tomosar2height_jax.models import nn
from tomosar2height_jax.models.decoder import PixelwiseDecoder
from tomosar2height_jax.models.unet import UNet


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


class TomoSAR2Height(nn.Module):
    """Flagship dual-topology network.

    Construct via :func:`build_model` (config dict) or directly with kwargs.
    """

    use_cloud: bool = True
    use_image: bool = False
    encoder: str = "pointnet_local_pool"
    encoder_kwargs: Optional[Dict[str, Any]] = None
    encoder2: str = "unet"
    encoder2_kwargs: Optional[Dict[str, Any]] = None
    decoder_kwargs: Optional[Dict[str, Any]] = None
    z_scale: float = 1.0
    # rematerialize encoder activations in the backward pass (jax.checkpoint):
    # trades ~1 extra encoder forward for the dominant activation memory
    remat: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_cloud: Optional[jnp.ndarray] = None,
        cloud_mask: Optional[jnp.ndarray] = None,
        input_image: Optional[jnp.ndarray] = None,
        cloud_cells: Optional[jnp.ndarray] = None,
        cloud_offsets: Optional[jnp.ndarray] = None,
    ):
        """Forward pass.

        Args:
            input_cloud: (B, N, 3) padded normalized points (or None).
            cloud_mask: (B, N) point validity (or None = all valid).
            input_image: (B, H, W, 3) normalized image (or None).
            cloud_cells / cloud_offsets: optional Morton-sorted bucket metadata
                (points must then be cell-sorted) enabling the scatter-free
                point->grid path; produced by the PatchLoader.

        Returns:
            (pa, pb): (B, S, S, out_dim) height raster in meters (z-rescaled,
            reference model.py:67) and footprint logits (or None).
        """
        assert self.use_cloud or self.use_image, "At least one input modality must be used."
        feature_planes: Dict[str, jnp.ndarray] = {}

        if self.use_cloud:
            from tomosar2height_jax.models import encoder_dict

            enc_cls = encoder_dict()[self.encoder]
            if self.remat:
                enc_cls = nn.remat(enc_cls)
            kwargs = dict(self.encoder_kwargs or {})
            enc = enc_cls(dtype=self.dtype, name="point_encoder", **kwargs)
            if self.encoder == "pointnet_local_pool":
                feature_planes.update(enc(input_cloud, cloud_mask, cloud_cells, cloud_offsets))
            else:
                feature_planes.update(enc(input_cloud, cloud_mask))

        if self.use_image:
            kwargs = dict(self.encoder2_kwargs or {})
            kwargs.pop("in_channels", None)  # NHWC: inferred from input
            if self.encoder2 == "unet":
                img_enc = UNet(dtype=self.dtype, name="image_encoder", **kwargs)
            else:
                from tomosar2height_jax.models import encoder_dict

                img_enc = encoder_dict()[self.encoder2](
                    dtype=self.dtype, name="image_encoder", **kwargs
                )
            feature_planes["image"] = img_enc(input_image)

        dec = PixelwiseDecoder(dtype=self.dtype, name="decoder", **dict(self.decoder_kwargs or {}))
        pa, pb = dec(feature_planes)
        # outputs are f32 regardless of the compute dtype: the decoders' final
        # heads run in f32 (decoder.py mixed-precision note) and the z-rescale
        # to meters must not round-trip through bf16
        pa = pa.astype(jnp.float32) * jnp.float32(self.z_scale)
        if pb is not None:
            pb = pb.astype(jnp.float32)
        return pa, pb


def build_model(cfg) -> TomoSAR2Height:
    """Build the network from the global config tree (reference model.py:15-44).

    Reads model.encoder/encoder_kwargs/encoder2/encoder2_kwargs/
    decoder_pixel_kwargs, use_cloud/use_image, dataset.normalize.z_bound.
    """
    cfg_model = cfg["model"]
    z_bound = cfg["dataset"]["normalize"]["z_bound"]
    dtype = jnp.dtype(_get(cfg_model, "dtype", "float32"))
    enc2_kwargs = dict(_get(cfg_model, "encoder2_kwargs", {}) or {})
    # reference UNet image encoder args: num_classes positional (model.py:33)
    return TomoSAR2Height(
        use_cloud=bool(cfg["use_cloud"]),
        use_image=bool(cfg["use_image"]),
        encoder=_get(cfg_model, "encoder", "pointnet_local_pool"),
        encoder_kwargs=dict(_get(cfg_model, "encoder_kwargs", {}) or {}),
        encoder2=_get(cfg_model, "encoder2", "unet"),
        encoder2_kwargs=enc2_kwargs,
        decoder_kwargs=dict(_get(cfg_model, "decoder_pixel_kwargs", {}) or {}),
        z_scale=float(z_bound[1]) - float(z_bound[0]),
        remat=bool(_get(cfg_model, "remat", False)),
        dtype=dtype,
    )

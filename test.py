#!/usr/bin/env python
"""Evaluation entry point. Same CLI surface as the reference (test.py:12-123):

    python test.py dataset=berlin run_suffix=-v1 [test.check_point=path]

Loads the best (or given) checkpoint, generates the full-scene nDSM GeoTIFF over
the test chunks, writes the tabulated metric report and the residual GeoTIFF.
"""

from __future__ import annotations

import logging
import os
import sys

import jax
import numpy as np

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import PatchLoader, TomoSARDataset
from tomosar2height_jax.infer import DSMEvaluator, DSMGenerator, print_statistics
from tomosar2height_jax.models import build_model
from tomosar2height_jax.train import CheckpointIO, DEFAULT_MODEL_FILE
from tomosar2height_jax.utils import enable_compile_cache, lock_seed, setup_logging

log = logging.getLogger("test")


def main(overrides=None):
    cfg = compose(default_conf_dir(), overrides=overrides if overrides is not None else sys.argv[1:])
    cfg_dataset, cfg_training, cfg_test, cfg_dsm = (
        cfg["dataset"], cfg["training"], cfg["test"], cfg["dsm_generation"]
    )
    from tomosar2height_jax.utils.cache import select_platform

    select_platform(cfg.select("device.platform", None))

    out_dir_run = os.path.join(cfg_training["out_dir"],
                               f"{cfg_training['run_name']}{cfg['run_suffix']}")
    out_dir_tiff = os.path.join(out_dir_run, "tiff_test")
    for d in (out_dir_run, out_dir_tiff):
        os.makedirs(d, exist_ok=True)
    setup_logging(os.path.join(out_dir_run, cfg["logging"]["filename"]))

    if cfg_training["lock_seed"]:
        lock_seed(0)
    enable_compile_cache()

    test_dataset = TomoSARDataset("test", cfg_dataset, random_sample=False,
                                  load_target=False,
                                  load_image=cfg["use_image"])
    sort_reso = (cfg.select("model.encoder_kwargs.plane_resolution")
                 if cfg.select("dataset.points.sort", False)
                 and cfg["use_cloud"] and cfg["model"]["encoder"] == "pointnet_local_pool"
                 else None)
    loader = PatchLoader(test_dataset, cfg_training["val_batch_size"],
                         cfg_dataset["points"]["bucket_sizes"],
                         fixed_bucket=cfg_dataset["points"]["train_bucket"],
                         sort_reso=sort_reso,
                         prefetch=cfg.select("dataloader.prefetch", 2),
                         n_workers=cfg.select("dataloader.n_workers", 0))
    log.info("Dataset path: '%s'", cfg_dataset["path"])

    model = build_model(cfg)
    sample = loader.collate([test_dataset[0]])
    init_image = sample.get("image") if cfg["use_image"] else None
    if cfg["use_image"] and init_image is None:
        # device-crop image wire (satellite_image.crop='device'): samples
        # carry origins, not crops — init from the static patch shape
        h, w = (int(v) for v in test_dataset._image_patch_shape)
        c = test_dataset.norm_image_data.shape[0]
        init_image = np.zeros((sample["points"].shape[0], h, w, c), np.float32)
    # jitted: one program instead of one device dispatch per init op
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0),
        sample["points"] if cfg["use_cloud"] else None,
        sample["point_mask"] if cfg["use_cloud"] else None,
        init_image,
    )

    checkpoint_io = CheckpointIO(out_dir_run, model=params)
    checkpoint_path = cfg_test.get("check_point") or os.path.join(
        out_dir_run, "check_points", DEFAULT_MODEL_FILE
    )
    log.info("Loading checkpoint: %s", checkpoint_path)
    try:
        load_dict = checkpoint_io.load(checkpoint_path, resume_scheduler=False)
    except FileNotFoundError:
        log.error("Checkpoint does not exist, cannot proceed with inference.")
        return None
    params = checkpoint_io.module_dict["model"]
    n_iter = int(load_dict.get("n_iter", 0))
    if load_dict.get("loss_val_best") is not None:
        log.info("Best validation metric: %.8f", float(load_dict["loss_val_best"]))

    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    log.info("Total model parameters: %d", n_params)

    # patch-sharded data-parallel inference over all compatible devices
    import math

    from tomosar2height_jax.parallel import make_mesh

    mesh = make_mesh(cfg.select("device.mesh.data", -1))
    g = math.gcd(int(cfg_training["val_batch_size"]), mesh.size)
    if g != mesh.size:
        mesh = make_mesh(g)
    log.info("Devices: %s (mesh %s)", jax.devices(), mesh.shape)

    generator_dsm = DSMGenerator(
        model, lambda: params, loader,
        dsm_pixel_size=cfg_dsm["pixel_size"],
        half_blend_percent=cfg_dsm.get("half_blend_percent"),
        crs_epsg=cfg_dsm.get("crs_epsg"),
        use_cloud=cfg["use_cloud"], use_image=cfg["use_image"],
        mesh=mesh,
    )
    evaluator = DSMEvaluator(cfg_dataset["dsm_gt_path"], None, cfg_dataset["mask_files"])

    output_path = os.path.join(out_dir_tiff, f"{cfg_training['run_name']}_dsm_{n_iter:06d}.tiff")
    writer = generator_dsm.generate_dsm(output_path)
    log.info("nDSM saved to '%s'", output_path)

    stats, diff = evaluator.eval(writer.get_data(), writer.T)
    eval_path = os.path.join(out_dir_tiff, f"{cfg_training['run_name']}_dsm_{n_iter:06d}_eval.txt")
    print_statistics(stats, f"{cfg_training['run_name']}-iter{n_iter}", save_to=eval_path,
                     has_binary=evaluator.has_binary_building,
                     has_ternary=evaluator.has_ternary_building)
    log.info("Evaluation results saved to '%s'", eval_path)

    residual_path = os.path.join(out_dir_tiff, f"{cfg_training['run_name']}_residual_{n_iter:06d}.tiff")
    writer.set_data(diff)
    writer.write_to_file(residual_path)
    log.info("Residual DSM saved to '%s'", residual_path)
    return stats


if __name__ == "__main__":
    main()

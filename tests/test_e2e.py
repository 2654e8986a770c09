"""End-to-end slice (SURVEY.md §7.5): synthetic city -> builder -> train loop
(cloud+image, footprint head) -> checkpoints -> full-scene DSM generation ->
metric report. Runs a tiny model on the CPU mesh."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import build_dataset


def _overrides(root):
    return [
        "dataset=synthetic",
        f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.satellite_image.folder={root}/raster",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"training.out_dir={root}/outputs",
        # tiny patches + model for CPU speed
        "dataset.patch_size=[128,128]",
        # strides must not exceed the (shrunk) patch size or coverage gaps
        # appear as NaN (0/0 blend weight — reference generator.py:156 behavior)
        "dataset.sliding_window.val_strip=[256,256]",
        "dataset.sliding_window.vis_strip=[128,128]",
        "dataset.sliding_window.test_strip=[128,128]",
        "dataset.points.bucket_sizes=[2048]",
        "dataset.points.train_bucket=2048",
        "use_image=true",
        "use_footprint=true",
        "model.encoder_kwargs.plane_resolution=32",
        "model.encoder_kwargs.hidden_dim=8",
        "model.encoder_kwargs.feature_dim=8",
        "model.encoder_kwargs.unet_kwargs.depth=3",
        "model.encoder_kwargs.unet_kwargs.start_filts=8",
        "model.encoder2_kwargs.num_classes=8",
        "model.encoder2_kwargs.depth=3",
        "model.encoder2_kwargs.start_filts=8",
        "model.decoder_pixel_kwargs.hidden_dim=8",
        "model.decoder_pixel_kwargs.output_size=128",
        "training.batch_size=2",
        "training.optimize_every=2",
        "training.max_iteration=2",
        "training.val_batch_size=2",
        "training.random_dataset_length=16",
        "training.validate_every=1",
        "training.checkpoint_every=1",
        "training.visualize_every=2",
        "training.augmentation.flip=true",
        "training.augmentation.rotate=true",
        "dataloader.prefetch=0",
    ]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("e2e"))
    msc.main(root, seed=0, density=0.15)
    ov = _overrides(root)
    cfg = compose(default_conf_dir(), overrides=ov)
    build_dataset(cfg, overwrite=True)

    import train as train_entry

    state, n_iter, best = train_entry.main(ov)
    return root, ov, n_iter, best


class TestEndToEnd:
    def test_train_ran(self, trained):
        root, ov, n_iter, best = trained
        assert n_iter == 2
        assert np.isfinite(best)

    def test_artifacts_on_disk(self, trained):
        root, ov, n_iter, best = trained
        run = f"{root}/outputs/TomoSAR2Height-synthetic"
        assert os.path.exists(f"{run}/check_points/model_1.ckpt")
        assert os.path.exists(f"{run}/check_points/model_best.ckpt")
        assert os.path.exists(f"{run}/wandb/metrics.jsonl")
        tiffs = os.listdir(f"{run}/tiff")
        assert any(t.endswith(".tiff") for t in tiffs)

    def test_generated_dsm_georeferenced(self, trained):
        from tomosar2height_jax.geo import RasterReader

        root, ov, n_iter, best = trained
        run = f"{root}/outputs/TomoSAR2Height-synthetic"
        tiff = sorted(os.listdir(f"{run}/tiff"))[-1]
        r = RasterReader(f"{run}/tiff/{tiff}")
        # vis chunk is chunk 1: x in [640, 1280], y in [5000000, 5000640]
        assert r.shape == (640, 640)
        assert r.T.c == 640.0 and r.T.f == 5000640.0
        data = r.get_data()
        assert np.isfinite(data).all()
        assert (data >= 0).all()  # clamped (reference generator.py:157)

    def test_test_entry_point(self, trained):
        root, ov, n_iter, best = trained
        import test as test_entry

        stats = test_entry.main(ov)
        assert stats is not None
        assert stats["overall"]["RMSE"] is not None
        assert stats["building"]["n_pixel"] > 0
        run = f"{root}/outputs/TomoSAR2Height-synthetic"
        files = os.listdir(f"{run}/tiff_test")
        assert any("eval.txt" in f for f in files)
        assert any("residual" in f for f in files)

    def test_resume_from_checkpoint(self, trained):
        root, ov, n_iter, best = trained
        import train as train_entry

        run = f"{root}/outputs/TomoSAR2Height-synthetic"
        ov2 = ov + [
            f"training.resume_from={run}/check_points/model_best.ckpt",
            "training.max_iteration=3",
        ]
        state, n_iter2, best2 = train_entry.main(ov2)
        assert n_iter2 == 3

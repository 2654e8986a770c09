"""Bit-consistent kill-and-resume.

With ``training.lock_seed`` the train loader runs det_stream: every batch is a
pure function of (seed, epoch, batch index) and checkpoints record the stream
position. A run killed at iteration k and resumed therefore consumes the EXACT
patch stream an uninterrupted run would — final params must match bitwise.
(The torch reference restarts its DataLoader stream from scratch on resume,
reference train.py:129-137, so this is a strengthening, not a port.)
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import build_dataset


def _overrides(root, out_dir, max_iteration):
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
        f"training.out_dir={out_dir}",
        "dataset.patch_size=[128,128]",
        "dataset.sliding_window.val_strip=[256,256]",
        "dataset.sliding_window.vis_strip=[128,128]",
        "dataset.points.bucket_sizes=[2048]",
        "dataset.points.train_bucket=2048",
        "use_image=false",
        "use_footprint=false",
        "model.encoder_kwargs.plane_resolution=32",
        "model.encoder_kwargs.hidden_dim=8",
        "model.encoder_kwargs.feature_dim=8",
        "model.encoder_kwargs.unet_kwargs.depth=3",
        "model.encoder_kwargs.unet_kwargs.start_filts=8",
        "model.decoder_pixel_kwargs.hidden_dim=8",
        "model.decoder_pixel_kwargs.output_size=128",
        "training.batch_size=2",
        "training.optimize_every=2",
        f"training.max_iteration={max_iteration}",
        "training.val_batch_size=2",
        # 4 batches/epoch at batch 2 -> 2 optimizer steps per epoch: 3
        # iterations cross an epoch boundary, resume-at-1 restarts mid-epoch
        "training.random_dataset_length=8",
        "training.validate_every=100",
        "training.checkpoint_every=1",
        "training.visualize_every=100",
        "training.augmentation.flip=true",
        "training.augmentation.rotate=true",
        # prefetch + worker threads on: determinism must not depend on
        # single-threaded fetch order
        "dataloader.prefetch=2",
        "dataloader.n_workers=2",
    ]


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = str(tmp_path_factory.mktemp("resume"))
    msc.main(root, seed=0, density=0.15)
    cfg = compose(default_conf_dir(),
                  overrides=_overrides(root, f"{root}/outputs_a", 3))
    build_dataset(cfg, overwrite=True)
    return root


def _leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


class TestResumeBitexact:
    def test_kill_and_resume_matches_straight_run(self, city):
        import train as train_entry

        root = city
        # straight run: 3 optimizer steps
        state_a, n_a, _ = train_entry.main(_overrides(root, f"{root}/outputs_a", 3))
        assert n_a == 3

        # killed run: stop after 1 step (mid-epoch), resume to 3
        ov_b = _overrides(root, f"{root}/outputs_b", 1)
        _, n_b1, _ = train_entry.main(ov_b)
        assert n_b1 == 1
        ckpt = f"{root}/outputs_b/TomoSAR2Height-synthetic/check_points/model_1.ckpt"
        assert os.path.exists(ckpt)
        ov_b2 = _overrides(root, f"{root}/outputs_b", 3) + [
            f"training.resume_from={ckpt}"]
        state_b, n_b2, _ = train_entry.main(ov_b2)
        assert n_b2 == 3

        for a, b in zip(_leaves(state_a.params), _leaves(state_b.params)):
            np.testing.assert_array_equal(a, b)

    def test_resume_at_epoch_boundary(self, city):
        import train as train_entry

        root = city
        # 2 optimizer steps = exactly one epoch of the 8-patch stream
        ov_c = _overrides(root, f"{root}/outputs_c", 2)
        _, n_c, _ = train_entry.main(ov_c)
        assert n_c == 2
        ckpt = f"{root}/outputs_c/TomoSAR2Height-synthetic/check_points/model_2.ckpt"
        ov_c2 = _overrides(root, f"{root}/outputs_c", 3) + [
            f"training.resume_from={ckpt}"]
        state_c, n_c2, _ = train_entry.main(ov_c2)
        assert n_c2 == 3

        state_a, _, _ = train_entry.main(
            _overrides(root, f"{root}/outputs_a2", 3))
        for a, c in zip(_leaves(state_a.params), _leaves(state_c.params)):
            np.testing.assert_array_equal(a, c)

    def test_stream_pos_in_checkpoint(self, city):
        from tomosar2height_jax.train.checkpoint import CheckpointIO

        root = city
        ckpt = f"{root}/outputs_b/TomoSAR2Height-synthetic/check_points/model_1.ckpt"
        io = CheckpointIO(os.path.dirname(ckpt))
        scalars = io.load(ckpt)
        assert scalars["stream_pos"] is not None
        epoch, batch = scalars["stream_pos"]
        assert epoch >= 1 and batch >= 1

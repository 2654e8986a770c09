"""Config composition tests (parity with the reference Hydra surface)."""

import pytest

from tomosar2height_jax.config import compose, parse_cli_overrides
from tomosar2height_jax.config.compose import default_conf_dir


class TestCompose:
    def test_default_tree(self):
        cfg = compose(default_conf_dir())
        # root defaults select munich (reference conf/config.yaml:7)
        assert cfg.dataset.name == "munich"
        assert cfg.use_cloud is True and cfg.use_image is False
        # munich overrides alto depth to 6 (reference conf/dataset/munich.yaml:6-11)
        assert cfg.model.encoder_kwargs.unet_kwargs.depth == 6
        assert cfg.use_footprint is True
        # interpolation: ${use_footprint} and ${gt_dsm}
        assert cfg.model.decoder_pixel_kwargs.use_footprint is True
        assert cfg.dataset.dsm_gt_path == cfg.gt_dsm

    def test_group_switch(self):
        cfg = compose(default_conf_dir(), overrides=["dataset=berlin"])
        assert cfg.dataset.name == "berlin"
        assert cfg.use_footprint is False
        assert cfg.model.encoder_kwargs.unet_kwargs.depth == 5
        assert cfg.dsm_generation.crs_epsg == 25833

    def test_value_overrides(self):
        cfg = compose(
            default_conf_dir(),
            overrides=["use_image=true", "training.max_iteration=7",
                       "training.scheduler.kwargs.max_lr=0.001", "run_suffix=-x"],
        )
        assert cfg.use_image is True
        assert cfg.training.max_iteration == 7
        assert cfg.training.scheduler.kwargs.max_lr == 0.001
        assert cfg.run_suffix == "-x"

    def test_override_beats_group_value(self):
        cfg = compose(default_conf_dir(),
                      overrides=["dataset=berlin", "use_footprint=true"])
        assert cfg.use_footprint is True
        # interpolation resolves against the overridden value
        assert cfg.model.decoder_pixel_kwargs.use_footprint is True

    def test_synthetic_dataset(self):
        cfg = compose(default_conf_dir(), overrides=["dataset=synthetic"])
        assert cfg.dataset.points.train_bucket == 4096
        assert cfg.training.max_iteration == 4

    def test_select_and_to_dict(self):
        cfg = compose(default_conf_dir())
        assert cfg.select("training.scheduler.type") == "CyclicLR"
        assert cfg.select("nope.nope", 42) == 42
        d = cfg.to_dict()
        assert isinstance(d, dict) and d["model"]["name"] == "tomosar2height"

    def test_parse_cli(self):
        ov = parse_cli_overrides(["a.b=1", "c=true", "d=[1,2]", "e=text"])
        assert ov == {"a.b": 1, "c": True, "d": [1, 2], "e": "text"}
        with pytest.raises(ValueError):
            parse_cli_overrides(["badtoken"])

"""Regression tests pinning the round-2 performance rewrites to their
reference semantics: quad-packed grid_sample, count-cached segment_mean,
the concat-free dense-skip decoder head, and the generator's deep pipeline.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


class TestQuadGridSample:
    def test_exact_edges_match_four_gather_form(self):
        """Coords at/beyond the borders: the rolled (wrapped) corners must
        contribute exactly zero weight."""
        from tomosar2height_jax.ops.sampling import grid_sample_2d

        rng = np.random.default_rng(0)
        plane = jnp.asarray(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
        coords = jnp.asarray(np.array([
            [1.0, 1.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0],
            [1.2, 0.5], [-0.3, 0.5], [0.5, 1.0], [0.999999, 0.5],
        ], dtype=np.float32)[None])

        got = grid_sample_2d(plane, coords)

        # reference four-gather form (clamped corner indices)
        b, h, w, c = plane.shape
        x = np.clip(np.asarray(coords)[..., 0] * (w - 1), 0, w - 1)
        y = np.clip(np.asarray(coords)[..., 1] * (h - 1), 0, h - 1)
        x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
        y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        p = np.asarray(plane)
        v = lambda yy, xx: p[0, yy[0], xx[0]]
        want = ((v(y0, x0) * (1 - fx[0]) + v(y0, x1) * fx[0]) * (1 - fy[0])
                + (v(y1, x0) * (1 - fx[0]) + v(y1, x1) * fx[0]) * fy[0])
        np.testing.assert_allclose(np.asarray(got)[0], want, rtol=1e-6, atol=1e-6)


class TestCountCachedSegmentMean:
    def test_precomputed_counts_identical(self):
        from tomosar2height_jax.ops.scatter import segment_counts, segment_mean

        rng = np.random.default_rng(1)
        vals = jnp.asarray(rng.normal(size=(2, 500, 8)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, 64, (2, 500)).astype(np.int32))
        mask = jnp.asarray(rng.random((2, 500)) > 0.2)
        counts = segment_counts(idx, 64, mask)
        a = segment_mean(vals, idx, 64, mask)
        b = segment_mean(vals, idx, 64, mask, counts=counts)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestConcatFreeDecoderHead:
    def test_conv1x1split_equals_conv_on_concat(self):
        from tomosar2height_jax.models.decoder import Conv1x1Split

        rng = np.random.default_rng(2)
        parts = [jnp.asarray(rng.normal(size=(1, 6, 6, c)).astype(np.float32))
                 for c in (4, 8, 16, 8)]
        mod = Conv1x1Split(3)
        params = mod.init(jax.random.PRNGKey(0), parts)
        got = mod.apply(params, parts)

        cat = jnp.concatenate(parts, axis=-1)
        kernel = params["params"]["kernel"]
        bias = params["params"]["bias"]
        want = jax.lax.conv_general_dilated(
            cat, kernel, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


class TestGeneratorPipelineDepth:
    def test_depths_give_identical_rasters(self, tmp_path):
        """pipeline_depth only changes scheduling, never the stitched DSM."""
        import sys

        sys.path.insert(0, "scripts")
        import make_synthetic_city as msc

        from tomosar2height_jax.config import compose
        from tomosar2height_jax.config.compose import default_conf_dir
        from tomosar2height_jax.data import PatchLoader, TomoSARDataset, build_dataset
        from tomosar2height_jax.geo import RasterReader
        from tomosar2height_jax.infer import DSMGenerator
        from tomosar2height_jax.models import build_model

        root = str(tmp_path)
        msc.main(root, seed=0, density=0.05)
        ov = [
            "dataset=synthetic", f"dataset.path={root}/generated",
            f"gt_dsm={root}/raster/ndsm.tif",
            f"input_pointcloud_folder={root}/cloud",
            f"output.output_folder={root}/generated",
            f"mask_files.building={root}/raster/footprint.tif",
            f"dataset.mask_files.building={root}/raster/footprint.tif",
            f"dataset.mask_files.type={root}/raster/building_class.tif",
            f"dataset.satellite_image.folder={root}/raster",
            "dataset.patch_size=[128,128]",
            "dataset.sliding_window.vis_strip=[128,128]",
            "dataset.points.bucket_sizes=[2048]",
            "dataset.points.train_bucket=2048",
            "use_cloud=true", "use_image=false", "use_footprint=false",
            "model.encoder_kwargs.plane_resolution=32",
            "model.encoder_kwargs.hidden_dim=8",
            "model.encoder_kwargs.feature_dim=8",
            "model.encoder_kwargs.unet_kwargs.depth=3",
            "model.encoder_kwargs.unet_kwargs.start_filts=8",
            "model.decoder_pixel_kwargs.hidden_dim=8",
            "model.decoder_pixel_kwargs.output_size=128",
        ]
        cfg = compose(default_conf_dir(), overrides=ov)
        build_dataset(cfg, overwrite=True)
        dataset = TomoSARDataset("vis", cfg["dataset"], random_sample=False)
        model = build_model(cfg)
        loader = PatchLoader(dataset, 2, [2048], fixed_bucket=2048)
        sample = loader.collate([dataset[0]])
        params = model.init(jax.random.PRNGKey(0), sample["points"],
                            sample["point_mask"], None)
        outs = []
        for depth in (1, 3):
            gen = DSMGenerator(model, lambda: params, loader,
                               dsm_pixel_size=cfg["dsm_generation"]["pixel_size"],
                               crs_epsg=25832, use_cloud=True, use_image=False,
                               pipeline_depth=depth)
            path = f"{root}/dsm_d{depth}.tiff"
            gen.generate_dsm(path)
            outs.append(RasterReader(path).get_data())
        np.testing.assert_array_equal(outs[0], outs[1])

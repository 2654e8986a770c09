"""Multi-chip (data-parallel) inference: patch-sharded DSM generation must
reproduce the single-device raster exactly (SURVEY.md §2.3(b)).

Runs on the virtual 8-device CPU mesh from conftest.py.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import jax

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import PatchLoader, TomoSARDataset, build_dataset
from tomosar2height_jax.infer import DSMGenerator
from tomosar2height_jax.models import TomoSAR2Height
from tomosar2height_jax.parallel import make_mesh


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    import make_synthetic_city as msc

    root = tmp_path_factory.mktemp("shard_city")
    msc.main(str(root), seed=0, density=0.15)
    cfg = compose(default_conf_dir(), overrides=[
        "dataset=synthetic",
        f"gt_dsm={root}/raster/ndsm.tif",
        f"mask_files.building={root}/raster/footprint.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"output.output_folder={root}/generated",
        f"dataset.path={root}/generated",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"dataset.satellite_image.folder={root}/raster",
        "dataset.patch_size=[128,128]",
        "dataset.sliding_window.vis_strip=[64,64]",
        "dataset.points.bucket_sizes=[2048]",
        "dataset.points.train_bucket=2048",
    ])
    build_dataset(cfg, overwrite=True)
    return cfg, root


def _tiny_model():
    return TomoSAR2Height(
        use_cloud=True,
        encoder_kwargs={
            "feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
            "unet_type": "alto",
            "unet_kwargs": {"depth": 3, "start_filts": 8, "merge_mode": "concat"},
        },
        decoder_kwargs={"hidden_dim": 8, "output_size": 128},
        z_scale=60.0,
    )


def _fusion_model():
    """Tiny cloud+image model (the paper's headline fusion config shrunk)."""
    return TomoSAR2Height(
        use_cloud=True, use_image=True,
        encoder_kwargs={
            "feature_dim": 8, "hidden_dim": 8, "plane_resolution": 32,
            "unet_type": "alto",
            "unet_kwargs": {"depth": 3, "start_filts": 8,
                            "merge_mode": "concat"},
        },
        encoder2_kwargs={"num_classes": 8, "in_channels": 3, "depth": 2,
                         "start_filts": 8},
        decoder_kwargs={"hidden_dim": 8, "output_size": 128},
        z_scale=60.0,
    )


def _generate(cfg, tmp_path, mesh, tag, device_blend=False,
              wire_dtype="float32", blend_loop="unroll"):
    ds = TomoSARDataset("vis", cfg["dataset"])
    loader = PatchLoader(ds, batch_size=8,
                         bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"],
                         fixed_bucket=cfg["dataset"]["points"]["train_bucket"])
    model = _tiny_model()
    sample = loader.collate([ds[0]])
    params = model.init(jax.random.PRNGKey(0), sample["points"],
                        sample["point_mask"], None)
    gen = DSMGenerator(model, lambda: params, loader,
                       dsm_pixel_size=[1.0, 1.0], half_blend_percent=[0.5, 0.5],
                       use_cloud=True, use_image=False, mesh=mesh,
                       device_blend=device_blend, wire_dtype=wire_dtype,
                       blend_loop=blend_loop)
    out = str(tmp_path / f"dsm_{tag}.tiff")
    writer = gen.generate_dsm(out)
    return writer.get_data()


class TestShardedInference:
    def test_eight_device_matches_single(self, city, tmp_path):
        cfg, root = city
        assert len(jax.devices()) >= 8
        single = _generate(cfg, tmp_path, make_mesh(1), "single")
        sharded = _generate(cfg, tmp_path, make_mesh(8), "sharded")
        assert single.shape == sharded.shape
        assert np.isfinite(single).all()
        np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-5)

    def test_none_mesh_still_works(self, city, tmp_path):
        cfg, root = city
        data = _generate(cfg, tmp_path, None, "nomesh")
        assert np.isfinite(data).all()

    def test_device_blend_matches_host(self, city, tmp_path):
        """On-device f32 blend accumulation (the serving fast path) matches
        the host f64 parity path within f32 tolerance."""
        cfg, root = city
        host = _generate(cfg, tmp_path, None, "hostblend")
        dev = _generate(cfg, tmp_path, None, "devblend", device_blend=True)
        assert host.shape == dev.shape
        np.testing.assert_allclose(dev, host, atol=2e-3, rtol=1e-4)

    def test_device_blend_scan_matches_unroll(self, city, tmp_path):
        """blend_loop='scan' (one lax.scan body, program size constant in
        batch) must reproduce the unrolled RMW chain bit-for-bit — identical
        sequential f32 arithmetic, just rolled."""
        cfg, root = city
        unroll = _generate(cfg, tmp_path, None, "blendunroll",
                           device_blend=True)
        scan = _generate(cfg, tmp_path, None, "blendscan",
                         device_blend=True, blend_loop="scan")
        np.testing.assert_array_equal(scan, unroll)

    def test_device_blend_f16_wire(self, city, tmp_path):
        """The f16 wire format (bench serving default) quantizes the
        stitched raster by <= 2^-11 relative — a few cm at building
        heights, far below the model's accuracy floor."""
        cfg, root = city
        host = _generate(cfg, tmp_path, None, "hostblend2")
        dev = _generate(cfg, tmp_path, None, "devblend16", device_blend=True,
                        wire_dtype="float16")
        scale = max(1.0, float(np.nanmax(np.abs(host))))
        np.testing.assert_allclose(dev, host, atol=2e-3 + scale * 2 ** -10,
                                   rtol=0)

    def test_device_blend_sharded_matches_host(self, city, tmp_path):
        """Multi-chip device blend: 8 devices each accumulate a partial scene
        raster for their patch shard (shard_map over 'data'); the finalize
        program folds the partials in ONE cross-device reduction. Must match
        the host f64 parity path within f32 accumulation tolerance."""
        cfg, root = city
        host = _generate(cfg, tmp_path, None, "hostblend3")
        dev = _generate(cfg, tmp_path, make_mesh(8), "devblend8",
                        device_blend=True)
        assert host.shape == dev.shape
        np.testing.assert_allclose(dev, host, atol=2e-3, rtol=1e-4)

    def test_uint8_image_wire_matches_f32(self, city, tmp_path):
        """satellite_image.wire=uint8 through DSMGenerator: raw u8 crops ship
        over the wire, (x-mean)/std runs inside the jitted forward, and the
        stitched raster matches the f32-wire raster (integral u8 source)."""
        import copy

        cfg, root = city
        model = _fusion_model()

        def generate(dcfg, tag, params=None):
            ds = TomoSARDataset("vis", dcfg)
            loader = PatchLoader(ds, batch_size=8, bucket_sizes=[2048],
                                 fixed_bucket=2048)
            sample = loader.collate([ds[0]])
            if params is None:
                img = sample["image"]
                if img.dtype == np.uint8:  # init wants the model-dtype input
                    mean, std = ds.image_norm
                    img = (img.astype(np.float32) - mean) / std
                params = model.init(jax.random.PRNGKey(0), sample["points"],
                                    sample["point_mask"], img)
            gen = DSMGenerator(model, lambda: params, loader,
                               dsm_pixel_size=[1.0, 1.0],
                               half_blend_percent=[0.5, 0.5],
                               use_cloud=True, use_image=True, mesh=None)
            out = str(tmp_path / f"dsm_{tag}.tiff")
            return gen.generate_dsm(out).get_data(), params

        f32_raster, params = generate(cfg["dataset"], "imgf32")
        d8 = copy.deepcopy(dict(cfg["dataset"]))
        d8["satellite_image"]["wire"] = "uint8"
        u8_raster, _ = generate(d8, "imgu8", params)
        assert f32_raster.shape == u8_raster.shape
        np.testing.assert_allclose(u8_raster, f32_raster, atol=1e-4, rtol=0)

    def test_device_crop_image_matches_host(self, city, tmp_path):
        """satellite_image.crop='device': the scene image uploads once and
        each tile's crop is a dynamic_slice inside the jitted forward — the
        stitched raster must equal the host-crop raster EXACTLY (the slice +
        row flip reads the same bytes the host crop ships). Covers f32 wire,
        uint8 wire (device normalize), and the sharded device-blend path."""
        import copy

        cfg, root = city
        model = _fusion_model()
        params = None

        def generate(dcfg, tag, mesh=None, device_blend=False):
            nonlocal params
            ds = TomoSARDataset("vis", dcfg, load_target=False)
            loader = PatchLoader(ds, batch_size=8, bucket_sizes=[2048],
                                 fixed_bucket=2048)
            sample = loader.collate([ds[0]])
            if params is None:
                assert "image" in sample  # host-crop reference goes first
                params = model.init(jax.random.PRNGKey(0), sample["points"],
                                    sample["point_mask"], sample["image"])
            gen = DSMGenerator(model, lambda: params, loader,
                               dsm_pixel_size=[1.0, 1.0],
                               half_blend_percent=[0.5, 0.5],
                               use_cloud=True, use_image=True, mesh=mesh,
                               device_blend=device_blend)
            if "crop" in dcfg["satellite_image"] and \
                    dcfg["satellite_image"]["crop"] == "device":
                assert gen._device_image
                assert "image" not in sample and "image_origin" in sample
            out = str(tmp_path / f"dsm_{tag}.tiff")
            return gen.generate_dsm(out).get_data()

        host_raster = generate(cfg["dataset"], "crop_host")
        ddev = copy.deepcopy(dict(cfg["dataset"]))
        ddev["satellite_image"]["crop"] = "device"
        np.testing.assert_array_equal(generate(ddev, "crop_dev"), host_raster)
        # uint8 wire + device crop: u8 scene resident, normalize on device
        d8 = copy.deepcopy(ddev)
        d8["satellite_image"]["wire"] = "uint8"
        np.testing.assert_allclose(generate(d8, "crop_dev_u8"), host_raster,
                                   atol=1e-4, rtol=0)
        # 8-chip device blend: scene replicates, origins shard over 'data'
        sharded = generate(ddev, "crop_dev_shard", mesh=make_mesh(8),
                           device_blend=True)
        np.testing.assert_allclose(sharded, host_raster, atol=2e-3, rtol=1e-4)

    def test_fusion_sharded_matches_single(self, city, tmp_path):
        """Cloud+image fusion under the 8-device mesh:
        sharded u8 image crops — host blend AND device blend — must
        reproduce the single-device f32-wire host-blend raster. Pins the
        paper's headline config's multi-device correctness (the other
        sharded tests run use_image=False; the image-wire tests run
        mesh=None)."""
        import copy

        cfg, root = city
        model = _fusion_model()
        params = None

        def generate(dcfg, tag, mesh=None, device_blend=False):
            nonlocal params
            ds = TomoSARDataset("vis", dcfg)
            loader = PatchLoader(ds, batch_size=8, bucket_sizes=[2048],
                                 fixed_bucket=2048)
            sample = loader.collate([ds[0]])
            if params is None:
                assert sample["image"].dtype != np.uint8  # f32 leg first
                params = model.init(jax.random.PRNGKey(0), sample["points"],
                                    sample["point_mask"], sample["image"])
            gen = DSMGenerator(model, lambda: params, loader,
                               dsm_pixel_size=[1.0, 1.0],
                               half_blend_percent=[0.5, 0.5],
                               use_cloud=True, use_image=True, mesh=mesh,
                               device_blend=device_blend)
            out = str(tmp_path / f"dsm_{tag}.tiff")
            return gen.generate_dsm(out).get_data()

        single = generate(cfg["dataset"], "fus_single")
        assert np.isfinite(single).all()
        d8 = copy.deepcopy(dict(cfg["dataset"]))
        d8["satellite_image"]["wire"] = "uint8"
        sharded = generate(d8, "fus_shard8", mesh=make_mesh(8))
        np.testing.assert_allclose(sharded, single, atol=1e-4, rtol=0)
        shard_db = generate(d8, "fus_shard8_db", mesh=make_mesh(8),
                            device_blend=True)
        np.testing.assert_allclose(shard_db, single, atol=2e-3, rtol=1e-4)

    def test_device_crop_gating(self, city):
        """crop='device' must NOT activate for trainer-feeding datasets:
        augmented/random splits and load_target=True keep host crops so the
        trainer's batch contract is unchanged."""
        import copy

        cfg, root = city
        ddev = copy.deepcopy(dict(cfg["dataset"]))
        ddev["satellite_image"]["crop"] = "device"
        train_ds = TomoSARDataset("train", ddev, random_sample=True,
                                  random_length=4, flip_augm=True,
                                  rotate_augm=True)
        assert not train_ds.image_crop_device
        assert "image" in train_ds[0] and "image_origin" not in train_ds[0]
        val_ds = TomoSARDataset("val", ddev)  # load_target=True
        assert not val_ds.image_crop_device
        assert "image" in val_ds[0]

    def test_batch_divisibility_asserted(self, city, tmp_path):
        cfg, root = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        loader = PatchLoader(ds, batch_size=3,
                             bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"])
        model = _tiny_model()
        with pytest.raises(AssertionError):
            DSMGenerator(model, lambda: None, loader, dsm_pixel_size=[1.0, 1.0],
                         use_cloud=True, use_image=False, mesh=make_mesh(8))


class TestBandPlan:
    def test_last_touch_consistent_with_actual_origins(self, city, tmp_path):
        """The banded-early-fetch plan's invariant: no batch AFTER a band's
        last-touch index writes rows into that band (otherwise a band would
        be fetched before its content is final)."""
        from tomosar2height_jax.geo.raster import RasterData

        cfg, root = city
        ds = TomoSARDataset("vis", cfg["dataset"])
        loader = PatchLoader(ds, batch_size=4,
                             bucket_sizes=cfg["dataset"]["points"]["bucket_sizes"],
                             fixed_bucket=cfg["dataset"]["points"]["train_bucket"])
        model = _tiny_model()
        sample = loader.collate([ds[0]])
        params = model.init(jax.random.PRNGKey(0), sample["points"],
                            sample["point_mask"], None)
        gen = DSMGenerator(model, lambda: params, loader,
                           dsm_pixel_size=[1.0, 1.0],
                           half_blend_percent=[0.5, 0.5],
                           use_cloud=True, use_image=False, mesh=None,
                           device_blend=True)
        tiff_data = RasterData()
        tiff_data.set_transform(
            bl_bound=[gen.l_bound, gen.b_bound],
            tr_bound=[gen.r_bound, gen.t_bound],
            pixel_size=gen.pixel_size, crs_epsg=gen.crs_epsg)
        plan = gen._band_plan(tiff_data)
        assert plan is not None, "sliding-window sampler must be plannable"
        bands, last = plan
        H = int(gen.dsm_shape[0])
        ph = int(gen.patch_weight.shape[0])
        assert bands[0][0] == 0 and bands[-1][1] == H
        # replay the real loader and check actual per-batch row footprints
        for k, batch in enumerate(loader):
            rows0, cols0, valid = gen._patch_origins(tiff_data, batch)
            for i in range(len(valid)):
                if not valid[i]:
                    continue
                r_eff = min(max(int(rows0[i]), 0), max(H - ph, 0))
                for b, (r0, r1) in enumerate(bands):
                    if r_eff < r1 and r_eff + ph > r0:  # patch touches band
                        assert last[b] >= k, (
                            f"band {b} fetched at batch {last[b]} but "
                            f"batch {k} still writes rows {r_eff}..{r_eff+ph}")

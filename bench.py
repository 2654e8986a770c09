#!/usr/bin/env python
"""Benchmark: nDSM serving / training throughput on one GPU (flagship model).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Baseline: the BASELINE.json north star of 10 tiles/s per device for 512m x
512m tiles (512^2 px output, 16k-point bucket) — vs_baseline = value / 10.
Fails unless JAX runs on a GPU. ``--profile DIR`` also traces a few steps and
adds the device time per named scope (point pooling, plane scatter, ALTO
round trips) to the line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time

import numpy as np


def require_gpu() -> dict:
    """The device the numbers are measured on; exits unless it is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on "
                         f"'{jax.default_backend()}'")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def e2e_bench(batch: int = 4, dtype: str = "float32", iters: int = 3,
              sorted_path: bool = False, big: bool = False,
              device_blend: bool = False, image: bool = False,
              wire_u8img: bool = False, device_img: bool = False,
              blend_scan: bool = False) -> dict:
    """End-to-end serving benchmark: loader -> device forwards -> f64 host
    blend -> GeoTIFF write over the synthetic city (reference hot path
    generator.py:130-159). Returns the MEDIAN iteration's phase breakdown
    (best-of overstates steady state) with the best attached for reference.
    ``big`` benches a 12-chunk 3840x1280 m city (~10x the patches) so
    per-call constants amortize like a real scene.
    """
    import os
    import sys

    from tomosar2height_jax.utils import enable_compile_cache

    enable_compile_cache()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import jax

    import make_synthetic_city as msc

    from tomosar2height_jax.config import compose
    from tomosar2height_jax.config.compose import default_conf_dir
    from tomosar2height_jax.data import PatchLoader, TomoSARDataset, build_dataset
    from tomosar2height_jax.infer import DSMGenerator
    from tomosar2height_jax.models import build_model

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, ".bench", "city_big" if big else "city")
    if big:
        width, height = 3840, 1280
        cx = [float(v) for v in range(0, width + 1, 640)]
        cy = [5000000.0 + v for v in range(0, height + 1, 640)]
        n_chunks = (len(cx) - 1) * (len(cy) - 1)
        grid_overrides = [
            f"chunk.chunk_x={cx}".replace(" ", ""),
            f"chunk.chunk_y={cy}".replace(" ", ""),
            f"dataset.vis_chunks={list(range(n_chunks))}".replace(" ", ""),
        ]
    else:
        width = height = None
        grid_overrides = ["dataset.vis_chunks=[0,1]"]
    overrides = [
        "dataset=synthetic",
        f"dataset.path={root}/generated",
        f"gt_dsm={root}/raster/ndsm.tif",
        f"input_pointcloud_folder={root}/cloud",
        f"output.output_folder={root}/generated",
        f"mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.building={root}/raster/footprint.tif",
        f"dataset.mask_files.type={root}/raster/building_class.tif",
        f"dataset.satellite_image.folder={root}/raster",
        "use_cloud=true", f"use_image={'true' if image else 'false'}",
        "use_footprint=false",
        # flagship shapes: 16k bucket, full z range
        "dataset.points.train_bucket=16384",
        "dataset.points.bucket_sizes=[16384]",
        *grid_overrides,
        f"training.val_batch_size={batch}",
        f"model.dtype={dtype}",
    ]
    if wire_u8img:
        # ship raw u8 image crops, normalize on device (4x less upload)
        overrides.append("dataset.satellite_image.wire=uint8")
    if device_img:
        # resident scene image: upload once, crop per tile ON DEVICE — each
        # tile ships a (row0, col0) origin instead of a 0.8-3 MB crop
        overrides.append("dataset.satellite_image.crop=device")
    # ~0.06 pts/m^2 fills the 16k bucket on a 512 m patch without overflow
    kw = dict(width=width, height=height) if big else {}
    # The stamp must cover EVERYTHING that shapes generated/: city-generation
    # params (resolved width/height, incl. the implicit defaults in the
    # non-big case) AND the dataset-build config (chunk grid) — a config
    # change must not silently reuse a stale dataset.
    build_params = {"seed": 0, "density": 0.055,
                    "width": width or msc.W, "height": height or msc.H,
                    "grid": grid_overrides}
    stamp_path = os.path.join(root, "city_params.json")
    stamp = None
    if os.path.exists(stamp_path):
        # an unreadable/corrupt stamp (e.g. a run killed mid-write) is STALE,
        # not fatal — fall through to the rebuild path
        try:
            with open(stamp_path) as f:
                stamp = json.load(f)
        except (json.JSONDecodeError, OSError):
            stamp = None
    if (stamp != build_params
            or not os.path.exists(os.path.join(root, "generated",
                                               "chunk_info.yaml"))):
        # Missing or stale cache (e.g. another script regenerated the city
        # with different params — a 0.6 pts/m^2 city silently overflows the
        # 16k bucket and invalidates every number measured on it).
        if os.path.isdir(root):
            shutil.rmtree(root)
        msc.main(root, seed=0, density=0.055, **kw)
        cfg = compose(default_conf_dir(), overrides=overrides)
        build_dataset(cfg, overwrite=True)
        with open(stamp_path, "w") as f:
            json.dump(build_params, f)
    cfg = compose(default_conf_dir(), overrides=overrides)

    dataset = TomoSARDataset("vis", cfg["dataset"], random_sample=False,
                             load_target=False, load_image=image)
    loader = PatchLoader(dataset, batch, [16384], fixed_bucket=16384,
                         sort_reso=256 if sorted_path else None,
                         prefetch=2, n_workers=4)
    model = build_model(cfg)
    sample = loader.collate([dataset[0]])
    img0 = sample.get("image") if image else None
    if img0 is not None and img0.dtype == np.uint8:  # init wants model dtype
        mean, std = dataset.image_norm
        img0 = (img0.astype(np.float32) - mean) / std
    if image and device_img:  # no crop on the wire: init from shapes alone
        h, w = (int(v) for v in dataset._image_patch_shape)
        img0 = np.zeros((1, h, w, dataset.norm_image_data.shape[0]),
                        np.float32)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), sample["points"], sample["point_mask"], img0,
        sample.get("cell"), sample.get("cell_offsets"))
    gen = DSMGenerator(model, lambda: params, loader,
                       dsm_pixel_size=cfg["dsm_generation"]["pixel_size"],
                       half_blend_percent=cfg["dsm_generation"].get("half_blend_percent"),
                       crs_epsg=cfg["dsm_generation"].get("crs_epsg"),
                       use_cloud=True, use_image=image, mesh=None,
                       device_blend=device_blend,
                       blend_loop="scan" if blend_scan else "unroll",
                       # serving wire format: f16 halves the dominant
                       # stitched-raster download (<= ~5 cm quantization)
                       wire_dtype="float16" if device_blend else "float32")
    out_tiff = os.path.join(root, "bench_dsm.tiff")
    runs = []
    for _ in range(iters + 1):  # +1 warmup/compile iteration
        gen.generate_dsm(out_tiff)
        runs.append(gen.last_stats)
    runs = runs[1:]  # drop compile/warmup
    runs.sort(key=lambda s: s["patches_per_s"])
    median = dict(runs[len(runs) // 2])
    median["best_patches_per_s"] = runs[-1]["patches_per_s"]
    return median


def main(batch: int | None = None, n_points: int = 16384, iters: int = 40, train: bool = False,
         dtype: str = "bfloat16", scan: int = 0, sorted_path: bool = False,
         e2e: bool = False, big: bool = False,
         device_blend: bool = False, image: bool = False,
         wire_u8img: bool = False, device_img: bool = False,
         encoder: str | None = None, blend_scan: bool = False,
         profile: str | None = None):
    device = require_gpu()
    if batch is None:
        batch = 4 if e2e else 8
    if e2e:
        stats = e2e_bench(batch, dtype, sorted_path=sorted_path, big=big,
                          device_blend=device_blend, image=image,
                          wire_u8img=wire_u8img, device_img=device_img,
                          blend_scan=blend_scan)
        print(json.dumps({
            "metric": "ndsm_tiles_per_sec_e2e",
            "value": stats["patches_per_s"],  # MEDIAN of iters
            "unit": "tiles/s",
            "vs_baseline": stats["patches_per_s"] / 10.0,
            "best": stats["best_patches_per_s"],
            "phases": {k: v for k, v in stats.items() if k.endswith("_s")},
            "n_patches": stats["n_patches"],
            "device": device,
        }))
        return
    from tomosar2height_jax.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_model

    from tomosar2height_jax.ops.sorted_scatter import host_morton_bucket

    model = _flagship_model(use_image=image)
    if encoder == "pointnet_plus_plus":
        # flagship-scale PointNet++ SSG: same plane/U-Net stage as the
        # default encoder, SA/FP pyramid per models/pointnetpp.py
        model = model.clone(
            encoder="pointnet_plus_plus",
            encoder_kwargs={"feature_dim": 32, "plane_resolution": 256,
                            "unet_type": "alto",
                            "unet_kwargs": {"depth": 5, "start_filts": 32,
                                            "merge_mode": "concat"}})
    if dtype != "float32":
        model = model.clone(dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(0)
    pts_np = rng.uniform(0.001, 0.999, (batch, n_points, 3)).astype(np.float32)
    mask_np = np.ones((batch, n_points), dtype=bool)
    RESO = 256
    if sorted_path:  # Morton-sorted alternative (kept for A/B)
        cells_np = np.empty((batch, n_points), np.int32)
        offs_np = np.empty((batch, RESO * RESO + 1), np.int32)
        for i in range(batch):
            order, cells_np[i], offs_np[i] = host_morton_bucket(pts_np[i], mask_np[i], RESO)
            pts_np[i] = pts_np[i][order]
        cells = jnp.asarray(cells_np)
        offsets = jnp.asarray(offs_np)
    else:
        cells = offsets = None
    points = jnp.asarray(pts_np)
    mask = jnp.asarray(mask_np)
    # cloud+image fusion: a normalized 512^2 RGB crop per tile (NHWC)
    img = (jnp.asarray(rng.normal(size=(batch, 512, 512, 3)).astype(np.float32))
           if image else None)

    out_px = model.decoder_kwargs["output_size"]
    init_key = jax.random.PRNGKey(0)
    params = jax.jit(model.init)(init_key, points[:1, :256], mask[:1, :256],
                                 img[:1] if image else None)

    if train:
        from tomosar2height_jax.parallel.mesh import make_mesh
        from tomosar2height_jax.train.trainer import Trainer

        # uint8 image wire A/B: ship raw u8 crops (4x less of the dominant
        # --image upload: 24 MB/step at b8 f32) and normalize inside the step
        norm = ((np.full((3,), 128.0, np.float32),
                 np.full((3,), 64.0, np.float32))
                if (image and wire_u8img) else None)
        trainer = Trainer(model, {"optimize_every": 1}, use_cloud=True,
                          use_image=image, mesh=make_mesh(1), donate=True,
                          image_norm=norm)
        batch_d = {
            "points": np.asarray(points), "point_mask": np.asarray(mask),
            "patch_valid": np.ones((batch,), bool),
            "dsm": rng.uniform(0, 30, (batch, out_px, out_px)).astype(np.float32),
        }
        if image:
            if wire_u8img:
                batch_d["image"] = rng.integers(
                    0, 256, (batch, 512, 512, 3)).astype(np.uint8)
            else:
                batch_d["image"] = np.asarray(img)
        if cells is not None:  # sorted-path training A/B
            batch_d["cell"] = np.asarray(cells)
            batch_d["cell_offsets"] = np.asarray(offsets)
        state = trainer.init_state(init_key, batch_d)
        state = trainer.train_step(state, batch_d, 1e-4)  # compile
        jax.block_until_ready(state)

        def window(n, state):
            # steady-state loop: batch k+1's host->device upload overlaps
            # batch k's compute (prepare_batch), metrics fetch lazily — ONE
            # barrier at the end, exactly how the real training loop runs
            nxt = trainer.prepare_batch(batch_d)
            for _ in range(n):
                cur = nxt
                nxt = trainer.prepare_batch(batch_d)
                state = trainer.train_step(state, cur, 1e-4)
            return jax.block_until_ready(state)

        t0 = time.perf_counter()
        state = window(iters, state)
        dt = time.perf_counter() - t0
        tiles_per_sec = batch * iters / dt
        metric = "train_patches_per_sec_per_chip"
        step = trainer._train_step
        step_args = (state, trainer.prepare_batch(batch_d), 1e-4)
        traced = lambda n: window(n, state)  # noqa: E731
    else:
        # Pipelined serving measurement: dispatch all batches asynchronously
        # (the device executes them in order) and block on the last one.
        if scan > 1:
            # K batches per dispatch via lax.map — amortizes per-call
            # dispatch overhead
            bc = lambda x: jnp.broadcast_to(x, (scan,) + x.shape)
            if cells is None:
                @jax.jit
                def fwd(params, sp, sm):
                    def one(a):
                        pa, _ = model.apply(params, a[0], a[1], None)
                        return pa.sum()
                    return jax.lax.map(one, (sp, sm)).sum()

                args = (params, bc(points), bc(mask))
            else:
                @jax.jit
                def fwd(params, sp, sm, sc, so):
                    def one(a):
                        pa, _ = model.apply(params, a[0], a[1], None, a[2], a[3])
                        return pa.sum()
                    return jax.lax.map(one, (sp, sm, sc, so)).sum()

                args = (params, bc(points), bc(mask), bc(cells), bc(offsets))
            per_call_tiles = batch * scan
        else:
            @jax.jit
            def fwd(params, points, mask, img, cells, offsets):
                pa, _ = model.apply(params, points, mask, img, cells, offsets)
                return pa.sum()

            args = (params, points, mask, img, cells, offsets)
            per_call_tiles = batch

        def window(n):
            out = None
            for _ in range(n):
                out = fwd(*args)
            return jax.block_until_ready(out)

        window(2)  # compile + warmup
        t0 = time.perf_counter()
        window(iters)
        dt = time.perf_counter() - t0
        tiles_per_sec = per_call_tiles * iters / dt
        metric = "ndsm_tiles_per_sec_per_chip"
        step, step_args, traced = fwd, args, window

    line = {
        "metric": metric,
        "value": tiles_per_sec,
        "unit": "tiles/s",
        "vs_baseline": tiles_per_sec / 10.0,
        "step_ms": 1000.0 * dt / iters,
        "device": device,
    }
    if profile:
        from tomosar2height_jax.utils.profiling import (
            hlo_op_scopes,
            scope_device_times,
        )

        n_traced = 5
        hlo = step.lower(*step_args).compile().as_text()  # before donation
        with jax.profiler.trace(profile):
            traced(n_traced)
        times = scope_device_times(profile, hlo_op_scopes(hlo, PROFILE_SCOPES))
        total = times.pop("__device_total__")
        line["profile"] = {
            "traced_steps": n_traced,
            "device_ms_per_step": 1000.0 * total / n_traced,
            "share": {k: v / total for k, v in times.items()},
        }
    print(json.dumps(line))


# named scopes whose device time --profile reports (models/pointnet.py,
# models/alto.py); an op belongs to the first scope its op_name contains
PROFILE_SCOPES = ("point_pool", "plane_scatter", "alto_round_trip/gather",
                  "alto_round_trip/mlp", "alto_round_trip/scatter_mean")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="tiles per step (default 8; 4 with --e2e)")
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--train", action="store_true")
    # bf16 is the serving default: the f32 regression heads keep height
    # precision (models/decoder.py)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--scan", type=int, default=0,
                    help="batches per dispatch (serving mode)")
    ap.add_argument("--sorted", action="store_true",
                    help="Morton-sorted scatter-free path (A/B)")
    ap.add_argument("--e2e", action="store_true",
                    help="end-to-end serving bench: loader + device + f64 "
                         "blend + GeoTIFF write on the synthetic city")
    ap.add_argument("--big", action="store_true",
                    help="with --e2e: 12-chunk 3840x1280 m city (steady-state)")
    ap.add_argument("--device-blend", action="store_true",
                    help="with --e2e: accumulate the blend on-device, fetch "
                         "one stitched raster per scene (f32 accumulation)")
    ap.add_argument("--image", action="store_true",
                    help="cloud+image fusion flagship (the paper's headline "
                         "config): adds the depth-6 512^2 image U-Net; "
                         "serving (non-scan) and --train modes")
    ap.add_argument("--wire-u8img", action="store_true",
                    help="with --image (--train or --e2e): ship RGB crops as "
                         "raw uint8 (4x less image upload; lossless for u8 "
                         "sources), normalize on device "
                         "(dataset satellite_image.wire)")
    ap.add_argument("--blend-scan", action="store_true",
                    help="with --e2e --device-blend: roll the per-batch "
                         "blend read-modify-writes into one lax.scan body "
                         "(constant program size in batch) instead of the "
                         "unrolled chain")
    ap.add_argument("--encoder", default=None,
                    choices=["pointnet_local_pool", "pointnet_plus_plus"],
                    help="point encoder for the micro benches (serving/"
                         "--train): 'pointnet_plus_plus' benches the "
                         "registered SSG alternate")
    ap.add_argument("--device-img", action="store_true",
                    help="with --image --e2e: resident scene image — upload "
                         "the whole scene to device memory once and crop per "
                         "tile on device; tiles ship a (row, col) origin "
                         "instead of a 0.8-3 MB crop (dataset "
                         "satellite_image.crop)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="micro benches: trace 5 steps into DIR and report "
                         "the device time per named scope")
    a = ap.parse_args()
    if a.image and a.scan > 1:
        ap.error("--image is not supported with --scan")
    if a.wire_u8img and not (a.image and (a.train or a.e2e)):
        ap.error("--wire-u8img requires --image with --train or --e2e "
                 "(the wire-inclusive image benches)")
    if a.device_img and not (a.image and a.e2e):
        ap.error("--device-img requires --image --e2e (serving only; "
                 "training keeps host crops for augmentation)")
    if a.encoder == "pointnet_plus_plus" and (a.e2e or a.scan > 1):
        ap.error("--encoder pointnet_plus_plus supports the micro benches "
                 "only (no --e2e/--scan)")
    if a.blend_scan and not (a.e2e and a.device_blend):
        ap.error("--blend-scan requires --e2e --device-blend")
    if a.profile and (a.e2e or a.scan > 1):
        ap.error("--profile supports the micro benches only (no --e2e/--scan)")
    main(a.batch, a.points, a.iters, a.train, a.dtype, a.scan, a.sorted,
         a.e2e, a.big, a.device_blend, a.image, a.wire_u8img, a.device_img,
         a.encoder, a.blend_scan, a.profile)

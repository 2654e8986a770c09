#!/usr/bin/env python
"""Real-data parity runbook: one command from raw data to
a baseline comparison table.

Given a city's inputs (LAS point clouds + GT nDSM + footprint/type masks +
optional satellite images, wired through conf/dataset/<city>.yaml), runs:

    builder -> train -> test (full-scene nDSM + raster metrics)
            -> building-instance eval (RMSE-B / MAE-B / MedAE-B)

and prints the instance metrics against the reference's published numbers
(BASELINE.md; reference scripts/evaluator_instance.py:100-128) for the same
city/config. The moment Berlin/Munich data is mounted, parity is:

    python scripts/runbook_real_data.py --dataset berlin \
        input_pointcloud_folder=/data/berlin/las gt_dsm=/data/berlin/ndsm.tif ...

Dry run (no real data needed; exercises the identical chain on a synthetic
city with a small model):

    python scripts/runbook_real_data.py --dry-run --work /tmp/runbook
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

# Reference-published building-instance metrics (BASELINE.md; comments in
# reference scripts/evaluator_instance.py:100-128). Keyed by (dataset, config).
BASELINE_INSTANCE = {
    ("berlin", "cloud"): {"RMSE_B": 6.170, "MAE_B": 3.686, "MedAE_B": 2.318},
    ("berlin", "image"): {"RMSE_B": 6.749, "MAE_B": 4.612, "MedAE_B": 3.241},
    ("berlin", "cloud+image"): {"RMSE_B": 5.353, "MAE_B": 3.544, "MedAE_B": 2.569},
    ("munich", "cloud"): {"RMSE_B": 6.866, "MAE_B": 5.061, "MedAE_B": 3.314},
    ("munich", "image"): {"RMSE_B": 4.830, "MAE_B": 3.462, "MedAE_B": 2.515},
    ("munich", "cloud+image"): {"RMSE_B": 4.615, "MAE_B": 3.313, "MedAE_B": 2.502},
}


def run(dataset: str, overrides: list, dry_run: bool, work: str | None,
        skip_train: bool = False):
    from tomosar2height_jax.config import compose
    from tomosar2height_jax.config.compose import default_conf_dir
    from tomosar2height_jax.data import build_dataset

    ov = [f"dataset={dataset}"] + list(overrides)
    if dry_run:
        import make_synthetic_city as msc

        work = work or "/tmp/tomosar_runbook"
        root = os.path.join(work, "city")
        if not os.path.exists(os.path.join(root, "raster", "ndsm.tif")):
            msc.main(root, seed=0, density=0.15)
        ov = [
            "dataset=synthetic",
            f"gt_dsm={root}/raster/ndsm.tif",
            f"mask_files.building={root}/raster/footprint.tif",
            f"input_pointcloud_folder={root}/cloud",
            f"output.output_folder={root}/generated",
            f"dataset.path={root}/generated",
            f"dataset.satellite_image.folder={root}/raster",
            f"dataset.mask_files.building={root}/raster/footprint.tif",
            f"dataset.mask_files.type={root}/raster/building_class.tif",
            f"training.out_dir={work}/outputs",
            "dataset.patch_size=[128,128]",
            "dataset.sliding_window.val_strip=[256,256]",
            "dataset.sliding_window.vis_strip=[128,128]",
            "dataset.sliding_window.test_strip=[128,128]",
            "dataset.points.bucket_sizes=[2048]",
            "dataset.points.train_bucket=2048",
            "model.encoder_kwargs.plane_resolution=32",
            "model.encoder_kwargs.hidden_dim=8",
            "model.encoder_kwargs.feature_dim=8",
            "model.encoder_kwargs.unet_kwargs.depth=3",
            "model.encoder_kwargs.unet_kwargs.start_filts=8",
            # image U-Net shrunk to match the 8-ch point plane (the decoder
            # SUMS the planes) — only used when use_image=true is passed
            "model.encoder2_kwargs.num_classes=8",
            "model.encoder2_kwargs.depth=3",
            "model.encoder2_kwargs.start_filts=8",
            "model.decoder_pixel_kwargs.hidden_dim=8",
            "model.decoder_pixel_kwargs.output_size=128",
            "training.batch_size=2", "training.optimize_every=2",
            "training.max_iteration=4", "training.val_batch_size=2",
            "training.random_dataset_length=16",
            "training.validate_every=2", "training.checkpoint_every=2",
            "training.visualize_every=4", "dataloader.prefetch=0",
            "device.platform=cpu",
        ] + list(overrides)
        dataset = "synthetic"

    cfg = compose(default_conf_dir(), overrides=ov)
    # honor device.platform BEFORE any step can initialize a backend
    from tomosar2height_jax.utils.cache import select_platform

    select_platform(cfg.select("device.platform", None))
    use_cloud = bool(cfg["use_cloud"])
    use_image = bool(cfg["use_image"])
    config_key = ("cloud+image" if use_cloud and use_image
                  else "cloud" if use_cloud else "image")

    # 1. builder (idempotent unless data changed; reference build_dataset.py)
    print(f"[runbook] building dataset ({dataset}) ...")
    build_dataset(cfg, overwrite=dry_run)

    # 2. train (reference train.py surface)
    if not skip_train:
        print(f"[runbook] training ({cfg['training']['max_iteration']} iterations) ...")
        import train as train_entry

        train_entry.main(ov)

    # 3. test: full-scene nDSM + raster metric report (reference test.py)
    print("[runbook] generating + evaluating full-scene nDSM ...")
    import test as test_entry

    stats = test_entry.main(ov)

    # 4. building-instance metrics on the generated nDSM
    from evaluator_instance import buildingwise_errors_georef

    from tomosar2height_jax.geo import RasterReader

    run_dir = os.path.join(cfg["training"]["out_dir"],
                           f"{cfg['test']['run_name']}{cfg['run_suffix']}")
    tiff_dir = os.path.join(run_dir, "tiff_test")
    preds = sorted(f for f in os.listdir(tiff_dir)
                   if f.endswith(".tiff") and "_dsm_" in f)
    assert preds, f"no predicted nDSM under {tiff_dir}"
    pred = os.path.join(tiff_dir, preds[-1])
    inst = buildingwise_errors_georef(
        RasterReader(pred),
        RasterReader(str(cfg["gt_dsm"])),
        RasterReader(str(cfg["mask_files"]["building"])),
    )

    # 5. the comparison table
    base = BASELINE_INSTANCE.get((dataset, config_key))
    print("\n=== runbook result ===")
    print(f"dataset={dataset} config={config_key} pred={os.path.basename(pred)}")
    if stats:
        ob = stats.get("building", {})
        print(f"raster  building MAE/RMSE/MedAE: "
              f"{ob.get('MAE')} / {ob.get('RMSE')} / {ob.get('MedAE')}")
    rows = []
    for k in ("RMSE_B", "MAE_B", "MedAE_B"):
        ours = float(inst[k])
        ref = base[k] if base else None
        delta = (f"{ours - ref:+.3f}" if ref is not None else "n/a")
        rows.append((k, f"{ours:.3f}",
                     f"{ref:.3f}" if ref is not None else "n/a (no published "
                     "number for this dataset)", delta))
    w = max(len(r[2]) for r in rows)
    print(f"{'metric':<9} {'ours':>8} {'reference':>{w}} {'delta':>8}   "
          f"(#buildings: {inst['n_buildings']})")
    for k, o, r, d in rows:
        print(f"{k:<9} {o:>8} {r:>{w}} {d:>8}")
    result = {"dataset": dataset, "config": config_key,
              "instance": {k: float(inst[k]) for k in
                           ("RMSE_B", "MAE_B", "MedAE_B")},
              "n_buildings": int(inst["n_buildings"]),
              "baseline": base}
    out_json = os.path.join(run_dir, "runbook_result.json")
    with open(out_json, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[runbook] wrote {out_json}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="berlin",
                    help="conf/dataset/<name>.yaml (berlin | munich | ...)")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic-city end-to-end exercise (no real data)")
    ap.add_argument("--work", default=None,
                    help="work dir for --dry-run artifacts")
    ap.add_argument("--skip-train", action="store_true",
                    help="evaluate an existing checkpoint only")
    ap.add_argument("overrides", nargs="*",
                    help="extra config overrides (key=value)")
    a = ap.parse_args()
    run(a.dataset, a.overrides, a.dry_run, a.work, a.skip_train)

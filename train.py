#!/usr/bin/env python
"""Training entry point. Same CLI surface as the reference (train.py:16-196):

    python train.py dataset=berlin use_cloud=true use_image=false run_suffix=-v1

Orchestration parity: output dirs outputs/<run_name><suffix>/{check_points,tiff},
seed locking, train/val/vis loaders, AdamW + scheduler, periodic
print/checkpoint/validate/visualize, best-checkpoint selection on val loss_l1,
resume-from-checkpoint with scalar metadata {n_iter, loss_val_best, training_time}.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import jax
import numpy as np

from tomosar2height_jax.config import compose
from tomosar2height_jax.config.compose import default_conf_dir
from tomosar2height_jax.data import PatchLoader, TomoSARDataset
from tomosar2height_jax.infer import DSMEvaluator, DSMGenerator
from tomosar2height_jax.models import build_model
from tomosar2height_jax.parallel import make_mesh
from tomosar2height_jax.train import CheckpointIO, Trainer, build_scheduler
from tomosar2height_jax.train.schedule import ITERATION_SCHEDULERS
from tomosar2height_jax.train.trainer import TrainState
from tomosar2height_jax.utils import MetricLogger, enable_compile_cache, lock_seed, setup_logging
from tomosar2height_jax.utils.cache import select_platform

log = logging.getLogger("train")


def _memory_metrics(n_iter: int, every: int) -> dict:
    """Device HBM + host RSS at ``print_every`` cadence (empty otherwise).

    Long-run steadiness evidence (leaks would show as monotonic growth in
    the metrics.jsonl trail); backends without memory_stats report host only.
    """
    if every <= 0 or n_iter % every != 0:
        return {}
    out = {}
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            out["misc/hbm_bytes_in_use"] = int(stats["bytes_in_use"])
            if "peak_bytes_in_use" in stats:
                out["misc/hbm_peak_bytes"] = int(stats["peak_bytes_in_use"])
    except Exception:  # backends without memory_stats report host only
        pass
    try:
        with open("/proc/self/statm") as f:
            out["misc/host_rss_bytes"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        pass
    return out


def main(overrides=None):
    cfg = compose(default_conf_dir(), overrides=overrides if overrides is not None else sys.argv[1:])

    cfg_training = cfg["training"]
    cfg_dataset = cfg["dataset"]
    select_platform(cfg.select("device.platform", None))

    # multi-host scale-out: no-op single-process; config-driven
    # explicit clusters via device.distributed.* (SURVEY.md §2.3/§5)
    from tomosar2height_jax.parallel import init_distributed

    init_distributed(
        coordinator_address=cfg.select("device.distributed.coordinator", None),
        num_processes=cfg.select("device.distributed.num_processes", None),
        process_id=cfg.select("device.distributed.process_id", None),
    )

    out_dir_run = os.path.join(cfg_training["out_dir"],
                               f"{cfg_training['run_name']}{cfg['run_suffix']}")
    out_dir_ckpt = os.path.join(out_dir_run, "check_points")
    out_dir_tiff = os.path.join(out_dir_run, "tiff")
    for d in (out_dir_run, out_dir_ckpt, out_dir_tiff):
        os.makedirs(d, exist_ok=True)
    setup_logging(os.path.join(out_dir_run, cfg["logging"]["filename"]),
                  cfg["logging"]["console_level"], cfg["logging"]["file_level"])

    if cfg_training["lock_seed"]:
        lock_seed(0)

    wandb = MetricLogger().init(
        project="tomosar2height", config=cfg.to_dict(),
        name=os.path.basename(out_dir_run), dir=os.path.join(out_dir_run, "wandb"),
        mode="online" if cfg["wandb"] else "disabled",
    )

    t_start = time.time()
    enable_compile_cache()
    mesh = make_mesh(cfg.select("device.mesh.data", -1))
    # batch axes shard over the mesh -> every batch size must divide evenly;
    # shrink the mesh to the largest compatible divisor if not
    import math

    g = math.gcd(math.gcd(int(cfg_training["batch_size"]),
                          int(cfg_training["val_batch_size"])),
                 mesh.size)
    if g != mesh.size:
        log.warning("batch sizes (%d/%d) not divisible by %d devices; using %d-device mesh",
                    cfg_training["batch_size"], cfg_training["val_batch_size"], mesh.size, g)
        mesh = make_mesh(g)
    log.info("Devices: %s (mesh %s)", jax.devices(), mesh.shape)

    # datasets / loaders
    datasets = {
        key: TomoSARDataset(
            key, cfg_dataset, random_sample=(key == "train"),
            random_length=(cfg_training["random_dataset_length"] if key == "train" else None),
            flip_augm=cfg_training["augmentation"]["flip"] if key == "train" else False,
            rotate_augm=cfg_training["augmentation"]["rotate"] if key == "train" else False,
            load_target=(key != "vis"),  # vis feeds DSMGenerator only
            load_image=cfg["use_image"],
        )
        for key in ("train", "val", "vis")
    }
    buckets = cfg_dataset["points"]["bucket_sizes"]
    prefetch = cfg.select("dataloader.prefetch", 2)
    n_workers = cfg.select("dataloader.n_workers", 0)
    # Optional Morton-sorted device path (dataset.points.sort): batches carry
    # per-cell offsets for the scatter-free segment reductions
    sort_reso = (cfg.select("model.encoder_kwargs.plane_resolution")
                 if cfg.select("dataset.points.sort", False)
                 and cfg["use_cloud"] and cfg["model"]["encoder"] == "pointnet_local_pool"
                 else None)
    common = dict(bucket_sizes=buckets, fixed_bucket=cfg_dataset["points"]["train_bucket"],
                  sort_reso=sort_reso, n_workers=n_workers)
    loaders = {
        # det_stream under lock_seed: every train batch is a pure function of
        # (seed, epoch, batch index) and checkpoints record the stream
        # position -> kill-and-resume continues on the exact patch stream
        # (bit-consistent; tests/test_resume_bitexact.py)
        "train": PatchLoader(datasets["train"], cfg_training["batch_size"],
                             shuffle=True, drop_last=True, prefetch=prefetch,
                             det_stream=bool(cfg_training["lock_seed"]), **common),
        "val": PatchLoader(datasets["val"], cfg_training["val_batch_size"], **common),
        "vis": PatchLoader(datasets["vis"], cfg_training["val_batch_size"], **common),
    }
    log.info("Training data: n_data=%d, batch_size=%d", len(datasets["train"]),
             cfg_training["batch_size"])
    log.info("Validation data: n_data=%d", len(datasets["val"]))

    # model / trainer / scheduler
    model = build_model(cfg)
    trainer = Trainer(
        model, cfg_training,
        use_cloud=cfg["use_cloud"], use_image=cfg["use_image"],
        use_footprint=cfg["use_footprint"], weight_ce=cfg_training["weight_ce"],
        mesh=mesh, donate=cfg.select("device.donate", True),
        image_norm=getattr(datasets["train"], "image_norm", None),
    )
    scheduler = build_scheduler(cfg_training)

    sample_batch = next(iter(loaders["val"]))
    state = trainer.init_state(jax.random.PRNGKey(0), sample_batch)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(state.params))
    log.info("Total model parameters: %d", n_params)
    # reference train.py:94 wandb.watch(model): per-module param norms at
    # print_every cadence (+ global grad/param norms from the jitted step).
    # Norms reduce ON DEVICE (Trainer.module_norms) — the host-side variant
    # fetches the full ~44 MB param tree every iteration.
    wandb.watch(norms_fn=lambda: trainer.module_norms(state.params),
                log_freq=cfg_training["print_every"])

    generator_dsm = DSMGenerator(
        model, lambda: state.params, loaders["vis"],
        dsm_pixel_size=cfg["dsm_generation"]["pixel_size"],
        half_blend_percent=cfg["dsm_generation"].get("half_blend_percent"),
        crs_epsg=cfg["dsm_generation"].get("crs_epsg"),
        use_cloud=cfg["use_cloud"], use_image=cfg["use_image"],
        mesh=mesh,
    )
    evaluator = DSMEvaluator(
        cfg_dataset["dsm_gt_path"], None, {"building": cfg_dataset["mask_files"]["building"]}
    )

    checkpoint_io = CheckpointIO(out_dir_run, model=state.params,
                                 optimizer=state.opt_state, scheduler=scheduler)
    try:
        load_dict = checkpoint_io.load(
            cfg_training.get("resume_from") or "",
            resume_scheduler=cfg_training.get("resume_scheduler", True),
        )
        state = TrainState(checkpoint_io.module_dict["model"],
                           checkpoint_io.module_dict["optimizer"], state.mini_step,
                           state.metric_acc)
        log.info("Resuming from previous checkpoint.")
    except FileNotFoundError:
        load_dict = {}
        log.info("Training from scratch.")
    n_iter = int(load_dict.get("n_iter", 0))
    metric_val_best = float(load_dict.get("loss_val_best", np.inf))
    stream_pos = load_dict.get("stream_pos")
    if stream_pos and loaders["train"].det_stream:
        loaders["train"].set_position(int(stream_pos[0]), int(stream_pos[1]))
        log.info("Resuming patch stream at epoch %s, batch %s.", *stream_pos)
    stream_pos = list(stream_pos) if stream_pos else None

    # best-ckpt (validate) and periodic ckpt share a cadence (both every 100
    # by default), so an improving iteration would fetch the ~130 MB
    # params+opt tree device->host TWICE. Fetch once per iteration and
    # serialize from the host copy.
    fetch_cache = {"iter": None, "model": None, "opt": None}

    def save_ckpt(path):
        if fetch_cache["iter"] != n_iter:
            fetch_cache.update(iter=n_iter, model=jax.device_get(state.params),
                               opt=jax.device_get(state.opt_state))
        checkpoint_io.module_dict["model"] = fetch_cache["model"]
        checkpoint_io.module_dict["optimizer"] = fetch_cache["opt"]
        checkpoint_io.save(path, n_iter=n_iter, loss_val_best=metric_val_best,
                           stream_pos=stream_pos,
                           training_time=time.time() - t_start + float(load_dict.get("training_time", 0.0)))

    def visualize():
        out_path = os.path.join(out_dir_tiff, f"{cfg_training['run_name']}_dsm_{n_iter:06d}.tiff")
        writer = generator_dsm.generate_dsm(out_path)
        eval_dict, _ = evaluator.eval(writer.get_data(), writer.T)
        wandb.log({f"nDSM/{k}/{k2}": v2 for k, v in eval_dict.items()
                   for k2, v2 in v.items()}, step=n_iter)

    # training loop (reference train.py:148-190). Batches are PREPARED one
    # ahead: batch k+1's host->device upload overlaps batch k's compute.
    def _prepared_batches(loader):
        nxt = None
        for batch in loader:
            pos = batch.pop("_stream_pos", None)
            if not batch["patch_valid"].any():
                continue
            cur, nxt = nxt, (trainer.prepare_batch(batch), pos)
            if cur is not None:
                yield cur
        if nxt is not None:
            yield nxt

    # Phase timers (misc/time_*_s, emitted per optimizer step): loader =
    # host collate + upload-dispatch wait; step = train_step dispatch;
    # log/aux = previous step's metric fetch + JSONL write / cadenced
    # validate+checkpoint+visualize. Reconciles sustained in-loop
    # throughput against the isolated bench.py --train number.
    ph = {"loader": 0.0, "step": 0.0, "log": 0.0, "aux": 0.0}

    while n_iter < cfg_training["max_iteration"]:
        batches = _prepared_batches(loaders["train"])
        while True:
            t0 = time.perf_counter()
            try:
                batch, batch_pos = next(batches)
            except StopIteration:
                break
            t1 = time.perf_counter()
            ph["loader"] += t1 - t0
            state = trainer.train_step(state, batch, scheduler.lr)
            ph["step"] += time.perf_counter() - t1
            if batch_pos is not None:
                stream_pos = list(batch_pos)
            if trainer.accumulated_steps != 0:
                continue
            n_iter += 1
            t_log = time.perf_counter()
            training_time = time.time() - t_start + float(load_dict.get("training_time", 0.0))
            wandb.log({
                "iteration": n_iter,
                "train/loss": trainer.last_avg_loss,
                "lr": scheduler.lr,
                "misc/training_time": training_time,
                **{f"misc/time_{k}_s": round(v, 4) for k, v in ph.items()},
                **_memory_metrics(n_iter, cfg_training["print_every"]),
                **{f"train/{k}": v for k, v in trainer.last_avg_loss_dict.items()},
            }, step=n_iter)

            if n_iter % cfg_training["print_every"] == 0:
                log.info("Iteration %d, Loss = %.5f", n_iter, trainer.last_avg_loss)
            # scheduler steps BEFORE any checkpoint save: the saved scheduler
            # state must be the state the next iteration trains with, or
            # kill-and-resume repeats one stale LR (the reference saves
            # pre-step, train.py:170-190 — a latent resume off-by-one
            # deliberately not replicated; tests/test_resume_bitexact.py)
            if cfg_training["scheduler"]["type"] in ITERATION_SCHEDULERS:
                scheduler.step()
            t_aux = time.perf_counter()
            if n_iter % cfg_training["validate_every"] == 0:
                eval_dict = trainer.evaluate(state, loaders["val"])
                metric_val = eval_dict[cfg_training["model_selection_metric"]]
                wandb.log({f"val/{k}": v for k, v in eval_dict.items()}, step=n_iter)
                if cfg_training["scheduler"]["type"] == "ReduceLROnPlateau":
                    # metric-driven scheduler steps on validation (the reference
                    # registers this scheduler type but never steps it,
                    # train.py:188-190 — wired up here)
                    scheduler.step(metric_val)
                if metric_val < metric_val_best:
                    metric_val_best = metric_val
                    save_ckpt(os.path.join(out_dir_ckpt, "model_best.ckpt"))
            if n_iter % cfg_training["checkpoint_every"] == 0:
                save_ckpt(os.path.join(out_dir_ckpt, f"model_{n_iter}.ckpt"))
            if n_iter % cfg_training["visualize_every"] == 0:
                visualize()
            t_end = time.perf_counter()
            # log/aux land in the NEXT step's record (measured after emit)
            ph = {"loader": 0.0, "step": 0.0,
                  "log": t_aux - t_log, "aux": t_end - t_aux}
            if n_iter >= cfg_training["max_iteration"]:
                break

    log.info("Optimization done!")
    wandb.finish()
    return state, n_iter, metric_val_best


if __name__ == "__main__":
    main()

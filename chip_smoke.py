#!/usr/bin/env python
"""Smoke run of the main path on the GPU, through the entry points a user calls.

    python chip_smoke.py          # one GPU: phases a-d
    python chip_smoke.py --four   # four GPUs: the data-parallel paths only

One process does everything (a JAX process reserves most of each card's
memory when it starts, so a second one could not share the card).

a. device: JAX must run on a GPU; prints the device, ``nvidia-smi``'s name and
   power limit, and whether the native host runtime loaded.
b. forward parity at flagship width (cloud-only, plane 256^2, depth-5 ALTO,
   32 channels, 11.08 M random params from seed 0; batch 8 of 16,384-point
   buckets, 512^2 output): the GPU forward in f32 under "highest" precision,
   at default precision (TF32 on Hopper) and in bf16, each against a float32
   reference on the host CPU under "highest".
c. train: ``train.main`` on the seed-0 synthetic city at flagship width
   (16,384-point bucket, batch 8, optimize_every 8, two optimizer steps, one
   checkpoint).
d. serve: ``test.main`` on that checkpoint: sliding-window DSMGenerator,
   GeoTIFF, evaluation report; the GeoTIFF is read back.

``--four`` runs the data-parallel training window on a 4-device mesh and the
mesh-sharded ``generate_dsm`` (host and device blend), each against the
single-device run under "highest" precision.

Any failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# Tolerances of phase b, as a fraction of the reference output's largest
# |height| (metres). f32 "highest": same math, but the GPU's atomic scatters
# add in another order than the CPU, and cuDNN picks other conv algorithms —
# f32 rounding through ~40 layers stays well under 1e-4. TF32 rounds every
# conv/matmul operand to a 10-bit mantissa (~5e-4 relative each): bounded at
# 2e-2. bf16 rounds activations and weights to 8 bits (~4e-3 relative each)
# through the whole network; the f32 decoder head keeps the output scale:
# bounded at 1e-1.
FORWARD_RTOL = {"f32_highest": 1e-4, "tf32_default": 2e-2, "bf16": 1e-1}
# --four: sharded vs single-device, both under "highest". The host blend
# differs only by atomic-add order inside each patch; the device blend also
# accumulates the overlap blend in f32 instead of f64.
FOUR_RTOL = {"host_blend": 1e-4, "device_blend": 1e-3, "train_metrics": 1e-4}

FLAGSHIP_BATCH, FLAGSHIP_POINTS = 8, 16384


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def phase_device(count: int) -> dict:
    import jax

    from tomosar2height_jax import native

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX runs on '{backend}'")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devices)}")
    info = {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
    say(f"[a] device: {info['kind']} x{info['count']} ({jax.__version__}); "
        f"native host runtime loaded: {native.available()}")
    return info


def random_points(batch: int, n: int, seed: int = 0):
    """Uniform points in (0, 1)^3 with 75-100 % of each bucket valid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.001, 0.999, (batch, n, 3)).astype(np.float32)
    counts = rng.integers(3 * n // 4, n + 1, batch)
    mask = np.arange(n)[None, :] < counts[:, None]
    return pts, mask


def forward_parity(model, batch: int, n_points: int, device, ref_device) -> dict:
    """Phase b: errors (metres) of the forward on ``device`` in three
    precisions against the f32 "highest" forward on ``ref_device``."""
    import jax
    import jax.numpy as jnp

    pts, mask = random_points(batch, n_points)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pts[:1, :256], mask[:1, :256])

    def run(m, dev, precision):
        put = lambda x: jax.device_put(x, dev)  # noqa: E731
        with jax.default_matmul_precision(precision):
            fwd = jax.jit(lambda p, x, k: m.apply(p, x, k)[0])
            return np.asarray(fwd(put(params), put(pts), put(mask)), np.float64)

    ref = run(model, ref_device, "highest")
    scale = float(np.max(np.abs(ref)))
    out = {"scale_m": scale}
    variants = {"f32_highest": (model, "highest"),
                "tf32_default": (model, None),
                "bf16": (model.clone(dtype=jnp.bfloat16), None)}
    for name, (m, precision) in variants.items():
        got = run(m, device, precision)
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        err = np.abs(got - ref)
        out[name] = {"max_m": float(err.max()), "mean_m": float(err.mean()),
                     "tol_m": FORWARD_RTOL[name] * scale}
    return out


def check_parity(errors: dict) -> None:
    for name in FORWARD_RTOL:
        e = errors[name]
        say(f"[b] {name}: max|err| {e['max_m']:.6g} m, mean|err| {e['mean_m']:.6g} m "
            f"(tolerance {e['tol_m']:.6g} m = {FORWARD_RTOL[name]:g} x "
            f"max|ref| {errors['scale_m']:.6g} m)")
        assert e["max_m"] <= e["tol_m"], f"{name} forward off the reference"


def train_overrides(root: str, platform: str, extra=()) -> list:
    from __graft_entry__ import synthetic_city_overrides

    return synthetic_city_overrides(root, [
        f"training.out_dir={root}/outputs",
        f"device.platform={platform}",
        f"dataset.points.train_bucket={FLAGSHIP_POINTS}",
        f"dataset.points.bucket_sizes=[{FLAGSHIP_POINTS}]",
        f"training.batch_size={FLAGSHIP_BATCH}",
        "training.optimize_every=8",
        f"training.val_batch_size={FLAGSHIP_BATCH}",
        "training.max_iteration=2",
        "training.validate_every=2",
        "training.checkpoint_every=2",
        "training.visualize_every=1000",
        *extra,
    ])


def phase_train(overrides) -> dict:
    """Phase c: two optimizer steps through ``train.main``."""
    import jax

    import train as train_entry
    from tomosar2height_jax.config import compose
    from tomosar2height_jax.config.compose import default_conf_dir
    from tomosar2height_jax.models import build_model

    cfg = compose(default_conf_dir(), overrides=overrides)
    state, n_iter, best = train_entry.main(overrides)
    run = os.path.join(cfg["training"]["out_dir"],
                       f"{cfg['training']['run_name']}{cfg['run_suffix']}")
    with open(os.path.join(run, "wandb", "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    ckpt = os.path.join(run, "check_points", f"model_{n_iter}.ckpt")
    pts, mask = random_points(1, 256)
    init = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0), pts, mask)
    changed = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                  for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(state.params)))
    stats = jax.devices()[0].memory_stats() or {}
    assert n_iter == 2 and len(losses) == 2, (n_iter, losses)
    assert np.isfinite(losses).all() and np.isfinite(best), (losses, best)
    assert changed > 0.0, "training left the params unchanged"
    assert os.path.exists(ckpt), ckpt
    say(f"[c] train: {n_iter} optimizer steps, losses {losses}, best val "
        f"{best:.6g}, max|Δparam| {changed:.3g}, checkpoint {os.path.basename(ckpt)}, "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")
    return {"run": run, "n_iter": n_iter, "ckpt": ckpt}


def phase_serve(overrides, trained: dict) -> None:
    """Phase d: ``test.main`` on the phase-c checkpoint."""
    import test as test_entry
    from tomosar2height_jax.geo import RasterReader

    stats = test_entry.main(list(overrides) + [f"test.check_point={trained['ckpt']}"])
    assert stats is not None, "test.main found no checkpoint"
    tiff_dir = os.path.join(trained["run"], "tiff_test")
    names = os.listdir(tiff_dir)
    dsm = [n for n in names if "_dsm_" in n and n.endswith(".tiff")]
    report = [n for n in names if n.endswith("_eval.txt")]
    assert dsm and report, names
    r = RasterReader(os.path.join(tiff_dir, dsm[0]))
    data = r.get_data()
    # the test chunk of the synthetic city: x in [640, 1280], y in [5000000, 5000640]
    assert r.shape == (640, 640) and (r.T.c, r.T.f) == (640.0, 5000640.0), (r.shape, r.T)
    assert r.T.a == 1.0 and r.T.e == -1.0, r.T
    assert np.isfinite(data).all() and (data >= 0).all()
    say(f"[d] serve: {dsm[0]} {data.shape}, origin ({r.T.c}, {r.T.f}), "
        f"height range [{data.min():.4g}, {data.max():.4g}] m, "
        f"RMSE {stats['overall']['RMSE']:.6g} m, report {report[0]}")


def four_devices(root: str, model, batch: int, n_points: int, city_overrides=()) -> None:
    """``--four``: the mesh paths against the single-device run."""
    import jax

    from __graft_entry__ import (
        build_synthetic_city,
        dp_train_window,
        max_param_change,
        mesh_generate,
        synthetic_city_overrides,
    )
    from tomosar2height_jax.parallel.mesh import make_mesh

    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    pts, mask = random_points(batch, n_points)
    out_px = model.decoder_kwargs["output_size"]
    rng = np.random.default_rng(1)
    train_batch = {"points": pts, "point_mask": mask,
                   "patch_valid": np.ones((batch,), bool),
                   "dsm": rng.uniform(0, 30, (batch, out_px, out_px)).astype(np.float32)}
    lr = 1e-4
    with jax.default_matmul_precision("highest"):
        m4, p0, p4 = dp_train_window(model, mesh4, train_batch, lr=lr)
        m1, _, p1 = dp_train_window(model, mesh1, train_batch, lr=lr)
    worst = max(abs(m4[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in m1)
    # one AdamW step moves a param by at most ~lr; a near-zero gradient whose
    # sign differs between the runs can flip that step, so params agree to 2 lr
    dparam = max_param_change(p4, p1)
    say(f"[4a] DP train window on 4 devices vs 1: loss {m4['loss']:.8g} vs "
        f"{m1['loss']:.8g}, grad_norm {m4['grad_norm']:.8g} vs {m1['grad_norm']:.8g}, "
        f"worst metric rel. diff {worst:.3g} (tolerance {FOUR_RTOL['train_metrics']:g}), "
        f"max|Δparam| {dparam:.3g} (bound {2 * lr:g}), "
        f"step moved params by {max_param_change(p0, p1):.3g}")
    assert worst <= FOUR_RTOL["train_metrics"] and dparam <= 2 * lr

    cfg = build_synthetic_city(root, 0.055, synthetic_city_overrides(root, city_overrides))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), pts[:1, :256], mask[:1, :256])
    tiff = lambda tag: os.path.join(root, f"four_{tag}.tiff")  # noqa: E731
    bucket = cfg["dataset"]["points"]["train_bucket"]
    with jax.default_matmul_precision("highest"):
        single = mesh_generate(model, params, cfg["dataset"], None, batch, bucket,
                               tiff("single"))
        shard = mesh_generate(model, params, cfg["dataset"], mesh4, batch, bucket,
                              tiff("shard"))
        shard_db = mesh_generate(model, params, cfg["dataset"], mesh4, batch, bucket,
                                 tiff("shard_db"), device_blend=True)
    assert np.isfinite(single).all()
    scale = float(np.max(np.abs(single)))
    for name, raster in (("host_blend", shard), ("device_blend", shard_db)):
        err = float(np.max(np.abs(raster - single)))
        tol = FOUR_RTOL[name] * scale
        say(f"[4b] sharded generate_dsm ({name}) on 4 devices vs 1: raster "
            f"{single.shape}, max|err| {err:.6g} m (tolerance {tol:.6g} m = "
            f"{FOUR_RTOL[name]:g} x max|ref| {scale:.6g} m)")
        assert err <= tol, name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU data-parallel paths instead of phases b-d")
    args = ap.parse_args(argv)

    import jax

    # phase b needs the host CPU backend beside the GPU
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")

    info = phase_device(4 if args.four else 1)
    smi = nvidia_smi_lines()
    from __graft_entry__ import _flagship_model
    from tomosar2height_jax.utils import enable_compile_cache

    enable_compile_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        if args.four:
            from tomosar2height_jax.parallel import init_distributed

            # one process drives all local GPUs: no cluster, no coordinator
            assert init_distributed() is False
            four_devices(root, _flagship_model(), FLAGSHIP_BATCH, FLAGSHIP_POINTS,
                         [f"dataset.points.train_bucket={FLAGSHIP_POINTS}",
                          f"dataset.points.bucket_sizes=[{FLAGSHIP_POINTS}]"])
        else:
            check_parity(forward_parity(_flagship_model(), FLAGSHIP_BATCH, FLAGSHIP_POINTS,
                                        jax.devices()[0], jax.devices("cpu")[0]))
            from __graft_entry__ import build_synthetic_city

            overrides = train_overrides(root, "gpu")
            build_synthetic_city(root, 0.055, overrides)
            phase_serve(overrides, phase_train(overrides))
    for line in smi:
        say(line)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Training-DYNAMICS parity vs the actual torch reference.

Forward/grad parity at init (tests/test_reference_parity.py) cannot catch a
drift in the optimizer/schedule/accumulation interplay. This script drives

  - the reference's own training stack: its ``Trainer`` class
    (/root/reference/trainer.py:47-89) around the torch ``TomoSAR2Height``,
    ``optim.AdamW`` + ``CyclicLR(triangular2)`` stepped per optimizer window
    (/root/reference/train.py:97-104,188-190), gradient accumulation via
    summed ``loss.backward()``; and
  - this framework's ``Trainer`` (``grad_reduction='sum'`` +
    ``optax.MultiSteps``) with the torch-parity ``CyclicLR``

from IDENTICAL ported init weights over an IDENTICAL recorded patch stream,
for ``--steps`` optimizer steps on CPU at reduced shapes, then compares the
two loss trajectories point-by-point and the final held-out val L1.

Run (CPU, ~2 min at the defaults):

    python scripts/parity_training_dynamics.py --steps 100 --accum 4

Exit code is non-zero if any tolerance fails, so it doubles as a gate; the
short-version pin lives in tests/test_reference_parity.py
(test_training_dynamics_short).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import numpy as np


def make_patch_stream(rng, n_patches, n_points, out_px):
    """A fixed, learnable stream: targets are a deterministic function of the
    points (per-cell max height on a coarse grid, upsampled), so the loss
    actually descends and optimizer states move through realistic regimes."""
    patches = []
    for _ in range(n_patches):
        pts = rng.uniform(0.01, 0.99, (1, n_points, 3)).astype(np.float32)
        coarse = np.zeros((8, 8), np.float32)
        ij = np.minimum((pts[0, :, :2] * 8).astype(int), 7)
        np.maximum.at(coarse, (ij[:, 1], ij[:, 0]), pts[0, :, 2] * 50.0)
        dsm = np.repeat(np.repeat(coarse, out_px // 8, 0), out_px // 8, 1)
        patches.append({"points": pts, "dsm": dsm[None]})
    return patches


def build_reference(harness):
    import torch

    import tomosar2height.model as ref_model_mod

    torch.manual_seed(0)
    return ref_model_mod.TomoSAR2Height(harness._ref_cfg(True, False, False))


def perturb_(ref, rel):
    """In-place multiplicative perturbation of every reference parameter —
    the 'chaos control': two torch runs whose inits differ by ``rel`` measure
    the problem's intrinsic trajectory divergence (Lyapunov growth). The
    cross-stack divergence is only meaningful relative to this floor."""
    import torch

    with torch.no_grad():
        g = torch.Generator().manual_seed(1234)
        for p in ref.parameters():
            noise = torch.rand(p.shape, generator=g) * 2.0 - 1.0
            p.mul_(1.0 + rel * noise)


def run_reference(ref, patches, val_patches, steps, accum, sched_kwargs, lr0):
    import torch

    import trainer as ref_trainer_mod  # /root/reference/trainer.py

    opt = torch.optim.AdamW(ref.parameters(), lr=lr0)
    sched = torch.optim.lr_scheduler.CyclicLR(opt, cycle_momentum=False,
                                              **sched_kwargs)
    tr = ref_trainer_mod.Trainer(ref, opt, device=None, optimize_every=accum,
                                 use_cloud=True, use_image=False,
                                 use_footprint=False)
    losses, lrs = [], []
    i = 0
    while len(losses) < steps:
        p = patches[i % len(patches)]
        i += 1
        data = {"inputs": torch.from_numpy(p["points"]),
                "dsm": torch.from_numpy(p["dsm"])}
        tr.train_step(data)
        if tr.accumulated_steps == 0:
            losses.append(float(tr.last_avg_loss))
            lrs.append(opt.param_groups[0]["lr"])
            sched.step()  # reference train.py:188-190: per optimizer window

    ref.eval()
    val_l1 = []
    with torch.no_grad():
        for p in val_patches:
            pa, _ = ref(torch.from_numpy(p["points"]), None)
            val_l1.append(float(torch.nn.functional.l1_loss(
                pa.squeeze(), torch.from_numpy(p["dsm"]).squeeze())))
    return np.array(losses), np.array(lrs), float(np.mean(val_l1))


def run_ours(harness, ported_params, patches, val_patches, steps, accum,
             sched_kwargs, lr0):
    import jax
    import jax.numpy as jnp

    from tomosar2height_jax.parallel.mesh import make_mesh
    from tomosar2height_jax.train.schedule import CyclicLR
    from tomosar2height_jax.train.trainer import Trainer

    model = harness._flax_model(True, False, False)
    trainer = Trainer(model, {"optimize_every": accum,
                              "grad_reduction": "sum",
                              "wire_dsm_dtype": "float32"},
                      use_cloud=True, mesh=make_mesh(1), donate=False)

    def to_batch(p):
        return {"points": p["points"],
                "point_mask": np.ones(p["points"].shape[:2], bool),
                "patch_valid": np.ones((1,), bool),
                "dsm": p["dsm"].astype(np.float32)}

    state = trainer.init_state(jax.random.PRNGKey(0), to_batch(patches[0]))
    state = state.replace(params=jax.tree.map(jnp.asarray, ported_params))

    sched = CyclicLR(**sched_kwargs)
    losses, lrs = [], []
    i = 0
    while len(losses) < steps:
        p = patches[i % len(patches)]
        i += 1
        lr = sched.lr
        state = trainer.train_step(state, to_batch(p), lr)
        if trainer.accumulated_steps == 0:
            losses.append(float(trainer.last_avg_loss))
            lrs.append(lr)
            sched.step()

    val_l1 = []
    for p in val_patches:
        m = trainer.eval_step(state, to_batch(p))
        val_l1.append(m["loss_l1"])
    return np.array(losses), np.array(lrs), float(np.mean(val_l1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100,
                    help="optimizer steps (windows) to run on each stack")
    ap.add_argument("--accum", type=int, default=4,
                    help="optimize_every (gradient-accumulation window)")
    ap.add_argument("--points", type=int, default=512)
    ap.add_argument("--stream", type=int, default=8,
                    help="distinct patches cycled in the train stream")
    ap.add_argument("--early-rtol", type=float, default=1e-3,
                    help="max relative loss divergence over the first quarter "
                         "of the run — tight enough to catch any systematic "
                         "mismatch (wrong wd/eps/schedule) before chaos "
                         "amplification dominates")
    ap.add_argument("--chaos-margin", type=float, default=3.0,
                    help="late-run divergence must stay within this factor "
                         "of the torch-vs-perturbed-torch control divergence")
    ap.add_argument("--control-rel", type=float, default=1e-6,
                    help="relative init perturbation for the control run")
    ap.add_argument("--val-rtol", type=float, default=5e-3)
    ap.add_argument("--json", default=None, help="write result JSON here")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")

    import test_reference_parity as harness

    # install the reference's dependency shims and import it
    import types

    import torch  # noqa: F401

    sys.modules.setdefault("torch_scatter", harness._shim_torch_scatter())
    for name in ("open3d", "laspy", "rasterio"):
        sys.modules.setdefault(name, types.ModuleType(name))
    o3d = sys.modules["open3d"]
    if not hasattr(o3d, "geometry"):
        o3d.geometry = types.SimpleNamespace(PointCloud=object)
        o3d.utility = types.SimpleNamespace(Vector3dVector=object)
    rio = sys.modules["rasterio"]
    rt = types.ModuleType("rasterio.transform")
    rt.Affine = object
    rio.transform = rt
    rio.DatasetReader = object
    rio.io = types.SimpleNamespace(DatasetWriter=object)
    sys.modules.setdefault("rasterio.transform", rt)
    if harness.REFERENCE_ROOT not in sys.path:
        sys.path.append(harness.REFERENCE_ROOT)

    rng = np.random.default_rng(7)
    patches = make_patch_stream(rng, args.stream, args.points, 64)
    val_patches = make_patch_stream(rng, 4, args.points, 64)

    # the reference flagship schedule scaled to the run length: one full
    # triangular2 LR cycle over the run (flagship: 500/500 over 10k steps,
    # reference conf/model/tomosar2height.yaml:46-54)
    half = max(args.steps // 4, 2)
    sched_kwargs = dict(base_lr=1e-4, max_lr=5e-4, mode="triangular2",
                        step_size_up=half, step_size_down=half, gamma=1.0)

    # port INIT weights before the reference trains in place
    import jax.numpy as jnp  # noqa: F401

    from tomosar2height_jax.utils.torch_port import port_torch_to_flax

    ref = build_reference(harness)
    model = harness._flax_model(True, False, False)
    pts0 = jnp.asarray(patches[0]["points"])
    mask0 = jnp.ones(pts0.shape[:2], bool)
    init_params = model.init(jax.random.PRNGKey(0), pts0, mask0, None)
    ported_params, _ = port_torch_to_flax(ref, init_params)

    t0 = time.time()
    loss_t, lr_t, val_t = run_reference(
        ref, patches, val_patches, args.steps, args.accum, sched_kwargs, 1e-4)
    t_torch = time.time() - t0

    # chaos control: same torch stack, init perturbed by --control-rel. Its
    # divergence from the unperturbed torch run is the intrinsic Lyapunov
    # growth of this training problem in f32 — the floor below which no
    # cross-implementation comparison can be expected to stay.
    ref_c = build_reference(harness)
    perturb_(ref_c, args.control_rel)
    loss_c, _, val_c = run_reference(
        ref_c, patches, val_patches, args.steps, args.accum, sched_kwargs,
        1e-4)

    t0 = time.time()
    loss_j, lr_j, val_j = run_ours(
        harness, ported_params, patches, val_patches, args.steps, args.accum,
        sched_kwargs, 1e-4)
    t_jax = time.time() - t0

    np.testing.assert_allclose(lr_j, lr_t, rtol=1e-9,
                               err_msg="LR schedules diverged")
    rel = np.abs(loss_j - loss_t) / np.maximum(np.abs(loss_t), 1e-6)
    rel_c = np.abs(loss_c - loss_t) / np.maximum(np.abs(loss_t), 1e-6)
    drop_t = loss_t[0] / loss_t[-1]
    q = max(len(rel) // 4, 1)
    print(f"steps={args.steps} accum={args.accum} "
          f"(= {args.steps * args.accum} patches each side)")
    print(f"torch {t_torch:.1f}s, jax {t_jax:.1f}s")
    print(f"loss[0]    torch {loss_t[0]:.6f}  jax {loss_j[0]:.6f}")
    for k in (1, len(loss_t) // 4, len(loss_t) // 2, len(loss_t) - 1):
        print(f"loss[{k:>3}]  torch {loss_t[k]:.6f}  jax {loss_j[k]:.6f}  "
              f"rel {rel[k]:.2e}  control {rel_c[k]:.2e}")
    print(f"early window (first {q} steps): jax-vs-torch {rel[:q].max():.2e} "
          f"(tol {args.early_rtol:.0e}), control {rel_c[:q].max():.2e}")
    print(f"full run: jax-vs-torch {rel.max():.2e}, "
          f"torch-vs-perturbed-torch control {rel_c.max():.2e} "
          f"(margin {args.chaos_margin:g}x)")
    print(f"loss descended {drop_t:.2f}x (torch) — trajectory is non-trivial")
    print(f"final val L1: torch {val_t:.6f}  jax {val_j:.6f}  "
          f"control {val_c:.6f}  rel {abs(val_j - val_t) / val_t:.2e} "
          f"(tol {args.val_rtol:.0e})")

    ok = (rel[:q].max() < args.early_rtol
          and rel.max() < args.chaos_margin * max(rel_c.max(), 1e-4)
          and abs(val_j - val_t) / val_t < args.val_rtol
          and drop_t > 1.5)
    if args.json:
        Path(args.json).write_text(json.dumps({
            "steps": args.steps, "accum": args.accum,
            "max_rel_loss_divergence": float(rel.max()),
            "early_rel_divergence": float(rel[:q].max()),
            "control_rel_divergence": float(rel_c.max()),
            "loss_first": [float(loss_t[0]), float(loss_j[0])],
            "loss_last": [float(loss_t[-1]), float(loss_j[-1]),
                          float(loss_c[-1])],
            "val_l1": [val_t, val_j, val_c],
            "loss_drop_torch": float(drop_t), "ok": bool(ok)}))
    print("PARITY OK" if ok else "PARITY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

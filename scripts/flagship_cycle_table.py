#!/usr/bin/env python
"""Per-LR-cycle summary table of a flagship 10k run.

The reference's production schedule is 10,000 optimizer steps of CyclicLR
triangular2 with step_size_up=500/down=500 (reference conf/model/
tomosar2height.yaml:40-44, train.py:97-104) = 10 LR cycles of 1000 steps.
This digests a run's wandb/metrics.jsonl into one row per cycle — peak LR
actually reached, train-loss trend, best val L1 (+ iteration), memory
steadiness — plus the checkpoint files on disk, as long-horizon
stability evidence.

Usage:
    python scripts/flagship_cycle_table.py <run_dir> [--cycle 1000]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics as st


def load(path):
    recs = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("_step") is not None:
                # one step may span several records (train metrics, then
                # val/); resume re-logs an overlap region — merge per step,
                # later writes win key-by-key
                recs.setdefault(r["_step"], {}).update(r)
    return [recs[s] for s in sorted(recs)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run")
    ap.add_argument("--cycle", type=int, default=1000)
    a = ap.parse_args()

    recs = load(os.path.join(a.run, "wandb", "metrics.jsonl"))
    assert recs, "no step records"
    last = recs[-1]["_step"]
    n_cycles = (last + a.cycle - 1) // a.cycle

    print(f"run: {a.run}")
    print(f"steps logged: {len(recs)} (last iteration {last})\n")
    hdr = ("| cycle | iters | peak lr | train L1 (med last 100) | "
           "best val L1 (@iter) | HBM peak GB | host RSS GB |")
    print(hdr)
    print("|" + "---|" * 7)
    for c in range(n_cycles):
        lo, hi = c * a.cycle + 1, min((c + 1) * a.cycle, last)
        window = [r for r in recs if lo <= r["_step"] <= hi]
        if not window:
            continue
        peak_lr = max(r["lr"] for r in window)
        tail = [r["train/loss_l1"] for r in window[-100:]]
        vals = [(r["val/loss_l1"], r["_step"]) for r in window
                if "val/loss_l1" in r]
        best = min(vals) if vals else (float("nan"), -1)
        hbm = [r["misc/hbm_peak_bytes"] for r in window
               if "misc/hbm_peak_bytes" in r]
        rss = [r["misc/host_rss_bytes"] for r in window
               if "misc/host_rss_bytes" in r]
        hbm_s = f"{max(hbm) / 2**30:.2f}" if hbm else "n/a"
        rss_s = f"{max(rss) / 2**30:.2f}" if rss else "n/a"
        print(f"| {c + 1} | {lo}-{hi} | {peak_lr:.2e} | "
              f"{st.median(tail):.4f} | {best[0]:.4f} (@{best[1]}) | "
              f"{hbm_s} | {rss_s} |")

    tt = [r["misc/training_time"] for r in recs if "misc/training_time" in r]
    print(f"\nwall-clock (training_time counter): {tt[-1] / 3600:.2f} h")
    ckpts = sorted(glob.glob(os.path.join(a.run, "check_points",
                                          "model_*.ckpt")))
    nums = sorted(int(os.path.basename(p)[6:-5]) for p in ckpts
                  if os.path.basename(p)[6:-5].isdigit())
    print(f"checkpoints on disk: {len(ckpts)} "
          f"(first {nums[0] if nums else '-'}, last {nums[-1] if nums else '-'}"
          f", best: {'yes' if any('best' in p for p in ckpts) else 'no'})")
    allv = [(r["val/loss_l1"], r["_step"]) for r in recs if "val/loss_l1" in r]
    if allv:
        b = min(allv)
        print(f"best val L1 overall: {b[0]:.4f} @ iteration {b[1]}")


if __name__ == "__main__":
    main()

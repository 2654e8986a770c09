#!/usr/bin/env python
"""Sustained in-loop training throughput from a run's metrics.jsonl.

Computes patches/s over the full trail and over "quiet" windows (iterations
with no validation/checkpoint/visualize work, i.e. aux < 1 s), plus the
phase-timer medians — the reconciliation between `bench.py --train`
(isolated, upload-cached compute) and what the shipped train.py sustains.

Usage:
    python scripts/sustained_from_metrics.py <run_dir_or_metrics.jsonl> \
        [--batch-patches 16] [--lo 200] [--hi 10000]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics as st


def load(path: str):
    if os.path.isdir(path):
        path = os.path.join(path, "wandb", "metrics.jsonl")
    recs = []
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line from a killed leg
            if r.get("_step") is not None and "misc/training_time" in r:
                recs.append(r)
    # kill-and-resume legs re-log the overlap region; keep the LAST record
    # per step (the one that continued the run)
    by_step = {r["_step"]: r for r in recs}
    return [by_step[s] for s in sorted(by_step)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run", help="run dir or metrics.jsonl path")
    ap.add_argument("--batch-patches", type=int, default=16,
                    help="patches per optimizer step (batch_size x optimize_every)")
    ap.add_argument("--lo", type=int, default=200,
                    help="first iteration of the analysis window (skip compile)")
    ap.add_argument("--hi", type=int, default=10 ** 9)
    a = ap.parse_args()

    recs = [r for r in load(a.run) if a.lo <= r["_step"] <= a.hi]
    assert len(recs) > 10, f"only {len(recs)} records in window"
    steps = [r["_step"] for r in recs]
    tt = [r["misc/training_time"] for r in recs]
    # per-step wall clock from consecutive training_time deltas; resume
    # boundaries show as negative/huge deltas -> drop them
    pairs = list(zip(steps, tt))
    deltas = [(s1, t1 - t0) for (s0, t0), (s1, t1) in zip(pairs, pairs[1:])
              if s1 == s0 + 1 and 0 < t1 - t0 < 300]
    dts = [d for _, d in deltas]
    full = st.median(dts)
    # quiet steps: no val/ckpt/vis in the PREVIOUS step's aux (the timers
    # land in the following record) and none in this one
    quiet = [d for (s, d), r in zip(deltas, recs[1:])
             if r.get("misc/time_aux_s", 0.0) < 1.0 and d < 3 * full]
    out = {
        "n_steps": len(dts),
        "window": [steps[0], steps[-1]],
        "s_per_step_median_full": round(full, 4),
        "patches_per_s_full": round(a.batch_patches / full, 2),
        "s_per_step_median_quiet": round(st.median(quiet), 4),
        "patches_per_s_quiet": round(a.batch_patches / st.median(quiet), 2),
        "phase_medians_s": {
            k.split("/")[-1]: round(st.median(
                [r.get(k, 0.0) for r in recs]), 4)
            for k in ("misc/time_loader_s", "misc/time_step_s",
                      "misc/time_log_s", "misc/time_aux_s")},
        "aux_s_per_100_steps": round(sum(
            r.get("misc/time_aux_s", 0.0) for r in recs)
            / max(len(recs), 1) * 100, 2),
        "wall_clock_h_total": round((tt[-1] - tt[0]) / 3600, 3),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Per-patch point-count histogram: size the padding buckets from real data.

The PatchLoader subsamples any patch denser than the largest configured bucket
(data/pipeline.py pad_points) — a documented deviation from the reference's
ragged tensors. This tool walks a dataset split, histograms the per-patch point
counts, and recommends power-of-two bucket sizes so that subsampling stays
below a target rate (default: none at P99.9).

Usage:
    python scripts/point_density.py dataset=berlin [--split test] [--bins 20]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.config import compose  # noqa: E402
from tomosar2height_jax.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_jax.data import TomoSARDataset  # noqa: E402


def patch_point_counts(dataset) -> np.ndarray:
    counts = np.zeros(len(dataset), dtype=np.int64)
    for i in range(len(dataset)):
        p = dataset[i]
        counts[i] = len(p["inputs"]) if p["is_valid"] else 0
    return counts


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def report(counts: np.ndarray, bucket_sizes, bins: int = 20) -> str:
    lines = []
    nz = counts[counts > 0]
    lines.append(f"patches: {len(counts)} total, {len(nz)} non-empty")
    if len(nz) == 0:
        return "\n".join(lines + ["no points found"])
    pct = {p: int(np.percentile(nz, p)) for p in (50, 90, 99, 99.9, 100)}
    lines.append("point-count percentiles: " +
                 "  ".join(f"P{p:g}={v}" for p, v in pct.items()))
    hist, edges = np.histogram(nz, bins=bins)
    peak = hist.max()
    for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
        bar = "#" * int(round(40 * h / max(peak, 1)))
        lines.append(f"  [{int(lo):>8d}, {int(hi):>8d}) {h:>6d} {bar}")
    largest = max(int(b) for b in bucket_sizes)
    n_over = int((nz > largest).sum())
    pts_over = int(np.maximum(nz - largest, 0).sum())
    lines.append(f"configured buckets: {sorted(int(b) for b in bucket_sizes)}")
    lines.append(
        f"overflow at largest bucket {largest}: {n_over} patches "
        f"({100.0 * n_over / len(nz):.2f}%), {pts_over} points would be subsampled"
    )
    rec = sorted({next_pow2(pct[50]), next_pow2(pct[90]), next_pow2(pct[99.9])})
    lines.append(f"recommended dataset.points.bucket_sizes: {rec} "
                 f"(P50/P90/P99.9 rounded up to powers of two)")
    return "\n".join(lines)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    split, bins = "test", 20
    overrides = []
    i = 0
    while i < len(argv):
        if argv[i] == "--split":
            split, i = argv[i + 1], i + 2
        elif argv[i] == "--bins":
            bins, i = int(argv[i + 1]), i + 2
        else:
            overrides.append(argv[i])
            i += 1
    cfg = compose(default_conf_dir(), overrides=overrides)
    dataset = TomoSARDataset(split, cfg["dataset"], random_sample=False)
    counts = patch_point_counts(dataset)
    print(report(counts, cfg["dataset"]["points"]["bucket_sizes"], bins))
    return counts


if __name__ == "__main__":
    main()

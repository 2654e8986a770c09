#!/usr/bin/env python
"""z standard deviation of a LAS cloud within the 5th-95th z percentile.

Capability parity: reference scripts/compute_std.py:1-21 (used to choose the
dataset z-range config).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo.cloud import load_pc  # noqa: E402


def robust_z_std(points: np.ndarray) -> float:
    z = points[:, 2]
    lo, hi = np.percentile(z, [5, 95])
    sel = z[(z >= lo) & (z <= hi)]
    return float(np.std(sel))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("cloud", help="las/npy/npz/ply point cloud")
    a = ap.parse_args()
    pts = load_pc(a.cloud)
    print(f"{a.cloud}: n={len(pts)}  z-std(5-95pct)={robust_z_std(pts):.3f} m")

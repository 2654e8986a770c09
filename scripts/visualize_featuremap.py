#!/usr/bin/env python
"""PCA-project saved feature-map pickles to turbo-colormap PNGs.

Capability parity: reference scripts/visualize_featuremap.py:1-48, consuming
pickles produced by tomosar2height_jax.utils.introspect.save_feature_maps
(the flax capture_intermediates equivalent of the reference's debug forwards).
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.utils.introspect import load_feature_maps  # noqa: E402


def pca_project(fmap: np.ndarray) -> np.ndarray:
    """First principal component of an (H, W, C) map -> (H, W)."""
    h, w, c = fmap.shape
    flat = fmap.reshape(-1, c).astype(np.float64)
    flat = flat - flat.mean(axis=0)
    if c == 1:
        return flat.reshape(h, w)
    # power iteration on the covariance (cheap, no sklearn dependency needed)
    v = np.ones(c) / np.sqrt(c)
    cov = flat.T @ flat
    for _ in range(50):
        v = cov @ v
        v /= np.linalg.norm(v) + 1e-12
    return (flat @ v).reshape(h, w)


def main(pickle_path: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    fmaps = load_feature_maps(pickle_path)
    for name, arr in fmaps:
        if arr.ndim != 4:
            continue
        img = pca_project(arr[0])
        plt.figure(figsize=(4, 4))
        plt.imshow(img, cmap="turbo")
        plt.axis("off")
        safe = name.replace("/", "_").replace(".", "_")
        plt.savefig(os.path.join(out_dir, f"{safe}.png"), bbox_inches="tight", dpi=120)
        plt.close()
    print(f"wrote {len(fmaps)} feature maps to {out_dir}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("pickle")
    ap.add_argument("--out", default="featuremaps")
    a = ap.parse_args()
    main(a.pickle, a.out)

#!/usr/bin/env python
"""Building-instance evaluation CLI (RMSE-B / MAE-B / MedAE-B).

Capability parity: reference scripts/evaluator_instance.py — raster mode
(predicted vs GT nDSM under a footprint mask) and the network-free point-cloud
median baseline. Library implementation: tomosar2height_jax/infer/instance.py.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo import RasterReader  # noqa: E402
from tomosar2height_jax.geo.cloud import load_pc  # noqa: E402
from tomosar2height_jax.infer.instance import buildingwise_errors_georef, pointcloud_median_baseline  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    r = sub.add_parser("raster", help="predicted nDSM GeoTIFF vs GT under footprint mask")
    r.add_argument("--pred", required=True)
    r.add_argument("--gt", required=True)
    r.add_argument("--mask", required=True)

    c = sub.add_parser("cloud", help="raw-point median baseline vs GT")
    c.add_argument("--cloud", required=True)
    c.add_argument("--gt", required=True)
    c.add_argument("--mask", required=True)
    c.add_argument("--dtm", default=None)
    c.add_argument("--skip-empty", action="store_true",
                   help="only score buildings containing points")

    a = ap.parse_args()
    if a.mode == "raster":
        out = buildingwise_errors_georef(
            RasterReader(a.pred), RasterReader(a.gt), RasterReader(a.mask)
        )
    else:
        out = pointcloud_median_baseline(
            load_pc(a.cloud),
            RasterReader(a.gt),
            RasterReader(a.mask),
            dtm=RasterReader(a.dtm) if a.dtm else None,
            include_empty=not a.skip_empty,
        )
    print(f"Building-wise RMSE (RMSE-B): {out['RMSE_B']}")
    print(f"Building-wise MAE (MAE-B): {out['MAE_B']}")
    print(f"Building-wise MedAE (MedAE-B): {out['MedAE_B']}")
    print(f"#buildings: {out['n_buildings']}")


if __name__ == "__main__":
    main()

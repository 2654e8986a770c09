#!/usr/bin/env python
"""Classical nDSM interpolation baselines (bilinear / IDW / nearest).

Capability parity: reference scripts/interpolate_bilinear.py, interpolate_idw.py,
interpolate_nearest.py — unified CLI over
tomosar2height_jax/infer/baselines.py.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.geo.cloud import load_pc  # noqa: E402
from tomosar2height_jax.infer.baselines import write_interpolated_ndsm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cloud")
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", choices=["bilinear", "idw", "nearest"], default="idw")
    ap.add_argument("--bounds", type=float, nargs=4, metavar=("XMIN", "YMIN", "XMAX", "YMAX"),
                    help="defaults to the cloud bbox")
    ap.add_argument("--pixel", type=float, default=1.0)
    ap.add_argument("--epsg", type=int, default=25832)
    ap.add_argument("--k", type=int, default=8, help="IDW neighbors")
    ap.add_argument("--p", type=float, default=2.0, help="IDW power")
    a = ap.parse_args()

    pts = load_pc(a.cloud)
    if a.bounds:
        bl, tr = a.bounds[:2], a.bounds[2:]
    else:
        bl = [pts[:, 0].min(), pts[:, 1].min()]
        tr = [pts[:, 0].max(), pts[:, 1].max()]
    kwargs = {"k": a.k, "p": a.p} if a.method == "idw" else {}
    write_interpolated_ndsm(a.out, pts, bl, tr, [a.pixel, a.pixel],
                            method=a.method, crs_epsg=a.epsg, **kwargs)
    print(f"{a.method} nDSM written to {a.out}")


if __name__ == "__main__":
    main()

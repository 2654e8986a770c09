"""Raster metric suite vs the ground-truth nDSM.

Parity: reference evaluator.py — mask handling with 2-px building dilation and
ternary type masks (:13-51), clipped residual statistics (:53-80),
max/min/MAE/RMSE/MedAE/median/NMAD/#pixels (:82-99), and the tabulated report
(:102-200).
"""

from __future__ import annotations

from collections import defaultdict
from datetime import datetime
from typing import Dict, Optional

import numpy as np

from tomosar2height_jax.geo.mask import dilate_mask
from tomosar2height_jax.geo.raster import RasterReader
from tomosar2height_jax.geo.transform import Affine


class DSMEvaluator:
    def __init__(
        self,
        gt_dsm_path: str,
        gt_mask_path: Optional[str] = None,
        other_mask_path_dict: Optional[Dict[str, str]] = None,
    ):
        self._gt_dsm_reader = RasterReader(gt_dsm_path)
        self.gt_dsm = self._gt_dsm_reader.get_data()

        self.gt_mask = (
            RasterReader(gt_mask_path).get_data().astype(bool)
            if gt_mask_path is not None
            else np.ones(self.gt_dsm.shape, dtype=bool)
        )

        self.other_mask: Optional[Dict[str, np.ndarray]] = None
        self.has_binary_building = False
        self.has_ternary_building = False

        if other_mask_path_dict:
            self.other_mask = {}
            if "building" in other_mask_path_dict:
                building = RasterReader(other_mask_path_dict["building"]).get_data().astype(bool)
                self.other_mask["building"] = dilate_mask(building, iterations=2)
                self.other_mask["terrain"] = ~self.other_mask["building"]
                self.has_binary_building = True
            if "type" in other_mask_path_dict:
                t = RasterReader(other_mask_path_dict["type"]).get_data()
                self.other_mask["non_building"] = t == 0
                self.other_mask["residential"] = dilate_mask(t == 1, iterations=2)
                self.other_mask["non_residential"] = dilate_mask(t == 2, iterations=2)
                self.other_mask["building_combined"] = dilate_mask(t > 0, iterations=2)
                self.has_ternary_building = True
            for key, path in other_mask_path_dict.items():
                if key not in ("building", "type"):
                    self.other_mask[key] = RasterReader(path).get_data().astype(bool)

    def eval(self, target_dsm: np.ndarray, T: Affine):
        """Compare a generated nDSM (with transform T) against the GT.

        Returns (stats dict per land type, residual array with NaN outside mask).
        """
        target_shape = target_dsm.shape
        tl = T * (0, 0)
        cr = np.floor((~self._gt_dsm_reader.T).apply(np.array([tl]))).astype(int)
        l_col, t_row = cr[0, 0], cr[0, 1]

        gt_clip = self.gt_dsm[t_row:t_row + target_shape[0], l_col:l_col + target_shape[1]]
        mask_clip = self.gt_mask[t_row:t_row + target_shape[0], l_col:l_col + target_shape[1]]

        residuals = target_dsm - gt_clip
        r = residuals[mask_clip]
        r = r[~np.isnan(r)]

        stats = defaultdict(dict)
        stats["overall"] = self.calculate_statistics(r)

        if self.other_mask:
            for land_type, mask in self.other_mask.items():
                mclip = mask[t_row:t_row + target_shape[0], l_col:l_col + target_shape[1]]
                lm = mask_clip & mclip
                lr = residuals[lm]
                lr = lr[~np.isnan(lr)]
                stats[land_type] = self.calculate_statistics(lr)

        diff = residuals * mask_clip
        diff[~mask_clip] = np.nan
        return stats, diff

    @staticmethod
    def calculate_statistics(residual: np.ndarray) -> Dict:
        """Reference evaluator.py:82-99 (incl. NMAD = 1.4826 * MAD)."""
        if residual.size > 0:
            a = np.abs(residual)
            return {
                "max": float(np.max(residual)),
                "min": float(np.min(residual)),
                "MAE": float(np.mean(a)),
                "RMSE": float(np.sqrt(np.mean(residual ** 2))),
                "abs_median": float(np.median(a)),
                "median": float(np.median(residual)),
                "n_pixel": int(residual.size),
                "NMAD": float(1.4826 * np.median(np.abs(residual - np.median(residual)))),
            }
        return {k: None for k in
                ("max", "min", "MAE", "RMSE", "abs_median", "median", "n_pixel", "NMAD")}


def _afterpoint(cell: str) -> int:
    """Digits after the decimal point (-1 for none), for decimal alignment."""
    pos = cell.rfind(".")
    if pos < 0:
        pos = cell.lower().rfind("e")
    return len(cell) - pos - 1 if pos >= 0 and cell.strip() else -1


def tabulate(rows, headers, floatfmt: str = ".4f") -> str:
    """A "simple" plain-text table: header, dashes, rows; text columns
    left-aligned, number columns right-aligned on the decimal point, each
    column at least two wider than its header; None prints empty and
    trailing blanks are cut."""
    columns = []
    for i, header in enumerate(headers):
        values = [row[i] for row in rows]
        known = [v for v in values if v is not None]
        numeric = bool(known) and all(
            isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool) for v in known)
        as_int = numeric and all(isinstance(v, (int, np.integer)) for v in known)
        cells = ["" if v is None else str(int(v)) if as_int
                 else format(float(v), floatfmt) if numeric else str(v)
                 for v in values]
        if numeric:
            decimals = [_afterpoint(c) for c in cells]
            cells = [c + " " * (max(decimals) - d) for c, d in zip(cells, decimals)]
        width = max([len(header) + 2] + [len(c) for c in cells])
        align = str.rjust if numeric else str.ljust
        columns.append([align(header, width), "-" * width]
                       + [align(c, width) for c in cells])
    return "\n".join("  ".join(line).rstrip() for line in zip(*columns))


def print_statistics(
    statistics: Dict,
    title: str,
    save_to: Optional[str] = None,
    has_binary: bool = False,
    has_ternary: bool = False,
) -> str:
    """Tabulated evaluation report (reference evaluator.py:102-200)."""
    metrics = {
        "MAE[m]": "MAE", "RMSE[m]": "RMSE", "MedAE[m]": "abs_median",
        "Max[m]": "max", "Min[m]": "min", "Median[m]": "median",
        "NMAD[m]": "NMAD", "#Pixels": "n_pixel",
    }
    header = ["Type"] + list(metrics.keys())
    output = [
        "DSM Evaluation\t\t\tcreated: " + datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        title,
        "Performance Evaluation",
        "=" * 30,
    ]

    def rows(keys, display):
        content = []
        for key in keys:
            if key in statistics:
                content.append([display[key]] + [statistics[key][metrics[m]] for m in header[1:]])
        return content

    if has_binary:
        content = rows(["overall", "terrain", "building"],
                       {"overall": "Overall", "terrain": "Terrain", "building": "Building"})
        if content:
            output += ["", "Binary Building Classification:",
                       tabulate(content, header)]
    if has_ternary:
        content = rows(["residential", "non_residential"],
                       {"residential": "Residential", "non_residential": "Non Residential"})
        if content:
            output += ["", "Building Type Classification:",
                       tabulate(content, header)]

    processed = {"overall", "building", "terrain", "residential", "non_residential",
                 "non_building", "building_combined"}
    other = [[k.replace("_", " ").title()] + [v[metrics[m]] for m in header[1:]]
             for k, v in statistics.items() if k not in processed]
    if other:
        output += ["", "Other Classifications:",
                   tabulate(other, header)]

    output += [
        "",
        "-" * 30,
        """ Metrics:
        MAE: Mean Absolute residual Error
        RMSE: Root Mean Square Error
        MedAE: Median Absolute Error
        Max / Min / Median: residual extrema and median
        NMAD: Normalised Median Absolute Deviation
        #pixels: Number of pixels
        """,
    ]
    result = "\n".join(output)
    if save_to:
        with open(save_to, "w+") as f:
            f.write(result)
    return result

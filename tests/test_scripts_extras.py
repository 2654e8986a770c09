"""extract_las + compute_std script tests (pure host, no jax)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from tomosar2height_jax.geo.cloud import load_pc, save_las


class TestExtractLas:
    def test_per_building_extraction(self, tmp_path, rng):
        import extract_las as el

        # a square building at [10, 20]^2, height 30
        obj = tmp_path / "objs" / "b1.obj"
        os.makedirs(obj.parent)
        verts = [(10, 10, 0), (20, 10, 0), (20, 20, 0), (10, 20, 0),
                 (10, 10, 30), (20, 10, 30), (20, 20, 30), (10, 20, 30)]
        with open(obj, "w") as f:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")

        cloud = np.concatenate([
            rng.uniform([11, 11, 25], [19, 19, 32], (500, 3)),   # on the roof
            rng.uniform([40, 40, 0], [60, 60, 5], (500, 3)),     # far away
        ])
        cloud_path = str(tmp_path / "city.las")
        save_las(cloud_path, cloud)

        out_dir = str(tmp_path / "out")
        os.makedirs(out_dir)
        name, n = el.extract_one((str(obj), load_pc(cloud_path), out_dir, 2.0))
        assert name == "b1"
        assert n == 500  # roof points only (buffer 2 m doesn't reach the far blob)
        back = load_pc(os.path.join(out_dir, "b1.las"))
        assert back.shape == (500, 3)
        assert back[:, 0].min() > 8 and back[:, 0].max() < 22

    def test_buffer_expands_footprint(self, tmp_path, rng):
        import extract_las as el

        verts = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0]], dtype=float)
        poly = el.footprint_hull(verts, buffer_m=2.0)
        # buffered corners extend beyond the original bbox
        assert poly[:, 0].min() < 0 and poly[:, 0].max() > 10

    def test_point_in_polygon(self):
        import extract_las as el

        poly = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], dtype=float)  # CCW
        pts = np.array([[2, 2], [5, 2], [-1, -1], [3.9, 3.9]])
        mask = el.points_in_convex_polygon(pts, poly)
        assert mask.tolist() == [True, False, False, True]


class TestComputeStd:
    def test_robust_std(self, rng):
        import compute_std as cs

        z = rng.normal(0, 2.0, 100000)
        pts = np.stack([np.zeros_like(z), np.zeros_like(z), z], axis=1)
        pts[0, 2] = 1e6  # gross outlier excluded by the 5-95 pct window
        s = cs.robust_z_std(pts)
        assert 1.0 < s < 2.0  # clipped std of a clipped normal < sigma

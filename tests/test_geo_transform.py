import math

import numpy as np
import pytest

from tomosar2height_jax.geo import (
    Affine,
    apply_transform,
    invert_transform,
    stack_transforms,
    coordinate2index,
    make_3d_grid,
    crop_pc_2d,
    crop_pc_2d_index,
    crop_pc_3d,
    dilate_mask,
    ROT_MATRICES,
    FLIP_MATRICES,
)


class TestAffine:
    def test_from_origin_and_apply(self):
        T = Affine.from_origin(100.0, 500.0, 2.0, 2.0)
        # pixel (0, 0) top-left corner
        assert T * (0, 0) == (100.0, 500.0)
        # pixel center query: col=1.5, row=2.5
        x, y = T * (1.5, 2.5)
        assert x == 103.0 and y == 495.0

    def test_invert_roundtrip(self):
        T = Affine(2.0, 0.0, 100.0, 0.0, -2.0, 500.0)
        Ti = ~T
        xy = np.array([[104.0, 492.0], [100.0, 500.0]])
        cr = Ti.apply(xy)
        np.testing.assert_allclose(T.apply(cr), xy, atol=1e-9)

    def test_floor_query_semantics(self):
        # matches reference io_raster.py:128-131: floor(T_inv * xy)
        T = Affine.from_origin(0.0, 10.0, 1.0, 1.0)
        Ti = ~T
        col, row = np.floor(Ti.apply(np.array([[3.7, 8.2]]))[0]).astype(int)
        assert (col, row) == (3, 1)

    def test_compose(self):
        A = Affine(2.0, 0.0, 1.0, 0.0, 2.0, -1.0)
        B = Affine(1.0, 0.0, 5.0, 0.0, 1.0, 5.0)
        C = A * B
        assert C * (0, 0) == (A * (B * (0, 0)))


class TestCoordinate2Index:
    def test_matches_reference_formula(self):
        # reference utils/coordinate.py:12-28 with reso=2 and the smoke points
        # from pointnet.py:114-123
        pts = np.array([[[0.0, 0.0], [0.3, 0.9], [0.9, 0.3], [0.9, 0.9], [0.1, 0.2]]])
        idx = coordinate2index(pts, 2)
        assert idx.shape == (1, 1, 5)
        np.testing.assert_array_equal(idx[0, 0], [0, 2, 1, 3, 0])

    def test_truncation(self):
        pts = np.array([[[0.999, 0.0]]])
        assert coordinate2index(pts, 256)[0, 0, 0] == 255


class TestHomogeneous:
    def test_apply_invert(self, rng):
        M = np.eye(4)
        M[:3, :3] = ROT_MATRICES[1][:3, :3]
        M[:3, 3] = [1.0, 2.0, 3.0]
        pts = rng.normal(size=(10, 3))
        out = apply_transform(pts, M)
        back = apply_transform(out, invert_transform(M))
        np.testing.assert_allclose(back, pts, atol=1e-12)

    def test_rotation_90cw(self):
        # -90° about z: (1, 0) -> (0, -1)
        out = apply_transform(np.array([[1.0, 0.0, 0.0]]), ROT_MATRICES[1])
        np.testing.assert_allclose(out, [[0.0, -1.0, 0.0]], atol=1e-12)

    def test_flip_x(self):
        out = apply_transform(np.array([[1.0, 2.0, 3.0]]), FLIP_MATRICES[0])
        np.testing.assert_allclose(out, [[-1.0, 2.0, 3.0]], atol=1e-12)

    def test_flip_identity(self):
        out = apply_transform(np.array([[1.0, 2.0, 3.0]]), FLIP_MATRICES[-1])
        np.testing.assert_allclose(out, [[1.0, 2.0, 3.0]])

    def test_stack(self):
        M = stack_transforms([ROT_MATRICES[1], ROT_MATRICES[1]])
        np.testing.assert_allclose(M, ROT_MATRICES[2], atol=1e-12)

    def test_rot_matches_reference_convention(self):
        # rot_mat_dic[k] is rotation by -k*90° about z (reference dataset.py:30-35)
        for k in range(4):
            ang = -k * math.pi / 2
            expect = np.eye(4)
            expect[0, 0] = expect[1, 1] = math.cos(ang)
            expect[0, 1] = -math.sin(ang)
            expect[1, 0] = math.sin(ang)
            np.testing.assert_allclose(ROT_MATRICES[k], expect, atol=1e-12)


class TestCrop:
    def test_crop_2d_strict(self):
        pts = np.array([[0.0, 0.5, 1.0], [0.5, 0.5, 2.0], [1.0, 0.5, 3.0]])
        out, idx = crop_pc_2d(pts, [0.0, 0.0], [1.0, 1.0])
        # strict inequalities: boundary points excluded (crop_cloud.py:22-27)
        assert out.shape == (1, 3)
        assert idx.tolist() == [1]

    def test_crop_3d_inclusive(self):
        pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [2.0, 0.0, 0.0]])
        out, idx = crop_pc_3d(pts, [0, 0, 0], [1, 1, 1])
        assert out.shape == (2, 3)


class TestDilate:
    def test_dilate(self):
        m = np.zeros((5, 5), dtype=bool)
        m[2, 2] = True
        d = dilate_mask(m, iterations=1)
        assert d.sum() == 5  # 4-connected cross
        d2 = dilate_mask(m, iterations=2)
        assert d2.sum() == 13


class TestMake3DGrid:
    def test_shape_and_ordering(self):
        g = make_3d_grid([0, 0, 0], [1, 1, 1], (2, 2, 2))
        assert g.shape == (8, 3)
        # z fastest, x slowest (reference coordinate.py:45-65)
        np.testing.assert_allclose(g[0], [0, 0, 0])
        np.testing.assert_allclose(g[1], [0, 0, 1])
        np.testing.assert_allclose(g[-1], [1, 1, 1])

"""ctypes bindings for the C++ host-runtime kernels (native/tomosar_native.cpp).

Builds the shared library on first use if missing/stale (g++ is in the image;
pybind11 is not — plain C ABI + ctypes). Every entry point has a numpy
fallback, and ``HAVE_NATIVE`` reports availability; correctness parity is
pinned by tests/test_native.py.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtomosar_native.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "tomosar_native.cpp")

_lib: Optional[ctypes.CDLL] = None
HAVE_NATIVE = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_i64_p = ctypes.POINTER(ctypes.c_int64)
_c_i32_p = ctypes.POINTER(ctypes.c_int32)


def _build() -> bool:
    if not os.path.exists(_SRC_PATH):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.warning("native build failed: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, HAVE_NATIVE
    if _lib is not None:
        return _lib
    stale = (
        not os.path.exists(_SO_PATH)
        or (os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_SO_PATH))
    )
    if stale and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.warning("native load failed: %s", e)
        return None

    lib.ts_crop_pc_2d.restype = ctypes.c_int64
    lib.ts_crop_pc_2d.argtypes = [_c_double_p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double, _c_i64_p]
    lib.ts_transform_points_f32.restype = None
    lib.ts_transform_points_f32.argtypes = [_c_double_p, ctypes.c_int64, _c_double_p, _c_float_p]
    lib.ts_crop_transform_patch.restype = ctypes.c_int64
    lib.ts_crop_transform_patch.argtypes = [_c_double_p, ctypes.c_int64,
                                            ctypes.c_double, ctypes.c_double,
                                            ctypes.c_double, ctypes.c_double,
                                            _c_double_p, _c_float_p]
    lib.ts_las_read.restype = ctypes.c_int64
    lib.ts_las_read.argtypes = [ctypes.c_char_p, _c_double_p]
    lib.ts_bucket_points.restype = None
    lib.ts_bucket_points.argtypes = [_c_float_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int32, _c_i32_p, _c_i64_p]
    lib.ts_max_z_grid.restype = None
    lib.ts_max_z_grid.argtypes = [_c_double_p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double,
                                  _c_float_p, ctypes.c_int64, ctypes.c_int64]
    lib.ts_blend_accumulate.restype = None
    lib.ts_blend_accumulate.argtypes = [_c_double_p, _c_double_p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        _c_double_p, _c_double_p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64]
    lib.ts_blend_accumulate_batch.restype = None
    lib.ts_blend_accumulate_batch.argtypes = [
        _c_double_p, _c_double_p, ctypes.c_int64, ctypes.c_int64,
        _c_double_p, _c_double_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _c_i64_p, _c_i64_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    _lib = lib
    HAVE_NATIVE = True
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ty):
    return arr.ctypes.data_as(ty)


def crop_pc_2d_index(points: np.ndarray, p_min, p_max) -> Optional[np.ndarray]:
    """Native strict-bbox crop; returns indices or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, stride = pts.shape[0], pts.shape[1]
    out = np.empty(n, dtype=np.int64)
    k = lib.ts_crop_pc_2d(_ptr(pts, _c_double_p), n, stride,
                          float(p_min[0]), float(p_min[1]),
                          float(p_max[0]), float(p_max[1]),
                          _ptr(out, _c_i64_p))
    return out[:k].copy()


def transform_points_f32(points: np.ndarray, m4: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    m = np.ascontiguousarray(m4, dtype=np.float64)
    out = np.empty((pts.shape[0], 3), dtype=np.float32)
    lib.ts_transform_points_f32(_ptr(pts, _c_double_p), pts.shape[0],
                                _ptr(m, _c_double_p), _ptr(out, _c_float_p))
    return out


def crop_transform_patch(points: np.ndarray, p_min, p_max, m4: np.ndarray) -> Optional[np.ndarray]:
    """Fused crop -> normalize -> unit-square recrop (the sampler hot path)."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    m = np.ascontiguousarray(m4, dtype=np.float64)
    out = np.empty((pts.shape[0], 3), dtype=np.float32)
    k = lib.ts_crop_transform_patch(_ptr(pts, _c_double_p), pts.shape[0],
                                    float(p_min[0]), float(p_min[1]),
                                    float(p_max[0]), float(p_max[1]),
                                    _ptr(m, _c_double_p), _ptr(out, _c_float_p))
    return out[:k].copy()


def las_read(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n = lib.ts_las_read(path.encode(), None)
    if n < 0:
        raise ValueError(f"native LAS read failed with code {n} for {path}")
    out = np.empty((n, 3), dtype=np.float64)
    n2 = lib.ts_las_read(path.encode(), _ptr(out, _c_double_p))
    if n2 != n:
        raise ValueError(f"native LAS read failed with code {n2} for {path}")
    return out


def bucket_points(points_xy: np.ndarray, reso: int):
    """(cells int32, order int64) — cell ids + cell-contiguous permutation."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points_xy, dtype=np.float32)
    n, stride = pts.shape[0], pts.shape[1]
    cells = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    lib.ts_bucket_points(_ptr(pts, _c_float_p), n, stride, reso,
                         _ptr(cells, _c_i32_p), _ptr(order, _c_i64_p))
    return cells, order


def max_z_grid(points: np.ndarray, bl, tr, pixel) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    rows = int(np.floor((tr[1] - bl[1]) / pixel[1]))
    cols = int(np.floor((tr[0] - bl[0]) / pixel[0]))
    grid = np.full((rows, cols), -np.inf, dtype=np.float32)
    lib.ts_max_z_grid(_ptr(pts, _c_double_p), pts.shape[0],
                      float(bl[0]), float(bl[1]), float(tr[0]), float(tr[1]),
                      float(pixel[0]), float(pixel[1]),
                      _ptr(grid, _c_float_p), rows, cols)
    return grid


def blend_accumulate(dsm: np.ndarray, weight: np.ndarray, patch: np.ndarray,
                     w: np.ndarray, row0: int, col0: int) -> bool:
    """In-place accumulate patch*w into dsm and w into weight at (row0, col0)."""
    lib = _load()
    if lib is None:
        return False
    assert dsm.dtype == np.float64 and dsm.flags.c_contiguous
    assert weight.dtype == np.float64 and weight.flags.c_contiguous
    p = np.ascontiguousarray(patch, dtype=np.float64)
    ww = np.ascontiguousarray(w, dtype=np.float64)
    lib.ts_blend_accumulate(_ptr(dsm, _c_double_p), _ptr(weight, _c_double_p),
                            dsm.shape[0], dsm.shape[1],
                            _ptr(p, _c_double_p), _ptr(ww, _c_double_p),
                            p.shape[0], p.shape[1], int(row0), int(col0))
    return True


def blend_accumulate_batch(dsm: np.ndarray, weight: np.ndarray,
                           patches: np.ndarray, w: np.ndarray,
                           rows0: np.ndarray, cols0: np.ndarray,
                           valid: np.ndarray, nthreads: int = 0) -> bool:
    """Blend a whole batch of patches in one threaded native call (threads
    partition the scene into row bands — overlap-safe; see the C++ notes)."""
    lib = _load()
    if lib is None:
        return False
    assert dsm.dtype == np.float64 and dsm.flags.c_contiguous
    assert weight.dtype == np.float64 and weight.flags.c_contiguous
    p = np.ascontiguousarray(patches, dtype=np.float64)
    ww = np.ascontiguousarray(w, dtype=np.float64)
    r0 = np.ascontiguousarray(rows0, dtype=np.int64)
    c0 = np.ascontiguousarray(cols0, dtype=np.int64)
    va = np.ascontiguousarray(valid, dtype=np.uint8)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    lib.ts_blend_accumulate_batch(
        _ptr(dsm, _c_double_p), _ptr(weight, _c_double_p),
        dsm.shape[0], dsm.shape[1],
        _ptr(p, _c_double_p), _ptr(ww, _c_double_p),
        p.shape[0], p.shape[1], p.shape[2],
        _ptr(r0, _c_i64_p), _ptr(c0, _c_i64_p),
        va.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(nthreads))
    return True

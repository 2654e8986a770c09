"""Affine-georeferenced raster data model (host, numpy).

API parity with reference utils/io_raster.py: ``RasterData`` (:12-149),
``RasterReader`` (:152-170), ``RasterWriter`` (:173-208) — band dict, T / T_inv
affine, col/row queries, ``cal_dsm_shape``, GeoTIFF read/write — backed by the
pure-numpy codec in :mod:`tomosar2height_jax.geo.tiff` instead of rasterio/GDAL.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Union

import numpy as np

from tomosar2height_jax.geo.tiff import read_tiff, write_tiff
from tomosar2height_jax.geo.transform import Affine

log = logging.getLogger(__name__)


class RasterData:
    """In-memory multi-band raster with an affine geo-transform.

    Bands are 1-indexed (GDAL convention), each a 2D numpy array.
    """

    def __init__(self):
        self._editable = True
        self._data: Dict[int, np.ndarray] = {}
        self._n_rows: Optional[int] = None
        self._n_cols: Optional[int] = None
        self.T: Optional[Affine] = None
        self.T_inv: Optional[Affine] = None
        self.pixel_size: Optional[List[float]] = None
        self.crs_epsg: Optional[int] = None
        self.nodata: Optional[float] = None
        self.tiff_file: Optional[str] = None

    # -- band data -------------------------------------------------------------

    def get_data(self, band: int = 1) -> Optional[np.ndarray]:
        """Copy of a band's array (parity: io_raster.py:25-30)."""
        out = self._data.get(band)
        return out.copy() if out is not None else None

    def set_data(self, data, band: int = 1):
        """Set a band (accepts numpy or anything np.asarray-able; io_raster.py:32-41)."""
        data = np.asarray(data)
        if self._is_shape_consistent({band: data}):
            self._data[band] = data
            self._n_rows, self._n_cols = data.shape
        else:
            log.warning("Cannot set data: shape inconsistent with existing bands.")

    def _is_shape_consistent(self, data_dict: Dict[int, np.ndarray]) -> bool:
        n_rows, n_cols = self._n_rows, self._n_cols
        for v in data_dict.values():
            h, w = v.shape
            if n_rows is None or n_cols is None:
                n_rows, n_cols = h, w
            elif (n_rows != h) or (n_cols != w):
                return False
        return True

    @property
    def shape(self):
        return (self._n_rows, self._n_cols)

    @property
    def count(self) -> int:
        return len(self._data)

    # -- geo-transform -----------------------------------------------------------

    def set_transform(self, bl_bound, tr_bound, pixel_size, crs_epsg):
        """North-up transform from bottom-left / top-right bounds (io_raster.py:56-66)."""
        if not self._editable:
            log.warning("Cannot edit this RasterData.")
            return
        self.pixel_size = list(np.asarray(pixel_size, dtype=np.float64))
        self.T = Affine(
            self.pixel_size[0], 0.0, float(bl_bound[0]),
            0.0, -self.pixel_size[1], float(tr_bound[1]),
        )
        self.T_inv = ~self.T
        self.crs_epsg = int(crs_epsg) if crs_epsg is not None else None

    def set_transform_from(self, target: "RasterData"):
        """Copy transform from another raster (io_raster.py:68-75)."""
        if not self._editable:
            log.warning("Cannot edit this RasterData.")
            return
        self.pixel_size = target.pixel_size
        self.T = target.T
        self.T_inv = target.T_inv
        self.crs_epsg = target.crs_epsg

    @staticmethod
    def cal_dsm_shape(bl_bound, tr_bound, pixel_size):
        """Raster (rows, cols) covering the bbox at the pixel size (io_raster.py:77-95)."""
        bl = np.asarray(bl_bound, dtype=np.float64)
        tr = np.asarray(tr_bound, dtype=np.float64)
        ps = np.asarray(pixel_size, dtype=np.float64)
        n_rows = math.floor((tr[1] - bl[1]) / ps[1])
        n_cols = math.floor((tr[0] - bl[0]) / ps[0])
        return n_rows, n_cols

    def is_complete(self) -> bool:
        return (
            len(self._data) > 0
            and self._is_shape_consistent(self._data)
            and self._n_rows is not None
            and self._n_cols is not None
            and self.T is not None
            and self.T_inv is not None
        )

    # -- queries -----------------------------------------------------------------

    def query_col_row(self, x: float, y: float):
        """Geographic (x, y) -> (col, row) integer pixel indices (io_raster.py:123-126)."""
        cols, rows = self.query_col_rows(np.array([[x, y]], dtype=np.float64))
        return cols[0], rows[0]

    def query_col_rows(self, xy_arr: np.ndarray):
        """Vectorized coordinate->index query with floor semantics (io_raster.py:128-131)."""
        cr = self.T_inv.apply(np.asarray(xy_arr, dtype=np.float64))
        cr = np.floor(cr).astype(int)
        return cr[:, 0], cr[:, 1]

    def is_in(self, col, row, band: int = 1) -> Union[bool, np.ndarray]:
        """Bounds check for scalar or array indices (io_raster.py:109-121)."""
        shape = self._data[band].shape
        if isinstance(col, (int, np.integer)) and isinstance(row, (int, np.integer)):
            return bool(0 <= row < shape[0] and 0 <= col < shape[1])
        col = np.asarray(col)
        row = np.asarray(row)
        return (0 <= row) & (row < shape[0]) & (0 <= col) & (col < shape[1])

    def query_value(self, x: float, y: float, band: int = 1):
        col, row = self.query_col_row(x, y)
        if self.is_in(col, row, band):
            return self._data[band][row, col]
        return None

    def query_values(self, xy_arr: np.ndarray, band: int = 1, outer_value=-99999):
        """Vectorized value query; out-of-bounds get ``outer_value`` (io_raster.py:133-143)."""
        cols, rows = self.query_col_rows(xy_arr)
        data = self._data[band]
        inside = self.is_in(cols, rows, band)
        pixels = np.full(xy_arr.shape[0], outer_value, dtype=data.dtype)
        pixels[inside] = data[rows[inside], cols[inside]]
        return pixels

    def query_value_3d_points(self, points: np.ndarray, band: int = 1, outer_value=0):
        if points.shape[0] == 0:
            return np.empty(0)
        return self.query_values(points[:, :2], band, outer_value)


class RasterReader(RasterData):
    """Loads all bands of a GeoTIFF into RAM on construction (io_raster.py:152-170)."""

    def __init__(self, tiff_file: str):
        super().__init__()
        self.tiff_file = tiff_file
        data, info = read_tiff(tiff_file)
        self._data = {i + 1: data[i] for i in range(data.shape[0])}
        self._n_rows, self._n_cols = data.shape[1], data.shape[2]
        a, b, c, d, e, f = info.transform
        self.T = Affine(a, b, c, d, e, f)
        self.T_inv = ~self.T
        self.pixel_size = [self.T.a, -self.T.e]
        self.crs_epsg = info.crs_epsg
        self.nodata = info.nodata
        self._editable = False

    @property
    def height(self) -> int:
        return self._n_rows

    @property
    def width(self) -> int:
        return self._n_cols

    def index(self, x: float, y: float):
        """(row, col) of the pixel containing (x, y) — rasterio DatasetReader.index parity."""
        col, row = self.query_col_row(x, y)
        return row, col

    def read_window(self, row_slice, col_slice, band: int = 1) -> np.ndarray:
        """Windowed read from the in-RAM band (capability parity with rasterio windows
        as used in reference scripts/build_dataset.py:154-158)."""
        return self._data[band][row_slice[0]:row_slice[1], col_slice[0]:col_slice[1]].copy()


class RasterWriter(RasterData):
    """GeoTIFF writer wrapping an existing RasterData (io_raster.py:173-208)."""

    def __init__(self, raster_data: RasterData, dtypes="float32"):
        super().__init__()
        self.__dict__.update(raster_data.__dict__)
        self.dtypes = dtypes

    def write_to_file(self, filename: str, compress: Optional[str] = None) -> bool:
        if not self.is_complete():
            log.warning("RasterData is not complete, cannot write to TIFF file.")
            return False
        self.tiff_file = filename
        bands = np.stack(
            [np.asarray(self._data[c], dtype=np.float32) for c in sorted(self._data)], axis=0
        )
        write_tiff(
            filename,
            bands,
            transform=self.T.coefficients(),
            crs_epsg=self.crs_epsg,
            nodata=self.nodata,
            compress=compress,
            dtype=np.float32,
        )
        return True

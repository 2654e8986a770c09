"""Sliding-window full-scene nDSM generation with linear-blend stitching.

Parity: reference generator.py:15-165 — scene raster from the union of chunk
bounds, per-patch model forward, row un-flip back to north-up, linear ramp
blend weights (min 1e-3) accumulated in float64, final divide + clamp >= 0,
GeoTIFF write.

Design: patches run in *batches* through one jitted forward (the
reference forces batch_size 1, generator.py:44); device compute is f32, the
geo accumulation stays host-side float64 numpy (SURVEY.md §7 hard part 3).

Multi-chip: batches shard over the mesh 'data' axis (SURVEY.md §2.3(b) —
sliding-window patches are embarrassingly parallel), params replicate, and the
host blends the gathered patch rasters. Device dispatch is async: each batch's
forward is issued before the previous batch's host blend runs, overlapping
device compute with the float64 stitch. With ``device_blend=True`` the mesh path
instead keeps one PARTIAL scene raster per chip (shard_map; zero cross-chip
traffic per step) and folds them in a single collective at finalize.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Optional

import jax
import numpy as np

from tomosar2height_jax.geo.raster import RasterData, RasterWriter

log = logging.getLogger(__name__)


def linear_blend_weight(grid_shape_2d, half_blend_percent) -> np.ndarray:
    """Separable linear ramp weights for overlap blending
    (reference generator.py:85-113; MIN_WEIGHT 1e-3, float64)."""
    assert 0 <= half_blend_percent[0] <= 0.5, "Blend percent X should be between 0 and 0.5."
    assert 0 <= half_blend_percent[1] <= 0.5, "Blend percent Y should be between 0 and 0.5."
    MIN_WEIGHT = 1e-3
    wx = np.ones(grid_shape_2d, dtype=np.float64)
    wy = np.ones(grid_shape_2d, dtype=np.float64)
    idx_x = math.floor(grid_shape_2d[0] * half_blend_percent[0])
    idx_y = math.floor(grid_shape_2d[1] * half_blend_percent[1])
    if idx_x > 0:
        ramp = np.linspace(MIN_WEIGHT, 1, idx_x)
        wx[:, :idx_x] = ramp[None, :]
        wx[:, -idx_x:] = ramp[::-1][None, :]
    if idx_y > 0:
        ramp = np.linspace(MIN_WEIGHT, 1, idx_y)
        wy[:idx_y, :] = ramp[:, None]
        wy[-idx_y:, :] = ramp[::-1][:, None]
    return wx * wy


class DSMGenerator:
    """Full-scene nDSM generator over a sliding-window PatchLoader."""

    NODATA_VALUE = np.nan

    def __init__(
        self,
        model,
        params_fn,
        data_loader,
        dsm_pixel_size,
        half_blend_percent=None,
        crs_epsg: Optional[int] = 25832,
        use_cloud: bool = True,
        use_image: bool = True,
        mesh=None,
        pipeline_depth: int = 3,
        device_blend: bool = False,
        wire_dtype: str = "float32",
        wire_cells: str = "device",
        blend_loop: str = "unroll",
    ):
        """
        Args:
            model: the flax module.
            params_fn: zero-arg callable returning current params (so the
                generator always sees the live training params — reference
                passes the mutable torch module instead).
            data_loader: PatchLoader over the 'vis'/'test' split (regular patching).
            mesh: optional jax.sharding.Mesh; batches shard over its 'data'
                axis (batch size must be divisible by the mesh size). None =
                single-device.
        """
        self.model = model
        self.params_fn = params_fn
        self.data_loader = data_loader
        self.pixel_size = np.asarray(dsm_pixel_size, dtype=np.float64)
        self.half_blend_percent = list(half_blend_percent or [0.5, 0.5])
        self.crs_epsg = crs_epsg
        self.use_cloud = use_cloud
        self.use_image = use_image

        dataset = data_loader.dataset
        assert not dataset.random_sample, "Only regular patching is accepted."
        self.patch_size = np.asarray(dataset.patch_size, dtype=np.float64)
        # uint8 image wire (dataset satellite_image.wire): crops arrive as raw
        # u8 pixels (4x less upload) and normalize on device inside the jit
        self._image_norm = getattr(dataset, "image_norm", None)
        # device-crop image wire (dataset satellite_image.crop='device'): the
        # scene image is STATIC across tiles, so it uploads to the device
        # exactly once and each tile ships only a (row0, col0) origin — the
        # jitted forward dynamic-slices its own crops. Removes the largest
        # cloud+image upload (0.8-3 MB/tile vs ~130 KB of points).
        self._device_image = bool(use_image and
                                  getattr(dataset, "image_crop_device", False))
        self._scene_dev = None
        if self._device_image:
            self._img_hw = (int(dataset._image_patch_shape[0]),
                            int(dataset._image_patch_shape[1]))

        self._calculate_bounds(dataset.chunk_info_ls)
        self.dsm_shape = RasterData.cal_dsm_shape(
            [self.l_bound, self.b_bound], [self.r_bound, self.t_bound], self.pixel_size
        )
        grid_shape = np.round(self.patch_size / self.pixel_size).astype(int)
        self.patch_weight = linear_blend_weight(
            (int(grid_shape[0]), int(grid_shape[1])), self.half_blend_percent
        )

        self.last_stats = None  # phase breakdown of the last generate_dsm
        # how many batches of device work stay in flight ahead of the host
        # blend; >1 hides the device time AND the per-fetch round trip
        # behind the float64 stitch of earlier batches
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.mesh = mesh
        if mesh is not None:
            bs = data_loader.batch_size
            assert bs % mesh.size == 0, (
                f"batch size {bs} not divisible by mesh size {mesh.size}")
        # device-side blend: accumulate weighted patches into scene rasters ON
        # the device and fetch ONE stitched raster per scene — removes the
        # per-patch device->host transfer (~1 MB/patch). f32 accumulation
        # instead of the host path's f64 (sums of <= a few dozen overlapping
        # weighted patches — sub-mm effect); host f64 stays the parity
        # default. Multi-device: each device accumulates a PARTIAL scene
        # raster for its own patch shard (shard_map over the 'data' axis);
        # partials cross devices exactly once, summed inside the finalize
        # program.
        self.device_blend = bool(device_blend)
        # wire format of the stitched-raster download: float16 halves the
        # device->host transfer; quantization is <= ~5 cm at 100 m heights —
        # serving-grade, not the parity default.
        self.wire_dtype = np.dtype(wire_dtype)
        # 'device': skip uploading the (B, Npad) int32 Morton cell ids — the
        # model recomputes them bit-exactly from points+mask on device
        # (models/pointnet.py wire-slim path; same default as the trainer's
        # training.wire_cells). Cells are ~24% of a cloud patch's upload
        # bytes on the sorted path.
        if wire_cells not in ("device", "host"):
            raise ValueError(f"Invalid wire_cells: {wire_cells}")
        self.wire_cells = wire_cells
        # device-blend accumulation loop over the batch: 'unroll' emits B
        # dynamic-slice read-modify-writes (overlapping patches must
        # serialize either way); 'scan' rolls them into one lax.scan body —
        # program size constant in B instead of linear.
        if blend_loop not in ("unroll", "scan"):
            raise ValueError(f"Invalid blend_loop: {blend_loop}")
        self.blend_loop = blend_loop
        self._band_fns = {}  # (r0, r1) -> jitted band finalize
        self._forward = jax.jit(self._forward_impl)
        import jax.numpy as jnp

        wdt = jnp.float16 if self.wire_dtype == np.float16 else jnp.float32
        if self.device_blend and mesh is not None:
            self._blend_step = self._make_sharded_blend_step()
        else:
            self._blend_step = jax.jit(self._blend_step_impl,
                                       donate_argnums=(0, 1))
        # finalize folds the per-device partials (leading dim, when present)
        # before the divide — under a mesh XLA lowers the fold to ONE
        # cross-device reduction of the scene raster

        def _finalize(d, w):
            if d.ndim == 3:
                d, w = jnp.sum(d, 0), jnp.sum(w, 0)
            return jnp.where(w > 0, jnp.maximum(d / w, 0.0),
                             jnp.nan).astype(wdt)

        self._blend_finalize = jax.jit(_finalize)

    def _blend_step_impl(self, dsm_dev, wgt_dev, params, points, mask, image,
                         cells, offsets, rows0, cols0, valid,
                         scene=None, origins=None):
        """Forward one batch and blend-accumulate it into the on-device scene
        rasters (unrolled over the static batch dim; read-modify-write of a
        patch-sized window per entry)."""
        import jax.numpy as jnp

        h = self._forward_impl(params, points, mask, image, cells, offsets,
                               scene, origins)
        pw = jnp.asarray(self.patch_weight, jnp.float32)
        ph, pwid = pw.shape

        def rmw(dsm, wgt, hi, r0, c0, v):
            contrib = hi.astype(jnp.float32) * pw * v
            win = jax.lax.dynamic_slice(dsm, (r0, c0), (ph, pwid))
            dsm = jax.lax.dynamic_update_slice(dsm, win + contrib, (r0, c0))
            wwin = jax.lax.dynamic_slice(wgt, (r0, c0), (ph, pwid))
            wgt = jax.lax.dynamic_update_slice(wgt, wwin + pw * v, (r0, c0))
            return dsm, wgt

        if self.blend_loop == "scan":
            def body(carry, x):
                return rmw(*carry, *x), None

            (dsm_dev, wgt_dev), _ = jax.lax.scan(
                body, (dsm_dev, wgt_dev), (h, rows0, cols0, valid))
        else:
            for i in range(h.shape[0]):
                dsm_dev, wgt_dev = rmw(dsm_dev, wgt_dev, h[i],
                                       rows0[i], cols0[i], valid[i])
        return dsm_dev, wgt_dev

    def _make_sharded_blend_step(self):
        """Multi-chip blend step: shard_map over the 'data' axis.

        Scene accumulators carry a leading per-device dim (N, H, W) sharded
        over the mesh; each device forwards and blends only ITS batch shard
        into its own partial raster — zero cross-chip traffic per step. The
        partials meet once, inside the finalize program's leading-dim sum
        (reference hot path generator.py:130-159 fetches every patch; here a
        scene crosses the wire exactly once regardless of chip count).
        """
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from tomosar2height_jax.parallel.mesh import DATA_AXIS

        def local_step(dsm, wgt, params, points, mask, image, cells, offsets,
                       rows0, cols0, valid, scene, origins):
            d, w = self._blend_step_impl(dsm[0], wgt[0], params, points, mask,
                                         image, cells, offsets, rows0, cols0,
                                         valid, scene, origins)
            return d[None], w[None]

        b = P(DATA_AXIS)
        # scene image (device-crop wire) replicates; everything batched shards
        fn = shard_map(
            local_step, mesh=self.mesh,
            in_specs=(b, b, P(), b, b, b, b, b, b, b, b, P(), b),
            out_specs=(b, b), check_vma=False)
        return jax.jit(fn, donate_argnums=(0, 1))

    def _calculate_bounds(self, chunk_info_ls):
        """Scene bbox = union of chunk bounds (reference generator.py:61-72)."""
        self.l_bound = self.b_bound = np.inf
        self.r_bound = self.t_bound = -np.inf
        for info in chunk_info_ls:
            l, b = info["min_bound"][:2]
            r, t = info["max_bound"][:2]
            self.l_bound = min(self.l_bound, l)
            self.b_bound = min(self.b_bound, b)
            self.r_bound = max(self.r_bound, r)
            self.t_bound = max(self.t_bound, t)

    def _forward_impl(self, params, points, mask, image, cells, offsets,
                      scene=None, origins=None):
        if scene is not None:
            # device-crop wire: slice each tile's crop out of the resident
            # scene image; [::-1] flips rows to y-up — together bit-identical
            # to the host crop (dataset.py image branch). B static slices
            # (B <= 16) beat a batched gather here.
            import jax.numpy as jnp

            h, w = self._img_hw
            c = scene.shape[-1]
            image = jnp.stack([
                jax.lax.dynamic_slice(scene, (origins[i, 0], origins[i, 1], 0),
                                      (h, w, c))
                for i in range(origins.shape[0])
            ])[:, ::-1]
        if image is not None and self._image_norm is not None:
            import jax.numpy as jnp

            mean, std = self._image_norm
            image = (image.astype(jnp.float32) - mean) / std
        pa, _ = self.model.apply(params, points, mask, image, cells, offsets)
        # un-flip rows: model works y-up, raster is north-up (generator.py:147)
        return pa[..., 0][:, ::-1, :]

    def _scene_device(self):
        """The resident scene image: device_put ONCE (replicated under a
        mesh), reused by every dispatch of every generate call."""
        if self._scene_dev is None:
            scene = self.data_loader.dataset.scene_image_hwc()
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                self._scene_dev = jax.device_put(
                    scene, NamedSharding(self.mesh, P()))
            else:
                self._scene_dev = jax.device_put(scene)
        return self._scene_dev

    def _dispatch(self, params, batch):
        """Issue one batch's forward (async); inputs shard over the mesh."""
        keys = ["points", "point_mask", "image", "cell", "cell_offsets",
                "image_origin"]
        if self.wire_cells == "device" and "cell_offsets" in batch:
            keys.remove("cell")  # recomputed on device from points+mask
        dev = {k: batch[k] for k in keys if k in batch}
        if self.mesh is not None:
            from tomosar2height_jax.parallel.mesh import shard_batch

            dev = shard_batch(dev, self.mesh)
        points = dev.get("points") if self.use_cloud else None
        mask = dev.get("point_mask") if self.use_cloud else None
        image = dev.get("image") if self.use_image else None
        cells = dev.get("cell") if self.use_cloud else None
        offsets = dev.get("cell_offsets") if self.use_cloud else None
        scene = origins = None
        if self._device_image:
            scene = self._scene_device()
            origins = dev.get("image_origin")
        return self._forward(params, points, mask, image, cells, offsets,
                             scene, origins)

    def _blend_batch(self, tiff_data, dsm_acc, weight_acc, h_grids, batch) -> int:
        """Blend-accumulate one batch of fetched patch rasters on host (one
        threaded native call banded over the scene; per-patch fallback).
        Returns the number of valid patches blended."""
        from tomosar2height_jax import native

        pw = self.patch_weight
        b = h_grids.shape[0]
        valid = np.asarray(batch["patch_valid"], dtype=bool)
        rows0 = np.zeros(b, dtype=np.int64)
        cols0 = np.zeros(b, dtype=np.int64)
        for i in range(b):
            if not valid[i]:
                continue
            min_c = batch["min_bound"][i] + self.pixel_size / 2.0
            l_col, _ = tiff_data.query_col_row(min_c[0], min_c[1])
            max_c = batch["max_bound"][i] - self.pixel_size / 2.0
            _, t_row = tiff_data.query_col_row(max_c[0], max_c[1])
            rows0[i], cols0[i] = t_row, l_col
        if native.blend_accumulate_batch(dsm_acc, weight_acc, h_grids, pw,
                                         rows0, cols0, valid):
            return int(valid.sum())
        n_patches = 0
        for i in range(b):
            if not valid[i]:
                continue
            n_patches += 1
            t_row, l_col = int(rows0[i]), int(cols0[i])
            if not native.blend_accumulate(dsm_acc, weight_acc, h_grids[i], pw,
                                           t_row, l_col):
                ph, pwid = h_grids[i].shape
                dsm_acc[t_row:t_row + ph, l_col:l_col + pwid] += h_grids[i] * pw
                weight_acc[t_row:t_row + ph, l_col:l_col + pwid] += pw
        return n_patches

    def _patch_origins(self, tiff_data, batch):
        """Host-side f64 geo math: scene raster (row, col) origin per patch."""
        b = len(batch["patch_valid"])
        valid = np.asarray(batch["patch_valid"], dtype=bool)
        rows0 = np.zeros(b, dtype=np.int32)
        cols0 = np.zeros(b, dtype=np.int32)
        for i in range(b):
            if not valid[i]:
                continue
            min_c = batch["min_bound"][i] + self.pixel_size / 2.0
            l_col, _ = tiff_data.query_col_row(min_c[0], min_c[1])
            max_c = batch["max_bound"][i] - self.pixel_size / 2.0
            _, t_row = tiff_data.query_col_row(max_c[0], max_c[1])
            rows0[i], cols0[i] = t_row, l_col
        return rows0, cols0, valid

    def _band_plan(self, tiff_data):
        """Per-band last-touch batch index for early band fetch.

        The sliding-window sampler's anchors fully determine every patch's
        scene-raster footprint before any data loads, so the scene can be
        split into patch-height row bands and each band finalized + fetched
        the moment its last contributing batch has been blended — the
        stitched-raster download then overlaps remaining device compute
        instead of serializing after it. Returns ([(r0, r1)], last_touch) or None when patch origins
        aren't precomputable (random sampler / unknown loader shape).
        """
        ds = getattr(self.data_loader, "dataset", None)
        anchors = getattr(ds, "anchor_points", None)
        bsz = getattr(self.data_loader, "batch_size", None)
        if not anchors or bsz is None or getattr(ds, "random_sample", True):
            return None
        try:
            nb = len(self.data_loader)
        except TypeError:
            return None
        ph = int(self.patch_weight.shape[0])
        H = int(self.dsm_shape[0])
        band_h = ph
        nbands = max(1, -(-H // band_h))
        if nbands < 2:
            return None  # nothing to overlap
        patch_size = np.asarray(ds.patch_size, np.float64).reshape(-1)[:2]
        last = np.full(nbands, -1, dtype=np.int64)
        for j, a in enumerate(anchors):
            k = j // bsz
            if k >= nb:
                break
            mn = np.asarray(a["anchor"], np.float64)[:2]
            max_c = (mn + patch_size
                     - np.asarray(self.pixel_size).reshape(-1)[:2] / 2.0)
            _, t_row = tiff_data.query_col_row(max_c[0], max_c[1])
            # mirror lax.dynamic_update_slice's origin clamp in _blend_step
            r_eff = min(max(int(t_row), 0), max(H - ph, 0))
            b0 = r_eff // band_h
            b1 = min(r_eff + ph - 1, H - 1) // band_h
            for b in range(b0, min(b1, nbands - 1) + 1):
                last[b] = max(last[b], k)
        last[last < 0] = 0  # untouched bands: all-NaN, fetch immediately
        bands = [(b * band_h, min((b + 1) * band_h, H)) for b in range(nbands)]
        return bands, last

    def _finalize_band(self, dsm_dev, wgt_dev, r0, r1):
        """Jitted per-band finalize (static row range; one tiny program per
        distinct band shape, cached)."""
        fn = self._band_fns.get((r0, r1))
        if fn is None:
            import jax
            import jax.numpy as jnp

            wdt = jnp.float16 if self.wire_dtype == np.float16 else jnp.float32

            def impl(d, w):
                if d.ndim == 3:  # per-device partials: fold before the divide
                    ds = jnp.sum(
                        jax.lax.slice(d, (0, r0, 0),
                                      (d.shape[0], r1, d.shape[2])), 0)
                    ws = jnp.sum(
                        jax.lax.slice(w, (0, r0, 0),
                                      (w.shape[0], r1, w.shape[2])), 0)
                else:
                    ds = jax.lax.slice(d, (r0, 0), (r1, d.shape[1]))
                    ws = jax.lax.slice(w, (r0, 0), (r1, w.shape[1]))
                return jnp.where(ws > 0, jnp.maximum(ds / ws, 0.0),
                                 jnp.nan).astype(wdt)

            fn = jax.jit(impl)
            self._band_fns[(r0, r1)] = fn
        return fn(dsm_dev, wgt_dev)

    def _generate_dsm_device_blend(self, tiff_data, params, start):
        from concurrent.futures import ThreadPoolExecutor

        import jax.numpy as jnp

        t_loader = t_dispatch = 0.0
        h, w = int(self.dsm_shape[0]), int(self.dsm_shape[1])
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from tomosar2height_jax.parallel.mesh import DATA_AXIS, replicate

            params = replicate(params, self.mesh)
            shard = NamedSharding(self.mesh, P(DATA_AXIS))
            make_acc = jax.jit(
                lambda: jnp.zeros((self.mesh.size, h, w), jnp.float32),
                out_shardings=shard)
            dsm_dev = make_acc()
            wgt_dev = make_acc()
        else:
            dsm_dev = jnp.zeros((h, w), jnp.float32)
            wgt_dev = jnp.zeros((h, w), jnp.float32)
        n_patches = 0
        plan = self._band_plan(tiff_data)
        fetch_ex = ThreadPoolExecutor(max_workers=2) if plan else None
        band_futs = {}  # band idx -> Future[np.ndarray]
        k = 0
        it = iter(self.data_loader)
        # NOTE: batch tensors are passed to the jitted call as host numpy —
        # the jit runtime uploads all args with the call. An explicit
        # device_put-one-batch-ahead variant has not been timed on the GPU.
        while True:
            t0 = time.perf_counter()
            cur = next(it, None)
            t_loader += time.perf_counter() - t0
            if cur is None:
                break
            t0 = time.perf_counter()
            rows0, cols0, valid = self._patch_origins(tiff_data, cur)
            n_patches += int(valid.sum())
            if valid.any():  # all-invalid batches contribute nothing
                dsm_dev, wgt_dev = self._blend_step(
                    dsm_dev, wgt_dev, params,
                    cur.get("points") if self.use_cloud else None,
                    cur.get("point_mask") if self.use_cloud else None,
                    cur.get("image") if self.use_image else None,
                    (cur.get("cell") if self.use_cloud and
                     not (self.wire_cells == "device" and "cell_offsets" in cur)
                     else None),
                    cur.get("cell_offsets") if self.use_cloud else None,
                    rows0, cols0, valid.astype(np.float32),
                    self._scene_device() if self._device_image else None,
                    cur.get("image_origin") if self._device_image else None)
            # band finalize runs even for skipped batches: the plan's
            # last-touch indices must fire on schedule
            if plan is not None:
                # bands whose last contributing batch just blended: finalize
                # on device and fetch on a thread, overlapping the wire
                # transfer with the remaining batches' compute
                bands, lastk = plan
                for b in np.nonzero(lastk == k)[0]:
                    r0, r1 = bands[b]
                    arr = self._finalize_band(dsm_dev, wgt_dev, int(r0), int(r1))
                    band_futs[int(b)] = fetch_ex.submit(np.asarray, arr)
            k += 1
            t_dispatch += time.perf_counter() - t0
        if plan is not None:
            bands, lastk = plan
            t0 = time.perf_counter()
            # bands the plan scheduled past the actual batch count (loader
            # yielded fewer batches) finalize now
            for b in range(len(bands)):
                if b not in band_futs:
                    r0, r1 = bands[b]
                    arr = self._finalize_band(dsm_dev, wgt_dev, int(r0), int(r1))
                    band_futs[b] = fetch_ex.submit(np.asarray, arr)
            out = np.empty((h, w), dtype=self.wire_dtype)
            for b, fut in band_futs.items():
                r0, r1 = bands[b]
                out[r0:r1] = fut.result()
            fetch_ex.shutdown()
            t_drain = 0.0
            t_fetch = time.perf_counter() - t0  # residual (un-overlapped) wait
        else:
            # drain: a 4-byte fetch syncs the whole dependency chain,
            # separating device compute from the stitched-raster transfer
            t0 = time.perf_counter()
            float(jnp.max(wgt_dev[:1, :1]))
            t_drain = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = np.asarray(self._blend_finalize(dsm_dev, wgt_dev))
            t_fetch = time.perf_counter() - t0  # ONE fetch per scene

        t0 = time.perf_counter()
        tiff_data.set_data(np.maximum(out.astype(np.float32), 0.0))
        writer = RasterWriter(tiff_data)
        writer.write_to_file(self._save_to)
        t_finalize = time.perf_counter() - t0
        total = time.time() - start
        self.last_stats = {
            "total_s": total, "n_patches": n_patches,
            "loader_s": t_loader, "dispatch_s": t_dispatch,
            "device_wait_blend_s": t_drain + t_fetch,
            "drain_s": t_drain, "fetch_wait_s": t_fetch,
            "blend_cpu_s": 0.0, "fetch_thread_s": t_fetch,
            "finalize_write_s": t_finalize,
            "patches_per_s": n_patches / total if total > 0 else 0.0,
        }
        log.info(
            "DSM Generation time: %.2f s (%d patches, %.2f tiles/s e2e "
            "device-blend; loader %.2f | dispatch %.2f | drain %.2f | "
            "raster fetch %.2f | write %.2f)",
            total, n_patches, self.last_stats["patches_per_s"],
            t_loader, t_dispatch, t_drain, t_fetch, t_finalize,
        )
        return writer

    def generate_dsm(self, save_to: str) -> RasterWriter:
        tiff_data = RasterData()
        tiff_data.set_transform(
            bl_bound=[self.l_bound, self.b_bound],
            tr_bound=[self.r_bound, self.t_bound],
            pixel_size=self.pixel_size,
            crs_epsg=self.crs_epsg,
        )
        if self.device_blend:
            self._save_to = save_to
            return self._generate_dsm_device_blend(tiff_data, self.params_fn(),
                                                   time.time())

        dsm_acc = np.zeros(self.dsm_shape, dtype=np.float64)
        weight_acc = np.zeros(self.dsm_shape, dtype=np.float64)
        params = self.params_fn()
        if self.mesh is not None:
            from tomosar2height_jax.parallel.mesh import replicate

            params = replicate(params, self.mesh)
        start = time.time()
        n_patches = 0
        # phase breakdown: loader wait / async dispatch /
        # device+fetch wait / f64 blend cpu / finalize + GeoTIFF write, seconds
        t_loader = t_dispatch = t_wait = t_blend = 0.0
        fetch_times = []

        # D-deep pipeline: keep `pipeline_depth` batches of async device work
        # in flight ahead of the host blend. Device->host transfers run in
        # FETCH THREADS submitted at dispatch time, so the round trip of
        # batch k+1 overlaps both the device compute of k+2.. and the f64
        # blend of batch k.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def _fetch(h_dev):
            t0 = time.perf_counter()
            arr = np.asarray(h_dev, dtype=np.float64)
            fetch_times.append(time.perf_counter() - t0)
            return arr

        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=2) as fetch_pool:
            it = iter(self.data_loader)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                t_loader += time.perf_counter() - t0
                if batch is None:
                    break
                t0 = time.perf_counter()
                h_dev = self._dispatch(params, batch)
                t_dispatch += time.perf_counter() - t0
                pending.append((fetch_pool.submit(_fetch, h_dev), batch))
                if len(pending) > self.pipeline_depth:
                    fut, b = pending.popleft()
                    t0 = time.perf_counter()
                    h = fut.result()
                    t_wait += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    n_patches += self._blend_batch(tiff_data, dsm_acc,
                                                   weight_acc, h, b)
                    t_blend += time.perf_counter() - t0
            while pending:
                fut, b = pending.popleft()
                t0 = time.perf_counter()
                h = fut.result()
                t_wait += time.perf_counter() - t0
                t0 = time.perf_counter()
                n_patches += self._blend_batch(tiff_data, dsm_acc, weight_acc,
                                               h, b)
                t_blend += time.perf_counter() - t0

        t0 = time.perf_counter()
        with np.errstate(invalid="ignore", divide="ignore"):
            out = dsm_acc / weight_acc
        out = np.maximum(out, 0.0)

        tiff_data.set_data(out.astype(np.float32))
        writer = RasterWriter(tiff_data)
        writer.write_to_file(save_to)
        t_finalize = time.perf_counter() - t0
        total = time.time() - start
        self.last_stats = {
            "total_s": total, "n_patches": n_patches,
            "loader_s": t_loader, "dispatch_s": t_dispatch,
            "device_wait_blend_s": t_wait + t_blend,
            "fetch_wait_s": t_wait, "blend_cpu_s": t_blend,
            "fetch_thread_s": float(sum(fetch_times)),
            "finalize_write_s": t_finalize,
            "patches_per_s": n_patches / total if total > 0 else 0.0,
        }
        log.info(
            "DSM Generation time: %.2f s (%d patches, %.2f tiles/s e2e; "
            "loader %.2f | dispatch %.2f | fetch-wait %.2f | blend %.2f | "
            "write %.2f; fetch threads busy %.2f)",
            total, n_patches, self.last_stats["patches_per_s"],
            t_loader, t_dispatch, t_wait, t_blend, t_finalize,
            self.last_stats["fetch_thread_s"],
        )
        return writer

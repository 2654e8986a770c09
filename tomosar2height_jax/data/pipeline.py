"""Batching + bucketed padding: ragged host patches -> static device arrays.

This is the ragged->static seam of the framework (SURVEY.md §7.2): every patch's
point count is padded (or subsampled) into a power-of-two bucket so the whole
forward/backward compiles to a small, cached set of XLA programs. Batches carry
a validity mask per point and per patch; invalid (empty) patches stay in the
batch (masked out of the loss) so training steps never recompile.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def pick_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest configured bucket that fits n points (caps at the largest)."""
    for b in bucket_sizes:
        if n <= b:
            return int(b)
    return int(bucket_sizes[-1])


def pad_points(
    pts: np.ndarray, bucket: int, rng: Optional[np.random.Generator] = None
):
    """Pad (or subsample) an (n, 3) array to (bucket, 3) + mask.

    Subsampling (n > bucket) is uniform without replacement — a deliberate,
    documented deviation from the reference (which feeds ragged tensors);
    bucket sizes should be configured above the patch-density P99 so it is rare.
    """
    n = pts.shape[0]
    out = np.zeros((bucket, pts.shape[1]), dtype=np.float32)
    mask = np.zeros((bucket,), dtype=bool)
    if n == 0:
        return out, mask
    if n > bucket:
        rng = rng or np.random.default_rng(0)
        sel = rng.choice(n, bucket, replace=False)
        out[:] = pts[sel]
        mask[:] = True
        return out, mask
    out[:n] = pts
    mask[:n] = True
    return out, mask


class PatchLoader:
    """Iterates batches of padded patches from a :class:`TomoSARDataset`.

    Yields dicts of numpy arrays:
      points (B, N, 3) f32 | point_mask (B, N) bool | patch_valid (B,) bool |
      dsm (B, H, W) f32 | image (B, H, W, C) f32 (if present) |
      min_bound/max_bound (B, 2) f64 | name list[str]

    For ``fixed_bucket`` (training) every batch has the same N; otherwise
    (eval/vis) N is the smallest bucket covering the batch's max count.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        bucket_sizes: Sequence[int],
        fixed_bucket: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = True,
        seed: int = 0,
        prefetch: int = 0,
        sort_reso: Optional[int] = None,
        n_workers: int = 0,
        det_stream: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.bucket_sizes = sorted(int(b) for b in bucket_sizes)
        self.fixed_bucket = int(fixed_bucket) if fixed_bucket else None
        self.shuffle = shuffle
        self.drop_last = drop_last
        # pad the final partial batch with invalid (masked) patches so every
        # batch has the same leading dim -> one XLA program per bucket
        self.pad_last = pad_last
        self.seed = seed
        self.prefetch = prefetch
        # when set, each patch's points are Morton-cell-sorted at this plane
        # resolution and batches carry 'cell'/'cell_offsets' for the device's
        # scatter-free segmented reductions (ops/sorted_scatter.py)
        self.sort_reso = int(sort_reso) if sort_reso else None
        # parallel patch fetch (reference train.py:80-84 uses 8 DataLoader
        # worker processes; dataset.__getitem__ is numpy + GIL-releasing C++
        # fast paths, so threads suffice here)
        self.n_workers = int(n_workers)
        # det_stream: every batch is a pure function of (seed, epoch, batch
        # index) — per-item generators replace the dataset's global-RNG draws
        # and batches carry their stream position ('_stream_pos') so training
        # can checkpoint it and set_position() resumes the EXACT stream
        # (bit-consistent kill-and-resume; the torch reference restarts its
        # DataLoader stream from scratch on resume, train.py:129-137).
        self.det_stream = bool(det_stream)
        self._start_batch = 0
        self._epoch = 0
        # bucket-overflow observability ("no silent caps"): points dropped by
        # subsampling when a patch exceeds the largest bucket, reset per epoch
        self.overflow_patches = 0
        self.overflow_points = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        self.overflow_patches = 0
        self.overflow_points = 0
        it = self._iter_batches()
        if self.prefetch <= 0:
            yield from it
            self._log_overflow()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def worker():
            try:
                for b in it:
                    q.put(b)
            finally:
                q.put(DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is DONE:
                break
            yield b
        self._log_overflow()

    def _log_overflow(self):
        if self.overflow_patches:
            log.warning(
                "PatchLoader: %d patches exceeded the largest bucket (%d); "
                "%d points subsampled away this epoch. Raise "
                "dataset.points.bucket_sizes (see scripts/point_density.py).",
                self.overflow_patches, self.bucket_sizes[-1], self.overflow_points,
            )

    def set_position(self, epoch: int, batch_idx: int):
        """Restart the loader at stream position (epoch, batch_idx) — the
        '_stream_pos' a det_stream batch carries names the position AFTER it,
        so passing a checkpointed position replays from the next batch.
        Requires det_stream (positions are meaningless otherwise)."""
        assert self.det_stream, "set_position requires det_stream=True"
        per_epoch = len(self)
        if batch_idx >= per_epoch:
            epoch, batch_idx = epoch + 1, 0
        # __iter__ pre-increments _epoch
        self._epoch = int(epoch) - 1
        self._start_batch = int(batch_idx)

    def _item_rng(self, pos: int) -> Optional[np.random.Generator]:
        """Per-item generator keyed by absolute position in the epoch."""
        if not self.det_stream:
            return None
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, pos]))

    def _get_item(self, i: int, rng: Optional[np.random.Generator]):
        """dataset[i], passing the stream rng only under det_stream so plain
        single-argument datasets (the standard __getitem__ signature) work."""
        if rng is None:
            return self.dataset[i]
        return self.dataset.__getitem__(i, rng)

    def _fetch_patches(self, idx: np.ndarray, base: int = 0):
        """Yield dataset[i] in order; with n_workers > 0, fetches run in a
        thread pool with a bounded lookahead window. ``base`` is the epoch
        position of idx[0] (nonzero after set_position)."""
        if self.n_workers <= 0:
            for k, i in enumerate(idx):
                yield self._get_item(int(i), self._item_rng(base + k))
            return
        from concurrent.futures import ThreadPoolExecutor

        lookahead = self.batch_size * max(self.prefetch + 1, 2)
        with ThreadPoolExecutor(max_workers=self.n_workers) as ex:
            pending = []
            it = enumerate(idx)
            for k, i in it:
                pending.append(ex.submit(self._get_item, int(i),
                                         self._item_rng(base + k)))
                if len(pending) >= lookahead:
                    break
            for k, i in it:
                yield pending.pop(0).result()
                pending.append(ex.submit(self._get_item, int(i),
                                         self._item_rng(base + k)))
            for f in pending:
                yield f.result()

    def _iter_batches(self):
        # Regular-patching (serving/eval) loaders are deterministic across
        # re-iterations: repeated generate_dsm calls must see the SAME
        # subsample of over-bucket patches (raster reproducibility). Random
        # training loaders keep per-epoch resampling — a free augmentation.
        deterministic = (not self.shuffle
                         and not getattr(self.dataset, "random_sample", False))
        epoch = 0 if deterministic else self._epoch
        rng = np.random.default_rng(self.seed + 1000 + epoch)
        idx = self._indices()
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        start, self._start_batch = self._start_batch, 0
        idx = idx[start * self.batch_size:]
        patch_it = self._fetch_patches(idx, base=start * self.batch_size)
        batch: List[dict] = []
        bi = start
        for p in patch_it:
            batch.append(p)
            if len(batch) == self.batch_size:
                yield self._finish_batch(batch, bi, rng)
                batch = []
                bi += 1
        if batch:
            yield self._finish_batch(batch, bi, rng)

    def _finish_batch(self, batch: List[dict], bi: int, rng):
        if self.det_stream:
            # position-keyed collate rng (pad_points subsample draws) + the
            # stream position AFTER this batch, for checkpointed resume
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 1000, self._epoch, bi]))
            out = self.collate(batch, rng)
            out["_stream_pos"] = (self._epoch, bi + 1)
            return out
        return self.collate(batch, rng)

    def collate(self, patches: List[dict], rng: Optional[np.random.Generator] = None):
        n_real = len(patches)
        if self.pad_last and n_real < self.batch_size:
            filler = {
                "name": "__pad__",
                "min_bound": np.zeros(2, dtype=np.float64),
                "max_bound": np.zeros(2, dtype=np.float64),
                "is_valid": False,
            }
            patches = patches + [filler] * (self.batch_size - n_real)
        bsz = len(patches)
        counts = [len(p["inputs"]) if p["is_valid"] else 0 for p in patches]
        if self.fixed_bucket:
            bucket = self.fixed_bucket
        else:
            bucket = pick_bucket(max(max(counts), 1), self.bucket_sizes)
        for cnt in counts:
            if cnt > bucket:
                self.overflow_patches += 1
                self.overflow_points += cnt - bucket

        points = np.zeros((bsz, bucket, 3), dtype=np.float32)
        point_mask = np.zeros((bsz, bucket), dtype=bool)
        if self.sort_reso:
            ncell = self.sort_reso * self.sort_reso
            cells = np.full((bsz, bucket), ncell, dtype=np.int32)
            offsets = np.zeros((bsz, ncell + 1), dtype=np.int32)
        patch_valid = np.zeros((bsz,), dtype=bool)
        dsm = None
        image = None
        image_origin = None  # device-crop wire: (B, 2) scene-pixel origins
        min_bound = np.zeros((bsz, 2), dtype=np.float64)
        max_bound = np.zeros((bsz, 2), dtype=np.float64)
        names = []

        for i, p in enumerate(patches):
            names.append(p["name"])
            min_bound[i] = p["min_bound"][:2]
            max_bound[i] = p["max_bound"][:2]
            if not p["is_valid"]:
                continue
            patch_valid[i] = True
            if self.sort_reso:
                from tomosar2height_jax.ops.sorted_scatter import host_morton_bucket

                points[i], point_mask[i] = pad_points(p["inputs"], bucket, rng)
                order, cell, off = host_morton_bucket(points[i], point_mask[i], self.sort_reso)
                points[i] = points[i][order]
                point_mask[i] = point_mask[i][order]
                cells[i] = cell
                offsets[i] = off
            else:
                points[i], point_mask[i] = pad_points(p["inputs"], bucket, rng)
            if "dsm" in p:
                if dsm is None:
                    dsm = np.zeros((bsz,) + p["dsm"].shape, dtype=np.float32)
                dsm[i] = p["dsm"]
            if "image" in p:
                if image is None:  # u8 on the uint8 wire, f32 otherwise
                    image = np.zeros((bsz,) + p["image"].shape,
                                     dtype=p["image"].dtype)
                image[i] = p["image"]
            if "image_origin" in p:
                if image_origin is None:  # pad entries keep (0, 0) — in-bounds
                    image_origin = np.zeros((bsz, 2), dtype=np.int32)
                image_origin[i] = p["image_origin"]

        out = {
            "points": points,
            "point_mask": point_mask,
            "patch_valid": patch_valid,
            "min_bound": min_bound,
            "max_bound": max_bound,
            "name": names,
        }
        if self.sort_reso:
            out["cell"] = cells
            out["cell_offsets"] = offsets
        if dsm is not None:
            out["dsm"] = dsm
        if image is not None:
            out["image"] = image
        if image_origin is not None:
            out["image_origin"] = image_origin
        return out

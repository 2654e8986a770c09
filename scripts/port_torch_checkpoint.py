#!/usr/bin/env python
"""Convert a reference (torch) checkpoint into this framework's format.

A user of the reference who has trained ``model_best.pt`` (reference
utils/io_checkpoint.py:38-48) ports it across with one command:

    python scripts/port_torch_checkpoint.py \
        --src outputs/TomoSAR2Height-berlin/check_points/model_best.pt \
        --dst /path/to/check_points/model_best.ckpt \
        dataset=berlin use_cloud=true use_image=false

The config overrides must describe the SAME architecture the torch model was
trained with (conf/model/tomosar2height.yaml mirrors the reference's).
Weight-layout conversions and the key mapping live in
``tomosar2height_jax/utils/torch_port.py`` and are numerically pinned by
``tests/test_reference_parity.py`` (forward ≤1e-4 through ported weights).
Scalars {n_iter, loss_val_best, training_time} carry over; torch
optimizer/scheduler state has no optax equivalent and is dropped (resume
re-warms momentum — same behavior as the reference's
``resume_scheduler=False`` path, io_checkpoint.py:90-105).

``--reverse`` exports the other way: a ``.ckpt`` trained here becomes a
reference-loadable ``.pt`` (load with ``strict=False`` — dead-head params
the reference allocates but never uses on the config's path are absent).
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="reference .pt checkpoint <-> tomosar2height_jax .ckpt")
    ap.add_argument("--src", required=True,
                    help="source checkpoint (.pt, or .ckpt with --reverse)")
    ap.add_argument("--dst", required=True,
                    help="output path (.ckpt, or .pt with --reverse)")
    ap.add_argument("--reverse", action="store_true",
                    help="export a .ckpt trained here as a reference-loadable "
                         ".pt (load with strict=False: dead-head params the "
                         "reference allocates but never uses are absent)")
    ap.add_argument("overrides", nargs="*", help="config overrides (key=value)")
    a = ap.parse_args(argv)

    import jax
    import numpy as np

    from tomosar2height_jax.config import compose
    from tomosar2height_jax.config.compose import default_conf_dir
    from tomosar2height_jax.models import build_model
    from tomosar2height_jax.train import CheckpointIO
    from tomosar2height_jax.utils.torch_port import (
        REFERENCE_SCALARS,
        export_arrays,
        load_reference_checkpoint,
        port_arrays,
    )

    cfg = compose(default_conf_dir(), overrides=list(a.overrides))
    # porting is pure layout work — never init an accelerator backend for it
    # (its process would reserve most of the card's memory)
    from tomosar2height_jax.utils.cache import select_platform

    select_platform(cfg.select("device.platform", None) or "cpu")
    model = build_model(cfg)

    # dummy inputs just to materialize the param tree structure/shapes
    use_cloud = bool(cfg["use_cloud"])
    use_image = bool(cfg["use_image"])
    out_size = int(cfg["model"]["decoder_pixel_kwargs"]["output_size"])
    rng = np.random.default_rng(0)
    points = mask = image = None
    if use_cloud:
        points = rng.uniform(0.001, 0.999, (1, 1024, 3)).astype(np.float32)
        mask = np.ones((1, 1024), dtype=bool)
    if use_image:
        image = np.zeros((1, out_size, out_size, 3), np.float32)
    params = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), points, mask, image))

    if a.reverse:
        # .ckpt -> .pt: restore our pytree against the template, invert the
        # layout permutations, save in the reference's torch-pickle format
        import torch

        real = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params)
        io = CheckpointIO(os.path.dirname(os.path.abspath(a.src)) or ".",
                          model=real)
        scalars = io.load(a.src, resume_scheduler=False)
        sd = export_arrays(io.module_dict["model"])
        blob = {"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}
        blob.update({k: scalars[k] for k in REFERENCE_SCALARS if k in scalars})
        os.makedirs(os.path.dirname(os.path.abspath(a.dst)) or ".",
                    exist_ok=True)
        torch.save(blob, a.dst)
        print(f"[port] wrote {a.dst}: {len(sd)} torch tensors "
              f"(reference loads with strict=False), scalars "
              f"{ {k: blob[k] for k in REFERENCE_SCALARS if k in blob} }")
        return a.dst

    sd, scalars = load_reference_checkpoint(a.src)
    ported, leftover = port_arrays(sd, params)
    if leftover:
        print(f"[port] {len(leftover)} reference params unused on this "
              f"config's path (dead heads):")
        for k in leftover:
            print(f"  - {k}")

    os.makedirs(os.path.dirname(os.path.abspath(a.dst)) or ".", exist_ok=True)
    io = CheckpointIO(os.path.dirname(os.path.abspath(a.dst)), model=ported)
    io.save(a.dst, **{k: float(v) if k != "n_iter" else int(v)
                      for k, v in scalars.items()})
    n_leaves = len(jax.tree.leaves(ported))
    print(f"[port] wrote {a.dst}: {n_leaves} param arrays, "
          f"scalars {scalars or '{}'}")
    return a.dst


if __name__ == "__main__":
    main()

"""Checkpoint save/load with the reference's directory layout and metadata.

Parity: reference utils/io_checkpoint.py:11-115 — registered modules
(model/optimizer/scheduler), scalar metadata {n_iter, loss_val_best,
training_time}, ``model_best`` default file, ``resume_scheduler=False`` support,
graceful skips for missing keys. A checkpoint is one numpy ``.npz`` file:
every pytree leaf under ``<module>/<key path>`` and the scalars as one JSON
string under ``__scalars__`` — no pickle.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

import jax
import numpy as np

log = logging.getLogger(__name__)

DEFAULT_MODEL_FILE = "model_best.ckpt"
SCALARS_KEY = "__scalars__"


def _key_name(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def flatten_arrays(name: str, tree) -> Dict[str, np.ndarray]:
    """{'<name>/<key path>': leaf} for every leaf of ``tree``."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join([name] + [_key_name(k) for k in path]): np.asarray(leaf)
            for path, leaf in leaves}


def restore_arrays(name: str, target, arrays) -> Any:
    """``target``'s structure with its leaves read from ``arrays``; raises
    KeyError for a missing leaf and ValueError for a shape mismatch."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    out = []
    for path, leaf in leaves:
        key = "/".join([name] + [_key_name(k) for k in path])
        value = arrays[key]
        if value.shape != np.shape(leaf):
            raise ValueError(f"{key}: stored {value.shape}, expected {np.shape(leaf)}")
        out.append(value)
    return jax.tree_util.tree_unflatten(treedef, out)


def _json_default(v):
    if isinstance(v, (np.generic, np.ndarray)):
        return v.tolist()
    raise TypeError(f"cannot store {type(v).__name__} in a checkpoint")


class CheckpointIO:
    """Save/load a dict of stateful modules + scalars.

    Registered values may be:
    - pytrees (params, optimizer state): one array per leaf;
    - objects with ``state_dict()/load_state_dict()`` (schedulers), stored
      with the scalars as JSON.
    """

    def __init__(self, checkpoint_dir: str, **modules):
        self.checkpoint_dir = checkpoint_dir
        self.module_dict: Dict[str, Any] = dict(modules)
        os.makedirs(checkpoint_dir, exist_ok=True)

    def register_modules(self, **modules):
        self.module_dict.update(modules)

    def save(self, filename: str, **scalars):
        out: Dict[str, Any] = dict(scalars)
        arrays: Dict[str, np.ndarray] = {}
        for k, v in self.module_dict.items():
            if v is None:
                continue
            if hasattr(v, "state_dict"):
                out[k] = v.state_dict()
            else:
                arrays.update(flatten_arrays(k, v))
        arrays[SCALARS_KEY] = np.array(json.dumps(out, default=_json_default))
        tmp = filename + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, filename)

    def _download_url(self, url: str) -> str:
        """Fetch a checkpoint URL into the checkpoint dir (skip if cached)."""
        import urllib.parse
        import urllib.request

        name = os.path.basename(urllib.parse.urlparse(url).path) or "model_url.ckpt"
        dest = os.path.join(self.checkpoint_dir, name)
        if os.path.exists(dest):
            log.info("Using cached checkpoint for %s", url)
            return dest
        log.info("Downloading checkpoint from url: %s", url)
        tmp = dest + ".tmp"
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            f.write(r.read())
        os.replace(tmp, dest)
        return dest

    def load(self, filename: str, resume_scheduler: bool = True) -> Dict[str, Any]:
        """Load; updates registered pytrees in-place (returns the new values in
        ``self.module_dict``) and returns the scalar dict.

        ``filename`` may be an http(s) URL (reference io_checkpoint.py:78-88
        ``load_url``): the file is downloaded into the checkpoint dir (cached
        by basename) and loaded from there.
        """
        if filename and filename.startswith(("http://", "https://")):
            filename = self._download_url(filename)
        if not filename or not os.path.exists(filename):
            raise FileNotFoundError(f"Checkpoint file {filename} not found.")
        log.info("Loading checkpoint from local file...")
        with np.load(filename, allow_pickle=False) as npz:
            arrays = {key: npz[key] for key in npz.files}
        scalars = json.loads(str(arrays.pop(SCALARS_KEY)))
        stored = {key.split("/", 1)[0] for key in arrays}
        for k, v in list(self.module_dict.items()):
            if v is None:
                continue
            if k == "scheduler" and not resume_scheduler:
                log.info("Skip loading scheduler from checkpoint.")
                scalars.pop(k, None)
                continue
            try:
                if hasattr(v, "load_state_dict"):
                    v.load_state_dict(scalars.pop(k))
                elif k in stored:
                    self.module_dict[k] = restore_arrays(k, v, arrays)
                else:
                    log.warning("Warning: Could not find %s in checkpoint!", k)
            except KeyError:
                log.warning("Warning: Could not find %s in checkpoint!", k)
            except Exception:  # shape/type mismatch — mirror reference leniency
                log.warning("Warning: Could not load %s in checkpoint!", k)
        return {k: v for k, v in scalars.items() if k not in self.module_dict}

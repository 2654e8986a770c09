"""Console/file logging plus a wandb-compatible metrics logger.

The reference logs via Hydra colorlog (conf/hydra/job_logging/custom.yaml) and
wandb (train.py:60-67,159-165). Neither is available here; ``MetricLogger``
exposes the same ``init/log/watch/finish`` call surface and persists metrics as
JSONL under the run directory so external tooling (or wandb, if installed) can
consume them.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def setup_logging(log_file: Optional[str] = None, console_level: int = logging.INFO,
                  file_level: int = logging.DEBUG,
                  fmt: str = "%(asctime)s - %(levelname)s - %(filename)s - %(funcName)s >> %(message)s"):
    root = logging.getLogger()
    root.setLevel(min(console_level, file_level))
    logging.getLogger("jax").setLevel(logging.WARNING)  # jax DEBUG is torrential
    root.handlers = [h for h in root.handlers if not isinstance(h, (logging.StreamHandler, logging.FileHandler))]
    ch = logging.StreamHandler()
    ch.setLevel(console_level)
    ch.setFormatter(logging.Formatter(fmt))
    root.addHandler(ch)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(file_level)
        fh.setFormatter(logging.Formatter(fmt))
        root.addHandler(fh)


class MetricLogger:
    """wandb-compatible metric sink writing JSONL (and wandb when importable)."""

    def __init__(self):
        self._file = None
        self._wandb = None
        self.enabled = False
        self._watch_params_fn = None
        self._watch_norms_fn = None
        self._watch_freq = 100

    def init(self, project: str, config: Dict[str, Any], name: str, dir: str,
             mode: str = "disabled"):
        self.enabled = mode != "disabled"
        os.makedirs(dir, exist_ok=True)
        self._path = os.path.join(dir, "metrics.jsonl")
        self._file = open(self._path, "a")
        self._file.write(json.dumps({
            "_event": "init", "project": project, "name": name,
            "time": time.time(), "config": _jsonable(config),
        }) + "\n")
        self._file.flush()
        if self.enabled:
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(project=project, config=config, name=name, dir=dir, mode="online")
            except ImportError:
                logging.getLogger(__name__).warning("wandb requested but not installed; JSONL only")
        return self

    def watch(self, params_fn=None, log_freq: int = 100, norms_fn=None):
        """Watch model parameters (reference train.py:94 ``wandb.watch(model)``).

        Every ``log_freq`` logged steps, per-top-level-module L2 param norms
        are emitted as ``watch/param_norm/<module>`` records. Two sources:

        - ``norms_fn``: zero-arg callable returning ``{module: norm}`` floats,
          already reduced ON DEVICE (Trainer.module_norms) — the production
          path. The host fetch is one small vector per watch step.
        - ``params_fn``: zero-arg callable returning the live param pytree,
          reduced here with numpy. Materializes EVERY leaf device->host —
          ~44 MB/step at flagship scale; kept for host-numpy trees and
          tests only.

        Global grad/param norms are computed inside the jitted train step
        (Trainer METRIC_KEYS) and arrive through the regular ``log()`` stream.
        """
        self._watch_params_fn = params_fn
        self._watch_norms_fn = norms_fn
        self._watch_freq = max(int(log_freq), 1)

    def _watch_metrics(self, step: Optional[int]) -> Dict[str, float]:
        if step is None or step % self._watch_freq:
            return {}
        if self._watch_norms_fn is not None:
            return {f"watch/param_norm/{name}": float(v)
                    for name, v in self._watch_norms_fn().items()}
        if self._watch_params_fn is None:
            return {}
        import numpy as np

        params = self._watch_params_fn()
        if isinstance(params, dict) and set(params) == {"params"}:
            params = params["params"]
        out: Dict[str, float] = {}
        for name, sub in (params.items() if isinstance(params, dict) else []):
            sq = 0.0
            for leaf in _tree_leaves(sub):
                arr = np.asarray(leaf)
                sq += float((arr.astype(np.float64) ** 2).sum())
            out[f"watch/param_norm/{name}"] = sq ** 0.5
        return out

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._file is None:
            return
        w = self._watch_metrics(step)
        if w:
            metrics = {**metrics, **w}
        rec = {"_step": step, "time": time.time()}
        rec.update(_jsonable(metrics))
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and callable(obj.item):
        try:
            return obj.item()
        except Exception:
            return str(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)

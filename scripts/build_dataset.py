#!/usr/bin/env python
"""Offline dataset builder CLI (parity: reference scripts/build_dataset.py:30-31).

    python scripts/build_dataset.py dataset=berlin [--overwrite] [key=value ...]

Composes the same config tree as train.py/test.py; the library implementation
is tomosar2height_jax/data/builder.py.
"""

from __future__ import annotations

import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tomosar2height_jax.config import compose  # noqa: E402
from tomosar2height_jax.config.compose import default_conf_dir  # noqa: E402
from tomosar2height_jax.data import build_dataset  # noqa: E402
from tomosar2height_jax.utils import setup_logging  # noqa: E402


def main():
    args = sys.argv[1:]
    overwrite = "--overwrite" in args
    overrides = [a for a in args if a != "--overwrite"]
    setup_logging()
    cfg = compose(default_conf_dir(), overrides=overrides)
    info = build_dataset(cfg, overwrite=overwrite)
    logging.getLogger("build").info("Built %d chunks.", len(info))


if __name__ == "__main__":
    main()

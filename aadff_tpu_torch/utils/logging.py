"""Logging and reproducibility helpers (the port of
`aadff_tpu/utils/logging.py`, reference deeplens/utils.py:95-130)."""
from __future__ import annotations

import logging
import os
import random
import time

import numpy as np


def set_seed(seed: int):
    """Seed Python's `random` and numpy's global stream (which the datasets'
    augmentation draws from), as the JAX package does.  The port's torch
    draws take explicit generators and are not seeded here."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def set_logger(result_dir: str):
    """File + console logging into `<result_dir>/output.log`
    (reference deeplens/utils.py:107-123)."""
    os.makedirs(result_dir, exist_ok=True)
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s - %(message)s")
    fh = logging.FileHandler(os.path.join(result_dir, "output.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)


class Timer:
    """Simple wall-clock timer for per-step profiling."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self):
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt

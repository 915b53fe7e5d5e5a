"""Reproducibility (port of `mcaq_yolo_tpu/utils/repro.py:22-36`): seed
Python's `random`, NumPy's global generator and torch's, before any model
or loader is built.  The data pipeline draws from its own seeded
generators; this covers what is left global.

Known limit: cuDNN may pick nondeterministic algorithms unless
`deterministic` asks for the deterministic ones.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_global_seed(seed: int, deterministic: bool = False) -> None:
    """Seed `random`, NumPy and torch (every device); with `deterministic`,
    ask cuDNN for deterministic algorithms and turn its autotuner off."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

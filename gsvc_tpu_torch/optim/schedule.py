"""Learning-rate schedules (PyTorch port of gsvc_tpu/optim/schedule.py).

The reference uses torch StepLR(step_size=20000, gamma=0.5) everywhere
(GaussianSplats_Represent.py:52), stepped once per training iteration.
"""

from __future__ import annotations

import numpy as np


def step_lr(base_lr: float, step: int, step_size: int = 20000,
            gamma: float = 0.5) -> float:
    """lr after `step` completed steps (0-based): the lr of iteration i
    (1-based) is base * gamma^((i-1) // step_size). `step` is a host int;
    the value is rounded to float32 as gsvc_tpu computes it."""
    k = np.float32(step // step_size)
    return float(np.float32(base_lr) * np.float32(gamma) ** k)

"""Training control utilities: early stopping and K-frame outlier
detection (PyTorch port of gsvc_tpu/utils/control.py; host numpy).

Ports of the reference `EarlyStopping` (utils.py:188-211) and
`detect_outliers_mean_diff` (utils.py:214-229). The training step in
models/represent.py keeps the same early-stop rule on the device.
"""

from __future__ import annotations

import numpy as np


class EarlyStopping:
    """Stop after `patience` iters without `min_delta` improvement."""

    def __init__(self, patience: int = 100, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = None
        self.counter = 0

    def __call__(self, current_loss: float) -> bool:
        if self.best_loss is None:
            self.best_loss = current_loss
            return False
        if self.best_loss - current_loss > self.min_delta:
            self.best_loss = current_loss
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience


def detect_outliers_mean_diff(values, window_size: int = 10, threshold: float = 3):
    """Windowed z-score outliers (K-frame detection, utils.py:214-229).

    A frame is an outlier if value - local_mean > threshold * local_std or
    value > threshold * local_mean, over a +-window_size window.
    """
    values = np.asarray(values, dtype=np.float64)
    outliers = []
    for i in range(len(values)):
        start = max(0, i - window_size)
        end = min(len(values), i + window_size)
        local_mean = np.mean(values[start:end])
        local_std = np.std(values[start:end])
        if (values[i] - local_mean) > threshold * local_std:
            outliers.append(i)
        elif values[i] > local_mean * threshold:
            outliers.append(i)
    return outliers

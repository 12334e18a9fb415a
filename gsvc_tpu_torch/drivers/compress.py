"""Compression-stage driver: only the checkpoint loader so far
(`load_gmodels` of gsvc_tpu/drivers/compress.py). The QAT driver arrives
with the compress slice."""

from __future__ import annotations

import numpy as np


def load_gmodels(path: str) -> dict:
    """Load the representation checkpoint ({'frame_{n}/_xyz': ...} npz)
    into {frame_n: gmodel_dict} of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            frame, name = key.split("/", 1)
            out.setdefault(frame, {})[name] = data[key]
    return out

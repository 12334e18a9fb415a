"""YUV 4:2:0 (I420) video reading, numpy only.

The numpy BT.601 video-range path of gsvc_tpu/io/yuv.py (the reference's
`process_yuv_video`, utils.py:134-156). The cv2 and native C++ decoders
of the JAX package are not ported; this path can differ from cv2's
fixed-point one by a level.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np


def yuv420_to_rgb(yuv: np.ndarray, width: int, height: int) -> np.ndarray:
    """One I420 frame ([h*3/2, w] uint8) -> RGB uint8 [h, w, 3]."""
    y = yuv[:height].astype(np.float32)
    u = yuv[height : height + height // 4].reshape(height // 2, width // 2)
    v = yuv[height + height // 4 :].reshape(height // 2, width // 2)
    u = u.repeat(2, 0).repeat(2, 1).astype(np.float32)
    v = v.repeat(2, 0).repeat(2, 1).astype(np.float32)
    c = 1.164 * (y - 16.0)
    d = u - 128.0
    e = v - 128.0
    r = c + 1.596 * e
    g = c - 0.392 * d - 0.813 * e
    b = c + 2.017 * d
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def iter_yuv_frames(
    file_path: str, width: int, height: int, limit: Optional[int] = None
) -> Iterator[np.ndarray]:
    frame_size = width * height * 3 // 2
    total = os.path.getsize(file_path) // frame_size
    if limit is not None:
        total = min(total, limit)
    with open(file_path, "rb") as f:
        for _ in range(total):
            raw = f.read(frame_size)
            if len(raw) < frame_size:
                break
            yuv = np.frombuffer(raw, np.uint8).reshape(height * 3 // 2, width)
            yield yuv420_to_rgb(yuv, width, height)


def process_yuv_video(
    file_path: str, width: int, height: int, limit: Optional[int] = None
) -> List[np.ndarray]:
    """All frames as RGB uint8 arrays (reference utils.py:134 API)."""
    return list(iter_yuv_frames(file_path, width, height, limit))

"""MP4 output writer (PyTorch port of gsvc_tpu/io/video.py, the reference
`generate_video`, utils.py:159-184). Takes RGB uint8 numpy frames.

Without cv2 (the GPU host has none) the frames go to `video.mp4.npz`
instead, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # cv2 missing
    _HAS_CV2 = False


def generate_video(
    out_dir, image_list: List[np.ndarray], fps: int, origin: bool = True
) -> None:
    if not image_list:
        return
    path = Path(out_dir) / "video"
    path.mkdir(parents=True, exist_ok=True)
    filename = "video.mp4" if origin else "combined_video.mp4"
    if not _HAS_CV2:
        np.savez_compressed(path / (filename + ".npz"), *image_list)
        return
    h, w = image_list[0].shape[:2]
    writer = cv2.VideoWriter(
        str(path / filename), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for img in image_list:
        writer.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    writer.release()

"""YUV 4:2:0 (I420) video reading.

The reference's `process_yuv_video` (utils.py:134-156) converts with
cv2.COLOR_YUV2RGB_I420 (BT.601 video range), and gsvc_tpu/io/yuv.py takes
cv2 or its native/yuv.cpp, which computes OpenCV's fixed-point integers.
The port converts with its copy of yuv.cpp (native/yuv.cpp, built with g++
at first use) and keeps a numpy version of the same int32 arithmetic as
its plain version (`native=False`): the two, cv2 and gsvc_tpu's reader
give the same bytes.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional

import numpy as np

# OpenCV's BT.601 coefficients in 20-bit fixed point (native/yuv.cpp)
_SHIFT = 20
_CY = 1220542  # 1.164 * 2^20
_CUB = 2116026  # 2.018 * 2^20
_CUG = -409993  # -0.391 * 2^20
_CVG = -852492  # -0.813 * 2^20
_CVR = 1673527  # 1.596 * 2^20
_ROUND = 1 << (_SHIFT - 1)


def yuv420_to_rgb_plain(yuv: np.ndarray, width: int, height: int) -> np.ndarray:
    """Plain version of `yuv420_to_rgb`: native/yuv.cpp's int32 arithmetic
    in numpy (every intermediate fits int32)."""
    yuv = np.asarray(yuv, np.uint8).reshape(-1)
    hw, cw = width * height, (width // 2) * (height // 2)
    y = yuv[:hw].reshape(height, width).astype(np.int32)
    u = yuv[hw:hw + cw].reshape(height // 2, width // 2).astype(np.int32) - 128
    v = yuv[hw + cw:hw + 2 * cw].reshape(height // 2, width // 2).astype(np.int32) - 128
    u = u.repeat(2, 0).repeat(2, 1)
    v = v.repeat(2, 0).repeat(2, 1)
    y = np.maximum(y - 16, 0) * _CY
    r = y + _CVR * v
    g = y + _CVG * v + _CUG * u
    b = y + _CUB * u
    rgb = (np.stack([r, g, b], -1) + _ROUND) >> _SHIFT
    return np.clip(rgb, 0, 255).astype(np.uint8)


def yuv420_to_rgb(yuv: np.ndarray, width: int, height: int,
                  native: bool = True) -> np.ndarray:
    """One I420 frame ([h*3/2, w] uint8) -> RGB uint8 [h, w, 3]: native/yuv.cpp,
    or its plain numpy version with native=False (the same bytes)."""
    if not native:
        return yuv420_to_rgb_plain(yuv, width, height)
    from gsvc_tpu_torch.native import yuv_lib

    src = np.ascontiguousarray(yuv, np.uint8)
    if src.size != width * height * 3 // 2:
        raise ValueError(f"an I420 frame of {width}x{height} holds "
                         f"{width * height * 3 // 2} bytes, got {src.size}")
    rgb = np.empty((height, width, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    yuv_lib().yuv420_to_rgb(src.ctypes.data_as(u8p), width, height,
                            rgb.ctypes.data_as(u8p))
    return rgb


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

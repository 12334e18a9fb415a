"""Configuration dataclasses (PyTorch port of gsvc_tpu/config.py).

`FrameConfig` carries the render and training fields of gsvc_tpu's,
with the same names and defaults; the video-level driver configuration
arrives with the driver slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static per-frame configuration (field names as in gsvc_tpu)."""

    H: int
    W: int
    num_points: int  # live splats at init
    max_num_points: int  # capacity
    iterations: int
    lr: float = 1e-3
    loss_type: str = "L2"
    lambda_value: float = 0.0
    densification_interval: int = 100
    removal_rate: float = 0.1
    isdensity: bool = False  # --is_ad adaptive control (P-frames)
    isremoval: bool = False  # --is_rm removal control (K-frames)
    block_h: int = 16
    block_w: int = 16
    # early stopping (train_video_Represent.py:83-96)
    early_stop_patience: int = 100
    early_stop_min_delta: float = 1e-9
    stable_control: int = 5000
    # Adan (optimizer.py defaults; the only optimizer GSVC uses)
    betas: Tuple[float, float, float] = (0.98, 0.92, 0.99)
    eps: float = 1e-8
    # rasterizer: "auto" | "cuda" | "torch" | "dense" (ops/rasterize.py)
    backend: str = "auto"
    max_intersects: Optional[int] = None

    @property
    def tile_bounds(self) -> Tuple[int, int, int]:
        return (
            (self.W + self.block_w - 1) // self.block_w,
            (self.H + self.block_h - 1) // self.block_h,
            1,
        )

"""Configuration dataclasses (PyTorch port of gsvc_tpu/config.py).

Only the fields the decode / eval-render path reads are here; the
training fields (lr, loss, splat control, Adan, early stopping) and the
video-level driver configuration arrive with the slices that read them.
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
    block_h: int = 16
    block_w: int = 16
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

"""The yardstick of the kernels' and steps' shares: the work the inputs
need, counted by the benchmark itself, and the card's published peaks.

Copies at commit a2bb42d: the peaks and `roofline_s` from
gsvc_tpu_torch/utils/profiling.py (`H100_*`, `roofline_ms`); the
operations a (pixel, lane) pair of K4 / K5 and K6 and the bytes their
functions move from gsvc_tpu_torch/utils/work.py (`K4_OPS["full"]`,
`K6_OPS`, `forward_bytes`, `backward_bytes`, `rows_bytes`). The pairs, the
pairs past the alpha gate and the kept lanes are counted here from the
benchmark's own plain projection and binning of the splats
(`reference.splats`, float32), never from what the program made, so a
kernel's share reads the same work whatever implements it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference import splats

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations a (pixel, lane) pair: (every pair, each pair past the gate)
K4_OPS = (17, 6)
K6_OPS = (16, 36)


def roofline_s(n_bytes: float, ops: float) -> float:
    """The least seconds the card could take to move `n_bytes` and do `ops`
    float32 operations."""
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


class Counts(NamedTuple):
    n: int  # splats read
    lanes: int  # sum over tiles of min(count, cap)
    gated: int  # (pixel, lane) pairs past the alpha gate
    tiles: int
    H: int
    W: int

    @property
    def pairs(self) -> int:
        return 256 * self.lanes


@torch.no_grad()
def count(means, chol, H: int, W: int, budget: int,
          alive: Optional[torch.Tensor] = None) -> Counts:
    """The work of one render of these splats (NDC means, cholesky with
    its bound), in float32 on their device."""
    means, chol = means.float(), chol.float()
    p = splats.project(means, chol, H, W, alive)
    pairs = splats.bin_pairs(p, H, W, budget)
    total = pairs.tile.shape[0]
    gated = 0
    step = max(1, splats.CHUNK_VALUES // 256)
    for lo in range(0, total, step):
        w, _flat = splats.pair_weights(pairs, p.xys, p.conics, W, lo, lo + step)
        gated += int((w > 0).sum())
    tb_x, tb_y = splats.grid(H, W)
    return Counts(means.shape[0], total, gated, tb_x * tb_y, H, W)


def mean_counts(a: Counts, b: Counts) -> Counts:
    return Counts(*((x + y) / 2 for x, y in zip(a, b)))


def rows_bytes(c: Counts) -> float:
    tb_x, tb_y = splats.grid(c.H, c.W)
    return 4 * tb_y * ((3 * tb_x + 7) // 8 * 8) * 256


def forward_ops(c: Counts) -> float:
    return K4_OPS[0] * c.pairs + K4_OPS[1] * c.gated


def backward_ops(c: Counts) -> float:
    return K6_OPS[0] * c.pairs + K6_OPS[1] * c.gated


def forward_bytes(c: Counts, layout: str) -> float:
    """Tile starts and counts, the used lane ids, 9 floats a splat, the
    image (12 bytes a pixel, or the rows layout)."""
    out = rows_bytes(c) if layout == "rows" else 12 * c.H * c.W
    return 8 * c.tiles + 4 * c.lanes + 36 * c.n + out


def backward_bytes(c: Counts, budget: int) -> float:
    """The forward's inputs, each splat's slot start and bbox, the rows
    image gradient, the [9, budget] slots."""
    return 8 * c.tiles + 4 * c.lanes + 44 * c.n + 4 + rows_bytes(c) + 36 * budget

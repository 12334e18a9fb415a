"""Binned sum-rasterizer in plain PyTorch (gather + reduce per tile).

PyTorch port of gsvc_tpu/ops/rasterize_binned.py and the plain version of
the forward kernel (ops/rasterize_cuda.py): the same CSR binning and
per-tile cap, evaluated as dense [tiles, cap, pixels] tensor math over
chunks of tiles. Serves any channel count C.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gsvc_tpu_torch.ops.binning import BinnedSplats
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF, _min1_forward_only

# Tiles per step: each materialises [TILE_CHUNK, cap, block_h * block_w]
# floats (16 MB at cap 256 and 16x16 tiles).
TILE_CHUNK = 64


def tile_lane_ids(binned: BinnedSplats, cap: int, n: int) -> torch.Tensor:
    """[T, cap] int64 gaussian id of each tile's first `cap` lanes; slots
    past a tile's count get id n, which gathers the zero row of `zrow`."""
    dev = binned.tile_bin_start.device
    k_range = torch.arange(cap, dtype=torch.int64, device=dev)
    lanes = binned.sorted_gauss_ids.shape[0]
    start = binned.tile_bin_start.to(torch.int64)[:, None]
    idx = (start + k_range).clamp(max=max(lanes - 1, 0))  # [T, cap]
    ids = binned.sorted_gauss_ids.to(torch.int64)[idx] if lanes else torch.full_like(idx, n)
    count = torch.clamp(binned.tile_counts, max=cap).to(torch.int64)[:, None]
    return torch.where(k_range[None, :] < count, ids, n)


def zrow(a: torch.Tensor) -> torch.Tensor:
    """`a` with one zero row appended (index n)."""
    return torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=a.device)])


def rasterize_binned(
    binned: BinnedSplats,
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    block_w: int = 16,
    block_h: int = 16,
    cap: int = 256,
) -> torch.Tensor:
    """Render [H, W, C] from binned splats, TILE_CHUNK tiles at a time."""
    dev, dtype = xys.device, xys.dtype
    n = xys.shape[0]
    c_dim = colors.shape[-1]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y

    ids = tile_lane_ids(binned, cap, n)
    xys_p, conics_p = zrow(xys), zrow(conics)
    colors_p, opac_p = zrow(colors), zrow(opacity.reshape(-1))

    local_y = torch.arange(block_h, dtype=dtype, device=dev).repeat_interleave(block_w)
    local_x = torch.arange(block_w, dtype=dtype, device=dev).repeat(block_h)
    out = torch.empty((num_tiles, block_h * block_w, c_dim), dtype=dtype, device=dev)
    for t0 in range(0, num_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, num_tiles)
        tids = torch.arange(t0, t1, device=dev)
        g = ids[t0:t1]  # [tc, cap]
        px = ((tids % tb_x) * block_w).to(dtype)[:, None] + local_x  # [tc, pix]
        py = ((tids // tb_x) * block_h).to(dtype)[:, None] + local_y
        dx = xys_p[g, 0][:, :, None] - px[:, None, :]  # [tc, cap, pix]
        dy = xys_p[g, 1][:, :, None] - py[:, None, :]
        gco = conics_p[g]
        sigma = (
            0.5 * (gco[..., 0:1] * dx * dx + gco[..., 2:3] * dy * dy)
            + gco[..., 1:2] * dx * dy
        )
        alpha = _min1_forward_only(opac_p[g][:, :, None] * torch.exp(-sigma))
        w = torch.where((sigma >= 0.0) & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
        out[t0:t1] = torch.einsum("tkc,tkp->tpc", colors_p[g], w)
    img = (
        out.reshape(tb_y, tb_x, block_h, block_w, c_dim)
        .permute(0, 2, 1, 3, 4)
        .reshape(tb_y * block_h, tb_x * block_w, c_dim)
    )
    return img[:img_height, :img_width]

"""Binned sum-rasterizer in plain PyTorch (gather + reduce per tile).

PyTorch port of gsvc_tpu/ops/rasterize_binned.py and the plain version of
the forward kernel (ops/rasterize_cuda.py): the same CSR binning and
per-tile cap, evaluated as dense [tiles, cap, pixels] tensor math over
chunks of tiles. Serves any channel count C.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gsvc_tpu_torch.ops.binning import BinnedSplats
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF, _min1_forward_only

# Tiles per step: each materialises [TILE_CHUNK, cap, block_h * block_w]
# floats (16 MB at cap 256 and 16x16 tiles).
TILE_CHUNK = 64
# log2(e) rounded to float32, the constant of the card's __expf (exact as a
# Python float, so a float32 product with it rounds once)
LOG2E = 1.4426950216293335


def splat_vis(sigma: torch.Tensor, fast_color: bool = False) -> torch.Tensor:
    """exp(-sigma); with `fast_color`, the fast-colour kernels' __expf(-sigma)
    as the card computes it: ex2.approx of the float32 product -sigma *
    log2(e), here exp2 of that product. What the emulation leaves out is
    ex2.approx's own error, ~2 ulp of the result."""
    if not fast_color:
        return torch.exp(-sigma)
    return torch.exp2(sigma * -LOG2E)


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


def tile_span(tile_rows: Optional[Tuple[int, int]], tb_y: int) -> Tuple[int, int]:
    """(row0, num_rows) of a render's tile-row span `tile_rows`, or the whole
    grid (0, tb_y) for None (gsvc_tpu's `tile_rows`). A span may reach past
    the grid's tb_y rows, as the last shards of a height that the shards do
    not divide do: its tiles there are empty."""
    if tile_rows is None:
        return 0, tb_y
    row0, num_rows = int(tile_rows[0]), int(tile_rows[1])
    if row0 < 0 or num_rows < 1:
        raise ValueError(f"tile_rows {tuple(tile_rows)}: want row0 >= 0, num_rows >= 1")
    return row0, num_rows


def span_height(tile_rows, tb_y: int, img_height: int, block_h: int = 16) -> int:
    """Pixel rows of a render's image / chw output: img_height when the span
    is all tb_y rows of the grid, else num_rows * block_h (gsvc_tpu's
    `partial_shard`, rasterize_pallas.py:925-926). The pixels of a partial
    span at or past img_height hold 0 in the port (gsvc_tpu renders the
    splats there); a sharded loss masks them either way."""
    _row0, num_rows = tile_span(tile_rows, tb_y)
    return img_height if num_rows == tb_y else num_rows * block_h


def span_lane_ids(binned: BinnedSplats, cap: int, n: int, tb_x: int, tb_y: int,
                  tile_rows=None) -> torch.Tensor:
    """`tile_lane_ids` of the span's num_rows * tb_x tiles, in span order:
    a tile past the grid gets id n in every lane (no splat)."""
    ids = tile_lane_ids(binned, cap, n)
    row0, num_rows = tile_span(tile_rows, tb_y)
    if (row0, num_rows) == (0, tb_y):
        return ids
    grid = (row0 * tb_x + torch.arange(num_rows * tb_x, device=ids.device)).clamp(
        max=tb_x * tb_y)
    return torch.cat([ids, ids.new_full((1, cap), n)])[grid]


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
    tile_rows: Optional[Tuple[int, int]] = None,
    fast_color: bool = False,
) -> torch.Tensor:
    """Render [H, W, C] from binned splats, TILE_CHUNK tiles at a time.

    tile_rows=(row0, num_rows) renders only tile rows [row0, row0 +
    num_rows) of the grid, in the grid's pixel coordinates (the binning
    stays the whole frame's): [span_height, W, C], zero at pixel rows at
    or past H (`span_height`). `fast_color` takes the fast-colour
    kernels' exponential (`splat_vis`)."""
    dev, dtype = xys.device, xys.dtype
    n = xys.shape[0]
    c_dim = colors.shape[-1]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    row0, num_rows = tile_span(tile_rows, tb_y)
    num_tiles = tb_x * num_rows
    tile0 = row0 * tb_x

    ids = span_lane_ids(binned, cap, n, tb_x, tb_y, tile_rows)
    xys_p, conics_p = zrow(xys), zrow(conics)
    colors_p, opac_p = zrow(colors), zrow(opacity.reshape(-1))

    local_y = torch.arange(block_h, dtype=dtype, device=dev).repeat_interleave(block_w)
    local_x = torch.arange(block_w, dtype=dtype, device=dev).repeat(block_h)
    out = torch.empty((num_tiles, block_h * block_w, c_dim), dtype=dtype, device=dev)
    for t0 in range(0, num_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, num_tiles)
        tids = torch.arange(tile0 + t0, tile0 + t1, device=dev)  # grid tiles
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
        alpha = _min1_forward_only(opac_p[g][:, :, None] * splat_vis(sigma, fast_color))
        w = torch.where((sigma >= 0.0) & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
        out[t0:t1] = torch.einsum("tkc,tkp->tpc", colors_p[g], w)
    img = (
        out.reshape(num_rows, tb_x, block_h, block_w, c_dim)
        .permute(0, 2, 1, 3, 4)
        .reshape(num_rows * block_h, tb_x * block_w, c_dim)
    )
    out_h = span_height(tile_rows, tb_y, img_height, block_h)
    img = img[:out_h, :img_width]
    if row0 * block_h + out_h > img_height:  # a span's rows past the image
        py = row0 * block_h + torch.arange(out_h, device=dev)[:, None, None]
        img = torch.where(py < img_height, img, 0.0)
    return img

"""Tile binning: per-tile splat lists (CSR) sorted by (tile, gaussian).

PyTorch port of gsvc_tpu/ops/binning.py. Each gaussian/tile intersection
becomes one key (tile << gauss_bits | gauss) written by K1
(ops/fill_cuda.fill_decode_keys), laid out by
`fill_cuda.key_layout(num_tiles, n)`: a 16-bit gauss field below 65,536
splats, as wide as n needs above, in int32 where the keys fit 31 bits and
int64 beyond; one `torch.sort` orders them; K2
(`rank_cap_decode`) splits the sorted keys into tile and gaussian ids,
applies the per-tile cap (forward.cu:613) and finds each tile's run, whose
edges give `tile_bin_start` and `tile_counts`. No host sync: the intersection
budget `max_intersects` is static and the kept total stays on the device.

The port matches the JAX package's outputs, not its TPU layout: the
row-superblock padding to LANE_ALIGN lanes is not reproduced, so the sorted
arrays hold exactly `max_intersects` lanes and `tile_bin_start` is the
exclusive prefix of `tile_counts`. gsvc_tpu sorts (tile, gauss) pairs with
a stable sort where its 16-bit key does not reach (n >= 65,535); the wider
key gives the port the same (tile, gauss) order at every n below 2^23.

If the budget overflows, whole gaussians are dropped from the tail
(highest indices) and `overflow` counts the lost intersections.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gsvc_tpu_torch.ops import fill_cuda
from gsvc_tpu_torch.ops.projection import _tile_bbox


class BinnedSplats(NamedTuple):
    """CSR view of gaussian/tile intersections, sorted by (tile, gaussian).

    sorted_gauss_ids: [I] int32 gaussian per lane; n for budget-dropped
      slots and lanes ranked >= cap in their tile.
    sorted_tile_ids: [I] int32 tile per lane; num_tiles past the kept total.
    tile_bin_start: [T] int32 first lane of each tile's run.
    tile_counts: [T] int32 intersections of each tile (before the cap).
    num_intersects: [] int32 kept intersections.
    overflow: [] int32 intersections dropped by the budget.
    sorted_keys: [I] sorted (tile << gauss_bits | gauss) keys, before the
      cap, laid out by `fill_cuda.key_layout(num_tiles, n)` (int32 or
      int64).
    gauss_slot_start: [N+1] int32 exclusive prefix of kept per-gaussian
      counts (gaussian g owns slots [start[g], start[g+1]) in gauss order).
    bbox_pack: [N] int32 (bbox_w << 16 | tmin_y << 8 | tmin_x).
    """

    sorted_gauss_ids: torch.Tensor
    sorted_tile_ids: torch.Tensor
    tile_bin_start: torch.Tensor
    tile_counts: torch.Tensor
    num_intersects: torch.Tensor
    overflow: torch.Tensor
    sorted_keys: torch.Tensor
    gauss_slot_start: torch.Tensor
    bbox_pack: torch.Tensor


def _kept(nth: torch.Tensor, max_intersects: int):
    """Whole-gaussian budget drop: (cum, kept, kept_nth)."""
    nth = nth.to(torch.int32)
    cum = torch.cumsum(nth, 0, dtype=torch.int32)
    kept = (cum <= max_intersects) & (nth > 0)
    return cum, kept, torch.where(kept, nth, 0)


class KeyInputs(NamedTuple):
    """Per-gaussian start slots, tile counts and bboxes; `k1` holds the
    arguments of K1 (`fill_cuda.fill_decode_keys`), in order."""

    starts: torch.Tensor  # [N] int32 exclusive start slot per gaussian
    nth: torch.Tensor  # [N] int32 tiles hit
    kept: torch.Tensor  # [N] bool inside the budget and hitting a tile
    tmin_x: torch.Tensor  # [N] int32 tile bbox
    tmin_y: torch.Tensor
    bbox_w: torch.Tensor  # [N] int32 max(tmax_x - tmin_x, 1)
    total_kept: torch.Tensor  # [] int32
    num_slots: int  # the budget
    tb_x: int
    num_tiles: int

    @property
    def k1(self) -> tuple:
        return (self.starts, self.tmin_x, self.tmin_y, self.bbox_w, self.total_kept,
                self.num_slots, self.tb_x, self.num_tiles)


def key_inputs(
    xys: torch.Tensor,
    radii: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    tile_bounds: Tuple[int, int, int],
    block_w: int,
    block_h: int,
    max_intersects: int,
) -> KeyInputs:
    """Per-gaussian tile bboxes and budget slots for K1, with the packing
    limits of gsvc_tpu's binning.

    starts is the exclusive prefix of the tile counts, so a splat that hits
    no tile shares its successor's start, and the budget drops whole splats
    from the tail, each starting at or after total_kept: the owner of a slot
    below total_kept is the last splat whose start is at or below it, all
    that K1 needs. The keys K1 makes follow `fill_cuda.key_layout(num_tiles,
    n)`: int32 for every grid up to 3840x2160 at 16-pixel tiles below 65,536
    splats, and at 1080p up to 262,143 splats; int64 beyond."""
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    if tb_x > 255 or tb_y > 255:
        raise ValueError(
            f"tile grid {tb_x}x{tb_y} exceeds the 8-bit tile-coordinate "
            "packing (max 255 tiles per axis — up to ~4K video at 16px tiles)"
        )
    if n >= (1 << 23):
        raise ValueError(f"num_points {n} exceeds the 23-bit gaussian-id packing")
    if max_intersects >= (1 << 23):
        raise ValueError(
            f"max_intersects {max_intersects} exceeds the 23-bit start-slot "
            "packing of the seed rows"
        )
    tmin_x, tmin_y, tmax_x, _tmax_y = _tile_bbox(
        xys, radii.to(xys.dtype), tile_bounds, block_w, block_h
    )
    nth = num_tiles_hit.to(torch.int32).contiguous()
    cum, kept, kept_nth = _kept(nth, max_intersects)
    return KeyInputs(
        starts=(cum - nth).contiguous(),
        nth=nth,
        kept=kept.contiguous(),
        tmin_x=tmin_x.contiguous(),
        tmin_y=tmin_y.contiguous(),
        bbox_w=torch.clamp(tmax_x - tmin_x, min=1).contiguous(),
        total_kept=kept_nth.sum(dtype=torch.int32),
        num_slots=max_intersects,
        tb_x=tb_x,
        num_tiles=tb_x * tb_y,
    )


def bin_gaussians(
    xys: torch.Tensor,
    radii: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    tile_bounds: Tuple[int, int, int],
    block_w: int,
    block_h: int,
    max_intersects: int,
    cap: int = 256,
    kernels: bool = True,
) -> BinnedSplats:
    """Bin projected splats into tiles.

    kernels=True runs K1/K2 through their wrappers (the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU tensor); kernels=False runs
    the plain versions on either device (the port's all-PyTorch path).
    """
    n = xys.shape[0]
    dev = xys.device
    ki = key_inputs(
        xys, radii, num_tiles_hit, tile_bounds, block_w, block_h, max_intersects
    )
    if kernels:
        keys = fill_cuda.fill_decode_keys(*ki.k1)
    else:
        keys = fill_cuda.fill_decode_keys_torch(*ki.k1)
    skeys = torch.sort(keys).values
    decode = fill_cuda.rank_cap_decode if kernels else fill_cuda.rank_cap_decode_torch
    tile_ids, gauss_ids, edges = decode(skeys, cap, n, ki.num_tiles)
    kept_nth = torch.where(ki.kept, ki.nth, 0)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return BinnedSplats(
        sorted_gauss_ids=gauss_ids,
        sorted_tile_ids=tile_ids,
        tile_bin_start=edges[:-1],
        tile_counts=edges[1:] - edges[:-1],
        num_intersects=ki.total_kept,
        overflow=ki.nth.sum(dtype=torch.int32) - ki.total_kept,
        sorted_keys=skeys,
        gauss_slot_start=torch.cat([zero, torch.cumsum(kept_nth, 0, dtype=torch.int32)]),
        bbox_pack=(ki.bbox_w << 16) | (ki.tmin_y << 8) | ki.tmin_x,
    )


def key_attrs(tile_bounds: Tuple[int, int, int], n: int) -> dict:
    """The keys' layout for `n` splat rows on the grid of `tile_bounds` as
    a span's attributes: `key_bytes`, a key's width in bytes, and
    `gauss_bits`, its gauss field's (`fill_cuda.key_layout`)."""
    layout = fill_cuda.key_layout(int(tile_bounds[0]) * int(tile_bounds[1]), n)
    return {"key_bytes": layout.dtype.itemsize, "gauss_bits": layout.gauss_bits}


def budget_overflow(num_tiles_hit: torch.Tensor, max_intersects: int) -> torch.Tensor:
    """Intersections `bin_gaussians` would drop for this budget ([] int32)."""
    cum, _kept_mask, kept_nth = _kept(num_tiles_hit, max_intersects)
    if cum.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=cum.device)
    return cum[-1] - kept_nth.sum(dtype=torch.int32)


def default_max_intersects(num_points: int, num_tiles: int, factor: int = 16) -> int:
    """Static intersection budget heuristic (gsvc_tpu's, rounded to 1024)."""
    budget = max(num_points * factor, num_tiles * 4, 1024)
    return ((budget + 1023) // 1024) * 1024

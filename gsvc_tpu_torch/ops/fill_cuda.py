"""Tile-binning index kernels K1 and K2 (csrc/fill.cu) and the segmented
cumsum K3 (csrc/segsum.cu), with their plain PyTorch versions.

Keys are (tile << gauss_bits | gauss), laid out by `key_layout(num_tiles,
n)`: the gauss field is max(16, n.bit_length()) bits wide, its sentinel
(2**gauss_bits - 1, at least n) marks slots past the kept total, and the
keys are int32 where the sentinel key (num_tiles << gauss_bits | that
sentinel) fits 31 bits, int64 above (PyTorch sorts no uint32). Below
65,536 splats the field is 16 bits, the JAX package's uint32 keys; 1080p
(8,160 tiles) keeps int32 keys up to 262,143 splats, 3840x2160 (32,400
tiles) up to 65,535. The int32 sort is the cheaper one. gsvc_tpu packs
16-bit keys only below 65,535 splats and sorts (tile, gauss) pairs with a
stable sort above; one key a slot of the width the splat count needs gives
that order with one `torch.sort`, whose keys are unique for real slots and
equal for sentinels.

K1 `fill_decode_keys` replaces `_fill_kernel` / `fill_decode_keys` of
gsvc_tpu/ops/fill_pallas.py. The TPU scatters one seed per gaussian and
forward-fills it over the intersection slots with a carried running max,
because its grid is sequential. On the card it is one launch, one CTA per
block of 1024 consecutive slots: one 256-way round of search over `starts`
brackets the owners of the block's slots, the CTA stages those gaussians
(start, bbox origin, width) in shared memory, and each thread finds the
owners of four consecutive slots there and writes their keys as one vector
store, so every write is coalesced. A slot's owner is the last gaussian
whose start is at or below it, so K1 reads no tile counts or kept mask:
`binning.key_inputs` makes starts the exclusive prefix of the counts, and
every gaussian past the budget starts at or after the kept total. Slots
from `total_kept` on, which it reads on the device (no host sync), get the
sentinel. Its bound is bytes (16 n + 4 + 4 S at int32 keys), far under one
launch; the few dependent loads of the search are its time.

K2 `rank_cap_decode` replaces `_rank_kernel` / `rank_cap_decode`, and
`bin_gaussians`' `searchsorted` of the tile edges. The TPU carries each tile
run's start from one grid step to the next; CUDA blocks run in no order.
On the card it is one launch with no carry: the keys are sorted, so a
lane's rank in its tile run reaches the cap exactly when the lane `cap`
back holds the same tile (a second, shifted vector load), and the lanes
where the tile changes write the tile edges (edge u: the first lane whose
tile is >= u), each edge once, a long run of empty tiles by a whole warp.
It reads keys of either width; its bound is bytes, far under one launch.

K3 `segmented_cumsum` replaces `_segsum_kernel` / `segmented_cumsum`, the
lane->splat gradient reduction's scan. The TPU carries each row's running
sum from one sequential grid step to the next. On the card it is one
launch of a thread-block cluster of 16 CTAs a row (`SEG_CLUSTER`): each warp
scans its own run of 128-lane steps in order, its carry in registers,
prefetching with cp.async, and writes each value once; the warps' totals
meet in shared memory, each CTA pushes its span's total into the shared
memory of the later CTAs of its cluster (distributed shared memory), and
each combines its predecessors' in rank order and adds that carry to its
lanes before their first flag. The order is fixed and no float is added atomically, so two
launches are bitwise equal. Bytes bound it (one read and one write of the
values, 6.2 MB for [9, 81920]).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (`_build.launch`, counted as the recorder's
`launches.<wrapper>`) or raises. Every K1 call, kernel or plain version,
adds the keys it wrote and their bytes to the recorder's counters
`binning.keys` and `binning.key_bytes` (`utils.profiling.RECORDER`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.utils.profiling import RECORDER


class KeyLayout(NamedTuple):
    """How K1 packs a (tile, gauss) pair into one sort key."""

    dtype: torch.dtype  # int32 or int64
    gauss_bits: int  # the gauss field's width: key = tile << gauss_bits | gauss
    sentinel: int  # the key of a slot past the kept total

    @property
    def gauss_mask(self) -> int:
        """The gauss field's mask, also its sentinel (>= n)."""
        return (1 << self.gauss_bits) - 1


def key_layout(num_tiles: int, n: int) -> KeyLayout:
    """The keys' layout for `n` splats on a grid of `num_tiles` tiles."""
    gauss_bits = max(16, int(n).bit_length())
    sentinel = (int(num_tiles) << gauss_bits) | ((1 << gauss_bits) - 1)
    return KeyLayout(torch.int32 if sentinel < 2**31 else torch.int64, gauss_bits,
                     sentinel)


def fill_decode_keys_torch(
    starts, tmin_x, tmin_y, bbox_w, total_kept,
    num_slots: int, tb_x: int, num_tiles: int,
) -> torch.Tensor:
    """Plain version of K1: per-gaussian bbox data -> [num_slots] keys laid
    out by `key_layout(num_tiles, n)`.

    Slot i < total_kept belongs to the last gaussian g with starts[g] <= i
    (starts is non-decreasing from 0); its rank j = i - starts[g] inside g's
    tile bbox decodes row-major to tile (tmin_y + j // bw, tmin_x + j % bw).
    Slots from total_kept on get the layout's sentinel.
    """
    dev = starts.device
    n = starts.shape[0]
    layout = key_layout(num_tiles, n)
    sentinel = torch.full((num_slots,), layout.sentinel, dtype=layout.dtype, device=dev)
    if n == 0:
        return sentinel
    i = torch.arange(num_slots, dtype=torch.int64, device=dev)
    start = starts.to(torch.int64)
    g = (torch.searchsorted(start, i, right=True) - 1).clamp(min=0)
    valid = i < total_kept.to(torch.int64)
    j = i - start[g]
    bw = bbox_w.to(torch.int64)[g].clamp(min=1)
    ty = tmin_y.to(torch.int64)[g] + j // bw
    tx = tmin_x.to(torch.int64)[g] + j % bw
    keys = (((ty * tb_x + tx) << layout.gauss_bits) | g).to(layout.dtype)
    return torch.where(valid, keys, sentinel)


def fill_decode_keys(
    starts, tmin_x, tmin_y, bbox_w, total_kept,
    num_slots: int, tb_x: int, num_tiles: int,
) -> torch.Tensor:
    """K1: [N] int32 per-gaussian start slots and tile bboxes, [] int32
    total_kept -> [num_slots] (tile << gauss_bits | gauss) keys laid out by
    `key_layout(num_tiles, n)` (`binning.KeyInputs.k1` holds these
    arguments)."""
    if not starts.is_cuda:
        return _counted(fill_decode_keys_torch(
            starts, tmin_x, tmin_y, bbox_w, total_kept, num_slots, tb_x, num_tiles,
        ))
    dev = starts.device
    n = starts.shape[0]
    ints = (starts, tmin_x, tmin_y, bbox_w)
    for t in ints:
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError("fill_decode_keys: per-gaussian inputs must be "
                             f"contiguous int32 [{n}] on {dev}")
    total = total_kept.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
    layout = key_layout(num_tiles, n)
    keys = torch.empty((num_slots,), dtype=layout.dtype, device=dev)
    _build.launch(
        _fill_lib(), "fill_decode_keys", dev, *(_build.ptr(t) for t in ints),
        _build.ptr(total), n, tb_x, num_tiles, num_slots, keys.element_size(),
        layout.gauss_bits, _build.ptr(keys),
    )
    return _counted(keys)


def _counted(keys: torch.Tensor) -> torch.Tensor:
    """`keys`, added to the recorder's counters `binning.keys` and
    `binning.key_bytes` (host side; a graph replay adds what its capture
    added, as it does every counter's)."""
    RECORDER.add("binning.keys", keys.numel())
    RECORDER.add("binning.key_bytes", keys.numel() * keys.element_size())
    return keys


def rank_cap_decode_torch(sorted_keys: torch.Tensor, cap: int, n: int,
                          num_tiles: int):
    """Plain version of K2: sorted int32 or int64 keys laid out by
    `key_layout(num_tiles, n)` -> (tile ids, gauss ids, tile edges), all
    int32. Ids are [S]; lanes ranked >= cap in their tile run, and sentinel
    lanes, get gauss id n. Edges are [num_tiles + 1]: edge u is the first
    lane whose tile is >= u, so edge num_tiles is the first sentinel lane (S
    when there is none)."""
    layout = key_layout(num_tiles, n)
    tile = (sorted_keys >> layout.gauss_bits).to(torch.int32)
    gauss = sorted_keys & layout.gauss_mask
    lane = torch.arange(sorted_keys.shape[0], dtype=torch.int64,
                        device=sorted_keys.device)
    change = torch.ones_like(tile, dtype=torch.bool)
    change[1:] = tile[1:] != tile[:-1]
    run_start = torch.cummax(torch.where(change, lane, 0), 0).values
    rank = lane - run_start
    gauss_ids = torch.where((rank < cap) & (gauss != layout.gauss_mask), gauss, n)
    edges = torch.searchsorted(
        tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=tile.device)
    ).to(torch.int32)
    return tile, gauss_ids.to(torch.int32), edges


def rank_cap_decode(sorted_keys: torch.Tensor, cap: int, n: int,
                    num_tiles: int):
    """K2: sorted keys laid out by `key_layout(num_tiles, n)`, in its dtype
    or int64 -> (tile ids [S], gauss ids [S], tile edges [num_tiles + 1]),
    all int32, with the per-tile cap applied; one launch."""
    if not sorted_keys.is_cuda:
        return rank_cap_decode_torch(sorted_keys, cap, n, num_tiles)
    if sorted_keys.dtype not in (torch.int32, torch.int64) or sorted_keys.dim() != 1:
        raise ValueError("rank_cap_decode: sorted_keys must be 1-D int32 or int64, "
                         f"got {sorted_keys.dtype} {tuple(sorted_keys.shape)}")
    if cap < 0 or num_tiles < 0:
        raise ValueError(f"rank_cap_decode: cap {cap} and num_tiles {num_tiles} "
                         "must be >= 0")
    layout = key_layout(num_tiles, n)
    if sorted_keys.dtype.itemsize < layout.dtype.itemsize:
        raise ValueError(f"rank_cap_decode: {n} splats on {num_tiles} tiles need "
                         f"{layout.dtype} keys, got {sorted_keys.dtype}")
    dev = sorted_keys.device
    keys = sorted_keys.contiguous()
    s = keys.shape[0]
    tile_ids = torch.empty((s,), dtype=torch.int32, device=dev)
    gauss_ids = torch.empty((s,), dtype=torch.int32, device=dev)
    edges = torch.empty((num_tiles + 1,), dtype=torch.int32, device=dev)
    _build.launch(
        _fill_lib(), "rank_cap_decode", dev, _build.ptr(keys), s, keys.element_size(),
        layout.gauss_bits, cap, n, num_tiles, _build.ptr(tile_ids), _build.ptr(gauss_ids),
        _build.ptr(edges),
    )
    return tile_ids, gauss_ids, edges


def segmented_cumsum_torch(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the inclusive cumsum along the last axis minus
    the cumsum carried in from before each lane's segment start (taken in
    float64, so the difference loses nothing in f32)."""
    s = vals.shape[-1]
    cs = torch.cumsum(vals.to(torch.float64), dim=-1)
    lane = torch.arange(s, dtype=torch.int64, device=vals.device)
    start = torch.cummax(torch.where(flags != 0, lane, 0), 0).values
    before = torch.where(start > 0, cs[..., (start - 1).clamp(min=0)], 0.0)
    return (cs - before).to(vals.dtype)


SEG_CLUSTER = 16  # CTAs a row in K3's cluster (segsum.cu's kCluster)


def segmented_cumsum(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """K3: inclusive segmented cumsum of [R, S] float32 values along S;
    flags [S] int32 is nonzero at each segment's first lane (gsvc_tpu's
    `fill_pallas.segmented_cumsum`)."""
    if not vals.is_cuda:
        return segmented_cumsum_torch(vals, flags)
    dev = vals.device
    if vals.dtype != torch.float32 or vals.dim() != 2 or vals.shape[0] > 32:
        raise ValueError("segmented_cumsum: vals must be float32 [R <= 32, S], "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    rows, s = vals.shape
    if flags.dtype != torch.int32 or tuple(flags.shape) != (s,) or flags.device != dev:
        raise ValueError(f"segmented_cumsum: flags must be int32 [{s}] on {dev}")
    v = vals.contiguous()
    out = torch.empty_like(v)
    _build.launch(
        _segsum_lib(), "segmented_cumsum", dev, _build.ptr(v),
        _build.ptr(flags.contiguous()), rows, s, _build.ptr(out),
    )
    return out


def _segsum_lib() -> ctypes.CDLL:
    return _build.bind("segsum", {
        "segmented_cumsum": (I32, [VP, VP, I32, I64, VP, VP])})


def _fill_lib() -> ctypes.CDLL:
    return _build.bind("fill", {
        "fill_decode_keys": (I32, [VP] * 5 + [I32, I32, I32, I64, I32, I32, VP, VP]),
        "rank_cap_decode": (I32, [VP, I64] + [I32] * 5 + [VP] * 4)})

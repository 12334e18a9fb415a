"""Tile-binning index kernels K1 and K2 (csrc/fill.cu) and the segmented
cumsum K3 (csrc/segsum.cu), with their plain PyTorch versions.

K1 `fill_decode_keys` replaces `_fill_kernel` / `fill_decode_keys` of
gsvc_tpu/ops/fill_pallas.py. The TPU scatters one seed per gaussian and
forward-fills it over the intersection slots with a carried running max,
because its grid is sequential and scatters are serial there. On the card
one thread per gaussian writes its own bbox's keys at its exclusive
offset, so neither the seed scatter nor the scan exists; a second kernel
writes the sentinel past `total_kept`, which it reads on the device.

K2 `rank_cap_decode` replaces `_rank_kernel` / `rank_cap_decode`. The TPU
carries each tile run's start from one grid step to the next; CUDA blocks
run in no order, so it becomes two passes: lanes where the tile changes
write the run start per tile, then every lane takes its rank from it and
applies the per-tile cap (forward.cu:613).

Both are integer index work bound by device-memory traffic (a few int64
reads and writes per slot, about 2.5 MB at 1080p/10k) and by launch
latency at these sizes; the design keeps each to one pass over its slots
with coalesced lane-parallel access (K1's per-gaussian writes are strided
by the bbox, which is small). Keys are int64 here, with the JAX uint32
values: PyTorch's uint32 sort support is thin.

K3 `segmented_cumsum` replaces `_segsum_kernel` / `segmented_cumsum`, the
lane->splat gradient reduction's scan. The TPU carries each row's running
sum from one sequential grid step to the next and scans inside a block by
log-shift rolls. CUDA blocks cannot carry, so it becomes three passes in a
fixed order: a block-local segmented scan (a thread's 4 lanes in order,
then warp shuffles, then the 8 warp totals), one thread per row turning
the block tails into carries in block order, and a fix-up adding each
block's carry to its lanes before the block's first flag. It reads and
writes each value twice (~6 MB at 1080p/10k), so memory traffic and the
three launches bound it.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `<wrapper>.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from gsvc_tpu_torch import _build

_SENT_GAUSS = 0xFFFF


def _sentinel(num_tiles: int) -> int:
    return (num_tiles << 16) | _SENT_GAUSS


def fill_decode_keys_torch(
    starts, nth, kept, tmin_x, tmin_y, bbox_w, total_kept,
    num_slots: int, tb_x: int, num_tiles: int,
) -> torch.Tensor:
    """Plain version of K1: per-gaussian bbox data -> [num_slots] int64 keys.

    Slot i < total_kept belongs to the kept gaussian g whose slot span
    [starts[g], starts[g] + nth[g]) holds it; its rank j inside g's tile
    bbox decodes row-major to tile (tmin_y + j // bw, tmin_x + j % bw).
    Slots past total_kept get the sentinel (num_tiles << 16 | 0xFFFF).
    """
    dev = starts.device
    n = starts.shape[0]
    sentinel = torch.full((num_slots,), _sentinel(num_tiles), dtype=torch.int64,
                          device=dev)
    if n == 0:
        return sentinel
    kept_nth = torch.where(kept, nth, 0).to(torch.int64)
    ends = torch.cumsum(kept_nth, 0)
    i = torch.arange(num_slots, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(ends, i, right=True)  # n past the last kept
    valid = owner < n
    g = owner.clamp(max=n - 1)
    j = i - starts.to(torch.int64)[g]
    bw = bbox_w.to(torch.int64)[g].clamp(min=1)
    ty = tmin_y.to(torch.int64)[g] + j // bw
    tx = tmin_x.to(torch.int64)[g] + j % bw
    keys = ((ty * tb_x + tx) << 16) | g
    return torch.where(valid, keys, sentinel)


def fill_decode_keys(
    starts, nth, kept, tmin_x, tmin_y, bbox_w, total_kept,
    num_slots: int, tb_x: int, num_tiles: int,
) -> torch.Tensor:
    """K1: [N] int32 per-gaussian starts / counts / bbox, [N] bool kept,
    [] int32 total_kept -> [num_slots] int64 (tile << 16 | gauss) keys."""
    if not starts.is_cuda:
        return fill_decode_keys_torch(
            starts, nth, kept, tmin_x, tmin_y, bbox_w, total_kept,
            num_slots, tb_x, num_tiles,
        )
    dev = starts.device
    n = starts.shape[0]
    ints = (starts, nth, tmin_x, tmin_y, bbox_w)
    for t in ints:
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError("fill_decode_keys: per-gaussian inputs must be "
                             f"contiguous int32 [{n}] on {dev}")
    if kept.dtype != torch.bool or kept.shape != (n,) or kept.device != dev:
        raise ValueError(f"fill_decode_keys: kept must be bool [{n}] on {dev}")
    total = total_kept.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
    kept = kept.contiguous()
    keys = torch.empty((num_slots,), dtype=torch.int64, device=dev)
    lib = _fill_lib()
    with torch.cuda.device(dev):
        rc = lib.fill_decode_keys(
            *(_build.ptr(t) for t in ints[:2]), _build.ptr(kept),
            *(_build.ptr(t) for t in ints[2:]), _build.ptr(total),
            n, tb_x, num_tiles, num_slots, _build.ptr(keys),
            _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "fill_decode_keys")
    fill_decode_keys.launches += 1
    return keys


fill_decode_keys.launches = 0


def rank_cap_decode_torch(sorted_keys: torch.Tensor, cap: int, n: int):
    """Plain version of K2: sorted int64 keys -> (tile ids, gauss ids),
    both [S] int32; lanes ranked >= cap in their tile run, and sentinel
    lanes, get gauss id n."""
    tile = (sorted_keys >> 16).to(torch.int32)
    gauss = (sorted_keys & _SENT_GAUSS).to(torch.int32)
    lane = torch.arange(sorted_keys.shape[0], dtype=torch.int64,
                        device=sorted_keys.device)
    change = torch.ones_like(tile, dtype=torch.bool)
    change[1:] = tile[1:] != tile[:-1]
    run_start = torch.cummax(torch.where(change, lane, 0), 0).values
    rank = lane - run_start
    gauss_ids = torch.where((rank < cap) & (gauss != _SENT_GAUSS), gauss, n)
    return tile, gauss_ids.to(torch.int32)


def rank_cap_decode(sorted_keys: torch.Tensor, cap: int, n: int,
                    num_tiles: int):
    """K2: sorted int64 keys whose tiles are <= num_tiles -> (tile ids,
    gauss ids), both [S] int32, with the per-tile cap applied."""
    if not sorted_keys.is_cuda:
        return rank_cap_decode_torch(sorted_keys, cap, n)
    if sorted_keys.dtype != torch.int64 or sorted_keys.dim() != 1:
        raise ValueError("rank_cap_decode: sorted_keys must be 1-D int64")
    dev = sorted_keys.device
    keys = sorted_keys.contiguous()
    s = keys.shape[0]
    run_start = torch.empty((num_tiles + 1,), dtype=torch.int32, device=dev)
    tile_ids = torch.empty((s,), dtype=torch.int32, device=dev)
    gauss_ids = torch.empty((s,), dtype=torch.int32, device=dev)
    lib = _fill_lib()
    with torch.cuda.device(dev):
        rc = lib.rank_cap_decode(
            _build.ptr(keys), s, cap, n, _build.ptr(run_start),
            _build.ptr(tile_ids), _build.ptr(gauss_ids), _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "rank_cap_decode")
    rank_cap_decode.launches += 1
    return tile_ids, gauss_ids


rank_cap_decode.launches = 0


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


_SEG_BLOCK = 1024  # lanes per CTA in csrc/segsum.cu


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
    nb = max((s + _SEG_BLOCK - 1) // _SEG_BLOCK, 1)
    tail = torch.empty((rows, nb), dtype=torch.float32, device=dev)
    carry = torch.empty_like(tail)
    bflag = torch.empty((rows, nb), dtype=torch.int32, device=dev)
    first = torch.empty((nb,), dtype=torch.int32, device=dev)
    lib = _segsum_lib()
    with torch.cuda.device(dev):
        rc = lib.segmented_cumsum(
            _build.ptr(v), _build.ptr(flags.contiguous()), rows, s,
            _build.ptr(tail), _build.ptr(bflag), _build.ptr(first),
            _build.ptr(carry), _build.ptr(out), _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "segmented_cumsum")
    segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0


def _segsum_lib() -> ctypes.CDLL:
    lib = _build.load("segsum")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segmented_cumsum.restype = i32
        lib.segmented_cumsum.argtypes = [vp, vp, i32, i64] + [vp] * 6
        lib._gsvc_bound = True
    return lib


def _fill_lib() -> ctypes.CDLL:
    lib = _build.load("fill")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fill_decode_keys.restype = i32
        lib.fill_decode_keys.argtypes = [vp] * 7 + [i32, i32, i32, i64, vp, vp]
        lib.rank_cap_decode.restype = i32
        lib.rank_cap_decode.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp]
        lib._gsvc_bound = True
    return lib

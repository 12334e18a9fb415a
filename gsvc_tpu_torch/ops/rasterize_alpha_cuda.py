"""The alpha compositor on the card: depth-ordered binning, the forward
kernel A1 and the backward kernel A2 (csrc/rasterize_alpha.cu), each
beside its plain PyTorch version, and their autograd function.

A1 and A2 replace no Pallas kernel: gsvc_tpu computes the compositor in
XLA (ops/rasterize_alpha.py:92-176), a scan over chunks of splats that
evaluates each chunk densely over every pixel. At 1920x1080 with 10k
splats that is 2.07e10 (splat, pixel) pairs, and a gradient through it
keeps ~850 GB of [chunk, H*W] intermediates, beyond an 80 GB card. So the
card gets two tile kernels (gsplat's forward.cu:252-374 and
backward.cu:242-315), which touch only the (tile, splat) intersections.

Binning (`bin_depth_ordered`). The splats are permuted into
argsort(depths, stable=True) order and binned by the port's
`bin_gaussians` (K1, torch.sort, K2): its (tile, gauss) key order is then
(tile, depth) order. Membership is gsvc_tpu's: a splat is valid where
radii > 0, and its tiles are `_tile_bbox` of its radius (num_tiles_hit is
recomputed, never read). Nothing is dropped: the budget is the exact sum
of tiles hit (one host read a call), the cap is that sum too (no tile
holds more), and a binning that overflowed raises.

A1 (forward): one CTA a 16x16 tile, a thread a pixel. The CTA stages
256 lanes at a time (position, conic, opacity, colours) in shared
memory and each thread composites them in depth order: alpha =
min(0.999, opac exp(-sigma)) at integer pixel coordinates, skipped where
sigma < 0 or alpha < 1/255, the pixel stopping before the splat whose
T (1 - alpha) <= 1e-4; the CTA leaves once all its pixels stopped. It
writes the image (plus T_final x background), 1 - T_final with
return_alpha, and for A2 each pixel's T_final and last contributing lane.
sigma is formed with explicitly rounded operations in the plain
version's order, and expf is the one ATen's exp calls, so A1 makes the
skip decisions of the plain version on the card; the break decision can
still differ from gsvc_tpu's, which forms T as exp(cumsum(log1p(-a))).

A2 (backward): one CTA a tile, a thread a pixel, sweeping the tile's
members back from the CTA's furthest last contributor in batches of
32 staged lanes. Each pixel recovers T before a splat as
T / (1 - alpha) and carries one scalar, the sum of later contributions
dotted with its image gradient, so the per-pixel state does not grow with
C (gsplat's backward.cu:242-315). A lane's 6 + C gradients (x, y, the
conic's three entries, opacity, the colours) are summed over the tile's
pixels by a fixed warp-shuffle tree and then over the 8 warps in order,
and written to the lane's expansion slot (gauss_slot_start[g] + its
tile's rank in g's bbox, K6's layout); K3 then reduces the slots to
splats (`fill_cuda.segmented_cumsum`). No float is added atomically, so
two launches are bitwise equal. The gradient is zero where alpha was
clamped at 0.999 and for splats at or past a pixel's break.

Colours of more than MAX_GROUP channels run as groups of at most
MAX_GROUP (each launch keeps its accumulators in registers): A1 writes
each group's columns; A2's colour rows are per group and its geometric
rows, linear in the image gradient, are summed over the groups.

Their least time on an H100 is set by bytes (the image, T_final and the
last lanes; `utils.work.alpha_work`), with the ~17 operations of each
evaluated (pixel, lane) pair close behind; they run far above it, bound
by issuing those operations a pixel a thread and, in A2, a 6 + C shuffle
tree a lane and warp. Simple first: shared-memory batches and shuffle
sums, no TMA or wgmma.

On a CPU tensor each wrapper runs its plain version (dense [tiles,
members, pixels] math over chunks of tiles); on a CUDA tensor it launches
its kernel or raises, counting each launch as the recorder's
`launches.<wrapper>` (`_build.launch`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.ops import fill_cuda
from gsvc_tpu_torch.ops.binning import BinnedSplats, bin_gaussians
from gsvc_tpu_torch.ops.projection import _tile_bbox
from gsvc_tpu_torch.ops.rasterize_alpha import ALPHA_CUTOFF, ALPHA_MAX, T_EPS
from gsvc_tpu_torch.ops.rasterize_binned import TILE_CHUNK, tile_lane_ids, zrow
from gsvc_tpu_torch.ops.rasterize_cuda import lane_slots, segment_flags

TILE = 16  # the kernels' tile side
MAX_GROUP = 32  # colour channels a launch (the kernels' largest template)
GEO_FIELDS = 6  # x y c1 c2 c3 opac: a lane's gradient rows before its colours
K3_ROWS = 32  # rows a K3 launch scans


class DepthBinned(NamedTuple):
    """Splats permuted into depth order and binned with every intersection
    kept: `order` [N] int64 (splat i of the binning is splat order[i]),
    `binned` over the permuted splats, `total` intersections."""

    order: torch.Tensor
    binned: BinnedSplats
    total: int


def bin_depth_ordered(xys, depths, radii, tile_bounds, block_w: int = 16,
                      block_h: int = 16, kernels: bool = True) -> DepthBinned:
    """Bin the splats in stable depth order, each on the tiles of
    `_tile_bbox` of its radius where radii > 0, with no budget or cap
    (kernels=False: K1 / K2's plain versions on any device)."""
    order = torch.argsort(depths, stable=True)
    xys_s, radii_s = xys[order].detach(), radii[order]
    tminx, tminy, tmaxx, tmaxy = _tile_bbox(
        xys_s, radii_s.to(xys.dtype), tile_bounds, block_w, block_h)
    area = (tmaxx - tminx) * (tmaxy - tminy)
    nth = torch.where(radii_s > 0, area, 0).to(torch.int32)
    total = int(nth.sum())  # the exact budget: the call's one host read
    binned = bin_gaussians(xys_s, radii_s, nth, tile_bounds, block_w, block_h,
                           total, cap=max(total, 1), kernels=kernels)
    if int(binned.overflow) != 0:
        raise RuntimeError(f"depth binning dropped {int(binned.overflow)} of "
                           f"{total} intersections")
    return DepthBinned(order, binned, total)


def groups(c_dim: int):
    """The channel groups [c0, c1) of the launches."""
    return [(c0, min(c0 + MAX_GROUP, c_dim)) for c0 in range(0, max(c_dim, 1), MAX_GROUP)]


def _template(cg: int) -> int:
    """The kernels' channel template for a group of cg channels."""
    for cmax in (4, 8, 16, 32):
        if cg <= cmax:
            return cmax
    raise ValueError(f"a group of {cg} channels exceeds {MAX_GROUP}")


# -- the plain versions -------------------------------------------------------


class _Terms(NamedTuple):
    dx: torch.Tensor  # [tc, m, pix]
    dy: torch.Tensor
    vis: torch.Tensor  # exp(-sigma)
    alpha_u: torch.Tensor  # opac * vis, before the clamp
    a: torch.Tensor  # the composited alpha, 0 where skipped
    T_before: torch.Tensor  # transmittance before the lane
    T_after: torch.Tensor  # and after it (unfrozen past a break)
    hit: torch.Tensor  # passes the sigma and alpha gates
    contrib: torch.Tensor  # hit, before the pixel's break


def _tile_terms(g, tids, splats, tb_x: int, block_w: int, block_h: int) -> _Terms:
    """The compositing terms of lanes g [tc, m] (ids into `zrow`ed splats,
    n past a tile's count) of tiles tids [tc] at the tiles' pixels, with
    A1's sequential transmittance (a cumulative product)."""
    xys_p, conics_p, _colors_p, opac_p = splats
    n = xys_p.shape[0] - 1
    dtype, dev = xys_p.dtype, xys_p.device
    local_y = torch.arange(block_h, dtype=dtype, device=dev).repeat_interleave(block_w)
    local_x = torch.arange(block_w, dtype=dtype, device=dev).repeat(block_h)
    px = ((tids % tb_x) * block_w).to(dtype)[:, None] + local_x  # [tc, pix]
    py = ((tids // tb_x) * block_h).to(dtype)[:, None] + local_y
    dx = xys_p[g, 0][:, :, None] - px[:, None, :]
    dy = xys_p[g, 1][:, :, None] - py[:, None, :]
    c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
    sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
    vis = torch.exp(-sigma)
    alpha_u = opac_p[g][:, :, None] * vis
    alpha = torch.clamp(alpha_u, max=ALPHA_MAX)
    hit = (g < n)[:, :, None] & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
    a = torch.where(hit, alpha, 0.0)
    T_incl = torch.cumprod(1.0 - a, dim=1)
    T_before = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], dim=1)
    # T_incl falls along the lanes: once at or under 1e-4 the pixel broke
    contrib = hit & (T_incl > T_EPS)
    return _Terms(dx, dy, vis, alpha_u, a, T_before, T_incl, hit, contrib)


def _chunks(binned: BinnedSplats, n: int, num_tiles: int):
    """(t0, t1, ids [tc, m], tids [tc]) over chunks of TILE_CHUNK tiles; m
    is the chunk's longest tile list."""
    counts = binned.tile_counts
    m_all = int(counts.max()) if num_tiles else 0
    ids = tile_lane_ids(binned, max(m_all, 1), n)
    dev = counts.device
    for t0 in range(0, num_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, num_tiles)
        m = max(int(counts[t0:t1].max()), 1)
        yield t0, t1, ids[t0:t1, :m], torch.arange(t0, t1, device=dev)


def to_tiles(img: torch.Tensor, tb_x: int, tb_y: int, block_w: int = 16,
             block_h: int = 16) -> torch.Tensor:
    """[H, W, C] -> [tiles, block_h * block_w, C], zero past the image."""
    h, w, c = img.shape
    img = torch.nn.functional.pad(img, (0, 0, 0, tb_x * block_w - w, 0, tb_y * block_h - h))
    img = img.reshape(tb_y, block_h, tb_x, block_w, c).permute(0, 2, 1, 3, 4)
    return img.reshape(tb_x * tb_y, block_h * block_w, c)


def from_tiles(t: torch.Tensor, tb_x: int, tb_y: int, img_height: int,
               img_width: int, block_w: int = 16, block_h: int = 16) -> torch.Tensor:
    """Inverse of `to_tiles`: [tiles, pix, ...] -> [H, W, ...]."""
    rest = tuple(t.shape[2:])
    img = t.reshape((tb_y, tb_x, block_h, block_w) + rest).transpose(1, 2)
    img = img.reshape((tb_y * block_h, tb_x * block_w) + rest)
    return img[:img_height, :img_width]


def alpha_forward_torch(binned: BinnedSplats, xys, conics, colors, opacity,
                        background, img_height: int, img_width: int,
                        tile_bounds: Tuple[int, int, int], return_alpha: bool = False,
                        block_w: int = 16, block_h: int = 16):
    """Plain version of A1 on depth-ordered, uncapped binning: (image
    [H, W, C], alpha [H, W] or None, T_final [H, W], the last
    contributing lane [H, W] int32, -1 for none)."""
    n, c_dim = colors.shape
    dev, f32 = xys.device, torch.float32
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y
    pix = block_w * block_h
    splats = (zrow(xys.to(f32)), zrow(conics.to(f32)), zrow(colors.to(f32)),
              zrow(opacity.reshape(-1).to(f32)))
    out = torch.zeros((num_tiles, pix, c_dim), dtype=f32, device=dev)
    T = torch.ones((num_tiles, pix), dtype=f32, device=dev)
    last = torch.full((num_tiles, pix), -1, dtype=torch.int64, device=dev)
    start = binned.tile_bin_start.to(torch.int64)
    for t0, t1, g, tids in _chunks(binned, n, num_tiles):
        tm = _tile_terms(g, tids, splats, tb_x, block_w, block_h)
        w = torch.where(tm.contrib, tm.a * tm.T_before, 0.0)
        out[t0:t1] = torch.einsum("tkp,tkc->tpc", w, splats[2][g])
        T[t0:t1] = torch.where(tm.contrib, tm.T_after, 1.0).amin(dim=1)
        lane = start[t0:t1, None, None] + torch.arange(g.shape[1], device=dev)[None, :, None]
        last[t0:t1] = torch.where(tm.contrib, lane, -1).amax(dim=1)
    out = out + T[:, :, None] * background.to(f32)
    img = from_tiles(out, tb_x, tb_y, img_height, img_width, block_w, block_h)
    T_img = from_tiles(T, tb_x, tb_y, img_height, img_width, block_w, block_h)
    last_img = from_tiles(last, tb_x, tb_y, img_height, img_width, block_w, block_h)
    alpha = (1.0 - T_img) if return_alpha else None
    return img, alpha, T_img.contiguous(), last_img.to(torch.int32).contiguous()


def alpha_backward_torch(binned: BinnedSplats, xys, conics, colors, opacity,
                         background, T_final, v_img, v_alpha, img_height: int,
                         img_width: int, tile_bounds: Tuple[int, int, int],
                         block_w: int = 16, block_h: int = 16):
    """Plain version of A2: (per-slot gradients [6 + C, S], rows x y c1 c2
    c3 opac and the colours, zero in slots no lane wrote; v_background
    [C]). Derived by hand from the compositing recurrence, as A2 is: with
    G the image gradient of a pixel and gc_k = G . c_k, the gradient in
    alpha_k is T_k gc_k - (D_k + vT T_final) / (1 - alpha_k), D_k the sum
    of gc_j alpha_j T_j over the later contributors and vT = G . bg -
    v_alpha."""
    n, c_dim = colors.shape
    dev, f32 = xys.device, torch.float32
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y
    s = binned.sorted_gauss_ids.shape[0]
    splats = (zrow(xys.to(f32)), zrow(conics.to(f32)), zrow(colors.to(f32)),
              zrow(opacity.reshape(-1).to(f32)))
    G = to_tiles(v_img.to(f32), tb_x, tb_y, block_w, block_h)  # [T, pix, C]
    Tf = to_tiles(T_final.to(f32)[..., None], tb_x, tb_y, block_w, block_h)[..., 0]
    vT = G @ background.to(f32)
    if v_alpha is not None:
        vT = vT - to_tiles(v_alpha.to(f32)[..., None], tb_x, tb_y, block_w, block_h)[..., 0]
    v_bg = torch.einsum("tp,tpc->c", Tf, G)
    out = torch.zeros((GEO_FIELDS + c_dim, s + 1), dtype=f32, device=dev)
    if s == 0:  # no intersection: no lane, no slot
        return out[:, :0], v_bg
    conics_p = splats[1]
    for t0, t1, g, tids in _chunks(binned, n, num_tiles):
        tm = _tile_terms(g, tids, splats, tb_x, block_w, block_h)
        Gc = G[t0:t1]
        gc = torch.einsum("tkc,tpc->tkp", splats[2][g], Gc)
        w = torch.where(tm.contrib, tm.a * tm.T_before, 0.0)
        wgc = w * gc
        later = wgc.sum(dim=1, keepdim=True) - torch.cumsum(wgc, dim=1)
        ra = 1.0 / (1.0 - tm.a)
        v_a = tm.T_before * gc - (later + (vT[t0:t1] * Tf[t0:t1])[:, None, :]) * ra
        v_a = torch.where(tm.contrib & (tm.alpha_u <= ALPHA_MAX), v_a, 0.0)
        v_sigma = -v_a * tm.alpha_u
        c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
        dx, dy = tm.dx, tm.dy
        grads = torch.stack([
            torch.sum((c1 * dx + c2 * dy) * v_sigma, -1),  # x
            torch.sum((c3 * dy + c2 * dx) * v_sigma, -1),  # y
            torch.sum(0.5 * dx * dx * v_sigma, -1),  # c1
            torch.sum(dx * dy * v_sigma, -1),  # c2
            torch.sum(0.5 * dy * dy * v_sigma, -1),  # c3
            torch.sum(v_a * tm.vis, -1),  # opacity
            *torch.einsum("tkp,tpc->ctk", w, Gc),  # the colours
        ])
        slots = lane_slots(binned, g, tids, tb_x, n)
        out[:, slots.reshape(-1)] = grads.reshape(grads.shape[0], -1)
    return out[:, :s], v_bg


def pair_counts(binned: BinnedSplats, xys, conics, opacity, img_height: int,
                img_width: int, tile_bounds: Tuple[int, int, int], block_w: int = 16,
                block_h: int = 16) -> Tuple[int, int, int]:
    """(pairs A1 evaluates, contributing pairs, pairs A2 evaluates) of the
    pixels inside the image: A1 walks a pixel's tile lanes up to and
    including the one it breaks before (all of them where it never
    breaks), A2 those up to its last contributor (`utils.work.alpha_work`)."""
    n = xys.shape[0]
    f32 = torch.float32
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    splats = (zrow(xys.to(f32)), zrow(conics.to(f32)), None,
              zrow(opacity.reshape(-1).to(f32)))
    inside = to_tiles(torch.ones((img_height, img_width, 1), device=xys.device),
                      tb_x, tb_y, block_w, block_h)[..., 0] > 0  # [T, pix]
    fwd = contrib = bwd = 0
    for t0, t1, g, tids in _chunks(binned, n, tb_x * tb_y):
        tm = _tile_terms(g, tids, splats, tb_x, block_w, block_h)
        count = binned.tile_counts[t0:t1].to(torch.int64)[:, None]
        alive = (tm.T_after > T_EPS).sum(dim=1)  # lanes before a break
        k = torch.arange(g.shape[1], device=g.device)[None, :, None]
        last = torch.where(tm.contrib, k, -1).amax(dim=1)
        ins = inside[t0:t1]
        fwd += int(torch.where(ins, torch.minimum(count, alive + 1), 0).sum())
        contrib += int((tm.contrib & ins[:, None, :]).sum())
        bwd += int(torch.where(ins, last + 1, 0).sum())
    return fwd, contrib, bwd


# -- the kernels --------------------------------------------------------------


def _check(what, binned, xys, conics, colors, opacity, background, tile_bounds,
           block_w, block_h):
    """Raise ValueError unless the splats are float32 on one device in the
    shapes of n splats of C channels, the binning int32 on the grid of
    `tile_bounds` in 16x16 tiles; the float buffers, contiguous."""
    dev = xys.device
    n, c_dim = colors.shape
    f32 = {"xys": (xys, (n, 2)), "conics": (conics, (n, 3)),
           "colors": (colors, (n, c_dim)), "opacity": (opacity.reshape(-1), (n,)),
           "background": (background, (c_dim,))}
    for name, (t, shape) in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (binned.tile_bin_start, binned.tile_counts, binned.sorted_gauss_ids,
              binned.gauss_slot_start, binned.bbox_pack):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{what}: binning arrays must be int32 on {dev}")
    if binned.tile_counts.shape[0] != int(tile_bounds[0]) * int(tile_bounds[1]):
        raise ValueError(f"{what}: binning tile grid mismatch")
    if (block_w, block_h) != (TILE, TILE):
        raise ValueError(f"{what}: the kernels take {TILE}x{TILE} tiles, got "
                         f"{block_w}x{block_h}")
    return [t.contiguous() for t, _ in f32.values()]


def alpha_forward(binned: BinnedSplats, xys, conics, colors, opacity, background,
                  img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
                  return_alpha: bool = False, block_w: int = 16, block_h: int = 16):
    """A1: the depth-ordered splats (their uncapped binning) -> (image
    [H, W, C], alpha [H, W] or None, T_final [H, W], last contributing
    lane [H, W] int32)."""
    if not xys.is_cuda:
        return alpha_forward_torch(binned, xys, conics, colors, opacity, background,
                                   img_height, img_width, tile_bounds, return_alpha,
                                   block_w, block_h)
    dev = xys.device
    f32 = _check("alpha_forward", binned, xys, conics, colors, opacity, background,
                 tile_bounds, block_w, block_h)
    n, c_dim = colors.shape
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    i32 = [t.contiguous() for t in (binned.tile_bin_start, binned.tile_counts,
                                    binned.sorted_gauss_ids)]
    img = torch.empty((img_height, img_width, c_dim), dtype=torch.float32, device=dev)
    alpha = (torch.empty((img_height, img_width), dtype=torch.float32, device=dev)
             if return_alpha else None)
    T = torch.empty((img_height, img_width), dtype=torch.float32, device=dev)
    last = torch.empty((img_height, img_width), dtype=torch.int32, device=dev)
    lib = _lib()
    null = ctypes.c_void_p(0)
    for gi, (c0, c1) in enumerate(groups(c_dim)):
        first = gi == 0  # the first group writes alpha, T and last
        _build.launch(
            lib, "alpha_forward", dev, *(_build.ptr(t) for t in i32 + f32), n, c_dim, c0,
            c1 - c0, _template(c1 - c0), img_height, img_width, tb_x, tb_x * tb_y,
            _build.ptr(img), _build.ptr(alpha) if first and return_alpha else null,
            _build.ptr(T) if first else null, _build.ptr(last) if first else null,
        )
    return img, alpha, T, last


def alpha_backward_slots(binned: BinnedSplats, xys, conics, colors, opacity,
                         background, T_final, last, v_img, v_alpha,
                         img_height: int, img_width: int,
                         tile_bounds: Tuple[int, int, int], block_w: int = 16,
                         block_h: int = 16):
    """A2: the image gradient v_img [H, W, C] (and v_alpha [H, W] or None)
    -> (per-slot gradients [6 + C, S], v_background [C]). `last` is A1's;
    the plain version recomputes it."""
    if not xys.is_cuda:
        return alpha_backward_torch(binned, xys, conics, colors, opacity, background,
                                    T_final, v_img, v_alpha, img_height, img_width,
                                    tile_bounds, block_w, block_h)
    dev = xys.device
    f32 = _check("alpha_backward", binned, xys, conics, colors, opacity, background,
                 tile_bounds, block_w, block_h)
    n, c_dim = colors.shape
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y
    pix = {"T_final": (T_final, torch.float32), "last": (last, torch.int32),
           "v_img": (v_img, torch.float32), "v_alpha": (v_alpha, torch.float32)}
    for name, (t, dtype) in pix.items():
        want = (img_height, img_width) + ((c_dim,) if name == "v_img" else ())
        if t is not None and (t.dtype != dtype or tuple(t.shape) != want or t.device != dev):
            raise ValueError(f"alpha_backward: {name} must be {dtype} {want} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    i32 = [t.contiguous() for t in (binned.tile_bin_start, binned.tile_counts,
                                    binned.sorted_gauss_ids, binned.gauss_slot_start,
                                    binned.bbox_pack)]
    per_pix = [T_final.contiguous(), last.contiguous(), v_img.contiguous()]
    s = binned.sorted_gauss_ids.shape[0]
    lib = _lib()
    null = ctypes.c_void_p(0)
    parts = []
    for gi, (c0, c1) in enumerate(groups(c_dim)):
        cg = c1 - c0
        slots = torch.zeros((GEO_FIELDS + cg, s), dtype=torch.float32, device=dev)
        bg_part = torch.empty((num_tiles, cg), dtype=torch.float32, device=dev)
        va = v_alpha.contiguous() if (gi == 0 and v_alpha is not None) else None
        _build.launch(
            lib, "alpha_backward", dev, *(_build.ptr(t) for t in i32 + f32 + per_pix),
            _build.ptr(va) if va is not None else null, n, c_dim, c0, cg, _template(cg),
            img_height, img_width, tb_x, num_tiles, s, _build.ptr(slots),
            _build.ptr(bg_part), counter="alpha_backward_slots",
        )
        parts.append((slots, bg_part.sum(dim=0)))
    if len(parts) == 1:
        return parts[0]
    geo = parts[0][0][:GEO_FIELDS]
    for slots, _ in parts[1:]:
        geo = geo + slots[:GEO_FIELDS]
    return (torch.cat([geo] + [p[0][GEO_FIELDS:] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _lib() -> ctypes.CDLL:
    return _build.bind("rasterize_alpha", {
        "alpha_forward": (I32, [VP] * 8 + [I32] * 9 + [VP] * 5),
        "alpha_backward": (I32, [VP] * 14 + [I32] * 9 + [I64, VP, VP, VP])})


# -- the splat reduction and the autograd function ----------------------------


def reduce_slots(vslots: torch.Tensor, gauss_slot_start: torch.Tensor) -> torch.Tensor:
    """Per-slot gradients [R, S] -> per-splat [N, R] via K3 (segmented
    cumsums of at most K3_ROWS rows, each splat's total read at the last
    slot of its span; zero for a splat with no slot)."""
    dev = vslots.device
    rows, s = vslots.shape
    gss = gauss_slot_start.to(torch.int64)
    n = gss.shape[0] - 1
    if s == 0:
        return torch.zeros((n, rows), dtype=vslots.dtype, device=dev)
    flags = segment_flags(gauss_slot_start, s)
    seg = torch.cat([fill_cuda.segmented_cumsum(vslots[r0:r0 + K3_ROWS].contiguous(), flags)
                     for r0 in range(0, rows, K3_ROWS)])
    ends = torch.clamp(gss[1:] - 1, min=0)
    width = (gss[1:] - gss[:-1]) > 0
    return torch.where(width[None, :], seg[:, ends], 0.0).T


class RasterizeAlpha(torch.autograd.Function):
    """The compositor through A1 / A2 on depth-ordered splats,
    differentiable in xys, conics, colors, opacity and background. Saves
    the inputs, the binning and A1's per-pixel T_final and last lane."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, background, binned, geom,
                return_alpha):
        img_height, img_width, tb, block_w, block_h = geom
        img, alpha, T, last = alpha_forward(binned, xys, conics, colors, opacity,
                                            background, img_height, img_width, tb,
                                            return_alpha, block_w, block_h)
        ctx.save_for_backward(xys, conics, colors, opacity, background, T, last, *binned)
        ctx.geom = geom
        return (img, alpha) if return_alpha else img

    @staticmethod
    def backward(ctx, v_img, v_alpha=None):
        xys, conics, colors, opacity, background, T, last, *b = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:5]):
            return (None,) * 8
        binned = BinnedSplats(*b)
        vslots, v_bg = alpha_backward_slots(
            binned, xys, conics, colors, opacity, background, T, last,
            v_img.to(torch.float32).contiguous(),
            None if v_alpha is None else v_alpha.to(torch.float32).contiguous(),
            *ctx.geom)
        per = reduce_slots(vslots, binned.gauss_slot_start)  # [N, 6 + C]
        grads = (per[:, 0:2], per[:, 2:5], per[:, GEO_FIELDS:],
                 per[:, 5:6].reshape(opacity.shape), v_bg)
        out = [g.to(t.dtype) if need else None for g, t, need in zip(
            grads, (xys, conics, colors, opacity, background), ctx.needs_input_grad)]
        return (*out, None, None, None)


def rasterize_alpha(xys, depths, radii, conics, colors, opacity, img_height: int,
                    img_width: int, block_w: int = 16, block_h: int = 16,
                    background: Optional[torch.Tensor] = None,
                    return_alpha: bool = False):
    """The compositor through the wrappers: depth-ordered uncapped binning,
    A1, and on backward A2 and K3 (their plain versions on CPU tensors).
    Returns [H, W, C], and the [H, W] alpha with `return_alpha`."""
    c_dim = colors.shape[1]
    if background is None:
        background = torch.zeros((c_dim,), dtype=colors.dtype, device=colors.device)
    tb = ((img_width + block_w - 1) // block_w, (img_height + block_h - 1) // block_h, 1)
    order, binned, _total = bin_depth_ordered(xys, depths, radii, tb, block_w, block_h)
    args = [xys[order], conics[order], colors[order], opacity[order]]
    f32 = [t.to(torch.float32) for t in args + [background]]
    geom = (img_height, img_width, tb, block_w, block_h)
    out = RasterizeAlpha.apply(*f32, binned, geom, return_alpha)
    if return_alpha:
        img, alpha = out
        return img.to(colors.dtype), alpha.to(colors.dtype)
    return out.to(colors.dtype)

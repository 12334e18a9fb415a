"""The work each kernel's function needs on given inputs, for
`utils.profiling.roofline_ms`: the bytes it must move (each input read
once, each output written once) and the operations it does, counted from
the kernel sources (gsvc_tpu_torch/csrc) and the scene's binning.

A scene `sc` is a `scripts.common.Scene` (its H, W, n, tb, budget,
binned splats and projected xys, conics, opacity). (pixel, lane) pairs
are 256 x the sum over tiles of min(count, 256); those past the alpha
gate (`gated_pairs`) do the gated part of a kernel's work, so an
operation count is (every pair, each gated pair) ops a pair. With
`tile_rows` (row0, num_rows) a count covers the tiles of that span of
tile rows only (the tile-sharded trainer's launches, `span_work`).
"""

from __future__ import annotations

import torch

from gsvc_tpu_torch.ops.fill_cuda import key_layout
from gsvc_tpu_torch.ops.rasterize_binned import (
    TILE_CHUNK,
    span_height,
    tile_lane_ids,
    tile_span,
    zrow,
)
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF

LOG2E = 1.4426950408889634
# Operations a (pixel, lane) pair of K4/K5 and of its P1 variants (the
# loop of csrc/rasterize_fwd.cuh). full: dx, dy 2, the
# quadratic form 9, negate and exp 2, alpha's product and min 2, the
# gate's two compares 2 (17), then 3 colour FMAs counted as 6. no_sigma:
# one product for sigma (7 + 6). no_exp: no negate, no exp (15 + 6).
# no_acc: one select-add a pair, no FMAs (18 + 0).
K4_OPS = {"full": (17, 6), "no_sigma": (7, 6), "no_exp": (15, 6),
          "no_acc": (18, 0), "fast_exp": (17, 6), "exp2": (17, 6)}
# K6 (csrc/rasterize_bwd.cuh) and P5's C, D, F and G: dx 1, the quadratic
# form 9, negate and exp 2, alpha's product and min 2, the gate 2 (16); then
# v_alpha 5, v_sigma 2, the colour FMAs 6, opacity's FMA 2, the three
# conic terms 4 + 3 + 4, x and y 5 + 5 (36).
K6_OPS = (16, 36)
# P5's E (csrc/profile_bwd_variants.cu): dx, dy, the quadratic form,
# negate, exp and one add, every pair.
E_OPS = 14
# A1 and A2 (csrc/rasterize_alpha.cu), each (pixel, lane) pair they
# evaluate: dx, dy 2, the quadratic form 9, negate and exp 2, alpha's
# product and min 2, the two gates 2 (17). A1's contributing pair: 1 -
# alpha, T's product, the break's compare and the weight (4), then the C
# colour FMAs counted as 2C. A2's contributing pair: 1 - alpha and its
# reciprocal, T's product and the weight (4), gc's C FMAs and the C colour
# gradients (3C), v_alpha 4, D's FMA 2, the clamp's compare 1, v_sigma 2,
# x and y 4 + 4, the conic terms 3 + 2 + 3, opacity 1 (26), and the
# (6 + C) sums over the tile's pixels, one add a value a pair (6 + C).
A1_OPS = (17, 4, 2)  # (every evaluated pair, a contributing pair + C x this)
A2_OPS = (17, 36, 4)
# Integer operations a slot: K1 decodes a key (a divide, a remainder, a
# multiply-add, a shift and an or: 6); K2 splits it, compares its tile with
# its neighbour's and with that of the key `cap` lanes back, and caps it
# (6). K3 adds and selects each value (2).
K1_OPS, K2_OPS, K3_OPS = 6, 6, 2


def _span_tiles(tile_bounds, tile_rows) -> range:
    """The grid tiles of a span of tile rows (the whole grid for None)."""
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    row0, num_rows = tile_span(tile_rows, tb_y)
    return range(min(row0 * tb_x, tb_x * tb_y), min((row0 + num_rows) * tb_x, tb_x * tb_y))


def lane_weights(variant, binned, xys, conics, opacity, tile_bounds, block_w=16,
                 block_h=16, cap=256, tile_rows=None):
    """Yield (t0, t1, ids [tc, cap], w [tc, cap, pix]) over chunks of
    TILE_CHUNK tiles (of the span `tile_rows`): each lane's alpha weight at
    each pixel (0 where the gate fails) under a K4 variant (`K4_OPS`' keys)."""
    if variant not in K4_OPS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(K4_OPS)}")
    dev, dtype = xys.device, torch.float32
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    ids = tile_lane_ids(binned, cap, n)
    xys_p, opac_p = zrow(xys.to(dtype)), zrow(opacity.reshape(-1).to(dtype))
    conics_p = zrow(conics.to(dtype))
    if variant == "exp2":
        conics_p = conics_p * LOG2E
    local_y = torch.arange(block_h, dtype=dtype, device=dev).repeat_interleave(block_w)
    local_x = torch.arange(block_w, dtype=dtype, device=dev).repeat(block_h)
    tiles = _span_tiles(tile_bounds, tile_rows)
    for t0 in range(tiles.start, tiles.stop, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, tiles.stop)
        tids = torch.arange(t0, t1, device=dev)
        g = ids[t0:t1]
        ox = ((tids % tb_x) * block_w).to(dtype)[:, None, None]
        oy = ((tids // tb_x) * block_h).to(dtype)[:, None, None]
        c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
        if variant == "no_sigma":
            gx, gy = xys_p[g, 0][:, :, None] - ox, xys_p[g, 1][:, :, None] - oy
            sigma = 0.01 * (0.5 * (c1 * gx * gx + c3 * gy * gy) + c2 * gx * gy)
            sigma = sigma.expand(-1, -1, block_w * block_h)
        else:
            dx = xys_p[g, 0][:, :, None] - (ox + local_x)
            dy = xys_p[g, 1][:, :, None] - (oy + local_y)
            sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
        if variant == "no_exp":
            vis = sigma
        elif variant == "exp2":
            vis = torch.exp2(-sigma)
        else:  # full, no_acc; fast_exp's __expf has no plain twin
            vis = torch.exp(-sigma)
        alpha = torch.clamp(opac_p[g][:, :, None] * vis, max=1.0)
        yield t0, t1, g, torch.where((sigma >= 0.0) & (alpha >= ALPHA_CUTOFF), alpha, 0.0)


def gated_pairs(sc, variant: str = "full", tile_rows=None) -> int:
    """(pixel, lane) pairs of the scene that pass the alpha gate under a K4
    variant: the data-dependent part of an operation count."""
    return sum(int((w > 0).sum()) for _t0, _t1, _g, w in lane_weights(
        variant, sc.binned, sc.xys, sc.conics, sc.opacity, sc.tb, tile_rows=tile_rows))


def lanes(sc, tile_rows=None) -> int:
    """Lanes the kernels render: sum over tiles of min(count, 256)."""
    tiles = _span_tiles(sc.tb, tile_rows)
    return int(torch.clamp(sc.binned.tile_counts[tiles.start:tiles.stop], max=256).sum())


def pairs(sc, tile_rows=None) -> int:
    """(pixel, lane) pairs of the forward and backward kernels."""
    return 256 * lanes(sc, tile_rows)


def rows_bytes(sc, tile_rows=None) -> int:
    """Bytes of one float32 buffer in K4's rows layout."""
    num_rows = tile_span(tile_rows, sc.tb[1])[1]
    return 4 * num_rows * ((3 * sc.tb[0] + 7) // 8 * 8) * 256


def splats_read(sc, tile_rows=None) -> int:
    """Splats the render must read: all n for the grid, the distinct ones
    of the span's lanes for a span."""
    if tile_rows is None:
        return sc.n
    tiles = _span_tiles(sc.tb, tile_rows)
    ids = tile_lane_ids(sc.binned, 256, sc.n)[tiles.start:tiles.stop]
    return int(torch.unique(ids[ids < sc.n]).numel())


def forward_bytes(sc, layout: str, tile_rows=None) -> int:
    """Bytes a forward render must move: the tile starts and counts, the
    used lane ids, 9 floats a splat, the image in `layout` (of the span)."""
    tiles = len(_span_tiles(sc.tb, tile_rows))
    out = (rows_bytes(sc, tile_rows) if layout == "rows"
           else 12 * span_height(tile_rows, sc.tb[1], sc.H) * sc.W)
    return 8 * tiles + 4 * lanes(sc, tile_rows) + 36 * splats_read(sc, tile_rows) + out


def backward_bytes(sc, tile_rows=None) -> int:
    """Bytes K6's function must move: the forward's inputs, each splat's
    slot start and bbox, the rows image gradient, the [9, S] slots."""
    tiles = len(_span_tiles(sc.tb, tile_rows))
    return (8 * tiles + 4 * lanes(sc, tile_rows) + 44 * splats_read(sc, tile_rows) + 4
            + rows_bytes(sc, tile_rows) + 36 * sc.budget)


def key_bytes(sc) -> int:
    """Bytes of one of the sort keys of the scene's sc.n splats on its grid
    (`fill_cuda.key_layout`)."""
    return key_layout(sc.tb[0] * sc.tb[1], sc.n).dtype.itemsize


def key_work(sc) -> dict:
    """{kernel: (bytes, operations)} of K1 and K2 on the scene's sc.n splats
    and sc.budget slots. K1 reads 16 bytes a splat (start slot and tile
    bbox) and the kept total and writes a key a slot; K2 reads a key and
    writes two int32 ids a slot, and writes the T + 1 int32 tile edges:
    (kb + 8) S + 4 (T + 1), kb the bytes of a key (`key_bytes`)."""
    n, s = sc.n, sc.budget
    kb, num_tiles = key_bytes(sc), sc.tb[0] * sc.tb[1]
    return {
        "K1 fill_decode_keys": (16 * n + 4 + kb * s, K1_OPS * s),
        "K2 rank_cap_decode": ((kb + 8) * s + 4 * (num_tiles + 1), K2_OPS * s),
    }


def kernel_work(sc, valid: int, k3_rows: int) -> dict:
    """{kernel: (bytes, operations)} of K1-K6 on the scene; `valid` pairs
    pass the alpha gate, K3 scans `k3_rows` rows of the budget's slots; K1
    and K2 as `key_work`."""
    s, every = sc.budget, pairs(sc)
    fwd_ops = K4_OPS["full"][0] * every + K4_OPS["full"][1] * valid
    return {
        **key_work(sc),
        "K3 segmented_cumsum": (8 * k3_rows * s + 4 * s, K3_OPS * k3_rows * s),
        "K4 forward image": (forward_bytes(sc, "image"), fwd_ops),
        "K4 forward rows": (forward_bytes(sc, "rows"), fwd_ops),
        "K5 forward chw": (forward_bytes(sc, "chw"), fwd_ops),
        "K6 backward": (backward_bytes(sc), K6_OPS[0] * every + K6_OPS[1] * valid),
    }


def span_work(sc, valid: int, tile_rows) -> dict:
    """{kernel: (bytes, operations)} of K4 rows, K4 image, K5 and K6 over the
    span `tile_rows` of the scene, `valid` of its pairs past the gate."""
    every = pairs(sc, tile_rows)
    fwd_ops = K4_OPS["full"][0] * every + K4_OPS["full"][1] * valid
    return {
        "K4 forward rows": (forward_bytes(sc, "rows", tile_rows), fwd_ops),
        "K4 forward image": (forward_bytes(sc, "image", tile_rows), fwd_ops),
        "K5 forward chw": (forward_bytes(sc, "chw", tile_rows), fwd_ops),
        "K6 backward": (backward_bytes(sc, tile_rows), K6_OPS[0] * every + K6_OPS[1] * valid),
    }


def parts_work(variant: str, sc, valid: int):
    """(bytes, operations) of one P1 variant: K4 rows's traffic and
    `K4_OPS[variant]` over the pairs (`valid` of them pass its gate)."""
    every, gated = K4_OPS[variant]
    return forward_bytes(sc, "rows"), every * pairs(sc) + gated * valid


def jobs_work(variant: str, sc, num_jobs: int, valid: int):
    """(bytes, operations) of one P5 variant. C, D, F and G are K6's
    function (K6's bytes and operations, `valid` pairs past the gate); the
    others read the splats, lane ids and job list and write the [9, S]
    slots: A moves data only, B adds the tile's 3 x 256 gradients a job, E
    does E_OPS a pair."""
    if variant in ("C", "D", "F", "G"):
        every, gated = K6_OPS
        return backward_bytes(sc), every * pairs(sc) + gated * valid
    n_bytes = 4 * lanes(sc) + 44 * sc.n + 4 + 12 * num_jobs + 36 * sc.budget
    if variant == "A":
        return n_bytes, 0
    if variant == "B":
        return n_bytes + rows_bytes(sc), 3 * 256 * num_jobs
    return n_bytes, E_OPS * pairs(sc)


def alpha_work(n: int, c_dim: int, total: int, num_tiles: int, H: int, W: int,
               return_alpha: bool, counts) -> dict:
    """{kernel: (bytes, operations)} of A1 and A2 on n splats of c_dim
    channels with `total` intersections over num_tiles tiles, at H x W;
    `counts` = (A1's evaluated pairs, contributing pairs, A2's evaluated
    pairs) of this run's data (`ops.rasterize_alpha_cuda.pair_counts`).

    A1 reads the tile starts and counts, a lane id an intersection, each
    splat's position, conic, C colours and opacity once, the background,
    and writes H W (C + return_alpha) floats plus each pixel's T_final and
    last lane. A2 reads the tile starts, the lane ids, the splats with
    their slot starts and bboxes, the background, each pixel's T_final,
    last lane, C image gradients (and alpha gradient), and writes the
    [6 + C, total] slots and a [tiles, C] background part."""
    fwd_pairs, contrib, bwd_pairs = counts
    pix = H * W
    splat = 4 * (2 + 3 + c_dim + 1)
    a1_bytes = (8 * num_tiles + 4 * total + n * splat + 4 * c_dim
                + 4 * pix * (c_dim + int(return_alpha)) + 8 * pix)
    a2_bytes = (4 * num_tiles + 4 * total + n * (splat + 8) + 4 * c_dim
                + 4 * pix * (2 + c_dim + int(return_alpha))
                + 4 * (6 + c_dim) * total + 4 * num_tiles * c_dim)
    return {
        "A1 alpha_forward": (a1_bytes, A1_OPS[0] * fwd_pairs
                             + (A1_OPS[1] + A1_OPS[2] * c_dim) * contrib),
        "A2 alpha_backward": (a2_bytes, A2_OPS[0] * bwd_pairs
                              + (A2_OPS[1] + A2_OPS[2] * c_dim) * contrib),
    }

"""The work each kernel's function needs on given inputs, for
`utils.profiling.roofline_ms`: the bytes it must move (each input read
once, each output written once) and the operations it does, counted from
the kernel sources (gsvc_tpu_torch/csrc) and the scene's binning.

A scene `sc` is a `scripts.common.Scene` (its H, W, n, tb, budget,
binned splats and projected xys, conics, opacity). (pixel, lane) pairs
are 256 x the sum over tiles of min(count, 256); those past the alpha
gate (`gated_pairs`) do the gated part of a kernel's work, so an
operation count is (every pair, each gated pair) ops a pair.
"""

from __future__ import annotations

import torch

from gsvc_tpu_torch.ops.rasterize_binned import TILE_CHUNK, tile_lane_ids, zrow
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF

LOG2E = 1.4426950408889634
# Operations a (pixel, lane) pair of K4/K5 (csrc/rasterize_fwd.cu) and of
# its P1 variants (csrc/profile_kernel_parts.cu). full: dx, dy 2, the
# quadratic form 9, negate and exp 2, alpha's product and min 2, the
# gate's two compares 2 (17), then 3 colour FMAs counted as 6. no_sigma:
# one product for sigma (7 + 6). no_exp: no negate, no exp (15 + 6).
# no_acc: one select-add a pair, no FMAs (18 + 0).
K4_OPS = {"full": (17, 6), "no_sigma": (7, 6), "no_exp": (15, 6),
          "no_acc": (18, 0), "fast_exp": (17, 6), "exp2": (17, 6)}
# K6 (csrc/rasterize_bwd.cu) and P5's C and D: dx 1, the quadratic form 9,
# negate and exp 2, alpha's product and min 2, the gate 2 (16); then
# v_alpha 5, v_sigma 2, the colour FMAs 6, opacity's FMA 2, the three
# conic terms 4 + 3 + 4, x and y 5 + 5 (36).
K6_OPS = (16, 36)
# P5's E (csrc/profile_bwd_variants.cu): dx, dy, the quadratic form,
# negate, exp and one add, every pair.
E_OPS = 14
# Integer operations a slot: K1 decodes a key (a divide, a remainder, a
# multiply-add, a shift and an or: 6); K2 splits it, compares it with its
# neighbour, ranks and caps it (6). K3 adds and selects each value (2).
K1_OPS, K2_OPS, K3_OPS = 6, 6, 2


def lane_weights(variant, binned, xys, conics, opacity, tile_bounds, block_w=16,
                 block_h=16, cap=256):
    """Yield (t0, t1, ids [tc, cap], w [tc, cap, pix]) over chunks of
    TILE_CHUNK tiles: each lane's alpha weight at each pixel (0 where the
    gate fails) under a K4 variant (`K4_OPS`' keys)."""
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
    for t0 in range(0, tb_x * tb_y, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, tb_x * tb_y)
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


def gated_pairs(sc, variant: str = "full") -> int:
    """(pixel, lane) pairs of the scene that pass the alpha gate under a K4
    variant: the data-dependent part of an operation count."""
    return sum(int((w > 0).sum()) for _t0, _t1, _g, w in lane_weights(
        variant, sc.binned, sc.xys, sc.conics, sc.opacity, sc.tb))


def lanes(sc) -> int:
    """Lanes the kernels render: sum over tiles of min(count, 256)."""
    return int(torch.clamp(sc.binned.tile_counts, max=256).sum())


def pairs(sc) -> int:
    """(pixel, lane) pairs of the forward and backward kernels."""
    return 256 * lanes(sc)


def rows_bytes(sc) -> int:
    """Bytes of one float32 buffer in K4's rows layout."""
    return 4 * sc.tb[1] * ((3 * sc.tb[0] + 7) // 8 * 8) * 256


def forward_bytes(sc, layout: str) -> int:
    """Bytes a forward render must move: the tile starts and counts, the
    used lane ids, 9 floats a splat, the image in `layout`."""
    out = rows_bytes(sc) if layout == "rows" else 12 * sc.H * sc.W
    return 8 * sc.tb[0] * sc.tb[1] + 4 * lanes(sc) + 36 * sc.n + out


def backward_bytes(sc) -> int:
    """Bytes K6's function must move: the forward's inputs, each splat's
    slot start and bbox, the rows image gradient, the [9, S] slots."""
    return (8 * sc.tb[0] * sc.tb[1] + 4 * lanes(sc) + 44 * sc.n + 4
            + rows_bytes(sc) + 36 * sc.budget)


def kernel_work(sc, valid: int, k3_rows: int) -> dict:
    """{kernel: (bytes, operations)} of K1-K6 on the scene; `valid` pairs
    pass the alpha gate, K3 scans `k3_rows` rows of the budget's slots."""
    n, s, every = sc.n, sc.budget, pairs(sc)
    fwd_ops = K4_OPS["full"][0] * every + K4_OPS["full"][1] * valid
    return {
        "K1 fill_decode_keys": (21 * n + 4 + 8 * s, K1_OPS * s),
        "K2 rank_cap_decode": (16 * s, K2_OPS * s),
        "K3 segmented_cumsum": (8 * k3_rows * s + 4 * s, K3_OPS * k3_rows * s),
        "K4 forward image": (forward_bytes(sc, "image"), fwd_ops),
        "K4 forward rows": (forward_bytes(sc, "rows"), fwd_ops),
        "K5 forward chw": (forward_bytes(sc, "chw"), fwd_ops),
        "K6 backward": (backward_bytes(sc), K6_OPS[0] * every + K6_OPS[1] * valid),
    }


def parts_work(variant: str, sc, valid: int):
    """(bytes, operations) of one P1 variant: K4 rows's traffic and
    `K4_OPS[variant]` over the pairs (`valid` of them pass its gate)."""
    every, gated = K4_OPS[variant]
    return forward_bytes(sc, "rows"), every * pairs(sc) + gated * valid


def jobs_work(variant: str, sc, num_jobs: int, valid: int):
    """(bytes, operations) of one P5 variant. C and D are K6's function
    (K6's bytes and operations, `valid` pairs past the gate); the others
    read the splats, lane ids and job list and write the [9, S] slots: A
    moves data only, B adds the tile's 3 x 256 gradients a job, E does
    E_OPS a pair."""
    if variant in ("C", "D"):
        every, gated = K6_OPS
        return backward_bytes(sc), every * pairs(sc) + gated * valid
    n_bytes = 4 * lanes(sc) + 44 * sc.n + 4 + 12 * num_jobs + 36 * sc.budget
    if variant == "A":
        return n_bytes, 0
    if variant == "B":
        return n_bytes + rows_bytes(sc), 3 * 256 * num_jobs
    return n_bytes, E_OPS * pairs(sc)

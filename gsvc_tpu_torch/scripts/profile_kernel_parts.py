"""P1: K4's time attributed to its parts, by ablation.

The port of scripts/profile_kernel_parts.py, whose variants of the TPU's
row-streaming forward kernel (`make_kernel` :52, pallas_call :174) ablated
the sigma and colour matmuls and re-typed them as bf16 x3 splits. K4 on
the card has no matmul, so the variants are translated: each is K4's own
kernel (csrc/rasterize_fwd.cuh, the rows store) with its inner loop
switched at compile time (csrc/profile_kernel_parts.cu), so `full` is K4
and the ablations describe the loop that runs:

  full      the real K4 loop
  no_sigma  sigma = 0.01 x the lane's sigma at its tile's origin (:86-87)
  no_exp    vis = sigma (:101-102)
  no_acc    one select-add a lane in place of the three colour FMAs;
            out = (sum w) x (sum rgb) x 1e-6 (:118-122)
  fast_exp  __expf, the counterpart of sig_bf16x3 (a cheaper, less exact
            sigma -> vis step; the --use_fast_math question)
  exp2      exp2f of sigma from conics pre-scaled by log2 e, the
            counterpart of acc_bf16x3

    python -m gsvc_tpu_torch.scripts.profile_kernel_parts [--iters 40]

prints each variant's events and busy ms and, for fast_exp and exp2, the
max-abs error against full (:196-201). Each variant's wrapper
(`FORWARD_PARTS[variant]`, counted as the recorder's
`launches.forward_parts_<variant>`) runs its kernel on a CUDA tensor and
its plain version, `render_parts_torch`, on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, VP
from gsvc_tpu_torch.ops.rasterize_binned import zrow
from gsvc_tpu_torch.ops.rasterize_cuda import (
    check_inputs,
    forward_grid,
    image_to_rows,
    round8,
    sm_count,
)
from gsvc_tpu_torch.scripts import common
from gsvc_tpu_torch.utils.work import K4_OPS, lane_weights

VARIANTS = tuple(K4_OPS)
PRECISION = ("fast_exp", "exp2")


def render_parts_torch(variant, binned, xys, conics, colors, opacity, img_height,
                       img_width, tile_bounds, block_w=16, block_h=16, cap=256):
    """Plain version of a P1 variant: the binned renderer with the same
    switch, in K4's rows layout."""
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    colors_p = zrow(colors.to(torch.float32))
    out = torch.empty((tb_x * tb_y, block_h * block_w, 3), dtype=torch.float32,
                      device=xys.device)
    for t0, t1, g, w in lane_weights(variant, binned, xys, conics, opacity,
                                     tile_bounds, block_w, block_h, cap):
        if variant == "no_acc":
            out[t0:t1] = w.sum(1)[:, :, None] * colors_p[g].sum(1)[:, None, :] * 1e-6
        else:
            out[t0:t1] = torch.einsum("tkc,tkp->tpc", colors_p[g], w)
    img = (out.reshape(tb_y, tb_x, block_h, block_w, 3).permute(0, 2, 1, 3, 4)
           .reshape(tb_y * block_h, tb_x * block_w, 3)[:img_height, :img_width])
    return image_to_rows(img, tb_x, tb_y, block_w, block_h)


def _parts_wrapper(variant: str):
    vid = VARIANTS.index(variant)

    def wrapper(binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w=16, block_h=16, cap=256):
        if not xys.is_cuda:
            return render_parts_torch(variant, binned, xys, conics, colors, opacity,
                                      img_height, img_width, tile_bounds, block_w,
                                      block_h, cap)
        dev = xys.device
        tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
        f32 = check_inputs("forward_parts", binned, xys, conics, colors, opacity,
                           tile_bounds, block_w, block_h, cap)
        i32 = [t.contiguous() for t in (binned.tile_bin_start, binned.tile_counts,
                                        binned.sorted_gauss_ids)]
        r_out = round8(3 * tb_x)
        alloc = torch.empty if r_out == 3 * tb_x else torch.zeros
        out = alloc((tb_y * r_out, block_h * block_w), dtype=torch.float32, device=dev)
        grid = forward_grid(tb_x * tb_y, sm_count(dev))
        _build.launch(
            _lib(), "forward_parts", dev, *(_build.ptr(t) for t in i32 + f32),
            xys.shape[0], img_height, img_width, tb_x, tb_y, cap, vid, r_out, grid,
            _build.ptr(out), counter=wrapper.__name__)
        return out

    wrapper.__name__ = wrapper.__qualname__ = f"forward_parts_{variant}"
    wrapper.__doc__ = f"P1 variant {variant!r}: K4's rows store with that switch."
    return wrapper


FORWARD_PARTS = {v: _parts_wrapper(v) for v in VARIANTS}


def _lib() -> ctypes.CDLL:
    return _build.bind("profile_kernel_parts", {
        "forward_parts": (I32, [VP] * 7 + [I32] * 9 + [VP, VP])})


def main(argv=None) -> int:
    args = common.parse(__doc__, argv, iters=40)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    print(f"P1 profile_kernel_parts [{common.card_line()}]: {sc.W}x{sc.H}, "
          f"{sc.n} splats, budget {sc.budget}")
    rows, outs = [], {}
    with torch.no_grad():
        for v in VARIANTS:
            def call(v=v):
                return FORWARD_PARTS[v](*sc.rargs)

            outs[v] = call()
            ms, busy = common.alone(call, args.iters, max(args.iters // 4, 3))
            note = ""
            if v in PRECISION:
                note = f"max-abs vs full {float((outs[v] - outs['full']).abs().max()):.3e}"
            rows.append((v, ms, busy, note))
    common.print_rows("P1 K4 parts (each variant alone):", rows)
    full = rows[0][1]
    print("P1 share of full: " + ", ".join(
        f"{name} {100 * ms / full:.1f} %" for name, ms, _b, _n in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""P2: the eval forward decomposed into cumulative prefixes, on the card.

The port of scripts/profile_fwd_chain.py, which timed the TPU's forward
kernel (pallas_call :136) inside cumulative prefixes of the forward
(:101-192). Each stage folds the full sum of its outputs into the chain
(so no output goes unread) and is timed chained through the means:

  proj     projection
  +bin     + binning (K1, the sort of its int32 keys, K2, the tile starts)
  +kernel  + K4, rows store
  +image   projection, binning and the full API render in the eval
           path's planar layout (K5) with the background select
  train    the harness's train step: clip(render) against a zero target,
           L2, autograd through the kernels, Adan at lr 1e-3

The TPU's chained loop ran inside one jit and was immune to dispatch;
eager PyTorch on the card is host-bound (device idle 82-88 %, PERF.md
section 5), so each stage is reported twice: events ms around the
chained loop (what the program pays) and device busy ms (what the device
does).

    python -m gsvc_tpu_torch.scripts.profile_fwd_chain [--iters 50]
"""

from __future__ import annotations

import sys

import torch

from gsvc_tpu_torch.ops import rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import _clip01
from gsvc_tpu_torch.optim.adan import adan_init, adan_step
from gsvc_tpu_torch.scripts import common

LR = 1e-3


def stages(sc: common.Scene) -> dict:
    """{stage: m -> m + 0 * fullsum(outputs)} of the forward prefixes."""
    L, colors, opacity = sc.L, sc.colors, sc.opacity
    H, W, tb = sc.H, sc.W, sc.tb

    def proj(m):
        return project_gaussians_2d(m, L, H, W, tb)

    def binned(m):
        xys, d, radii, conics, nth = p = proj(m)
        return p, bin_gaussians(xys, radii, nth, tb, 16, 16, sc.budget)

    def kernel(m):
        p, b = binned(m)
        return p, b, rasterize_cuda.forward_rows(b, p[0], p[3], colors, opacity, H, W, tb)

    return {
        "proj": lambda m: common.fold(m, proj(m)),
        "+bin": lambda m: common.fold(m, binned(m)),
        "+kernel": lambda m: common.fold(m, kernel(m)),
        "+image": lambda m: common.fold(m, eval_image(sc, m)),
    }


def eval_image(sc: common.Scene, means) -> torch.Tensor:
    """The `+image` stage's render: [3, H, W] through K1, K2 and K5."""
    return common.render(sc, means, sc.L, sc.colors, layout="chw")


def train_step(sc: common.Scene, carry, target: torch.Tensor):
    """One step of the harness's training: (params {m, l, c}, Adan state)
    -> the same after value_and_grad of mean((clip(render) - target)^2)
    and `adan_step` at LR."""
    params, state = carry
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        img = _clip01(common.render(sc, leaves["m"], leaves["l"], leaves["c"]))
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return adan_step(params, dict(zip(leaves, grads)), state, LR)


def main(argv=None) -> int:
    args = common.parse(__doc__, argv, iters=50)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    busy_reps = max(args.iters // 5, 3)
    print(f"P2 profile_fwd_chain [{common.card_line()}]: {sc.W}x{sc.H}, {sc.n} splats")
    rows, prev = [], (0.0, 0.0)
    with torch.no_grad():
        for name, fn in stages(sc).items():
            ms, busy = common.chained(fn, sc.means, args.iters, busy_reps)
            rows.append((name, ms, busy, f"delta {ms - prev[0]:+.4f} / {busy - prev[1]:+.4f}"))
            prev = (ms, busy)
    full_ms, full_busy = rows[-1][1], rows[-1][2]
    params = {"m": sc.means, "l": sc.L, "c": sc.colors}
    target = torch.zeros((sc.H, sc.W, 3), device=dev)
    ms, busy = common.chained(lambda c: train_step(sc, c, target),
                              (params, adan_init(params)), max(args.iters // 2, 10),
                              busy_reps)
    rows.append(("train", ms, busy, f"{1e3 / ms:.1f} it/s"))
    common.print_rows("P2 cumulative prefixes (chained through the means):", rows)
    print(f"P2 +image: {1e3 / full_ms:.1f} fps chained, {1e3 / full_busy:.1f} fps of "
          "device busy time")
    print(f"P2 n={sc.n} isect={int(sc.binned.num_intersects)} budget={sc.budget} "
          f"S={sc.binned.sorted_gauss_ids.shape[0]} rows={sc.tb[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""P4: the train step's backward decomposed, on the card.

The port of scripts/profile_bwd_chain.py, which timed the TPU's backward
kernel (pallas_call :172) alone and the train step's stages cumulatively
(:116-123). Chained through the parameters {means, L, colours}:

  fwd+loss  render, clip and the L2 loss taken on [3, H, W] copies (the
            TPU harness's loss-side transpose pair)
  vag       + the backward (value and gradients)
  vag_notr  value and gradients with the loss taken on [H, W, 3]
  train     vag + Adan at lr 1e-3

and in isolation, on fixed residuals (the bench scene, a uniform image
gradient):

  vrows     `image_to_rows` of the image gradient
  bwdkern   K6 alone on the rows gradient
  K3        K3 by itself on [16, S] values with a segment every 8 lanes
            (the TPU harness's input), and on K6's [9, S] slots
  segsum    the port's reduction of K6's slots to splats (segment flags,
            K3, gather), with `index_add_` beside it as the counterpart of
            the TPU harness's jax.ops.segment_sum (:186-191)

Each stage is reported as events ms around its chained loop and device
busy ms.

    python -m gsvc_tpu_torch.scripts.profile_bwd_chain [--iters 30]
"""

from __future__ import annotations

import sys

import torch

from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.rasterize import _clip01
from gsvc_tpu_torch.optim.adan import adan_init, adan_step
from gsvc_tpu_torch.scripts import common

LR = 1e-3


def loss(sc: common.Scene, p: dict, gt: torch.Tensor, transposed: bool) -> torch.Tensor:
    """mean((clip(render) - gt)^2); `transposed` takes it on [3, H, W]
    copies of both (gt given as [H, W, 3])."""
    img = _clip01(common.render(sc, p["m"], p["l"], p["c"]))
    if transposed:
        return torch.mean((img.permute(2, 0, 1).contiguous()
                           - gt.permute(2, 0, 1).contiguous()) ** 2)
    return torch.mean((img - gt) ** 2)


def value_and_grad(sc, p, gt, transposed):
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    with torch.enable_grad():
        v = loss(sc, leaves, gt, transposed)
        grads = torch.autograd.grad(v, list(leaves.values()))
    return v.detach(), dict(zip(leaves, grads))


def stages(sc: common.Scene, gt: torch.Tensor) -> dict:
    """{stage: (fn, x0)} of the cumulative stages, chained through the
    parameters."""
    params = {"m": sc.means, "l": sc.L, "c": sc.colors}

    def shift(p, s):
        return {k: a + s * 0.0 for k, a in p.items()}

    def fwd_loss(p):
        with torch.no_grad():
            return shift(p, loss(sc, p, gt, True))

    def vag(transposed):
        def f(p):
            v, g = value_and_grad(sc, p, gt, transposed)
            return shift(p, v + common.fullsum(g))
        return f

    def train(carry):
        p, st = carry
        _v, g = value_and_grad(sc, p, gt, True)
        return adan_step(p, g, st, LR)

    return {"fwd+loss": (fwd_loss, params), "vag": (vag(True), params),
            "vag_notr": (vag(False), params),
            "train": (train, (params, adan_init(params)))}


def main(argv=None) -> int:
    args = common.parse(__doc__, argv, iters=30)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    H, W, tb, b = sc.H, sc.W, sc.tb, sc.binned
    busy_reps = max(args.iters // 5, 3)
    print(f"P4 profile_bwd_chain [{common.card_line()}]: {W}x{H}, {sc.n} splats")
    gt = torch.zeros((H, W, 3), device=dev)
    rows, prev = [], 0.0
    for name, (fn, x0) in stages(sc, gt).items():
        ms, busy = common.chained(fn, x0, args.iters, busy_reps)
        rows.append((name, ms, busy, f"delta {ms - prev:+.4f}"))
        prev = ms
    with torch.no_grad():
        g_img = torch.ones((H, W, 3), device=dev) / (H * W * 3)
        vrows0 = rasterize_cuda.image_to_rows(g_img, tb[0], tb[1])
        bargs = (*sc.rargs[:5], H, W, tb, 16, 16, 256, "rows")

        def k6(vr):
            return rasterize_cuda.backward_slots(*bargs[:5], vr, *bargs[5:])

        vslots0 = k6(vrows0)
        owners = common.slot_owners(b.gauss_slot_start, sc.budget)
        flags = rasterize_cuda.segment_flags(b.gauss_slot_start, sc.budget)
        vals16 = torch.randn((16, sc.budget), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
        flags8 = (torch.arange(sc.budget, device=dev) % 8 == 0).to(torch.int32)
        isolated = {
            "vrows": (lambda g: common.fold(g, rasterize_cuda.image_to_rows(g, tb[0], tb[1])),
                      g_img, ""),
            "bwdkern": (lambda vr: common.fold(vr, k6(vr)), vrows0, "K6 alone"),
            "K3 [16,S]": (lambda v: common.fold(v, fill_cuda.segmented_cumsum(v, flags8)),
                          vals16, "K3 alone, a segment every 8 lanes"),
            "K3 slots": (lambda vs: common.fold(vs, fill_cuda.segmented_cumsum(vs, flags)),
                         vslots0, "K3 alone on K6's [9,S] slots"),
            "segsum": (lambda vs: common.fold(vs, rasterize_cuda.reduce_slot_grads(
                vs, b.gauss_slot_start)), vslots0, "flags + K3 + gather"),
            "segsum index_add_": (lambda vs: common.fold(vs, common.segsum_index_add(
                vs, owners, sc.n)), vslots0, "jax.ops.segment_sum's counterpart"),
        }
        for name, (fn, x0, note) in isolated.items():
            rows.append((name, *common.chained(fn, x0, args.iters, busy_reps), note))
    common.print_rows("P4 train-step stages (chained through the parameters) and "
                      "backward pieces (fixed residuals):", rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())

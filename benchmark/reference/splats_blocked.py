"""Plain reference of the 2D splat codec's render and its L2 fit step, its
gradient computed in blocks: the copy of `splats.py` for cells whose
renders hold more (pixel, pair) values than one autograd graph of every
chunk can keep on the card (3840x2160 at 100,000 splats: ~8e8 values a
render, ~13 float64 tensors of that size saved for the backward).

A frozen copy of `splats.render_splats` and `splats.represent_steps`
(reference/splats.py as first written, commit 844ef8a), with one change:
`render` runs in three parts, whatever the pair count,

1. the forward pass over `splats.render`'s chunks, without a graph;
2. dL/d(image), from autograd through what follows the render (the
   clip, the loss);
3. each chunk's vector-Jacobian product, its weights worked out again
   from the chunk's inputs, accumulated into the xys, conics and colours
   gradients in chunk order.

So peak memory is one chunk's graph (`splats.CHUNK_VALUES` values). The
arithmetic is splats.py's: the same chunks, gates and sums, so the two
agree to rounding (a CPU test holds them to 1e-12 in float64). The
projection, binning, clip, Adan and the revive are splats.py's own.
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference import splats


def _chunks(total: int):
    step = max(1, splats.CHUNK_VALUES // (splats.BLOCK * splats.BLOCK))
    return [(lo, lo + step) for lo in range(0, total, step)]


class _Render(torch.autograd.Function):
    """`splats.render` with its backward worked out chunk by chunk."""

    @staticmethod
    def forward(ctx, xys, conics, colors, tile, gauss, H: int, W: int):
        ctx.save_for_backward(xys, conics, colors, tile, gauss)
        ctx.size = (H, W)
        return splats.render(splats.Pairs(tile, gauss), xys, conics, colors, H, W)

    @staticmethod
    def backward(ctx, grad):
        xys, conics, colors, tile, gauss = ctx.saved_tensors
        H, W = ctx.size
        tb_x, tb_y = splats.grid(H, W)
        padded = grad.new_zeros((tb_y * splats.BLOCK, tb_x * splats.BLOCK, 3))
        padded[:H, :W] = grad
        padded = padded.reshape(-1, 3)
        pairs = splats.Pairs(tile, gauss)
        sums = [torch.zeros_like(xys), torch.zeros_like(conics), torch.zeros_like(colors)]
        for lo, hi in _chunks(tile.shape[0]):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (xys, conics, colors)]
                w, flat = splats.pair_weights(pairs, leaves[0], leaves[1], W, lo, hi)
                contrib = w[:, :, None] * leaves[2][gauss[lo:hi]][:, None, :]
                parts = torch.autograd.grad(contrib, leaves, padded[flat], allow_unused=True)
            for s, p in zip(sums, parts):
                if p is not None:
                    s += p
        return (*sums, None, None, None, None)


def render(pairs: splats.Pairs, xys, conics, colors, H: int, W: int) -> torch.Tensor:
    """`splats.render`'s [H, W, 3] image, its backward in chunks."""
    return _Render.apply(xys, conics, colors, pairs.tile, pairs.gauss, H, W)


def render_splats(means, chol, colors, H: int, W: int, budget: int,
                  alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project, bin and render, clipped to [0, 1]: [H, W, 3]."""
    p = splats.project(means, chol, H, W, alive)
    pairs = splats.bin_pairs(p, H, W, budget)
    return splats.clip01(render(pairs, p.xys, p.conics, colors, H, W))


def represent_steps(init: dict, alive: torch.Tensor, gt: torch.Tensor, budget: int,
                    steps: int, lr: float, dtype, revived=None) -> splats.FitSteps:
    """`splats.represent_steps` on the blocked render."""
    H, W = gt.shape[0], gt.shape[1]
    params = {k: v.to(dtype) for k, v in init.items()}
    target = gt.to(dtype)
    opt = splats.Adan(params)
    losses, first, after = [], None, []
    start = {k: v.clone() for k, v in params.items()}
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        img = render_splats(torch.tanh(leaves["xyz"]),
                            leaves["cholesky"] + splats.bound(target),
                            leaves["features_dc"] * leaves["rgb_w"], H, W, budget, alive)
        loss = torch.sum((img - target) ** 2) / (H * W * 3)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            if i == 0 and revived is not None:
                params, alive = splats.revive(params, alive, *revived)
                opt = splats.Adan(params)
                opt.t = 1
            else:
                params = opt.step({k: v.detach() for k, v in leaves.items()}, grads, lr)
        after.append(params)
    return splats.FitSteps(losses, first, start, after)

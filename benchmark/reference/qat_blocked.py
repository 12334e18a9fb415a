"""Plain reference of a frame's QAT steps on the blocked render: the copy
of `qat.py` for the cells whose renders `splats_blocked.py` computes in
blocks.

A frozen copy of `qat.forward` and `qat.qat_steps` (reference/qat.py as
first written, commit 844ef8a) whose render is
`splats_blocked.render_splats`; the quantizers, the residual VQ, its
k-means start and the codes are qat.py's own.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import qat, splats, splats_blocked


def forward(params: dict, vq: qat.VQ, frozen: dict, H: int, W: int, budget: int,
            training: bool):
    """`qat.forward` on the blocked render: (image [H, W, 3] clipped,
    commitment loss, new VQ)."""
    xyz = params["xyz"]
    means = torch.tanh(xyz + (xyz.half().to(xyz.dtype) - xyz).detach() + frozen["xyz"])
    chol, _codes = qat.uniform_quantize(params["cholesky"], params["q_scale"], params["q_beta"])
    colors, _idx, commit, new = qat.vq_forward(params["features_dc"], vq, training)
    img = splats_blocked.render_splats(means, chol + splats.bound(chol) + frozen["cholesky"],
                                       colors + frozen["features_dc"], H, W, budget)
    return img, commit, new


def qat_steps(gmodel: dict, previous, gt: torch.Tensor, budget: int, picks, steps: int,
              lr: float, dtype) -> qat.QatSteps:
    """`qat.qat_steps` on the blocked render."""
    H, W = gt.shape[0], gt.shape[1]
    dev = gt.device

    def leaves(model) -> dict:
        return {k: torch.as_tensor(np.asarray(model[f"_{k}"]), device=dev).to(dtype)
                for k in ("xyz", "cholesky", "features_dc")}

    params = leaves(gmodel)
    frozen = {k: torch.zeros_like(v) for k, v in params.items()}
    if previous is not None:
        frozen = leaves(previous)
        params = {k: v - frozen[k] for k, v in params.items()}
    params["q_scale"] = torch.full((3,), 1.0 / qat.QMAX, dtype=dtype, device=dev)
    params["q_beta"] = torch.full((3,), 1.0 / qat.QMAX, dtype=dtype, device=dev)
    target = gt.to(dtype)
    vq = qat.kmeans_init(params["features_dc"], picks)
    opt = splats.Adan(params)
    losses, embeds, after = [], [], []
    start = {k: v.clone() for k, v in params.items()}
    for _ in range(steps):
        tracked = {k: v.detach().requires_grad_() for k, v in params.items()}
        img, commit, vq = forward(tracked, vq, frozen, H, W, budget, True)
        recon = torch.sum((img - target) ** 2) / (H * W * 3)
        loss = recon + commit
        grads = dict(zip(tracked, torch.autograd.grad(loss, list(tracked.values()))))
        losses.append(float(loss.detach()))
        embeds.append(vq.embed)
        with torch.no_grad():
            params = opt.step({k: v.detach() for k, v in tracked.items()}, grads, lr)
        after.append(params)
    return qat.QatSteps(losses, start, after, embeds)

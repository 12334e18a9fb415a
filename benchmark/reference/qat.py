"""Plain reference of the quantization-aware (QAT) step of a frame and of
the codes a fitted frame is coded with.

Frozen copies of plain arithmetic at commit a2bb42d, in any float dtype:
- `forward`: gsvc_tpu_torch/models/compress.py `forward_quantize`: fp16
  straight-through means, the learned 6-bit uniform quantizer of the
  cholesky elements (gsvc_tpu_torch/compress/quantizers.py
  `uniform_quantize`), the 2-stage residual VQ of the colours with EMA
  codebooks and a 5-iteration k-means init (`residual_vq_forward`); in
  delta mode (a P-frame) the trainable values are the frame's less the
  frame before's, which are added back, frozen, after quantizing.
- `qat_steps`: `make_train_step_quantize`: L2 + the VQ commitment loss,
  Adan on xyz, cholesky, features and the quantizer's scale and offset.
- `frame_codes`: what `compress/bitstream.encode_frame` codes from a
  fitted state: fp16 means, cholesky codes, VQ stage indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import splats

CHOL_BITS = 6
QMAX = 2 ** CHOL_BITS - 1
STAGES, CODEBOOK, DECAY, KMEANS_ITERS = 2, 8, 0.8, 5


def _ste_round(x):
    return x + (torch.round(x) - x).detach()


def uniform_quantize(x, scale, beta):
    """(dequantized, integer codes) of the learned uniform quantizer."""
    code = torch.minimum(torch.maximum((x - beta) / scale, x.new_zeros(())),
                         x.new_full((), float(QMAX)))
    return _ste_round(code) * scale + beta, torch.round(code.detach())


def _assign(x, means):
    return torch.argmin(torch.sum((x[:, None, :] - means[None, :, :]) ** 2, -1), -1)


def _counts_sums(x, idx, k):
    one_hot = torch.nn.functional.one_hot(idx, k).to(x.dtype)
    return one_hot.sum(0), one_hot.T @ x


class VQ(NamedTuple):
    embed: torch.Tensor  # [Q, K, 3]
    cluster_size: torch.Tensor  # [Q, K]
    embed_avg: torch.Tensor  # [Q, K, 3]


def kmeans_init(x, picks) -> VQ:
    """Per stage: k-means from the rows picks[stage], on the residual."""
    embeds, css, eas = [], [], []
    residual = x.detach()
    for s in range(STAGES):
        means = residual[picks[s]]
        for _ in range(KMEANS_ITERS):
            counts, sums = _counts_sums(residual, _assign(residual, means), CODEBOOK)
            means = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1), means)
        counts, sums = _counts_sums(residual, _assign(residual, means), CODEBOOK)
        embeds.append(means)
        css.append(counts)
        eas.append(sums)
        residual = residual - means[_assign(residual, means)]
    return VQ(torch.stack(embeds), torch.stack(css), torch.stack(eas))


def vq_forward(x, vq: VQ, training: bool, eps: float = 1e-5):
    """(straight-through quantized x, indices [N, Q], commitment loss, new VQ)."""
    residual, total = x, torch.zeros_like(x)
    losses, idxs, es, cs_, eas = [], [], [], [], []
    for s in range(STAGES):
        r = residual.detach()
        idx = _assign(r, vq.embed[s])
        q = vq.embed[s][idx]
        e, cs, ea = vq.embed[s], vq.cluster_size[s], vq.embed_avg[s]
        if training:
            counts, sums = _counts_sums(r, idx, CODEBOOK)
            cs = cs * DECAY + counts * (1 - DECAY)
            ea = ea * DECAY + sums * (1 - DECAY)
            n = torch.sum(cs)
            e = ea / ((cs + eps) / (n + CODEBOOK * eps) * n)[:, None]
        losses.append(torch.mean((q.detach() - residual) ** 2))
        idxs.append(idx)
        es.append(e)
        cs_.append(cs)
        eas.append(ea)
        total = total + q
        residual = residual - q
    new = VQ(torch.stack(es).detach(), torch.stack(cs_).detach(), torch.stack(eas).detach())
    return x + (total - x).detach(), torch.stack(idxs, -1), torch.sum(torch.stack(losses)), new


def forward(params: dict, vq: VQ, frozen: dict, H: int, W: int, budget: int,
            training: bool):
    """(image [H, W, 3] clipped, commitment loss, new VQ); `frozen` holds
    the frame before's xyz, cholesky and features (zeros for a K-frame)."""
    xyz = params["xyz"]
    means = torch.tanh(xyz + (xyz.half().to(xyz.dtype) - xyz).detach() + frozen["xyz"])
    chol, _codes = uniform_quantize(params["cholesky"], params["q_scale"], params["q_beta"])
    colors, _idx, commit, new = vq_forward(params["features_dc"], vq, training)
    img = splats.render_splats(means, chol + splats.bound(chol) + frozen["cholesky"],
                               colors + frozen["features_dc"], H, W, budget)
    return img, commit, new


class QatSteps(NamedTuple):
    losses: list  # the loss (L2 + commitment) of each step
    start: dict  # leaf -> parameters before step 1
    after: list  # leaf -> parameters, after each step
    embeds: list  # the codebooks [Q, K, 3] after each step


def qat_steps(gmodel: dict, previous, gt: torch.Tensor, budget: int, picks, steps: int,
              lr: float, dtype) -> QatSteps:
    """A frame's first `steps` QAT steps from the representation `gmodel`
    ({_xyz, _cholesky, _features_dc}); with `previous`, the frame before's,
    in delta mode. `picks` are the k-means start rows of each stage."""
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
    params["q_scale"] = torch.full((3,), 1.0 / QMAX, dtype=dtype, device=dev)
    params["q_beta"] = torch.full((3,), 1.0 / QMAX, dtype=dtype, device=dev)
    target = gt.to(dtype)
    vq = kmeans_init(params["features_dc"], picks)
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
    return QatSteps(losses, start, after, embeds)


class Codes(NamedTuple):
    xyz16: np.ndarray  # [N, 2] float16
    chol_codes: np.ndarray  # [N, 3] int
    indices: np.ndarray  # [N, Q] int
    q_scale: np.ndarray
    q_beta: np.ndarray
    embed: np.ndarray  # [Q, K, 3]


def frame_codes(xyz, cholesky, features_dc, q_scale, q_beta, embed, dtype) -> Codes:
    """The codes of a fitted frame's parameters (host arrays of the state),
    worked out in `dtype` on the CPU."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)

    scale, beta = t(q_scale), t(q_beta)
    _deq, codes = uniform_quantize(t(cholesky), scale, beta)
    e = t(embed)
    residual, idxs = t(features_dc), []
    for s in range(e.shape[0]):
        idx = _assign(residual, e[s])
        idxs.append(idx)
        residual = residual - e[s][idx]
    return Codes(t(xyz).float().numpy().astype(np.float16),
                 codes.float().numpy().astype(np.int64),
                 torch.stack(idxs, -1).numpy().astype(np.int64),
                 scale.float().numpy(), beta.float().numpy(), e.float().numpy())

"""Quantizers of the compression stage (PyTorch port of
gsvc_tpu/compress/quantizers.py, the reference quantize.py stack):

- `fake_quantize_half`: FakeQuantizationHalf (quantize.py:15-24), fp16
  forward, identity backward.
- `uniform_quantize` + `UniformQuantParams`: the learned-scale uniform
  quantizer (quantize.py:26-87); scale and beta get plain gradients and
  start at 1/qmax (the reference's quirks, see the JAX module).
- `residual_vq_*`: the 2-stage residual VQ with EMA codebooks and k-means
  init of GaussianSplats_Compress.py:36 (dim 3, codebook 8, decay 0.8,
  commitment weight 1, 5 k-means iterations). Codebooks move by EMA, not by
  gradient; the quantized output passes gradients straight through; the
  commitment loss sum_stage mse(x_stage, stop_grad(q_stage)) is returned.

Parity details. Clipping uses torch.minimum/maximum, which split the
gradient at a tie as jnp.clip does (torch.clamp gives it all to x);
rounding is half-to-even in both packages. Distances pick the first
minimum (argmin in both). The k-means and EMA sums `one_hot.T @ x` run as
exact-f32 matmuls with TF32 off, never as index_add_/scatter_add_, whose
float atomics would make the card's results run-dependent.

Random draws: k-means starts from k rows of x chosen by a random
permutation (`jax.random.permutation(key, n)[:k]` in gsvc_tpu). Here
`draws` is a torch.Generator (`torch.randperm`) or a callable
(stage, n, k) -> k indices, so tests feed both packages the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import numpy as np
import torch

from gsvc_tpu_torch.utils.metrics import _no_tf32

VQDraws = Union[None, torch.Generator, Callable[[int, int, int], object]]


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip with jnp.clip's gradient (half to each side at a tie); the
    bounds are filled on x's device, with no host-to-device copy."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round with a straight-through gradient (quantize.py:12-13)."""
    return x + (torch.round(x) - x).detach()


def fake_quantize_half(x: torch.Tensor) -> torch.Tensor:
    """fp16 forward / identity backward (quantize.py:15-24)."""
    return x + (x.half().float() - x).detach()


@dataclasses.dataclass
class UniformQuantParams:
    """Trainable per-channel scale and offset (quantize.py:39-40)."""

    scale: torch.Tensor  # [C]
    beta: torch.Tensor  # [C]


def _qrange(bits: int, signed: bool) -> Tuple[int, int]:
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def uniform_quantizer_init(num_channels: int, bits: int = 6, signed: bool = False,
                           device="cpu") -> UniformQuantParams:
    qmax = _qrange(bits, signed)[1]
    return UniformQuantParams(
        scale=torch.full((num_channels,), 1.0 / qmax, dtype=torch.float32, device=device),
        beta=torch.full((num_channels,), 1.0 / qmax, dtype=torch.float32, device=device),
    )


def uniform_quantize(x: torch.Tensor, qp: UniformQuantParams, bits: int = 6,
                     signed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learned uniform quantization. Returns (dequant, integer codes).

    code = clip((x - beta) / scale, qmin, qmax); quant = ste_round(code);
    dequant = quant * scale + beta (quantize.py:51-59). Gradients reach x,
    scale and beta through the dequant expression."""
    qmin, qmax = _qrange(bits, signed)
    code = _clip((x - qp.beta) / qp.scale, float(qmin), float(qmax))
    dequant = _ste_round(code) * qp.scale + qp.beta
    return dequant, torch.round(code.detach()).to(torch.int32)


# -- residual VQ with EMA codebooks ------------------------------------------


@dataclasses.dataclass
class VQState:
    """EMA codebook state of all residual stages.

    embed [Q, K, D] codebooks; cluster_size [Q, K] / embed_avg [Q, K, D] the
    EMA statistics (vector_quantize_pytorch's EuclideanCodebook); initted:
    k-means has run. `initted` is a host bool: it flips once, at the first
    training forward, so a step never reads the device for it."""

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor
    initted: bool


def residual_vq_init(num_quantizers: int = 2, codebook_size: int = 8, dim: int = 3,
                     device="cpu") -> VQState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return VQState(
        embed=z(num_quantizers, codebook_size, dim),
        cluster_size=z(num_quantizers, codebook_size),
        embed_avg=z(num_quantizers, codebook_size, dim),
        initted=False,
    )


def _assign(x: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """Index of the nearest mean of each row (the first one at a tie)."""
    d = torch.sum((x[:, None, :] - means[None, :, :]) ** 2, -1)
    return torch.argmin(d, -1)


def _counts_and_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Per-cluster row counts and row sums: one_hot.T @ x in exact f32."""
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
    with _no_tf32():
        return one_hot.sum(0), one_hot.T @ x


def _sample_indices(draws: VQDraws, stage: int, n: int, k: int, device):
    if callable(draws):
        idx = draws(stage, n, k)
        return torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)
    gdev = draws.device if draws is not None else "cpu"
    return torch.randperm(n, generator=draws, device=gdev)[:k].to(device)


def _kmeans(x: torch.Tensor, idx: torch.Tensor, k: int, iters: int):
    """Lloyd's k-means from the rows `idx` (vector_quantize_pytorch's
    kmeans init). Returns (means, counts, sums) of the final assignment."""
    means = x[idx]
    for _ in range(iters):
        counts, sums = _counts_and_sums(x, _assign(x, means), k)
        means = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1), means)
    counts, sums = _counts_and_sums(x, _assign(x, means), k)
    return means, counts, sums


def _stage_forward(x, embed, cluster_size, embed_avg, training: bool,
                   decay: float, eps: float = 1e-5):
    """One EuclideanCodebook forward + EMA update. Returns (q, idx, embed,
    cluster_size, embed_avg)."""
    idx = _assign(x, embed)
    q = embed[idx]
    if not training:
        return q, idx, embed, cluster_size, embed_avg
    k = embed.shape[0]
    counts, sums = _counts_and_sums(x, idx, k)
    new_cs = cluster_size * decay + counts * (1 - decay)
    new_ea = embed_avg * decay + sums * (1 - decay)
    # laplace-smoothed normalisation (vector_quantize_pytorch)
    n = torch.sum(new_cs)
    smoothed = (new_cs + eps) / (n + k * eps) * n
    return q, idx, new_ea / smoothed[:, None], new_cs, new_ea


def residual_vq_forward(
    x: torch.Tensor,
    state: VQState,
    training: bool,
    decay: float = 0.8,
    kmeans_iters: int = 5,
    draws: VQDraws = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Residual VQ over [N, D]. Returns (quantized, indices [N, Q],
    commit_loss_sum, new_state).

    The quantized output carries straight-through gradients to x; the
    commitment loss is sum over stages of mse(x_stage, stop_grad(q_stage)).
    A training forward on an un-initialised state first runs k-means per
    stage on the residual, from the rows `draws` picks."""
    nq, k, _dim = state.embed.shape
    if training and not state.initted:
        embeds, css, eas = [], [], []
        residual = x.detach()
        for qi in range(nq):
            idx = _sample_indices(draws, qi, residual.shape[0], k, x.device)
            means, counts, sums = _kmeans(residual, idx, k, kmeans_iters)
            embeds.append(means)
            css.append(counts)
            eas.append(sums)
            residual = residual - means[_assign(residual, means)]
        state = VQState(embed=torch.stack(embeds), cluster_size=torch.stack(css),
                        embed_avg=torch.stack(eas), initted=True)

    residual = x
    quant_total = torch.zeros_like(x)
    losses, indices, new_embed, new_cs, new_ea = [], [], [], [], []
    for qi in range(nq):
        q, idx, e, cs, ea = _stage_forward(
            residual.detach(), state.embed[qi], state.cluster_size[qi],
            state.embed_avg[qi], training, decay,
        )
        losses.append(torch.mean((q.detach() - residual) ** 2))
        indices.append(idx)
        new_embed.append(e)
        new_cs.append(cs)
        new_ea.append(ea)
        quant_total = quant_total + q
        residual = residual - q
    # straight-through: gradients of the summed quantization flow to x
    quant_st = x + (quant_total - x).detach()
    new_state = VQState(
        embed=torch.stack(new_embed).detach(),
        cluster_size=torch.stack(new_cs).detach(),
        embed_avg=torch.stack(new_ea).detach(),
        initted=state.initted or training,
    )
    commit = torch.sum(torch.stack(losses))
    return quant_st, torch.stack(indices, -1), commit, new_state


def residual_vq_decompress(state: VQState, indices: np.ndarray) -> np.ndarray:
    """Reconstruct from per-stage indices (reference quantize.py:146-150)."""
    embed = state.embed.detach().cpu().numpy()
    idx = np.asarray(indices)
    recon = np.zeros((idx.shape[0], embed.shape[-1]), np.float32)
    for qi in range(embed.shape[0]):
        recon += embed[qi][idx[:, qi]]
    return recon

"""Adan optimizer (Adaptive Nesterov Momentum, arXiv 2208.06677).

PyTorch port of gsvc_tpu/optim/adan.py, the functional form of the
reference's vendored torch Adan (optimizer.py:238-293). Parameters,
gradients and moments are dicts of tensors keyed like `_trainable`;
the update is plain elementwise PyTorch under `torch.no_grad()` (the JAX
package has no kernel here either). The step counter and the per-leaf
`fresh` flags are host values, so no update needs a host sync.

Update rule per step t:
    g       <- g * clip                      (global-norm clip factor)
    m_t     = b1*m + (1-b1)*g
    diff_t  = b2*diff + (1-b2)*(g - g_{t-1})
    u       = g + b2*(g - g_{t-1})
    n_t     = b3*n + (1-b3)*u^2
    denom   = sqrt(n_t)/sqrt(1-b3^t) + eps
    p       <- p - lr/(1-b1^t) * m_t/denom - lr*b2/(1-b2^t) * diff_t/denom
    p       <- p / (1 + lr*wd)               (prox form; no_prox flips order)

On the first step, or after `adan_reset_moments`, g_{t-1} is taken to be
g itself, so the difference term is zero (optimizer.py:187-189).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdanState:
    step: int  # group step counter
    exp_avg: Tree  # m: EMA of grads
    exp_avg_sq: Tree  # n: EMA of squared nesterov-corrected grads
    exp_avg_diff: Tree  # d: EMA of grad differences
    neg_pre_grad: Tree  # -g_{t-1}
    fresh: Dict[str, bool]  # neg_pre_grad is re-seeded from the next grad


def _zeros(tree: Mapping[str, torch.Tensor]) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def adan_init(params: Mapping[str, torch.Tensor]) -> AdanState:
    return AdanState(
        step=0, exp_avg=_zeros(params), exp_avg_sq=_zeros(params),
        exp_avg_diff=_zeros(params), neg_pre_grad=_zeros(params),
        fresh={k: True for k in params},
    )


def adan_reset_moments(state: AdanState) -> AdanState:
    """Zero all moments but keep the step counter: the reference's state
    after pruning swaps the parameter tensors (optimizer.py:181-189)."""
    return dataclasses.replace(adan_init(state.exp_avg), step=state.step)


def _f32(x) -> float:
    return float(np.float32(x))


@torch.no_grad()
def adan_step(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdanState,
    lr: float,
    betas: Tuple[float, float, float] = (0.98, 0.92, 0.99),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float = 0.0,
    no_prox: bool = False,
) -> Tuple[Tree, AdanState]:
    """One Adan update. Returns (new_params, new_state); the inputs are
    not modified. Step scalars are rounded to float32 as gsvc_tpu takes
    them."""
    b1, b2, b3 = betas
    step = state.step + 1
    t = np.float32(step)
    lr32 = np.float32(lr)
    bc1 = np.float32(1.0) - np.float32(b1) ** t
    bc2 = np.float32(1.0) - np.float32(b2) ** t
    bc3_sqrt = _f32(np.sqrt(np.float32(1.0) - np.float32(b3) ** t))
    step_size = _f32(lr32 / bc1)
    step_size_diff = _f32(lr32 * np.float32(b2) / bc2)
    decay = _f32(np.float32(1.0) + lr32 * np.float32(weight_decay))

    clip = None
    if max_grad_norm > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        clip = torch.clamp(max_grad_norm / (gnorm + eps), max=1.0)

    new_p, m_new, n_new, d_new, npg_new = {}, {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k] if clip is None else grads[k] * clip
        npg = -g if state.fresh[k] else state.neg_pre_grad[k]
        diff = npg + g  # g_t - g_{t-1}
        m_t = b1 * state.exp_avg[k] + (1.0 - b1) * g
        d_t = b2 * state.exp_avg_diff[k] + (1.0 - b2) * diff
        u = g + b2 * diff
        n_t = b3 * state.exp_avg_sq[k] + (1.0 - b3) * u * u
        denom = torch.sqrt(n_t) / bc3_sqrt + eps
        if no_prox:
            q = p * _f32(np.float32(1.0) - lr32 * np.float32(weight_decay))
            q = q - step_size * m_t / denom - step_size_diff * d_t / denom
        else:
            q = p - step_size * m_t / denom - step_size_diff * d_t / denom
            q = q / decay
        new_p[k], m_new[k], n_new[k], d_new[k], npg_new[k] = q, m_t, n_t, d_t, -g
    return new_p, AdanState(
        step=step, exp_avg=m_new, exp_avg_sq=n_new, exp_avg_diff=d_new,
        neg_pre_grad=npg_new, fresh={k: False for k in params},
    )

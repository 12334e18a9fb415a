"""Adan optimizer (Adaptive Nesterov Momentum, arXiv 2208.06677).

PyTorch port of gsvc_tpu/optim/adan.py, the functional form of the
reference's vendored torch Adan (optimizer.py:238-293). Parameters,
gradients and moments are dicts of tensors keyed like `_trainable`. The
step counter and the per-leaf `fresh` flags are host values, so no update
needs a host sync.

Two forms of one update. `adan_step` takes the step's scalars as host
floats and returns new tensors, by `_update`: plain elementwise PyTorch
under `torch.no_grad()`, one op at a time (gsvc_tpu's jnp, which XLA fuses
into one update). `adan_step_`, the fits' form, takes them as a table made
once a fit (`adan_table`) and a [] int64 device tensor holding the step's
row, the fresh flag as a [] bool tensor, and writes its results into the
parameters' and the state's own tensors: a CUDA graph of the step then
replays every later step. On CUDA tensors it is one launch of a
hand-written kernel for every leaf (`optim.adan_cuda`, csrc/adan.cu),
which reads the row, the flag and the clip factor on the device; on CPU
tensors it runs `_update` and `copy_`s its results
(`adan_update_torch_`). All give the same
bits: a multiply by a [] tensor rounds as one by the float, `torch.where`
on the flag copies, a division by a Python float, which PyTorch computes
on a CUDA tensor as a multiply by its float32 reciprocal
(div_true_kernel_cuda), is taken from a table that holds that reciprocal
(`_div`), and the kernel does `_update`'s float32 operations in its order,
each rounded once.

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
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch.optim import adan_cuda

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


# A step's scalars, the columns of `adan_table`: the two step sizes, the
# divisors sqrt(1 - b3^t) and 1 + lr*wd, and no_prox's factor 1 - lr*wd.
SCALARS = ("step_size", "step_size_diff", "bc3_sqrt", "decay", "shrink")
_DIVISORS = (2, 3)


def adan_scalars(step: int, lr: float, betas=(0.98, 0.92, 0.99),
                 weight_decay: float = 0.0) -> tuple:
    """The scalars (`SCALARS`) of Adan step `step` (1-based) at rate `lr`,
    rounded to float32 as gsvc_tpu takes them, as host floats."""
    b1, b2, b3 = betas
    t = np.float32(step)
    lr32 = np.float32(lr)
    bc1 = np.float32(1.0) - np.float32(b1) ** t
    bc2 = np.float32(1.0) - np.float32(b2) ** t
    wd = np.float32(weight_decay)
    return (_f32(lr32 / bc1), _f32(lr32 * np.float32(b2) / bc2),
            _f32(np.sqrt(np.float32(1.0) - np.float32(b3) ** t)),
            _f32(np.float32(1.0) + lr32 * wd), _f32(np.float32(1.0) - lr32 * wd))


def adan_table(steps, betas=(0.98, 0.92, 0.99), weight_decay: float = 0.0,
               device="cpu") -> np.ndarray:
    """[R, 5] float32: `adan_scalars` of each (step, lr) of `steps`, for
    `adan_step_` on `device`. For a CUDA device the divisors are stored as
    their float32 reciprocals (`_div`)."""
    table = np.array([adan_scalars(s, lr, betas, weight_decay) for s, lr in steps],
                     np.float32).reshape(-1, len(SCALARS))
    if torch.device(device).type == "cuda":
        table[:, _DIVISORS] = np.float32(1.0) / table[:, _DIVISORS]
    return table


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d as PyTorch divides by the Python float d. A [] tensor d is a
    row of `adan_table`: on a CUDA tensor PyTorch divides by a Python float
    as a multiply by its float32 reciprocal, which the table holds there;
    on the CPU it divides."""
    if isinstance(d, torch.Tensor) and d.is_cuda:
        return x * d
    return x / d


def _clip_factor(grads, eps, max_grad_norm) -> Optional[torch.Tensor]:
    """The global-norm clip factor of the gradients, a [] tensor (None where
    max_grad_norm is 0: no clip)."""
    if max_grad_norm <= 0.0:
        return None
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    return torch.clamp(max_grad_norm / (gnorm + eps), max=1.0)


def _update(params, grads, state: AdanState, sc, fresh, betas, eps,
            max_grad_norm, no_prox):
    """The update's arithmetic: (params, m, n, d, -g) dicts of new tensors.
    `sc` holds the `SCALARS` as floats or [] tensors; `fresh` is the dict of
    host flags or one [] bool tensor for every leaf."""
    b1, b2, b3 = betas
    step_size, step_size_diff, bc3_sqrt, decay, shrink = sc
    clip = _clip_factor(grads, eps, max_grad_norm)

    new_p, m_new, n_new, d_new, npg_new = {}, {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k] if clip is None else grads[k] * clip
        if isinstance(fresh, torch.Tensor):
            npg = torch.where(fresh, -g, state.neg_pre_grad[k])
        else:
            npg = -g if fresh[k] else state.neg_pre_grad[k]
        diff = npg + g  # g_t - g_{t-1}
        m_t = b1 * state.exp_avg[k] + (1.0 - b1) * g
        d_t = b2 * state.exp_avg_diff[k] + (1.0 - b2) * diff
        u = g + b2 * diff
        n_t = b3 * state.exp_avg_sq[k] + (1.0 - b3) * u * u
        denom = _div(torch.sqrt(n_t), bc3_sqrt) + eps
        if no_prox:
            q = p * shrink
            q = q - step_size * m_t / denom - step_size_diff * d_t / denom
        else:
            q = p - step_size * m_t / denom - step_size_diff * d_t / denom
            q = _div(q, decay)
        new_p[k], m_new[k], n_new[k], d_new[k], npg_new[k] = q, m_t, n_t, d_t, -g
    return new_p, m_new, n_new, d_new, npg_new


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
    sc = adan_scalars(state.step + 1, lr, betas, weight_decay)
    new_p, m_new, n_new, d_new, npg_new = _update(
        params, grads, state, sc, state.fresh, betas, eps, max_grad_norm, no_prox)
    return new_p, AdanState(
        step=state.step + 1, exp_avg=m_new, exp_avg_sq=n_new, exp_avg_diff=d_new,
        neg_pre_grad=npg_new, fresh={k: False for k in params},
    )


@torch.no_grad()
def adan_step_(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdanState,
    table: torch.Tensor,
    row: torch.Tensor,
    fresh: torch.Tensor,
    betas: Tuple[float, float, float] = (0.98, 0.92, 0.99),
    eps: float = 1e-8,
    max_grad_norm: float = 0.0,
    no_prox: bool = False,
) -> AdanState:
    """`adan_step` on the fit's own tensors: the step's scalars are row
    `row` ([] int64) of `table` (`adan_table` for the parameters' device)
    and `fresh` the [] bool twin of the state's flags. The new parameters
    go into `params`' tensors and the moments into the state's; `fresh` is
    set False. On CUDA tensors one kernel launch does it all
    (`adan_cuda.adan_update`); on CPU tensors its plain version
    (`adan_update_torch_`). Returns the state with step + 1 and its flags
    False."""
    if next(iter(params.values())).is_cuda:
        # autograd may hand a gradient over transposed (features_dc's); the
        # kernel reads each leaf's tensors as one contiguous range
        leaves = [(p, grads[k].contiguous(), state.exp_avg[k], state.exp_avg_sq[k],
                   state.exp_avg_diff[k], state.neg_pre_grad[k])
                  for k, p in params.items()]
        adan_cuda.adan_update(leaves, table, row, fresh,
                              _clip_factor(grads, eps, max_grad_norm), betas, eps, no_prox)
    else:
        adan_update_torch_(params, grads, state, table, row, fresh, betas, eps,
                           max_grad_norm, no_prox)
    fresh.fill_(False)
    return adan_host_step(state)


@torch.no_grad()
def adan_update_torch_(params, grads, state: AdanState, table: torch.Tensor,
                       row: torch.Tensor, fresh: torch.Tensor, betas, eps: float,
                       max_grad_norm: float, no_prox: bool) -> None:
    """The plain version of `adan_step_`'s update, on either device: the
    row's scalars as [] tensors, `_update` one PyTorch op at a time, its
    results `copy_`d into the parameters and the state (on a card, 31
    kernels a leaf; the kernel's yardstick in `chip_smoke.py`). Leaves
    `fresh` as it is."""
    scalars = torch.index_select(table, 0, row.view(1))[0].unbind()
    new = _update(params, grads, state, scalars, fresh, betas, eps, max_grad_norm, no_prox)
    for dst, src in zip((params, state.exp_avg, state.exp_avg_sq, state.exp_avg_diff,
                         state.neg_pre_grad), new):
        for k, t in src.items():
            dst[k].copy_(t)


def adan_host_step(state: AdanState) -> AdanState:
    """The host fields after one update (a replayed step sets them so):
    step + 1, fresh flags False."""
    return dataclasses.replace(state, step=state.step + 1,
                               fresh={k: False for k in state.fresh})


@torch.no_grad()
def adan_reset_moments_(state: AdanState, fresh: torch.Tensor) -> AdanState:
    """`adan_reset_moments` in the state's own tensors (zeroed) and the [] bool
    twin `fresh` (set True)."""
    for tree in (state.exp_avg, state.exp_avg_sq, state.exp_avg_diff, state.neg_pre_grad):
        for t in tree.values():
            t.zero_()
    fresh.fill_(True)
    return dataclasses.replace(state, fresh={k: True for k in state.fresh})

"""The port's represent steps on int64 binning keys against the plain
float64 reference (`benchmark/reference/splats.represent_steps`): the
cases of `test_torch_int64_keys_kframe.py` and `_pframe.py`.

Keys are int64 once the sentinel key (tiles << gauss bits) passes 2^31:
at 3840x2160 and 100,000 splats a 17-bit field on 32,400 tiles (the 4K
UHD cell), here a 21-bit field on 1,024 tiles (512x512, 2^20 slots of
capacity), the fewest pixels that reach int64 keys. The plain versions
of K4 rows and K6 work on every (tile, lane, pixel) of the grid, so their
cost follows the tiles alone: at 2048x2048, the fewest pixels with a
17-bit field, a step took ~35 s on 4 threads, and the two cases pushed
the suite past its time limit; here one takes ~2 s. `fill_cuda.key_layout`
gives both grids the same code (a wider shift). ~2,000 of the slots are
alive, the first and the last 1,000, so alive splats sit past slot
2^20 - 1,000 and their ids need every bit of the field. Each case runs 3
steps through `fit_frame_partial` (backend "cuda": K1, the sort, K2, K4
rows, K6 and K3 in their plain versions on the CPU) and compares the
losses, the first gradient and the parameters after each step:

- a K-frame under removal control (no control step acts in 3 steps);
- a P-frame warm-started from a frame before, whose adaptive control
  revives the first dead slots at step 1 (`removal_rate` of the
  capacity; the step updates nothing and restarts Adan's moments; the
  reference's `revive`).

A key whose gauss field is too narrow (16 bits, the layout below 65,536
splats) mixes the splats past 65,535 into the wrong tiles.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.reference import splats as ref
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.models.represent import GaussianFrame
from gsvc_tpu_torch.ops import fill_cuda

H = W = 512
CAP, EDGE = 1 << 20, 1_000  # capacity; alive: slots [0, EDGE) and [CAP - EDGE, CAP)
BUDGET = 1 << 17  # intersection slots, ~25x what the alive splats hit
REVIVE_RATE = 0.005  # the P-frame revives 5,242 dead slots at step 1
STEPS, LR = 3, 1e-3

# Tolerances (the float32 program against the float64 reference), each
# about 20x the largest gap read on the CPU:
# - loss: relative 2e-6. A loss is a float32 sum of 786,432 squared errors
#   over renders that agree to a few ulp a pixel: read <= 9.4e-8.
# - gradient and change: the worst leaf's |norm gap| against the larger
#   of its reference norm and the median leaf's, 1e-4. The first gradient
#   gathers each pair's float32 sum over its tile's 256 pixels in another
#   order than the reference (read 1.7e-8); Adan's normalised step lifts the
#   gap of the change where the second moment is still small (read <= 4.3e-6
#   by step 3). A splat misbinned by a too narrow gauss field moves its
#   leaves whole.
LOSS_TOL, LEAF_TOL = 2e-6, 1e-4


@pytest.fixture
def four_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def _uniforms(seed: int):
    u = torch.rand((CAP, 8), generator=torch.Generator().manual_seed(seed))
    return 2.0 * u[:, :2] - 1.0, u[:, 2:5], u[:, 5:8]


def _alive() -> torch.Tensor:
    slot = torch.arange(CAP)
    return (slot < EDGE) | (slot >= CAP - EDGE)


def _gt() -> torch.Tensor:
    return torch.rand((H, W, 3), generator=torch.Generator().manual_seed(11))


def _cfg(is_k: bool) -> FrameConfig:
    return FrameConfig(H=H, W=W, num_points=CAP, max_num_points=CAP, iterations=STEPS,
                       lr=LR, isremoval=is_k, isdensity=not is_k, removal_rate=REVIVE_RATE,
                       densification_interval=100, backend="cuda", max_intersects=BUDGET)


B1 = _cfg(True).betas[0]  # Adan's first-moment rate: m after step 1 is (1 - B1) g


def _leaves(params) -> dict:
    return {k: v.detach().clone() for k, v in rep._trainable(params).items()}


def _program(is_k: bool):
    """The port's 3 steps: (init leaves, budget, losses, first gradient,
    leaves after each step)."""
    cfg = _cfg(is_k)
    warm = None
    if not is_k:  # the frame before's splats in every slot
        u_xyz, u_chol, u_feat = _uniforms(5)
        warm = GaussianFrame(torch.atanh(0.9 * u_xyz), u_chol, u_feat,
                             torch.ones((CAP, 1)))
    state = rep.init_train_state(cfg, warm=warm, warm_count=None if is_k else CAP,
                                 uniforms=_uniforms(3))
    state = dataclasses.replace(state, alive=_alive())
    init = _leaves(state.params)
    draws = torch.Generator().manual_seed(7)
    losses, after, first = [], [], None
    for step in range(1, STEPS + 1):  # chained slices: one fit, bit for bit
        state = rep.fit_frame_partial(state, _gt(), step, cfg, draws=draws)
        losses.append(float(state.loss))
        after.append(_leaves(state.params))
        if first is None:
            first = {k: v.double() / (1 - B1) for k, v in state.opt.exp_avg.items()}
    return init, rep.intersection_budget(cfg), losses, first, after


def _reference(init: dict, budget: int, is_k: bool):
    revived = None
    if not is_k:  # the adaptive control's draws at step 1, from the fit's generator
        g = torch.Generator().manual_seed(7)
        u = (2.0 * torch.rand((CAP, 2), generator=g) - 1.0, torch.rand((CAP, 3), generator=g),
             torch.rand((CAP, 3), generator=g))
        revived = (u, int(CAP * _cfg(is_k).removal_rate))
    return ref.represent_steps(init, _alive(), _gt(), budget, STEPS, LR, torch.float64,
                               revived)


def _leaf_gap(prog: dict, want: dict) -> float:
    """The worst leaf's |norm gap| against the larger of its reference norm
    and the median leaf's (leaves the reference leaves at 0 are skipped)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return max(abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
               / max(norms[k], med) for k in want if norms[k] > 0)


def _change(leaves: list, a: int, b: int) -> dict:
    return {k: leaves[b][k].double() - leaves[a][k].double() for k in leaves[b]}


def check_steps(frame: str) -> None:
    """The port's 3 steps of `frame` ("K" or "P") held to the reference's."""
    is_k = frame == "K"
    cfg = _cfg(is_k)
    layout = fill_cuda.key_layout(cfg.tile_bounds[0] * cfg.tile_bounds[1], CAP)
    assert (layout.dtype, layout.gauss_bits) == (torch.int64, 21)
    init, budget, losses, first, after = _program(is_k)
    fit = _reference({k: v.clone() for k, v in init.items()}, budget, is_k)
    for got, want in zip(losses, fit.losses):
        assert abs(got - want) <= LOSS_TOL * abs(want), (losses, fit.losses)
    if is_k:  # a P-frame's step 1 updates nothing: its moment is no gradient
        assert _leaf_gap(first, fit.first_grads) <= LEAF_TOL
    prog = [init] + after
    want = [fit.start] + fit.after
    for a, b in zip(range(STEPS), range(1, STEPS + 1)):
        gap = _leaf_gap(_change(prog, a, b), _change(want, a, b))
        assert gap <= LEAF_TOL, (frame, a, b, gap)
    if not is_k:  # the revive moved the dead slots the reference revived
        assert torch.equal(after[0]["xyz"], want[1]["xyz"].float())

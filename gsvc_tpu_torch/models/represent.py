"""Per-frame representation model and its training loop (PyTorch port of
gsvc_tpu/models/represent.py): `render_frame(_pos/_rows)`, the train step
`make_train_step`, `fit_frame` (and its resumable slice
`fit_frame_partial`), `fit_frame_trace` and `pre_train_frame`.

One step is the reference train_iter (GaussianSplats_Represent.py:191-207):
render, loss, backward (autograd; on the "cuda" backend the rasterizer's
backward is K6 and the K3 reduction), splat control, Adan, StepLR, the
binning-overflow check and early stopping. Splats live at a fixed capacity
beside an `alive` mask, as in gsvc_tpu. The port keeps the iteration
counter, the Adan step, `lr_frozen` and the early-stop grace on the host,
so control iterations need no sync; the device is read only where the JAX
step branches on a device value: the prune count at the control threshold
and the early-stop patience (`fit_frame` reads it only when it could have
run out).

A step writes every new value into the state's own tensors with `copy_`
(values unchanged), so the tensors of a state never change during a fit,
and reads the host values it depends on from their device twins
(`utils.graphs.Twins`: Adan's step scalars, folded with the StepLR rate
into one table a fit slice, Adan's fresh flag and the grace). On a CUDA
device the fits (`fit_frame(_partial)`, `pre_train_frame`) therefore run
each plain step as a replay of one captured CUDA graph, gsvc_tpu's one
jitted `lax.while_loop` / `lax.scan` a fit; the control steps (`it == 1`
and every `densification_interval`-th, where the mask is rebuilt, the
moments reset and the overflow checked) run eagerly (`plan_steps`).
`graph=False` runs every step eagerly, with the same bits. The fits update
the given state's tensors in place and return a state that holds them.

Reference quirks kept (see gsvc_tpu's module docstring): control
iterations that rebuild parameters skip the Adan update and restart its
moments while its step keeps counting; after the threshold's
`update_optimizer` the learning rate is frozen at base lr; colours render
as features_dc * rgb_W with no activation.

Random draws of `_revive` are injected: a step takes a `torch.Generator`
or a callable n -> (u_xyz [n,2] in U(-1,1), u_chol [n,3], u_feat [n,3]),
so parity tests feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import GaussianFrame, cholesky_bound, init_splats
from gsvc_tpu_torch.ops.binning import budget_overflow, default_max_intersects
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import image_to_rows, rasterize_gaussians_sum
from gsvc_tpu_torch.optim.adan import (
    AdanState,
    adan_init,
    adan_host_step,
    adan_reset_moments_,
    adan_step_,
    adan_table,
)
from gsvc_tpu_torch.optim.schedule import step_lr
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.losses import loss_fn

Draws = Union[None, torch.Generator, Callable[[int], tuple]]


@dataclasses.dataclass
class TrainState:
    params: GaussianFrame
    alive: torch.Tensor  # [N] bool
    opt: AdanState
    it: int  # iterations completed
    lr_frozen: bool  # update_optimizer happened (scheduler quirk)
    best_loss: torch.Tensor  # [] f32 early-stop best
    patience: torch.Tensor  # [] int32 iters without improvement
    grace: int  # early-stop grace countdown
    stop: torch.Tensor  # [] bool
    loss: torch.Tensor  # [] f32 last loss
    psnr: torch.Tensor  # [] f32 last psnr
    max_overflow: torch.Tensor  # [] int32 worst binning budget overflow seen


class FitResult(NamedTuple):
    state: TrainState
    image: torch.Tensor  # final render [H, W, 3]


def _trainable(params: GaussianFrame) -> dict:
    return {
        "xyz": params.xyz,
        "cholesky": params.cholesky,
        "features_dc": params.features_dc,
        "rgb_w": params.rgb_w,
    }


def init_train_state(
    cfg: FrameConfig, warm: Optional[GaussianFrame] = None,
    warm_count: Optional[int] = None, uniforms=None,
    generator: Optional[torch.Generator] = None, device="cpu",
) -> TrainState:
    """Fresh state, optionally warm-started from a previous frame's splats
    (train_video_Represent.py:64-69: xyz/cholesky/features copied, rgb_W
    restarts at its init value). `uniforms` / `generator` feed
    `init_splats`."""
    rgb_w_value = 0.01 if cfg.isremoval else 1.0
    params, alive = init_splats(
        cfg.num_points, capacity=cfg.max_num_points, rgb_w_value=rgb_w_value,
        uniforms=uniforms, generator=generator, device=device,
    )
    if warm is not None:
        count = warm_count if warm_count is not None else cfg.num_points
        m = torch.arange(cfg.max_num_points, device=device) < count
        with torch.no_grad():
            params = GaussianFrame(
                torch.where(m[:, None], warm.xyz, params.xyz),
                torch.where(m[:, None], warm.cholesky, params.cholesky),
                torch.where(m[:, None], warm.features_dc, params.features_dc),
                params.rgb_w.detach().clone(),
            )
        alive = m

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return TrainState(
        params=params, alive=alive, opt=adan_init(_trainable(params)), it=0,
        lr_frozen=False, best_loss=scalar(float("inf"), torch.float32),
        patience=scalar(0, torch.int32),
        grace=cfg.stable_control if (cfg.isdensity or cfg.isremoval) else 0,
        stop=scalar(False, torch.bool), loss=scalar(float("inf"), torch.float32),
        psnr=scalar(0.0, torch.float32), max_overflow=scalar(0, torch.int32),
    )


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """clip to [0, 1] with jnp.clip's gradient (half at a tie)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _render(params: GaussianFrame, alive, cfg: FrameConfig, layout="image",
            rgb_w_trainable=True) -> torch.Tensor:
    """The differentiable model.forward(): render + clip to [0, 1]
    (GaussianSplats_Represent.py:83-90: opacity ones, colours
    premultiplied by rgb_W, clip outside the rasterizer)."""
    colors = params.get_features if rgb_w_trainable else params.features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    opacity = torch.ones((params.capacity, 1), dtype=torch.float32,
                         device=xys.device)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, colors, opacity,
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects, layout=layout,
    )
    return _clip01(img) if img.requires_grad else torch.clamp(img, 0.0, 1.0)


@torch.no_grad()
def render_frame(
    params: GaussianFrame, alive: torch.Tensor, cfg: FrameConfig,
    rgb_w_trainable: bool = True, layout: str = "image",
) -> torch.Tensor:
    """model.forward(): [H, W, 3] ("image"), planar [3, H, W] ("chw") or
    the tile-row blocks of `image_to_rows` ("rows")."""
    return _render(params, alive, cfg, layout, rgb_w_trainable)


@torch.no_grad()
def render_frame_rows(params: GaussianFrame, alive: torch.Tensor,
                      cfg: FrameConfig) -> torch.Tensor:
    """model.forward() in the tile-row block layout (the clip commutes with
    the tiling, so tile-space clip is exact)."""
    return _render(params, alive, cfg, "rows")


@torch.no_grad()
def render_frame_pos(
    params: GaussianFrame, alive: torch.Tensor, cfg: FrameConfig
) -> torch.Tensor:
    """model.forward_pos(): every live splat with unit colour and a fixed
    cholesky of 1.0 (+ bound), [H, W, 3] (GaussianSplats_Represent.py:72-82)."""
    n = params.capacity
    dev = params.xyz.device
    cholesky = torch.full((n, 3), 1.0, dtype=torch.float32, device=dev) + cholesky_bound(dev)
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, cholesky, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    ones = torch.ones((n, 3), dtype=torch.float32, device=dev)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, ones, ones[:, :1],
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
    )
    return torch.clamp(img, 0.0, 1.0)


def uses_kernels(cfg: FrameConfig, device) -> bool:
    """Whether the backend resolves to the kernel path: "cuda", or "auto"
    on a CUDA device."""
    return cfg.backend == "cuda" or (
        cfg.backend == "auto" and torch.device(device).type == "cuda")


def _use_rows_loss(cfg: FrameConfig, device) -> bool:
    """Pointwise losses (L1/L2) run in the rasterizer's tile-row layout,
    skipping the untile transpose in both passes, on the kernel path;
    structural losses need the image."""
    return cfg.loss_type in ("L2", "L1") and uses_kernels(cfg, device)


def make_rows_target(gt: torch.Tensor, cfg: FrameConfig, valid_h=None):
    """The [h, W, 3] target and its valid-pixel mask in the layout="rows"
    blocks, made once per frame fit. `valid_h` (an int or a [] tensor)
    masks the pixel rows at or past it too: a tile-row shard of a frame
    whose height the shards do not divide holds padding rows there."""
    h = gt.shape[0]
    gt_rows = image_to_rows(gt, h, cfg.W, cfg.block_h, cfg.block_w)
    ones = torch.ones_like(gt)
    if valid_h is not None:
        ridx = torch.arange(h, device=gt.device)[:, None, None]
        ones = torch.where(ridx < valid_h, ones, 0.0)
    mask = image_to_rows(ones, h, cfg.W, cfg.block_h, cfg.block_w)
    return gt_rows, mask


def _loss_and_psnr(params, alive, gt, cfg: FrameConfig, lambda_value,
                   rows_target=None):
    """(loss, (sq_sum, render)): the differentiable loss, and the sum of
    squared error the caller turns into PSNR (detached)."""
    denom = cfg.H * cfg.W * 3
    if rows_target is not None:
        rows = _render(params, alive, cfg, "rows")
        gt_rows, mask = rows_target
        diff = (rows - gt_rows) * mask  # mask zeroes tile-padding pixels
        sq = torch.sum(diff * diff)
        loss = sq if cfg.loss_type == "L2" else torch.sum(torch.abs(diff))
        return loss / denom, (sq.detach(), rows)
    img = _render(params, alive, cfg)
    loss = loss_fn(img.permute(2, 0, 1), gt.permute(2, 0, 1), cfg.loss_type,
                   lambda_value=lambda_value)
    sq = torch.sum((img.detach() - gt) ** 2)
    return loss, (sq, img)


def _alive_rank_by_weight(params: GaussianFrame, alive: torch.Tensor) -> torch.Tensor:
    """Rank of each slot by |rgb_W| among alive slots (dead slots last; ties
    by slot index, a stable sort like torch.sort in the reference,
    GaussianSplats_Represent.py:102)."""
    keys = torch.where(alive, torch.abs(params.rgb_w[:, 0]), float("inf"))
    order = torch.argsort(keys, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(keys.shape[0], device=keys.device)
    return rank


def _prune(params, alive, remove_count):
    return alive & (_alive_rank_by_weight(params, alive) >= remove_count)


def _draw(draws: Draws, n: int, device):
    """(u_xyz [n,2] in U(-1,1), u_chol [n,3], u_feat [n,3]) on `device`."""
    if callable(draws):
        u = draws(n)
    else:
        gdev = draws.device if draws is not None else device

        def rand(*shape):
            return torch.rand(shape, generator=draws, dtype=torch.float32, device=gdev)

        u = (2.0 * rand(n, 2) - 1.0, rand(n, 3), rand(n, 3))
    return [(a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a)))
            .to(device=device, dtype=torch.float32) for a in u]


def _revive(params: GaussianFrame, alive, uniforms, add_count: int):
    """Revive the first `add_count` dead slots with fresh random splats
    (the reference appends new tensors, GaussianSplats_Represent.py:136-143;
    slot order differs, as in gsvc_tpu)."""
    u_xyz, u_chol, u_feat = uniforms
    dead = ~alive
    dead_rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    revive = dead & (dead_rank < add_count)
    rv = revive[:, None]
    new_xyz = torch.atanh(torch.clamp(u_xyz, -1.0 + 1e-7, 1.0 - 1e-7))
    with torch.no_grad():
        params = GaussianFrame(
            torch.where(rv, new_xyz, params.xyz),
            torch.where(rv, u_chol, params.cholesky),
            torch.where(rv, u_feat, params.features_dc),
            torch.where(rv, 0.01, params.rgb_w),
        )
    return params, alive | revive


def _threshold_prune(params, alive, target: int):
    """At the control threshold, prune down to `target` alive splats; the
    count is read from the device (the JAX step branches on it too)."""
    rc = int(torch.sum(alive.to(torch.int32))) - target
    if rc > 0:
        return _prune(params, alive, rc), True
    return alive, False


# splat control's thresholds: removal prunes until iteration 4000
# (GaussianSplats_Represent.py:98-128); adaptive control revives at 1,
# prunes from 500 and stops at 1000 (:130-172)
REMOVAL_THRESHOLD = 4000
DENSITY_ADD, DENSITY_REMOVE = 500, 500


def _removal_control(params, alive, it: int, cfg: FrameConfig):
    """GaussianSplats_Represent.py:98-128. Returns (params, alive, rebuilt,
    hit_threshold)."""
    thresh = REMOVAL_THRESHOLD
    interval_events = thresh // cfg.densification_interval
    per_step = int((cfg.removal_rate / interval_events) * cfg.max_num_points)
    target = int(cfg.max_num_points * (1.0 - cfg.removal_rate))
    if it < thresh:
        return params, _prune(params, alive, per_step), True, False
    if it == thresh:
        alive, rebuilt = _threshold_prune(params, alive, target)
        return params, alive, rebuilt, True
    return params, alive, False, False


def _adaptive_control(params, alive, draws: Draws, it: int, cfg: FrameConfig):
    """GaussianSplats_Represent.py:130-172. Returns (params, alive, rebuilt,
    hit_threshold)."""
    t_rm, t_add = DENSITY_REMOVE, DENSITY_ADD
    thresh = t_rm + t_add
    den = int(cfg.max_num_points * cfg.removal_rate)
    events = t_rm // cfg.densification_interval
    per_step = int(den / events) if events else 0
    target = int(cfg.max_num_points * (1.0 - cfg.removal_rate))
    if it == 1:
        u = _draw(draws, alive.shape[0], alive.device)
        params, alive = _revive(params, alive, u, den)
        return params, alive, den > 0, False
    if t_add <= it < thresh:
        return params, _prune(params, alive, per_step), True, False
    if it == thresh:
        alive, rebuilt = _threshold_prune(params, alive, target)
        return params, alive, rebuilt, True
    return params, alive, False, False


def _psnr(cfg: FrameConfig, sq: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(cfg.H * cfg.W * 3 / torch.clamp(sq, min=1e-20))


def _loss_and_grads(state: TrainState, gt, cfg: FrameConfig, lambda_value,
                    rows_target):
    tr = _trainable(state.params)
    loss, (sq, _render_out) = _loss_and_psnr(
        state.params, state.alive, gt, cfg, lambda_value, rows_target)
    grads = torch.autograd.grad(loss, list(tr.values()))
    return loss.detach(), sq, dict(zip(tr, grads))


def control_step(it: int, cfg: FrameConfig) -> bool:
    """Whether iteration `it` (1-based) is a control step, which runs
    eagerly: it == 1 and every densification_interval-th iteration in every
    mode (the binning-overflow check runs there; with --is_ad / --is_rm the
    mask is rebuilt and the moments reset)."""
    return it == 1 or it % cfg.densification_interval == 0


def _hits_threshold(it: int, cfg: FrameConfig) -> bool:
    """Whether step `it` is the control threshold, after which the rate is
    frozen and Adan's step restarts (the hit_threshold `_removal_control` /
    `_adaptive_control` return there)."""
    thresh = (DENSITY_ADD + DENSITY_REMOVE if cfg.isdensity
              else REMOVAL_THRESHOLD if cfg.isremoval else None)
    return it == thresh and it % cfg.densification_interval == 0


def plan_steps(it: int, limit: int, cfg: FrameConfig) -> list:
    """Steps it + 1 .. limit of a represent fit as runs [(first, count,
    eager)]: each control step (`control_step`) alone and eager, the plain
    steps between them one run (`utils.graphs.plan_runs`)."""
    return graphs.plan_runs(it, limit, lambda i: control_step(i, cfg))


def step_twins(opt: AdanState, it: int, limit: int, cfg: FrameConfig, device,
               grace: Optional[int] = None, lr_frozen: bool = False,
               threshold: Callable[[int], bool] = lambda i: False) -> graphs.Twins:
    """The device twins of the steps it + 1 .. limit: Adan's scalars of each
    (its step counter and the StepLR rate as the steps move them: frozen
    from the step where threshold(i) holds, where Adan's step restarts),
    Adan's fresh flag and, for a fit, the early-stop grace."""
    steps = []
    step, frozen = opt.step, lr_frozen
    for i in range(it + 1, limit + 1):
        hit = threshold(i)
        frozen = frozen or hit
        steps.append((step + 1, cfg.lr if frozen else step_lr(cfg.lr, i - 1)))
        step = 0 if hit else step + 1
    return graphs.make_twins(adan_table(steps, cfg.betas, device=device), opt.fresh,
                             grace, device)


def fit_twins(state: TrainState, limit: int, cfg: FrameConfig) -> graphs.Twins:
    """`step_twins` of the fit slice from state.it to `limit`."""
    return step_twins(state.opt, state.it, limit, cfg, state.alive.device, state.grace,
                      state.lr_frozen, lambda i: _hits_threshold(i, cfg))


def _assign_splats(dst: GaussianFrame, src: GaussianFrame) -> None:
    """Copy `src`'s splats into `dst`'s own parameter tensors."""
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        getattr(dst, name).copy_(getattr(src, name))


def intersection_budget(cfg: FrameConfig) -> int:
    """The intersection budget a fit with `cfg` bins into."""
    tbb = cfg.tile_bounds
    return (cfg.max_intersects if cfg.max_intersects is not None
            else default_max_intersects(cfg.max_num_points, tbb[0] * tbb[1]))


def make_train_step(cfg: FrameConfig, lambda_value: float = 0.0,
                    draws: Draws = None):
    """One reference train_iter: forward/loss/backward, splat control, Adan
    step, scheduler step, overflow check, early stopping.

    step(state, gt, rows_target=None, twins=None) writes the step into the
    state's own tensors and returns the state with its host fields moved on;
    `rows_target` (make_rows_target, made once per frame) runs the loss in
    tile-row space. `twins` (`fit_twins`, made once a fit slice) holds the
    device copies of the host values the step reads; without them the step
    makes its own for this one step."""
    mi = intersection_budget(cfg)

    def step(state: TrainState, gt: torch.Tensor, rows_target=None,
             twins: Optional[graphs.Twins] = None) -> TrainState:
        if twins is None:
            twins = fit_twins(state, state.it + 1, cfg)
        it = state.it + 1  # 1-based like the reference loop
        loss, sq, grads = _loss_and_grads(state, gt, cfg, lambda_value, rows_target)
        psnr = _psnr(cfg, sq)

        params, alive, opt = state.params, state.alive, state.opt
        rebuilt = hit_threshold = False
        with torch.no_grad():
            if control_step(it, cfg):
                new = None
                if cfg.isdensity:
                    new = _adaptive_control(params, alive, draws, it, cfg)
                elif cfg.isremoval and it % cfg.densification_interval == 0:
                    new = _removal_control(params, alive, it, cfg)
                if new is not None:
                    new_params, new_alive, rebuilt, hit_threshold = new
                    if new_params is not params:
                        _assign_splats(params, new_params)
                    alive.copy_(new_alive)
                # binning budget overflow, on the control-step parameters (a
                # silent overflow drops the highest-index splats and their grads)
                nth = project_gaussians_2d(
                    params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
                    cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive)[4]
                state.max_overflow.copy_(
                    torch.maximum(state.max_overflow, budget_overflow(nth, mi)))

            # scheduler-detach quirk: after update_optimizer lr stays at base
            # (folded into the twins' table, `fit_twins`)
            lr_frozen = state.lr_frozen or hit_threshold
            if rebuilt:
                # rebuilt parameters have no grads in the reference: the
                # update is skipped, moments restart, the step still counts
                opt = adan_reset_moments_(opt, twins.fresh)
                opt = dataclasses.replace(opt, step=opt.step + 1)
            else:
                opt = adan_step_(_trainable(params), grads, opt, twins.scalars,
                                 twins.fresh, betas=cfg.betas, eps=cfg.eps)
            if hit_threshold:
                opt = dataclasses.replace(opt, step=0)
            twins.row.add_(1)

            # early stopping (EarlyStopping, utils.py:188-211), on the device
            improved = state.best_loss - loss > cfg.early_stop_min_delta
            take = improved | torch.isinf(state.best_loss)
            patience = torch.where(take, 0, state.patience + 1).to(torch.int32)
            twins.grace.sub_(1)
            stop = (patience >= cfg.early_stop_patience) & (twins.grace < 0)
            state.best_loss.copy_(torch.where(take, loss, state.best_loss))
            for dst, src in ((state.patience, patience), (state.stop, stop),
                             (state.loss, loss), (state.psnr, psnr)):
                dst.copy_(src)

        return dataclasses.replace(state, opt=opt, it=it, lr_frozen=lr_frozen,
                                   grace=state.grace - 1)

    return step


def _after_plain(state: TrainState, grace: bool = True) -> TrainState:
    """The host fields after a plain step (no control): the iteration, Adan's
    step and, for a fit step, the grace move on."""
    return dataclasses.replace(state, it=state.it + 1, opt=adan_host_step(state.opt),
                               grace=state.grace - 1 if grace else state.grace)


def fit_frame(state: TrainState, gt: torch.Tensor, cfg: FrameConfig,
              lambda_value: float = 0.0, draws: Draws = None,
              graph: Optional[bool] = None) -> FitResult:
    """Run the per-frame optimisation to cfg.iterations or early stop.

    Stops at exactly the iteration where gsvc_tpu's while_loop stops. The
    patience grows by at most one a step, so after reading it as p the
    stop cannot come within the next patience - p steps: the device is
    read about once per early_stop_patience steps, not every step.
    gt: [H, W, 3] float32 in [0, 1]. `graph`: see `fit_frame_partial`.
    """
    state = fit_frame_partial(state, gt, cfg.iterations, cfg, lambda_value, draws, graph)
    return FitResult(state=state, image=render_frame(state.params, state.alive, cfg))


def _rows_target_for(gt: torch.Tensor, cfg: FrameConfig):
    return make_rows_target(gt, cfg) if _use_rows_loss(cfg, gt.device) else None


def fit_plan(state: TrainState, gt: torch.Tensor, limit: int, cfg: FrameConfig,
             lambda_value: float = 0.0, draws: Draws = None) -> graphs.FitPlan:
    """The fit slice from state.it to `limit`: its runs (`plan_steps`), its
    step on the slice's twins and rows target, and the host fields after a
    plain step."""
    step = make_train_step(cfg, lambda_value, draws)
    rows_target = _rows_target_for(gt, cfg)
    twins = fit_twins(state, limit, cfg)
    return graphs.FitPlan(plan_steps(state.it, limit, cfg),
                          lambda s: step(s, gt, rows_target, twins), _after_plain)


def fit_frame_partial(state: TrainState, gt: torch.Tensor, limit: int,
                      cfg: FrameConfig, lambda_value: float = 0.0,
                      draws: Draws = None, graph: Optional[bool] = None) -> TrainState:
    """Resumable slice of `fit_frame`: the same steps up to iteration
    min(limit, cfg.iterations) or the early stop. Chained slices with one
    `draws` generator equal one `fit_frame` bitwise, early stop included
    (the stop rule reads only the state).

    graph None (the default) runs the plain steps as CUDA-graph replays on
    a CUDA device (`utils.graphs.StepGraph`) and eagerly on the CPU; False
    runs every step eagerly, with the same bits; True on the CPU raises."""
    lim = min(int(limit), cfg.iterations)
    if bool(state.stop) or state.it >= lim:
        return state
    next_check = state.it

    def stop(s: TrainState) -> bool:
        nonlocal next_check
        if s.grace < 0 and s.it >= next_check:
            p = int(s.patience)
            next_check = s.it + cfg.early_stop_patience - p
            return p >= cfg.early_stop_patience
        return False

    plan = fit_plan(state, gt, lim, cfg, lambda_value, draws)
    return graphs.run_fit(state, plan, gt.device, graph, stop)


def fit_frame_trace(state: TrainState, gt: torch.Tensor, cfg: FrameConfig,
                    lambda_value: float = 0.0, trace_every: int = 1,
                    draws: Draws = None):
    """The reference `train_iter_trace` loop (GaussianSplats_Represent.py:
    175-188): cfg.iterations steps with no early stop and the loss lambda
    fixed to 0, keeping the render from the PRE-update parameters of
    iterations trace_every, 2*trace_every, ... (gsvc_tpu's
    `fit_frame_trace`; `lambda_value` is accepted and ignored there too).
    Every step runs eagerly.

    Returns (final state, images [iterations // trace_every, H, W, 3])."""
    del lambda_value
    plan = fit_plan(state, gt, state.it + cfg.iterations, cfg, 0.0, draws)
    images = []
    for i in range(cfg.iterations):
        if (i + 1) % trace_every == 0:
            images.append(render_frame(state.params, state.alive, cfg))
        state = plan.step(state)
    if not images:
        return state, gt.new_zeros((0, cfg.H, cfg.W, 3))
    return state, torch.stack(images)


def pre_train_plan(state: TrainState, gt: torch.Tensor, cfg: FrameConfig,
                   lambda_value: float = 0.7) -> graphs.FitPlan:
    """The pre-train's cfg.iterations steps from state.it: one run of plain
    steps (no control, no early stop), the StepLR rate unfrozen."""
    rows_target = _rows_target_for(gt, cfg)
    first, limit = state.it, state.it + cfg.iterations
    twins = step_twins(state.opt, first, limit, cfg, state.alive.device)

    def step(state: TrainState) -> TrainState:
        loss, sq, grads = _loss_and_grads(state, gt, cfg, lambda_value, rows_target)
        with torch.no_grad():
            opt = adan_step_(_trainable(state.params), grads, state.opt,
                             twins.scalars, twins.fresh, betas=cfg.betas, eps=cfg.eps)
            twins.row.add_(1)
            state.loss.copy_(loss)
            state.psnr.copy_(_psnr(cfg, sq))
        return dataclasses.replace(state, opt=opt, it=state.it + 1)

    return graphs.FitPlan(graphs.plan_runs(first, limit, lambda i: False), step,
                          lambda s: _after_plain(s, grace=False))


def pre_train_frame(state: TrainState, gt: torch.Tensor, cfg: FrameConfig,
                    lambda_value: float = 0.7, graph: Optional[bool] = None) -> FitResult:
    """The pre_train loop (no control, no early stop): the K-frame
    detection pass (SimpleTrainer2d.pre_train, train_video_Represent.py:117-133).
    `graph` as in `fit_frame_partial`."""
    plan = pre_train_plan(state, gt, cfg, lambda_value)
    state = graphs.run_fit(state, plan, gt.device, graph)
    return FitResult(state=state,
                     image=render_frame(state.params, state.alive, cfg))

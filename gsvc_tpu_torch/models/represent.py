"""Per-frame representation model and its training loop (PyTorch port of
gsvc_tpu/models/represent.py): `render_frame(_pos/_rows)`, the train step
`make_train_step`, `fit_frame` (and its resumable slice
`fit_frame_partial`), `fit_frame_trace` and `pre_train_frame`.

One step is the reference train_iter (GaussianSplats_Represent.py:191-207):
render, loss, backward (autograd; on the "cuda" backend the L1 / L2 loss
is E1, one pass from K4's rows to their gradient, and the rasterizer's
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

With a `TileShard`, a step renders only its rank's span of tile rows and
all-reduces the loss, the squared error and the per-splat gradients over
the shard's process group (parallel/sharded.py runs it); such a step runs
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import GaussianFrame, cholesky_bound, init_splats
from gsvc_tpu_torch.ops.binning import budget_overflow, default_max_intersects, key_attrs
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import (
    image_to_rows,
    rasterize_gaussians_sum_clipped,
    rasterize_rows_loss,
)
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
from gsvc_tpu_torch.utils.profiling import RECORDER

Draws = Union[None, torch.Generator, Callable[[int], tuple]]


@dataclasses.dataclass(frozen=True)
class TileShard:
    """Image-space sharding context of a train step (gsvc_tpu's `TileShard`).

    This rank is tile shard `index` of `num_shards` over the process group
    `group` (torch.distributed; None: the default group): it renders tile
    rows [index * rows_per, (index + 1) * rows_per) (`shard_tile_rows`) of
    the frame against its slice of the target, and its loss, squared error
    and per-splat gradients are its span's alone. `all_reduce` sums them
    over the group after backward, outside autograd (the collective
    counterpart of the reference backward's atomicAdd into shared
    per-splat slots, backward.cu:843-858); a collective inside the
    differentiated function would count the gradient once a rank, which
    Adan's scale invariance would all but hide. Everything else (splat
    control, early stopping, Adan, the draws) is replicated: every reduced
    value holds the same bits on every rank (gloo's ring), so the ranks'
    states stay bitwise equal."""

    num_shards: int
    index: int = 0
    group: object = None

    def all_reduce(self, *tensors: torch.Tensor) -> list:
        """The tensors summed over the group: one all_reduce of their
        concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out


def shard_rows_per(cfg: FrameConfig, num_shards: int) -> int:
    """Tile rows a shard: ceil, so every shard is equal-sized. When
    num_shards does not divide the grid's rows (68 at 1920x1080 over 3
    shards), the last shard's span reaches past the grid: the rasterizer
    renders those rows empty and the loss masks them (`shard_valid_h`)."""
    tb_y = cfg.tile_bounds[1]
    if num_shards > tb_y:
        raise ValueError(f"{num_shards} tile shards > {tb_y} tile rows at H={cfg.H}")
    return -(-tb_y // num_shards)


def shard_padded_height(cfg: FrameConfig, num_shards: int) -> int:
    """Pixel rows the sharded target is zero-padded to, so that it splits
    into equal whole-tile-row slices (1080 -> 1088 over 2 or 4 shards)."""
    return shard_rows_per(cfg, num_shards) * num_shards * cfg.block_h


def shard_tile_rows(cfg: FrameConfig, shard: TileShard) -> tuple:
    """(row0, rows_per) of the shard's tile-row span."""
    rows_per = shard_rows_per(cfg, shard.num_shards)
    return shard.index * rows_per, rows_per


def shard_valid_h(cfg: FrameConfig, shard: TileShard, row0: int):
    """Valid pixel rows at the top of the shard's target slice (<= 0: none),
    or None where the shards cover exactly cfg.H rows (no masking)."""
    if shard_padded_height(cfg, shard.num_shards) == cfg.H:
        return None
    return cfg.H - row0 * cfg.block_h


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
    `init_splats`. A `represent.init` span (`utils.profiling.RECORDER`)."""
    with RECORDER("represent.init", device=device, splats=cfg.num_points):
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


def _splats(params: GaussianFrame, alive, cfg: FrameConfig, rgb_w_trainable=True):
    """The rasterizer's splat arguments (xys, depths, radii, conics,
    num_tiles_hit, colors, opacity) of model.forward()
    (GaussianSplats_Represent.py:83-90: opacity ones, colours premultiplied
    by rgb_W)."""
    colors = params.get_features if rgb_w_trainable else params.features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    opacity = torch.ones((params.capacity, 1), dtype=torch.float32,
                         device=xys.device)
    return xys, depths, radii, conics, nth, colors, opacity


def _render(params: GaussianFrame, alive, cfg: FrameConfig, layout="image",
            rgb_w_trainable=True, tile_rows=None) -> torch.Tensor:
    """The differentiable model.forward(): render + clip to [0, 1] (the clip
    outside the rasterizer; an eval render's in K4 / K5's store);
    `tile_rows` as in `render_frame`."""
    return rasterize_gaussians_sum_clipped(
        *_splats(params, alive, cfg, rgb_w_trainable),
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects, layout=layout,
        tile_rows=tile_rows,
    )


@torch.no_grad()
def render_frame(
    params: GaussianFrame, alive: torch.Tensor, cfg: FrameConfig,
    rgb_w_trainable: bool = True, layout: str = "image", tile_rows=None,
) -> torch.Tensor:
    """model.forward(): [H, W, 3] ("image"), planar [3, H, W] ("chw") or
    the tile-row blocks of `image_to_rows` ("rows"). tile_rows=(row0,
    num_rows) renders only that span of the grid's tile rows (image
    sharding, parallel/sharded.py; `ops.rasterize_gaussians_sum`)."""
    return _render(params, alive, cfg, layout, rgb_w_trainable, tile_rows)


@torch.no_grad()
def render_frame_rows(params: GaussianFrame, alive: torch.Tensor,
                      cfg: FrameConfig, tile_rows=None) -> torch.Tensor:
    """model.forward() in the tile-row block layout (the clip commutes with
    the tiling, so tile-space clip is exact)."""
    return _render(params, alive, cfg, "rows", tile_rows=tile_rows)


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
    return rasterize_gaussians_sum_clipped(
        xys, depths, radii, conics, nth, ones, ones[:, :1],
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
    )


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
                   rows_target=None, shard: Optional[TileShard] = None):
    """(loss, sq_sum): the differentiable loss, and the sum of squared error
    the caller turns into PSNR (detached). With `rows_target` the render,
    its clip and the loss run in the rasterizer's tile-row layout through
    E1 (`ops.rasterize.rasterize_rows_loss`), which writes no clipped
    render.

    With `shard`, gt (and rows_target) are the shard's slice of the padded
    target, and loss and sq_sum the shard's local terms: the caller reduces
    them outside autograd (`TileShard`). Sharding takes the pointwise
    losses (L2, L1): the structural ones need windows across shards."""
    if shard is not None and cfg.loss_type not in ("L2", "L1"):
        raise ValueError(f"tile-sharded training takes pointwise losses, got "
                         f"{cfg.loss_type!r}")
    denom = cfg.H * cfg.W * 3
    tile_rows = None if shard is None else shard_tile_rows(cfg, shard)
    if rows_target is not None:
        gt_rows, mask = rows_target  # mask zeroes tile-padding pixels
        loss, sq = rasterize_rows_loss(
            *_splats(params, alive, cfg), cfg.H, cfg.W, gt_rows, mask, cfg.block_h,
            cfg.block_w, loss_type=cfg.loss_type, backend=cfg.backend,
            max_intersects=cfg.max_intersects, tile_rows=tile_rows)
        return loss / denom, sq
    img = _render(params, alive, cfg, tile_rows=tile_rows)
    if shard is not None:
        diff = img - gt
        valid_h = shard_valid_h(cfg, shard, tile_rows[0])
        if valid_h is not None:  # the padding rows of a ragged height
            ridx = torch.arange(img.shape[0], device=img.device)[:, None, None]
            diff = torch.where(ridx < valid_h, diff, 0.0)
        sq = torch.sum(diff * diff)
        loss = sq if cfg.loss_type == "L2" else torch.sum(torch.abs(diff))
        return loss / denom, sq.detach()
    loss = loss_fn(img.permute(2, 0, 1), gt.permute(2, 0, 1), cfg.loss_type,
                   lambda_value=lambda_value)
    sq = torch.sum((img.detach() - gt) ** 2)
    return loss, sq


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
                    rows_target, shard: Optional[TileShard] = None):
    """(loss, sq_sum, grads) of the step; with `shard`, summed over its
    ranks after backward."""
    tr = _trainable(state.params)
    loss, sq = _loss_and_psnr(
        state.params, state.alive, gt, cfg, lambda_value, rows_target, shard)
    grads = torch.autograd.grad(loss, list(tr.values()))
    loss = loss.detach()
    if shard is not None:
        loss, sq, *grads = shard.all_reduce(loss, sq, *grads)
    return loss, sq, dict(zip(tr, grads))


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
                    draws: Draws = None, shard: Optional[TileShard] = None):
    """One reference train_iter: forward/loss/backward, splat control, Adan
    step, scheduler step, overflow check, early stopping.

    step(state, gt, rows_target=None, twins=None) writes the step into the
    state's own tensors and returns the state with its host fields moved on;
    `rows_target` (make_rows_target, made once per frame) runs the loss in
    tile-row space. `twins` (`fit_twins`, made once a fit slice) holds the
    device copies of the host values the step reads; without them the step
    makes its own for this one step. With `shard` it is the same step on
    the rank's tile-row span: gt and rows_target are the shard's slice
    (`parallel.sharded.shard_target`), and the loss, squared error and
    gradients are all-reduced before the control and Adan (`TileShard`)."""
    mi = intersection_budget(cfg)

    def step(state: TrainState, gt: torch.Tensor, rows_target=None,
             twins: Optional[graphs.Twins] = None) -> TrainState:
        if twins is None:
            twins = fit_twins(state, state.it + 1, cfg)
        it = state.it + 1  # 1-based like the reference loop
        loss, sq, grads = _loss_and_grads(state, gt, cfg, lambda_value, rows_target,
                                          shard)
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
                opt = adan_step_(_trainable(params), grads, opt, twins.table, twins.row,
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
    The final render is a `represent.render` span.
    """
    state = fit_frame_partial(state, gt, cfg.iterations, cfg, lambda_value, draws, graph)
    with RECORDER("represent.render", device=gt.device, splats=cfg.num_points):
        image = render_frame(state.params, state.alive, cfg)
    return FitResult(state=state, image=image)


def _rows_target_for(gt: torch.Tensor, cfg: FrameConfig,
                     shard: Optional[TileShard] = None):
    """The rows loss's target on the kernel path (None elsewhere); with
    `shard`, of the shard's target slice, its padding rows masked."""
    if not _use_rows_loss(cfg, gt.device):
        return None
    valid_h = None if shard is None else shard_valid_h(
        cfg, shard, shard_tile_rows(cfg, shard)[0])
    return make_rows_target(gt, cfg, valid_h)


def fit_plan(state: TrainState, gt: torch.Tensor, limit: int, cfg: FrameConfig,
             lambda_value: float = 0.0, draws: Draws = None,
             shard: Optional[TileShard] = None) -> graphs.FitPlan:
    """The fit slice from state.it to `limit`: its runs (`plan_steps`), its
    step on the slice's twins and rows target, and the host fields after a
    plain step. With `shard`, gt is the shard's target slice."""
    step = make_train_step(cfg, lambda_value, draws, shard)
    rows_target = _rows_target_for(gt, cfg, shard)
    twins = fit_twins(state, limit, cfg)
    return graphs.FitPlan(plan_steps(state.it, limit, cfg),
                          lambda s: step(s, gt, rows_target, twins), _after_plain)


def fit_frame_partial(state: TrainState, gt: torch.Tensor, limit: int,
                      cfg: FrameConfig, lambda_value: float = 0.0,
                      draws: Draws = None, graph: Optional[bool] = None,
                      shard: Optional[TileShard] = None) -> TrainState:
    """Resumable slice of `fit_frame`: the same steps up to iteration
    min(limit, cfg.iterations) or the early stop. Chained slices with one
    `draws` generator equal one `fit_frame` bitwise, early stop included
    (the stop rule reads only the state).

    graph None (the default) runs the plain steps as CUDA-graph replays on
    a CUDA device (`utils.graphs.StepGraph`) and eagerly on the CPU; False
    runs every step eagerly, with the same bits; True on the CPU raises.
    With `shard` (gt the shard's target slice) every step runs eagerly: a
    gloo collective cannot be captured in a CUDA graph, so graph=True
    raises."""
    graph = _sharded_graph(graph, shard)
    lim = min(int(limit), cfg.iterations)
    if bool(state.stop) or state.it >= lim:
        return state
    next_check = state.it

    def stop(s: TrainState, read) -> bool:
        nonlocal next_check
        if s.grace < 0 and s.it >= next_check:
            p = read(lambda: int(s.patience))
            next_check = s.it + cfg.early_stop_patience - p
            return p >= cfg.early_stop_patience
        return False

    plan = fit_plan(state, gt, lim, cfg, lambda_value, draws, shard)
    return graphs.run_fit(state, plan, gt.device, graph, stop, kind="represent",
                          **fit_attrs(cfg, state.alive.shape[0]))


def fit_attrs(cfg: FrameConfig, capacity: int) -> dict:
    """A fit's `fit` span attributes (`utils.graphs.run_fit`): the config's
    iterations and num_points as splats, and its binning keys' layout at
    the config's grid and the state's `capacity` of splat rows
    (`binning.key_attrs`)."""
    return {"iterations": cfg.iterations, "splats": cfg.num_points,
            **key_attrs(cfg.tile_bounds, capacity)}


def _sharded_graph(graph: Optional[bool], shard) -> Optional[bool]:
    """A fit's `graph` argument: unchanged unsharded; eager (False) for a
    sharded fit, where graph=True raises."""
    if shard is None:
        return graph
    if graph:
        raise ValueError("a sharded fit runs eagerly: its all_reduce (gloo) cannot be "
                         "captured in a CUDA graph")
    return False


def fit_frame_trace(state: TrainState, gt: torch.Tensor, cfg: FrameConfig,
                    lambda_value: float = 0.0, trace_every: int = 1,
                    draws: Draws = None, graph: Optional[bool] = None):
    """The reference `train_iter_trace` loop (GaussianSplats_Represent.py:
    175-188): cfg.iterations steps with no early stop and the loss lambda
    fixed to 0, keeping the render from the PRE-update parameters of
    iterations trace_every, 2*trace_every, ... (gsvc_tpu's
    `fit_frame_trace`, two nested `lax.scan`s; `lambda_value` is accepted
    and ignored there too).

    `graph` as in `fit_frame_partial`: on a card (None) the plain steps
    replay one `utils.graphs.StepGraph` and the traced renders one
    `RenderGraph`, whose inputs (the splats and the mask) are copied in
    from the state before each replay, so a control step that rebuilds
    them is seen; False runs every step and render eagerly, with the same
    bits; True on the CPU raises.

    Returns (final state, images [iterations // trace_every, H, W, 3])."""
    del lambda_value
    plan = fit_plan(state, gt, state.it + cfg.iterations, cfg, 0.0, draws)
    images = gt.new_empty((cfg.iterations // trace_every, cfg.H, cfg.W, 3))

    def splats(s: TrainState) -> tuple:
        p = s.params
        return p.xyz, p.cholesky, p.features_dc, p.rgb_w, s.alive

    with torch.no_grad():
        frame = GaussianFrame(*(t.detach().clone() for t in splats(state)[:4]))
        frame.requires_grad_(False)
        alive = state.alive.clone()
    inputs = (frame.xyz, frame.cholesky, frame.features_dc, frame.rgb_w, alive)
    with graphs.render_graph(lambda *_: render_frame(frame, alive, cfg), inputs,
                             gt.device, graph) as traced:
        @torch.no_grad()
        def trace(s: TrainState, k: int) -> None:  # before the fit's step k (0-based)
            if (k + 1) % trace_every == 0:
                traced.load(*splats(s))
                images[(k + 1) // trace_every - 1].copy_(traced())

        state = graphs.run_fit(state, plan, gt.device, graph, before=trace, kind="trace",
                               **fit_attrs(cfg, state.alive.shape[0]))
    return state, images


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
                             twins.table, twins.row, twins.fresh, betas=cfg.betas,
                             eps=cfg.eps)
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
    state = graphs.run_fit(state, plan, gt.device, graph, kind="pretrain",
                           **fit_attrs(cfg, state.alive.shape[0]))
    return FitResult(state=state,
                     image=render_frame(state.params, state.alive, cfg))

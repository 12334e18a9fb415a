"""Quantization-aware compression model and its QAT loop (PyTorch port of
gsvc_tpu/models/compress.py, the reference GaussianSplats_Compress.py):

- `CompressParams` / `forward_quantize`: GaussianVideo_frame with the
  quantizers in the loop (:11-98): fp16 straight-through means, the learned
  6-bit uniform-quantized cholesky, residual-VQ colours.
- delta mode: GaussianVideo_delta (:102-193), trainable deltas on top of
  the previous frame's frozen p_xyz / p_cholesky / p_features_dc.
- `fit_compress`: the QAT loop of train_video_Compress.SimpleTrainer2d.train
  (:83-116): Adan + StepLR, the best-PSNR snapshot kept every iteration
  (:91-93) and reloaded at the end, no early stopping.

On the kernel path (backend "cuda", or "auto" on a CUDA device) a step
renders through the kernels' autograd function with the L2 loss in the
tile-row layout: K1 and K2 bin, K4 `rows` renders, E1 blends, clips and
takes the loss and its gradient in one pass, K6 and K3 take the gradient
back to the splats. The best snapshot is chosen on the device
with torch.where, so a step never waits for the host; the iteration
counter is a host int.

A step writes its results into the state's own tensors with `copy_` and
reads Adan's step scalars and fresh flag from device twins
(`utils.graphs.Twins`), so on a CUDA device `fit_compress` runs each plain
step as a replay of one captured CUDA graph (gsvc_tpu's `lax.scan` inside
the jitted fit); the first step of an un-initialised VQ, which runs
k-means from `draws`, runs eagerly (`plan_steps`). `graph=False` runs every
step eagerly, with the same bits. The fit updates the given state's
tensors in place.

Bit accounting runs on the host after training (`measure_bits`): fp16
means (16 * N * 2 bits), rANS-coded cholesky codes + f32 scale / beta
(quantize.py:72-80), the VQ codebook + rANS-coded stage indices
(quantize.py:116-140); bpp = total bits / (H * W).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch.compress.entropy import (
    compress_matrix_flatten_categorical,
    get_np_size,
)
from gsvc_tpu_torch.compress.quantizers import (
    UniformQuantParams,
    VQDraws,
    VQState,
    fake_quantize_half,
    residual_vq_forward,
    residual_vq_init,
    uniform_quantize,
    uniform_quantizer_init,
)
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import cholesky_bound
from gsvc_tpu_torch.models.represent import (
    TileShard,
    _rows_target_for,
    _sharded_graph,
    fit_attrs,
    shard_tile_rows,
    shard_valid_h,
    step_twins,
)
from gsvc_tpu_torch.ops.binning import budget_overflow, default_max_intersects
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum_clipped, rasterize_rows_loss
from gsvc_tpu_torch.optim.adan import AdanState, adan_host_step, adan_init, adan_step_
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.profiling import RECORDER, _sync

CHOL_BITS = 6  # UniformQuantizer(bits=6), GaussianSplats_Compress.py:37


@dataclasses.dataclass
class CompressParams:
    """Trainable tensors of the compress-stage model (+ quantizer params)."""

    xyz: torch.Tensor  # [N,2] (delta mode: the delta)
    cholesky: torch.Tensor  # [N,3]
    features_dc: torch.Tensor  # [N,3]
    q_scale: torch.Tensor  # [3] uniform-quantizer scale
    q_beta: torch.Tensor  # [3] uniform-quantizer offset


def _p2d(p: CompressParams) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@dataclasses.dataclass
class CompressState:
    params: CompressParams
    vq: VQState
    opt: AdanState
    it: int  # iterations completed
    best_psnr: torch.Tensor  # [] f32
    best_params: CompressParams
    best_vq: VQState
    loss: torch.Tensor  # [] f32 last loss
    psnr: torch.Tensor  # [] f32 last psnr
    # delta-mode frozen buffers (zeros in frame mode)
    p_xyz: torch.Tensor
    p_cholesky: torch.Tensor
    p_features_dc: torch.Tensor


def init_compress_state(gmodel: dict, p_gmodel: Optional[dict] = None,
                        device="cpu") -> CompressState:
    """Build from representation checkpoints ({"_xyz", "_cholesky",
    "_features_dc"} numpy dicts).

    Frame mode (K-frames): parameters straight from gmodel
    (train_video_Compress.py:74-80). Delta mode (P-frames): trainable
    params = gmodel - p_gmodel, frozen buffers = p_gmodel (:51-72). A
    `qat.init` span (`utils.profiling.RECORDER`)."""
    with RECORDER("qat.init", device=device, splats=int(np.shape(gmodel["_xyz"])[0])):
        def t(a):  # a copy: the fit updates the parameters in place
            return torch.tensor(np.asarray(a, np.float32), device=device)

        xyz, chol, feat = t(gmodel["_xyz"]), t(gmodel["_cholesky"]), t(gmodel["_features_dc"])
        if p_gmodel is not None:
            if p_gmodel["_xyz"].shape != gmodel["_xyz"].shape:
                # the reference's delta model needs one splat count per GOP; a
                # represent run shorter than its control threshold (4000 its
                # with --is_rm, 1000 with --is_ad) can leave K- and P-frames
                # with different counts
                raise ValueError(
                    f"delta mode: the frame has {gmodel['_xyz'].shape[0]} splats, "
                    f"the previous frame {p_gmodel['_xyz'].shape[0]}")
            p_xyz, p_chol, p_feat = (t(p_gmodel[k])
                                     for k in ("_xyz", "_cholesky", "_features_dc"))
            xyz, chol, feat = xyz - p_xyz, chol - p_chol, feat - p_feat
        else:
            p_xyz, p_chol, p_feat = (torch.zeros_like(a) for a in (xyz, chol, feat))
        uq = uniform_quantizer_init(3, CHOL_BITS, device=device)
        params = CompressParams(xyz=xyz, cholesky=chol, features_dc=feat,
                                q_scale=uq.scale, q_beta=uq.beta)

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        # the fit updates params in place, so the snapshot starts as a copy
        best_params = CompressParams(**{k: v.clone() for k, v in _p2d(params).items()})
        return CompressState(
            params=params, vq=residual_vq_init(2, 8, 3, device), opt=adan_init(_p2d(params)),
            it=0, best_psnr=scalar(float("-inf")), best_params=best_params,
            best_vq=residual_vq_init(2, 8, 3, device), loss=scalar(float("inf")),
            psnr=scalar(0.0), p_xyz=p_xyz, p_cholesky=p_chol, p_features_dc=p_feat,
        )


def _quantized_geometry(params: CompressParams, p_xyz, p_cholesky):
    """(means [N,2], cholesky + bound [N,3], cholesky codes [N,3])."""
    means = torch.tanh(fake_quantize_half(params.xyz) + p_xyz)
    uq = UniformQuantParams(scale=params.q_scale, beta=params.q_beta)
    chol_deq, chol_codes = uniform_quantize(params.cholesky, uq, CHOL_BITS)
    chol = chol_deq + cholesky_bound(chol_deq.device) + p_cholesky
    return means, chol, chol_codes


def forward_quantize(
    params: CompressParams,
    vq: VQState,
    p_xyz: torch.Tensor,
    p_cholesky: torch.Tensor,
    p_features_dc: torch.Tensor,
    cfg: FrameConfig,
    training: bool,
    layout: str = "image",
    tile_rows=None,
    draws: VQDraws = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Quantize-aware render. Returns (img, vq_loss, chol_codes, new_vq).

    Frame mode (p_* all zeros) mirrors GaussianSplats_Compress.py:71-84,
    delta mode :165-179. layout "rows" renders the tile-row blocks of
    `image_to_rows`, "chw" the planar [3, H, W]; tile_rows=(row0, num_rows)
    only that span of tile rows (image sharding, parallel/sharded.py).
    `draws` picks the k-means rows of a training forward on an
    un-initialised VQ."""
    splats, l_vqc, chol_codes, new_vq = _quantized_splats(
        params, vq, p_xyz, p_cholesky, p_features_dc, cfg, training, draws)
    img = rasterize_gaussians_sum_clipped(
        *splats, cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects, layout=layout,
        tile_rows=tile_rows,
    )
    return img, l_vqc, chol_codes, new_vq


def _quantized_splats(params: CompressParams, vq: VQState, p_xyz, p_cholesky, p_features_dc,
                      cfg: FrameConfig, training: bool, draws: VQDraws = None):
    """(the rasterizer's splat arguments, vq_loss, chol_codes, new_vq) of
    `forward_quantize`."""
    means, chol, chol_codes = _quantized_geometry(params, p_xyz, p_cholesky)
    colors, _idx, l_vqc, new_vq = residual_vq_forward(
        params.features_dc, vq, training, draws=draws)
    colors = colors + p_features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        means, chol, cfg.H, cfg.W, cfg.tile_bounds, cfg.block_w, cfg.block_h)
    opacity = torch.ones((means.shape[0], 1), dtype=torch.float32, device=means.device)
    return (xys, depths, radii, conics, nth, colors, opacity), l_vqc, chol_codes, new_vq


@torch.no_grad()
def compress_overflow(state: CompressState, cfg: FrameConfig) -> torch.Tensor:
    """Binning budget overflow of the fitted quantized model ([] int32), on
    the eval-mode quantized geometry measure_bits renders."""
    means, chol, _codes = _quantized_geometry(state.params, state.p_xyz,
                                              state.p_cholesky)
    nth = project_gaussians_2d(means, chol, cfg.H, cfg.W, cfg.tile_bounds,
                               cfg.block_w, cfg.block_h)[4]
    num_tiles = cfg.tile_bounds[0] * cfg.tile_bounds[1]
    mi = (cfg.max_intersects if cfg.max_intersects is not None
          else default_max_intersects(means.shape[0], num_tiles))
    return budget_overflow(nth, mi)


def _assign(dst, src, where: Optional[torch.Tensor] = None) -> None:
    """dst <- src, or torch.where(where, src, dst), field by field in dst's
    own tensors (dataclasses of tensors; host fields untouched)."""
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if isinstance(d, torch.Tensor):
            v = getattr(src, f.name)
            d.copy_(v if where is None else torch.where(where, v, d))


def _loss_and_grads(state: CompressState, gt: torch.Tensor, cfg: FrameConfig,
                    rows_target=None, draws: VQDraws = None,
                    shard: Optional[TileShard] = None):
    """One training forward and backward: (recon, vq_loss, grads keyed like
    CompressParams, new_vq); recon and vq_loss detached.

    With `shard`, gt (and rows_target) are the shard's target slice: the
    rank differentiates its share recon_local + vq_loss / num_shards (the
    shares sum to the loss; the VQ term, the same on every rank, would
    otherwise count once a rank), then recon and the gradients are summed
    over the ranks (gsvc_tpu/models/compress.py:224-268)."""
    tr = {k: v.detach().requires_grad_() for k, v in _p2d(state.params).items()}
    tile_rows = None if shard is None else shard_tile_rows(cfg, shard)
    model = (CompressParams(**tr), state.vq, state.p_xyz, state.p_cholesky,
             state.p_features_dc, cfg)
    if rows_target is None:
        img, vq_loss, _codes, new_vq = forward_quantize(
            *model, training=True, tile_rows=tile_rows, draws=draws)
        diff = img - gt
        valid_h = None if shard is None else shard_valid_h(cfg, shard, tile_rows[0])
        if valid_h is not None:  # the padding rows of a ragged height
            ridx = torch.arange(diff.shape[0], device=diff.device)[:, None, None]
            diff = torch.where(ridx < valid_h, diff, 0.0)
        sq = torch.sum(diff * diff)
    else:  # render, clip and L2 in one pass of E1
        splats, vq_loss, _codes, new_vq = _quantized_splats(*model, training=True,
                                                            draws=draws)
        gt_rows, mask = rows_target  # mask zeroes tile-padding pixels
        sq, _sq = rasterize_rows_loss(
            *splats, cfg.H, cfg.W, gt_rows, mask, cfg.block_h, cfg.block_w,
            backend=cfg.backend, max_intersects=cfg.max_intersects, tile_rows=tile_rows)
    recon = sq / (cfg.H * cfg.W * 3)
    shards = 1 if shard is None else shard.num_shards
    grads = torch.autograd.grad(recon + vq_loss / shards, list(tr.values()))
    recon = recon.detach()
    if shard is not None:
        recon, *grads = shard.all_reduce(recon, *grads)
    return recon, vq_loss.detach(), dict(zip(tr, grads)), new_vq


def make_train_step_quantize(cfg: FrameConfig, shard: Optional[TileShard] = None,
                             draws: VQDraws = None):
    """train_iter_quantize (GaussianSplats_Compress.py:86-98): loss =
    L2(recon) + vq_loss; Adan step; StepLR; best-PSNR snapshot.

    step(state, gt, rows_target=None, twins=None) writes the step into the
    state's own tensors and returns the state with its host fields moved
    on; with `rows_target` (models.represent.make_rows_target) the L2 runs
    in the rasterizer's tile-row layout. `twins` (`represent.step_twins`,
    made once a fit slice) holds the device copies of the host values the
    step reads; without them the step makes its own for this one step.
    `draws` picks the k-means rows of the first step (see
    compress.quantizers). With `shard` (models.represent.TileShard) the
    step renders the rank's tile-row span against gt / rows_target, the
    shard's target slice, and sums the recon term and the gradients over
    the ranks (`_loss_and_grads`); the VQ codebook's EMA update depends on
    the replicated features alone and stays replicated."""

    def step(state: CompressState, gt: torch.Tensor, rows_target=None,
             twins: Optional[graphs.Twins] = None) -> CompressState:
        if twins is None:
            twins = step_twins(state.opt, state.it, state.it + 1, cfg, state.psnr.device)
        recon, vq_loss, grads, new_vq = _loss_and_grads(state, gt, cfg, rows_target, draws,
                                                        shard)
        with torch.no_grad():
            psnr = 10.0 * torch.log10(1.0 / torch.clamp(recon, min=1e-20))
            opt = adan_step_(_p2d(state.params), grads, state.opt, twins.table, twins.row,
                             twins.fresh, betas=cfg.betas, eps=cfg.eps)
            twins.row.add_(1)
            improved = psnr > state.best_psnr
            state.best_psnr.copy_(torch.maximum(psnr, state.best_psnr))
            _assign(state.best_params, state.params, improved)
            _assign(state.best_vq, new_vq, improved)
            _assign(state.vq, new_vq)
            state.loss.copy_(recon + vq_loss)
            state.psnr.copy_(psnr)
        # initted (host) is True from the first training step on
        return dataclasses.replace(
            state, opt=opt, it=state.it + 1,
            vq=dataclasses.replace(state.vq, initted=new_vq.initted),
            best_vq=dataclasses.replace(state.best_vq, initted=new_vq.initted))

    return step


def plan_steps(it: int, limit: int, initted: bool) -> list:
    """Steps it + 1 .. limit of a QAT fit as runs [(first, count, eager)]:
    the first step of an un-initialised VQ (k-means from `draws`, and the
    host flag `initted` flips) alone and eager, the rest one run."""
    return graphs.plan_runs(it, limit, lambda i: i == it + 1 and not initted)


def _after_plain(state: CompressState) -> CompressState:
    """The host fields after a replayed QAT step: the iteration and Adan's
    step move on."""
    return dataclasses.replace(state, it=state.it + 1, opt=adan_host_step(state.opt))


def qat_plan(state: CompressState, gt: torch.Tensor, cfg: FrameConfig,
             draws: VQDraws = None, shard: Optional[TileShard] = None) -> graphs.FitPlan:
    """The QAT slice of cfg.iterations steps from state.it: its runs, its
    step on the slice's twins and rows target, the host fields after a
    plain step. With `shard`, gt is the shard's target slice."""
    step = make_train_step_quantize(cfg, shard, draws)
    rows_target = _rows_target_for(gt, cfg, shard)
    limit = state.it + cfg.iterations
    twins = step_twins(state.opt, state.it, limit, cfg, state.psnr.device)
    return graphs.FitPlan(plan_steps(state.it, limit, state.vq.initted),
                          lambda s: step(s, gt, rows_target, twins), _after_plain)


def _reload_best(state: CompressState) -> CompressState:
    """Load the best snapshot (train_video_Compress.py:102)."""
    return dataclasses.replace(state, params=state.best_params, vq=state.best_vq)


def fit_compress(state: CompressState, gt: torch.Tensor, cfg: FrameConfig,
                 reload_best: bool = True, draws: VQDraws = None,
                 graph: Optional[bool] = None,
                 shard: Optional[TileShard] = None) -> CompressState:
    """cfg.iterations QAT steps, then the best-PSNR snapshot
    (train_video_Compress.py:89-102). reload_best=False leaves the last
    state, so the fit can be resumed (`fit_compress_chunked`). graph None
    (the default) runs the plain steps as CUDA-graph replays on a CUDA
    device and eagerly on the CPU; False runs every step eagerly, with the
    same bits; True on the CPU raises. With `shard` (gt the shard's target
    slice) every step runs eagerly and graph=True raises."""
    graph = _sharded_graph(graph, shard)
    state = graphs.run_fit(state, qat_plan(state, gt, cfg, draws, shard), gt.device,
                           graph, kind="qat", **fit_attrs(cfg, state.params.xyz.shape[0]))
    return _reload_best(state) if reload_best else state


def fit_compress_chunked(state: CompressState, gt: torch.Tensor, cfg: FrameConfig,
                         chunk: int, draws: VQDraws = None,
                         graph: Optional[bool] = None) -> CompressState:
    """fit_compress in slices of at most `chunk` iterations, synced between
    slices; the same trajectory, the best snapshot reloaded once at the end."""
    done = 0
    while done < cfg.iterations:
        n = min(chunk, cfg.iterations - done)
        state = fit_compress(state, gt, dataclasses.replace(cfg, iterations=n),
                             reload_best=False, draws=draws, graph=graph)
        _sync(state.loss)
        done += n
    return _reload_best(state)


def _coded_bits(symbols: torch.Tensor) -> int:
    """Bytes * 8 of the rANS stream of `symbols` with its counts and
    unique-value tables (quantize.py:72-80)."""
    comp, counts, unique = compress_matrix_flatten_categorical(
        symbols.cpu().numpy().flatten())
    return get_np_size(comp) * 8 + get_np_size(counts) * 8 + get_np_size(unique) * 8


@torch.no_grad()
def measure_bits(state: CompressState, cfg: FrameConfig) -> Tuple[dict, torch.Tensor]:
    """Eval-mode bit accounting + the reconstructed image ([H, W, 3]).

    Returns ({"m_bit", "s_bit", "r_bit", "c_bit", "bpp"}, image). A
    `qat.bits` span (`utils.profiling.RECORDER`)."""
    with RECORDER("qat.bits", device=state.loss.device, splats=state.params.xyz.shape[0],
                  iterations=cfg.iterations):
        p = state.params
        n = p.xyz.shape[0]
        img, _l, chol_codes, _vq = forward_quantize(
            p, state.vq, state.p_xyz, state.p_cholesky, state.p_features_dc, cfg,
            training=False)
        m_bit = 16 * n * 2  # fp16 means (GaussianSplats_Compress.py:72)
        s_bit = _coded_bits(chol_codes) + p.q_scale.numel() * 32 + p.q_beta.numel() * 32
        _colors, idx, _loss, _ = residual_vq_forward(p.features_dc, state.vq, False)
        c_bit = state.vq.embed.numel() * 32 + _coded_bits(idx)
        r_bit = 0
        bpp = (m_bit + s_bit + r_bit + c_bit) / cfg.H / cfg.W
        return ({"m_bit": m_bit, "s_bit": s_bit, "r_bit": r_bit, "c_bit": c_bit,
                 "bpp": bpp}, img)

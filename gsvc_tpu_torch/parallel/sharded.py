"""Image-space (tile-row) sharding of the frame fits over torch.distributed
ranks (PyTorch port of gsvc_tpu/parallel/sharded.py).

gsvc_tpu runs its fits under `shard_map` over a ("frame", "tile") device
mesh. Here each rank is a process (`parallel.launch`, gloo), and a `Mesh`
is the rank's place in that grid as process groups:

- tile axis: the frame's tile rows are split over the n_tile ranks of a
  frame index. Every rank holds the whole splat set, projects and bins
  the whole frame (global binning, so K1, K2 and the sort run unchanged),
  renders only its span of `shard_rows_per` tile rows (K4 `rows` / K5,
  their `tile_rows`) against its slice of the zero-padded target, and
  takes K6 and K3 back over that span alone. The loss, the squared error
  and every per-splat gradient are then summed over the tile group with
  one all_reduce, after backward and outside autograd
  (`models.represent.TileShard`); the QAT step differentiates its share
  recon_local + vq_loss / n_tile.
- frame axis: ranks of different frame indices step different blocks of
  frames (`frame_block`), with no collective between them.

Replicated state: every tensor of a TrainState / CompressState (splats,
mask, Adan's moments, early-stop fields, VQ codebook, best snapshot) and
every host field (it, grace, Adan's step). Each rank takes the same
control steps, revive and k-means draws (seed each rank's generator
alike), early stop and overflow flag, because each reads only replicated
or all-reduced values, and gloo's ring gives every rank the same bits of
a sum: the ranks' states stay bitwise equal. They are not bitwise equal to
an unsharded fit: each rank reduces its lanes with K3 and the ranks' sums
are then added, another order than one K3 over all lanes.

A partial span's image rows at or past cfg.H hold 0 in the port (gsvc_tpu
renders splat content there, in its last partial tile row); the target is
zero-padded there and the loss masks those rows (`shard_valid_h`), so the
fit is the same either way.

The fits run every step eagerly: a gloo collective cannot be captured in a
CUDA graph. The eager steps launch the same kernels as the graphs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.models.represent import (
    Draws,
    FitResult,
    TileShard,
    TrainState,
    _rows_target_for,
    fit_frame_partial,
    make_train_step,
    render_frame,
    shard_padded_height,
    shard_tile_rows,
)
from gsvc_tpu_torch.utils.profiling import tensors


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_frame x n_tile grid of ranks (rank =
    frame * n_tile + tile of the default group), and its tile group: the
    n_tile ranks of its frame index (None: the default group)."""

    n_frame: int
    n_tile: int
    frame: int
    tile: int
    group: object = None

    @property
    def shard(self) -> TileShard:
        """The train steps' sharding context."""
        return TileShard(self.n_tile, self.tile, self.group)


def shard_frames_mesh(n_frame: int, n_tile: int) -> Mesh:
    """The 2D frame-parallel x tile-parallel mesh over the first n_frame *
    n_tile ranks of the default group. Every rank of the group must call it
    (it makes the n_frame tile groups); a rank past the mesh raises."""
    world, rank = dist.get_world_size(), dist.get_rank()
    size = n_frame * n_tile
    if n_frame < 1 or n_tile < 1 or size > world:
        raise ValueError(f"a {n_frame} x {n_tile} mesh over {world} ranks")
    if size == world and n_frame == 1:
        groups = [None]  # the tile group is the default group
    else:
        groups = [dist.new_group(list(range(f * n_tile, (f + 1) * n_tile)))
                  for f in range(n_frame)]
    if rank >= size:
        raise ValueError(f"rank {rank} is past the {n_frame} x {n_tile} mesh")
    return Mesh(n_frame, n_tile, rank // n_tile, rank % n_tile, groups[rank // n_tile])


def tile_mesh(n_tile: int) -> Mesh:
    """The 1D tile-parallel mesh (the CLIs' --tile_shards path)."""
    return shard_frames_mesh(1, n_tile)


def frame_block(mesh: Mesh, num_frames: int) -> range:
    """The frames (0-based) this rank's frame index steps: an equal block a
    frame index, as shard_map splits the frame axis."""
    if num_frames % mesh.n_frame:
        raise ValueError(f"{num_frames} frames do not split over {mesh.n_frame} frame ranks")
    per = num_frames // mesh.n_frame
    return range(mesh.frame * per, (mesh.frame + 1) * per)


def _pad_gt_rows(gt: torch.Tensor, cfg: FrameConfig, n_tile: int) -> torch.Tensor:
    """Zero-pad the pixel-row axis (dim -3 of [..., H, W, 3]) to
    `shard_padded_height`, so the target splits into equal whole-tile-row
    slices at any height (1080 -> 1088 over 2 or 4 shards); the padding
    rows render empty and the loss masks them."""
    h_pad = shard_padded_height(cfg, n_tile)
    if gt.shape[-3] == h_pad:
        return gt
    # F.pad's list starts at the last dim: (3 channels, W, H)
    return torch.nn.functional.pad(gt, (0, 0, 0, 0, 0, h_pad - gt.shape[-3]))


def shard_target(gt: torch.Tensor, cfg: FrameConfig, shard: TileShard) -> torch.Tensor:
    """The shard's [rows_per * block_h, W, 3] slice of the padded [H, W, 3]
    target."""
    row0, rows_per = shard_tile_rows(cfg, shard)
    padded = _pad_gt_rows(gt, cfg, shard.num_shards)
    return padded[row0 * cfg.block_h:(row0 + rows_per) * cfg.block_h]


def make_sharded_train_step(mesh: Mesh, cfg: FrameConfig, lambda_value: float = 0.0,
                            draws: Draws = None):
    """The train step (`models.represent.make_train_step`: splat control,
    early-stop bookkeeping, StepLR and its detach quirk, the overflow
    check) over the mesh: step(states, gt) steps this rank's block of
    frames (`frame_block`): `states` their TrainStates, gt [F_block, H, W,
    3] their whole targets. Each frame renders the rank's tile-row span and
    all-reduces over the tile group. Returns the updated states (each
    written in place, as the unsharded step does)."""
    shard = mesh.shard
    step = make_train_step(cfg, lambda_value, draws, shard)

    def sharded(states: Sequence[TrainState], gt: torch.Tensor) -> List[TrainState]:
        if len(states) != gt.shape[0]:
            raise ValueError(f"{len(states)} states for {gt.shape[0]} targets")
        out = []
        for state, frame in zip(states, gt):
            target = shard_target(frame, cfg, shard)
            out.append(step(state, target, _rows_target_for(target, cfg, shard)))
        return out

    return sharded


def gather_rows(img: torch.Tensor, cfg: FrameConfig, shard: TileShard) -> torch.Tensor:
    """The padded [shard_padded_height, W, 3] image from each rank's span
    image: every rank places its span in a zero buffer and one all_reduce
    sums them (gloo's all_gather takes no CUDA tensors; x + 0 is exact)."""
    row0, rows_per = shard_tile_rows(cfg, shard)
    full = img.new_zeros((shard_padded_height(cfg, shard.num_shards), *img.shape[1:]))
    full[row0 * cfg.block_h:row0 * cfg.block_h + img.shape[0]] = img
    dist.all_reduce(full, group=shard.group)
    return full


def fit_frame_sharded(state: TrainState, gt: torch.Tensor, cfg: FrameConfig, mesh: Mesh,
                      lambda_value: float = 0.0, draws: Draws = None,
                      graph: Optional[bool] = None) -> FitResult:
    """`models.represent.fit_frame` with the frame's tile rows split over the
    mesh's tile group: the same steps to cfg.iterations or the early stop,
    every step eager (graph None means eager here; True raises). `state`
    is replicated (each rank's own, equal ones) and gt the whole [H, W, 3]
    target. Returns this rank's final state, bitwise rank 0's, and the
    image assembled from the ranks' spans, [H, W, 3]."""
    shard = mesh.shard
    state = fit_frame_partial(state, shard_target(gt, cfg, shard), cfg.iterations, cfg,
                              lambda_value, draws, graph, shard)
    span = render_frame(state.params, state.alive, cfg, tile_rows=shard_tile_rows(cfg, shard))
    return FitResult(state=state, image=gather_rows(span, cfg, shard)[:cfg.H])


def fit_compress_sharded(state, gt: torch.Tensor, cfg: FrameConfig, mesh: Mesh,
                         draws=None, graph: Optional[bool] = None):
    """`models.compress.fit_compress` (QAT and the best-PSNR snapshot,
    reloaded at the end) with the tile rows split over the mesh's tile
    group; every step eager. The VQ codebook's EMA path stays replicated
    (it reads only the replicated features); the recon term and the
    gradients are summed over the ranks."""
    from gsvc_tpu_torch.models.compress import fit_compress

    shard = mesh.shard
    return fit_compress(state, shard_target(gt, cfg, shard), cfg, draws=draws, graph=graph,
                        shard=shard)


def replicate_to_mesh(mesh: Mesh, tree):
    """Every tensor of `tree` (a tensor, or a tuple, list, dict or
    dataclass of them) overwritten in place with rank 0's, over the
    default group (gloo broadcasts CUDA tensors too). Returns the tree."""
    del mesh  # every rank of the mesh is in the default group
    for t in tensors(tree):
        dist.broadcast(t, 0)
    return tree


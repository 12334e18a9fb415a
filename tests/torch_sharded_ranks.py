"""The rank side of tests/test_torch_sharded.py: functions that
`gsvc_tpu_torch.parallel.launch` runs in each spawned gloo rank on the CPU.

This module imports the port only (no JAX), so a spawned rank starts fast.
Inputs arrive as numpy trees and results leave as numpy trees (`to_numpy`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import compress_state_from_numpy, train_state_from_numpy
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.parallel import sharded


def to_numpy(tree):
    """A tensor / dataclass / dict / list tree with numpy leaves (host
    ints, bools and floats kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, torch.nn.Module):  # GaussianFrame: its parameters
        return {k: to_numpy(v) for k, v in tree.named_parameters()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree


class Draws:
    """Revive draws fixed in advance: (u_xyz, u_chol, u_feat) for n slots."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __call__(self, n):
        return tuple(a[:n] for a in self.arrays)


class KMeansDraws:
    """k-means rows fixed in advance: the first k of a permutation a stage."""

    def __init__(self, perms):
        self.perms = perms

    def __call__(self, stage, n, k):
        return torch.tensor(np.asarray(self.perms[stage][:k]))


def _steps(job, mesh):
    """The state after the job's sharded steps, and the all-reduced loss,
    squared error and gradients of its first step (as the step takes
    them)."""
    cfg = FrameConfig(**job["cfg"])
    shard = mesh.shard
    step = sharded.make_sharded_train_step(mesh, cfg, draws=job.get("draws"))
    gt = torch.from_numpy(job["gt"])
    state = train_state_from_numpy(job["state"])
    target = sharded.shard_target(gt, cfg, shard)
    loss, sq, grads = rep._loss_and_grads(state, target, cfg, 0.0,
                                          rep._rows_target_for(target, cfg, shard), shard)
    first = {"loss": loss, "sq": sq, "grads": grads}
    states = [state]
    for _ in range(job["steps"]):
        states = step(states, gt[None])
    return {"state": to_numpy(states[0]), "first": to_numpy(first)}


def _frames(job, _mesh):
    mesh = sharded.shard_frames_mesh(job["n_frame"], job["n_tile"])
    cfg = FrameConfig(**job["cfg"])
    block = sharded.frame_block(mesh, len(job["states"]))
    step = sharded.make_sharded_train_step(mesh, cfg)
    states = [train_state_from_numpy(job["states"][f]) for f in block]
    states = step(states, torch.from_numpy(job["gt"][block.start:block.stop]))
    return {"frames": list(block), "mesh": (mesh.frame, mesh.tile),
            "states": to_numpy(states)}


def _fit(job, mesh):
    cfg = FrameConfig(**job["cfg"])
    res = sharded.fit_frame_sharded(train_state_from_numpy(job["state"]),
                                    torch.from_numpy(job["gt"]), cfg, mesh)
    return {"state": to_numpy(res.state), "image": to_numpy(res.image)}


def _qat(job, mesh):
    cfg = FrameConfig(**job["cfg"])
    gt = torch.from_numpy(job["gt"])
    draws = KMeansDraws(job["perms"])
    shard = mesh.shard
    state = compress_state_from_numpy(job["state"])
    target = sharded.shard_target(gt, cfg, shard)
    _recon, _vq, grads, _new_vq = comp._loss_and_grads(
        state, target, cfg, rep._rows_target_for(target, cfg, shard), draws, shard)
    fitted = sharded.fit_compress_sharded(compress_state_from_numpy(job["state"]), gt, cfg,
                                          mesh, draws=draws)
    return {"grads": to_numpy(grads), "state": to_numpy(fitted)}


def _replicate(job, mesh):
    rank = dist.get_rank()
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.arange(4) * (rank + 1)]}
    return to_numpy(sharded.replicate_to_mesh(mesh, tree))


JOBS = {"steps": _steps, "frames": _frames, "fit": _fit, "qat": _qat,
        "replicate": _replicate}


def run_jobs(rank, world_size, jobs):
    """Each job of `jobs` ({"kind": ..., ...}) on this rank, over the tile
    mesh of every rank (a "frames" job makes its own 2D mesh); the results
    in order."""
    torch.set_num_threads(1)
    mesh = sharded.tile_mesh(world_size)
    return [JOBS[job["kind"]](job, mesh) for job in jobs]


def fail_on_rank(rank, world_size, bad):
    """Rank `bad` raises while the others wait in an all_reduce with it."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


def sleep_between_collectives(rank, world_size, seconds):
    """An all_reduce, `seconds` of work on every rank, another all_reduce."""
    x = torch.ones(1)
    dist.all_reduce(x)
    time.sleep(seconds)
    dist.all_reduce(x)
    return float(x)

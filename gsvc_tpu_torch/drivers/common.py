"""CLI policy shared by the represent and compress drivers and the decoder:
the device a run asked for, the refusal of the unported multi-host mode,
the tile-sharded ranks of `--tile_shards N`, the per-frame random
generator and the representation checkpoint reader."""

from __future__ import annotations

import os

import numpy as np
import torch

from gsvc_tpu_torch.parallel.launch import launch
from gsvc_tpu_torch.parallel.multihost import NOT_PORTED


def resolve_device(name: str) -> torch.device:
    """The torch device of `--device`; a CUDA device must exist (there is no
    CPU fallback for a run that asked for the card)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but no CUDA device is available (use --device cpu)"
        )
    return device


def check_single_host(args) -> None:
    """Refuse the multi-host mode, which is not ported: it must never run
    silently on one host."""
    hosts = args.hosts if args.hosts > 1 else int(os.environ.get("GSVC_NUM_PROCS", "1"))
    if hosts > 1:
        raise NotImplementedError(f"--hosts {hosts} {NOT_PORTED}")


def launch_ranks(rank_main, args, *rank_args) -> int:
    """`--tile_shards N` > 1: run the CLI as N ranks (`parallel.launch`:
    spawned processes in one gloo group), each rank_main(rank, N,
    *rank_args) the same driver on the same frames with its fits
    tile-sharded (`parallel.sharded`), rank 0 alone writing. Prints how
    the ranks map onto the cards first. A failed rank fails the run
    (RankFailed). The run has no deadline (a default run fits for hours);
    a rank that hangs ends it through the collective timeout of the
    others (`parallel.launch`)."""
    n = args.tile_shards
    device = resolve_device(args.device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        where = f"{min(n, cards)} card{'s' if min(n, cards) > 1 else ''}"
    else:
        where = "the CPU"
    print(f"--tile_shards {n}: {n} ranks on {where} (gloo); rank 0 writes", flush=True)
    launch(rank_main, n, rank_args)
    return 0


def frame_generator(seed: int, frame_num: int) -> torch.Generator:
    """The host generator of frame `frame_num`'s random draws."""
    return torch.Generator().manual_seed(seed * 100003 + frame_num)


def load_gmodels(path: str) -> dict:
    """Load the representation checkpoint ({'frame_{n}/_xyz': ...} npz)
    into {frame_n: gmodel_dict} of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            frame, name = key.split("/", 1)
            out.setdefault(frame, {})[name] = data[key]
    return out

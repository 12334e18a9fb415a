"""CLI policy shared by the represent and compress drivers and the decoder:
the device a run asked for, the hosts of a multi-host run (`--hosts N`),
the tile-sharded ranks of `--tile_shards N`, the per-frame random
generator and the representation checkpoint reader."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from gsvc_tpu_torch.parallel import multihost
from gsvc_tpu_torch.parallel.launch import launch


def resolve_device(name: str) -> torch.device:
    """The torch device of `--device`; a CUDA device must exist (there is no
    CPU fallback for a run that asked for the card)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but no CUDA device is available (use --device cpu)"
        )
    return device


class Hosts(NamedTuple):
    """A run's hosts: their number, this host's id, and the suffix of this
    host's shard files ("" on one host)."""

    n: int
    host_id: int

    @property
    def multi(self) -> bool:
        return self.n > 1

    @property
    def suffix(self) -> str:
        return f".host{self.host_id}" if self.multi else ""


SINGLE_HOST = Hosts(1, 0)


@contextlib.contextmanager
def hosts_of(args) -> Iterator[Hosts]:
    """The hosts of a CLI run, as gsvc_tpu's drivers resolve them: `--hosts`
    or else GSVC_NUM_PROCS; `--host_id` or else the torch.distributed rank
    or else GSVC_PROC_ID. The gloo group of `multihost.initialize` (when
    GSVC_COORDINATOR is set) lives for the block. `--hosts > 1` with
    `--tile_shards > 1` raises ValueError before any group is made."""
    n = args.hosts if args.hosts > 1 else int(os.environ.get("GSVC_NUM_PROCS", "1"))
    if n > 1 and args.tile_shards > 1:
        raise ValueError(
            f"--hosts {n} with --tile_shards {args.tile_shards}: a multi-host run fits "
            "each frame in one process (gsvc_tpu's tile mesh spans every host's "
            "devices while the hosts fit different GOPs, so it has no such mode)")
    dist = multihost.initialize()
    try:
        if args.host_id >= 0:
            host_id = args.host_id
        elif dist:
            host_id = torch.distributed.get_rank()
        else:
            host_id = int(os.environ.get("GSVC_PROC_ID", "0"))
        yield Hosts(n, host_id)
    finally:
        if dist:
            torch.distributed.destroy_process_group()


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

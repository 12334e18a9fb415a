"""Start the ranks of a torch.distributed program on one host.

`launch(fn, world_size, args)` runs fn(rank, world_size, *args) in
`world_size` processes started with the `spawn` context, joined in one
process group that meets at a FileStore in a fresh temporary directory: no
TCP port, so launches that run at the same time cannot clash. It returns
the ranks' results (pickled; return CPU values) in rank order.

A rank that raises or dies ends the launch: the launch terminates the
other ranks (which may be waiting in a collective) and raises `RankFailed`
with that rank's traceback. A rank waits at most `collective_timeout`
seconds in the rendezvous or in one collective, then raises, so a rank that
hangs ends the launch too. The launch as a whole has no deadline unless the
caller gives one (`timeout`: a test, a smoke run): a CLI's fit may rightly
run for hours.

Backend: gloo, everywhere. It is the one backend that runs several ranks on
one card (NCCL refuses two ranks on one device) and the one that runs on
the CPU; its all_reduce and broadcast take CUDA tensors. NCCL, for a host
with a card a rank, is a later item (ROADMAP Queue 2).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

BACKEND = "gloo"
COLLECTIVE_TIMEOUT = 1800.0  # seconds a rank waits in the rendezvous or one collective


class RankFailed(RuntimeError):
    """A rank of a launch raised or died."""


def rank_device(rank: int, device) -> torch.device:
    """Rank `rank`'s device, made current: cuda:{rank % device_count} when
    `device` is a CUDA device (several ranks may share a card), else
    `device` itself (the CPU only when the caller asks for it). A CPU rank
    runs one intra-op thread: ranks whose thread pools spin at their
    barriers while other ranks (or processes) hold the cores stall each
    other's collectives."""
    device = torch.device(device)
    if device.type != "cuda":
        torch.set_num_threads(1)
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA rank but no CUDA device is available")
    device = torch.device("cuda", rank % count)
    torch.cuda.set_device(device)
    return device


def _worker(fn: Callable, rank: int, world_size: int, tmp: str,
            collective_timeout: float, args: tuple) -> None:
    import torch.distributed as dist

    out = Path(tmp)
    try:
        dist.init_process_group(BACKEND, init_method=f"file://{out / 'store'}", rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=collective_timeout))
        result = fn(rank, world_size, *args)
        with open(out / f"result.{rank}", "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, then exit 1
        (out / f"error.{rank}").write_text(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)  # the other ranks may be blocked in a collective with this one


def launch(fn: Callable, world_size: int, args: Sequence = (),
           timeout: Optional[float] = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT) -> list:
    """fn(rank, world_size, *args) on `world_size` spawned gloo ranks; their
    results in rank order. `fn` and `args` must pickle (a module-level
    function). A launch still running after `timeout` seconds (None: no
    deadline) is terminated and raises TimeoutError."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gsvc_ranks_") as tmp:
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(fn, r, world_size, tmp, collective_timeout, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            pending = set(range(world_size))
            while pending:
                left = 1.0 if deadline is None else deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(pending)} of {world_size} still running "
                                       f"after {timeout} s")
                multiprocessing.connection.wait([procs[r].sentinel for r in pending],
                                                timeout=min(left, 1.0))
                for r in sorted(pending):
                    code = procs[r].exitcode
                    if code is None:
                        continue
                    pending.discard(r)
                    if code != 0:
                        err = Path(tmp, f"error.{r}")
                        why = err.read_text() if err.exists() else f"exit code {code}"
                        raise RankFailed(f"rank {r} of {world_size} failed:\n{why}")
            results = []
            for r in range(world_size):
                with open(Path(tmp, f"result.{r}"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()

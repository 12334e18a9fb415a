"""Device timing on the card (the port's twin of
gsvc_tpu/utils/profiling.py `device_loop_time`).

A chained loop x -> fn(x) timed with CUDA events: each iteration's input
depends on the previous output, so the device runs them in order, and the
events bracket device work rather than the host's enqueue.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_loop_time(
    fn: Callable,
    x0: torch.Tensor,
    reps: int = 100,
    outer: int = 3,
) -> float:
    """Mean device seconds per iteration of the chain x -> fn(x).

    `fn` must return a tensor like its input that depends on its work
    (fold the output in with `x + out.sum() * 0.0`). Fails without a card:
    a CPU timing is no device number.
    """
    if not x0.is_cuda:
        raise RuntimeError("device_loop_time needs a CUDA tensor")
    x = x0
    for _ in range(3):  # warm-up
        x = fn(x)
    torch.cuda.synchronize(x0.device)
    total = 0.0
    for _ in range(outer):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            x = fn(x)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) / 1e3
    return total / (reps * outer)

"""Device timing on the card (the port's twin of
gsvc_tpu/utils/profiling.py `_sync` and `device_loop_time`).

`_sync` is the barrier the drivers take before reading the host clock:
PyTorch enqueues CUDA work asynchronously, so a clock read without it
times the host's enqueue. `device_loop_time` times a chained loop
x -> fn(x) with CUDA events: each iteration's input depends on the
previous output, so the device runs them in order, and the events bracket
device work rather than the host's enqueue.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _sync(t: Optional[torch.Tensor]) -> None:
    """Wait for the device of `t` to finish its queued work (no-op on CPU
    tensors, whose ops run synchronously)."""
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


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

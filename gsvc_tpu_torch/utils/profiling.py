"""Device timing on the card (the port's twin of
gsvc_tpu/utils/profiling.py `_sync` and `device_loop_time`).

`_sync` is the barrier the drivers take before reading the host clock:
PyTorch enqueues CUDA work asynchronously, so a clock read without it
times the host's enqueue. `device_loop_time` times a chained loop
x -> fn(x) with CUDA events: each iteration's input depends on the
previous output, so the device runs them in order, and the events bracket
what the program pays, host enqueue included where it is the slower side.
`event_ms` times one call behind a spin kernel (device time of the call
alone); `device_busy_ms` sums the device-side events of torch.profiler
(what the device does, whatever the host costs); `roofline_ms` is the
least time an H100 could take for a given work.

Every timer fails without a card: a CPU timing is no device number.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
# limit): HBM3 bandwidth and float32 outside the tensor cores. A card set
# below 700 W (nvidia-smi power.limit) runs slower under load.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def _sync(t: Optional[torch.Tensor]) -> None:
    """Wait for the device of `t` to finish its queued work (no-op on CPU
    tensors, whose ops run synchronously)."""
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tensor, tuple, list, dict or dataclass tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = vars(tree)
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(
        tree, (tuple, list)) else ()
    for v in items:
        yield from tensors(v)


def _require_cuda(what: str, t: Optional[torch.Tensor] = None) -> None:
    if t is None:
        ok = torch.cuda.is_available()
    else:
        ok = t.is_cuda
    if not ok:
        raise RuntimeError(f"{what} needs a CUDA device: a CPU timing is no device number")


def device_loop_time(
    fn: Callable,
    x0,
    reps: int = 100,
    outer: int = 3,
) -> float:
    """Mean device seconds per iteration of the chain x -> fn(x).

    `x0` is a tensor or a tuple / list / dict / dataclass tree holding
    tensors (such as `(params, adan_state)`), and `fn` returns the same
    structure, depending on its work (fold outputs in with
    `x + out.sum() * 0.0`). Fails without a card.
    """
    _require_cuda("device_loop_time", next(tensors(x0), None))
    x = x0
    for _ in range(3):  # warm-up
        x = fn(x)
    torch.cuda.synchronize()
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


def event_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up.

    A spin kernel queued first keeps the card busy while the host enqueues
    the calls, so the events bracket device time rather than the host's
    launch rate (where enqueueing takes longer than the spin, as for the
    plain versions' thousands of launches, host time shows through).
    """
    _require_cuda("event_ms")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of device cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(fn: Callable[[], object], reps: int) -> Tuple[float, list]:
    """Run fn() reps times under torch.profiler: (device busy ms a call,
    the profiler's key_averages()).

    Busy sums the self time of device-side events only (kernels, copies,
    fills): a host op's device time is that of the kernels it launched,
    so adding host ops would count those kernels twice. The CUPTI trace
    of a session now and then comes back with no device records at all
    (seen on an H100 for one of many short sessions in a process, whose
    repeat recorded them), so an empty session is run again, up to three
    times in all, before this raises."""
    from torch.profiler import ProfilerActivity, profile

    _require_cuda("profile_device")
    for _attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = list(prof.key_averages())
        busy = sum(e.self_device_time_total for e in device_events(events)) / reps / 1e3
        if busy > 0:
            return busy, events
    raise RuntimeError("the profiler recorded no device time in three sessions")


def device_events(events) -> list:
    """The device-side entries of a key_averages() list."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def launches(events) -> int:
    """Kernel launches the host made in a key_averages() list."""
    return sum(e.count for e in events if e.key in _LAUNCH_KEYS)


def device_busy_ms(fn: Callable[[], object], reps: int) -> float:
    """Device busy milliseconds a call of fn(), from device-side profiler
    events only (`profile_device`)."""
    return profile_device(fn, reps)[0]


def roofline_ms(n_bytes: float, ops: float) -> Tuple[float, str]:
    """The least milliseconds an H100 SXM could take to move `n_bytes`
    through device memory and do `ops` float32 operations: the larger of
    the two times, and which of "bytes" or "operations" it is."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

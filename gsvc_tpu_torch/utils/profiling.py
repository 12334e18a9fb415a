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

Every device timer fails without a card: a CPU timing is no device
number. The driver-level helpers of gsvc_tpu's module, `trace` (a
torch.profiler Chrome trace in place of jax.profiler's), `time_fn` and
`StepTimer`, time on the host clock and run on either device, syncing a
CUDA result before they read the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
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


def _sync_tree(out) -> None:
    """Wait for the devices of the CUDA tensors in a result tree."""
    for t in tensors(out):
        _sync(t)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block (CPU ops, and
    the card's kernels where there is one) and write it into `log_dir` as
    a Chrome trace, `trace-<pid>-<ns>.json` (chrome://tracing, Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def time_fn(
    fn: Callable,
    *args,
    iters: int = 100,
    warmup: int = 2,
    block_every_call: bool = True,
) -> float:
    """Mean wall-clock seconds per call of fn(*args), after `warmup` calls.

    block_every_call=True syncs each call's output (torch.cuda.synchronize
    on its CUDA tensors), so a call's time includes its device work;
    False syncs once after the last call.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync_tree(out)
    t0 = time.perf_counter()
    if block_every_call:
        for _ in range(iters):
            _sync_tree(fn(*args))
    else:
        for _ in range(iters):
            out = fn(*args)
        _sync_tree(out)
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Per-phase wall-clock accumulator for driver-level observability.

    Usage:
        timer = StepTimer()
        with timer("fit"):   ...
        with timer("eval", sync=img):  ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync_tree(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {total:.3f}s over {n} calls"
                f" ({total / n * 1e3:.2f} ms/call)"
            )
        return "\n".join(lines)


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

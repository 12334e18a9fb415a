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

`StepTimer` is also the port's recorder of spans and counters, and
`RECORDER` its process-wide instance: the fits (`utils.graphs.run_fit`:
`fit`, `fit.eager`, `fit.warmup`, `graph.capture`, `fit.replays`,
`fit.sync`), the encoder's stages (`represent.init`, `represent.render`,
`qat.init`, `qat.bits`, `qat.encode`) and the decoder's (`decode.*`)
record into it, at the granularity of steps and stages, with device
seconds from timing events that it reads without a sync.
"""

from __future__ import annotations

import collections
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


class Span:
    """One span of the recorder (`StepTimer`).

    name; id; parent, the id of the span open around it (None at the top);
    root, the id of the outermost span open around it (its own at the
    top): the fit or library call that caused it; t0 / t1, host start and
    end in ns on CLOCK_REALTIME (`time.time_ns`), the clock of
    torch.profiler's events; attrs, a dict or None. On a CUDA device,
    device_s is the device seconds between the span's two events and
    device_t0 the seconds from its anchor's start event (the start event
    of the outermost span around it that recorded events) to its own, so
    spans of one root share an origin; both None until the events are
    read (`StepTimer.resolve`), and for ever where the span recorded
    none."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "attrs", "device_s",
                 "device_t0", "_events", "_anchor", "_rf")

    def __init__(self, name: str, sid: int, parent: Optional["Span"]):
        self.name, self.id = name, sid
        self.parent = None if parent is None else parent.id
        self.root = sid if parent is None else parent.root
        self.t0 = self.t1 = 0
        self.attrs: Optional[dict] = None
        self.device_s: Optional[float] = None
        self.device_t0: Optional[float] = None
        self._events = None  # (device index, start event, end event)
        self._anchor = None if parent is None else parent._anchor
        self._rf = None

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def seconds(self) -> float:
        """Device seconds where the span has them, else host seconds."""
        return self.host_s if self.device_s is None else self.device_s

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"host_s={self.host_s:.6f}, device_s={self.device_s}, attrs={self.attrs})")


class StepTimer:
    """Spans and counters: the port's one recorder (`RECORDER` is the
    process-wide instance its layers record into), and a per-phase
    wall-clock accumulator for driver-level observability.

    Usage:
        timer = StepTimer()
        with timer("fit"):   ...
        with timer("eval", sync=img):  ...
        print(timer.report())

    `timer(name, device=None, timed=False, **attrs)` records a span
    (`Span`): its host interval, its parent and root, and `attrs` (more
    may be added when it closes, `close(span, **attrs)`); `open` / `close`
    do the same for a span that outlives one block. The recorder is
    single-threaded: spans nest in the order they open and close. `totals`
    and `counts` sum each name's host seconds and spans.

    Where `device` is a CUDA device, the span records a timing event on
    the device's current stream at entry and another at exit (pooled), but
    none on a stream under capture, so none inside a graph. The events are
    read lazily (`resolve`, which the recorder runs itself now and then):
    only events that `query()` finds complete, so the recorder never
    synchronises the device. While a torch.profiler session is active a
    span is also a `record_function` range of its own name, so traces show
    the program's spans above the device's kernels, on one clock.

    Closed spans are kept in a ring of `capacity` (the oldest go first;
    `counters["spans.dropped"]` counts them). `counters` holds named
    process totals that code adds to (`add`): each kernel wrapper's
    launches, `launches.<wrapper>` (`_build.launch`), the binning's keys
    (`binning.*`) and the graph classes' captures, replays and capture
    seconds (`graph.*`); a graph's replay adds what its capture added to
    the others (`utils.graphs`). `enabled` False records no span, no event
    and no range (counters still count: their readers check the kernels
    and the graphs with them), but for a span opened `timed`, whose
    seconds its caller reads itself (the decoder's stages): that one is
    still timed, its events included, and is kept nowhere (id 0, no
    parent, not in the ring, the totals or a profiler trace). `RECORDER`
    starts enabled unless the environment sets GSVC_SPANS=0.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 clock: Callable[[], int] = time.time_ns):
        self.totals: dict = {}
        self.counts: dict = {}
        self.counters: dict = {}
        self.enabled = enabled
        self.clock = clock
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._pending: list = []  # closed spans whose events are unread
        self._pool: dict = {}  # device index -> free timing events
        self._stack: list = []  # the open spans, innermost last
        self._last_id = 0

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None, device=None, timed=False, **attrs):
        span = self.open(name, device, timed, **attrs)
        try:
            yield span
        finally:
            if sync is not None:
                _sync_tree(sync)
            self.close(span)

    def open(self, name: str, device=None, timed=False, **attrs) -> Optional[Span]:
        """Open a span inside the innermost open one (when disabled, None,
        or a span kept nowhere where `timed`)."""
        if not self.enabled:
            if not timed:
                return None
            span = Span(name, 0, None)
        else:
            self._last_id += 1
            span = Span(name, self._last_id, self._stack[-1] if self._stack else None)
        if attrs:
            span.attrs = attrs
        index = _cuda_index(device)
        if index is not None and not torch.cuda.is_current_stream_capturing():
            start = self._mark(index)
            if span._anchor is None:
                span._anchor = start
            span._events = (index, start, None)
        if span.id and torch.autograd._profiler_enabled():
            # record_function's light twin: a range ~0.2 us from the clock's reading, not ~3 us
            span._rf = torch._C._profiler._RecordFunctionFast(name)
            span._rf.__enter__()
        span.t0 = self.clock()
        if span.id:
            self._stack.append(span)
        return span

    def close(self, span: Optional[Span], **attrs) -> None:
        """Close `span` (and any span still open inside it), adding attrs."""
        if span is None:
            return
        if span.id:
            stack = self._stack
            while stack and stack[-1] is not span:
                self.close(stack[-1])
            if stack:
                stack.pop()
        if span._events is not None:
            index, start, _ = span._events
            if torch.cuda.is_current_stream_capturing():
                span._events = None
            else:
                span._events = (index, start, self._mark(index))
                self._pending.append(span)
        if span._rf is not None:  # the range ends, then the clock is read: as close as at entry
            span._rf.__exit__(None, None, None)
            span._rf = None
        span.t1 = self.clock()
        if attrs:
            span.attrs = {**(span.attrs or {}), **attrs}
        if not span.id:  # timed for its caller alone
            self.resolve()
            return
        dt = span.host_s
        self.totals[span.name] = self.totals.get(span.name, 0.0) + dt
        self.counts[span.name] = self.counts.get(span.name, 0) + 1
        if len(self._ring) == self._ring.maxlen:
            self.add("spans.dropped")
        self._ring.append(span)
        if span.parent is None or len(self._pending) >= 256:
            self.resolve()

    def _mark(self, index: int) -> torch.cuda.Event:
        """A timing event recorded on the current stream of device `index`."""
        pool = self._pool.setdefault(index, [])
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(index))
        return ev

    def resolve(self) -> None:
        """Read the events of the closed spans, in the order they closed, as
        far as they have completed (never waiting for the device), and
        pool them again. A span's anchor belongs to a span that closed
        after it, so it is pooled only once every span that refers to it
        has been read."""
        done = 0
        for span in self._pending:
            index, start, end = span._events
            anchor = span._anchor
            if not (end.query() and start.query() and anchor.query()):
                break
            span.device_s = start.elapsed_time(end) / 1e3
            span.device_t0 = anchor.elapsed_time(start) / 1e3
            span._events = span._anchor = None
            self._pool.setdefault(index, []).extend((start, end))
            done += 1
        del self._pending[:done]

    def spans(self, name: Optional[str] = None, after: int = 0) -> list:
        """The spans kept, in the order they closed (their events read as
        far as they have completed): those named `name`, with ids above
        `after` (`last_id` read before the work)."""
        self.resolve()
        return [s for s in self._ring
                if s.id > after and (name is None or s.name == name)]

    @property
    def last_id(self) -> int:
        """The id of the last span opened (0 before any): spans opened later
        have larger ids."""
        return self._last_id

    def add(self, counter: str, value=1) -> None:
        """Add `value` to a named counter."""
        self.counters[counter] = self.counters.get(counter, 0) + value

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {total:.3f}s over {n} calls"
                f" ({total / n * 1e3:.2f} ms/call)"
            )
        return "\n".join(lines)


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of `device` (its current device where it has
    no index), or None where it is no CUDA device."""
    if device is None:
        return None
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


RECORDER = StepTimer(enabled=os.environ.get("GSVC_SPANS", "1") != "0")


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

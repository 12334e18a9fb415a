"""A fit's plain steps as replays of one captured CUDA graph: the port's
counterpart of gsvc_tpu's fits, each one jitted `lax.while_loop` or
`lax.scan` that visits the host once a frame
(gsvc_tpu/models/represent.py:619-665, :710-741; models/compress.py:296-316).

A fit's step reads and writes a fixed set of tensors: the model state's own
tensors, which every step updates with `copy_`, and the device twins of the
host values it reads (`Twins`). So one capture of a plain step replays
every later plain step of the fit. The steps a graph cannot hold, the
control steps that rebuild the splat mask and the QAT step that runs
k-means, run eagerly, as before; `plan_runs` lays out which.

`StepGraph` runs the plain steps of one fit on a CUDA device: the first
WARMUP eagerly on a side stream (PyTorch's warm-up before capturing
autograd; they are real steps of the fit, not extra ones), the next one
captured and replayed, every later one a replay. A failed capture or replay
raises: nothing falls back to the eager loop. The code a graph holds counts
into the recorder's counters on the host (the kernels' launches,
`launches.<wrapper>`; the binning's keys), so a replay counts nothing by
itself: each replay adds what the capture added to every counter.
`runner(device, graph)` picks a `StepGraph` on a CUDA device unless
`graph` is False, else `Eager`, which runs every step as it comes.

The renders that gsvc_tpu jits once and calls frame after frame (the
decoder's render, one jitted function per FrameConfig kept by
`functools.lru_cache(maxsize=8)`, gsvc_tpu/compress/bitstream.py:184-216;
the represent driver's eval fps loop, gsvc_tpu/drivers/represent.py:206-215)
are `RenderGraph`s here: one no-grad capture of a render of fixed input
tensors, replayed after the frame's values are copied into them.
`RenderCache` keeps up to 8 of them by the render's shapes and code.
Within `eager()`, every fit and render runs eagerly, as with graph=False:
the comparison path the smoke test times and re-records against.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Hashable, NamedTuple, Optional, Sequence, TypeVar

import numpy as np
import torch

from gsvc_tpu_torch._build import LAUNCHES
from gsvc_tpu_torch.utils.profiling import RECORDER

T = TypeVar("T")
WARMUP = 3  # eager plain steps on a side stream before the capture


@functools.lru_cache(maxsize=None)
def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of `device` that every warm-up and capture runs
    on. PyTorch keeps a cuBLAS workspace (32 MiB on an H100) for each stream
    a matmul ran on until the process ends, so a new stream a graph would
    leave that much allocated once the graph is freed."""
    return torch.cuda.Stream(device)


class Twins(NamedTuple):
    """Device twins of the host values a fit's step reads (a graph would
    freeze a host value). The host keeps its own copy of each, and the step
    advances both.

    table [R, 5] float32: Adan's scalars of the fit's steps, a row a step
      in order (`optim.adan.adan_table`), which fold in the StepLR rate;
    row [] int64: the row of the next step (Adan reads it on the device);
    fresh [] bool: Adan re-seeds its previous gradient (`AdanState.fresh`);
    grace [] int32: the early-stop grace countdown (represent fits only).
    """

    table: torch.Tensor
    row: torch.Tensor
    fresh: torch.Tensor
    grace: Optional[torch.Tensor] = None


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of `a` on `device`. To a CUDA device it goes from pinned
    memory without a host sync; the caching host allocator holds the pinned
    block until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


def make_twins(table: np.ndarray, fresh: dict, grace: Optional[int], device) -> Twins:
    """Twins of a fit: `table` (`adan_table`), row 0, the host's Adan fresh
    flags (one value for every leaf, as the port and gsvc_tpu keep them) and
    its early-stop grace."""
    flags = set(fresh.values())
    if len(flags) != 1:
        raise ValueError(f"Adan's fresh flags differ between leaves: {fresh}")

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=device)

    return Twins(_to_device(np.asarray(table, np.float32), device),
                 scalar(0, torch.int64), scalar(flags.pop(), torch.bool),
                 None if grace is None else scalar(grace, torch.int32))


def plan_runs(it: int, limit: int, eager: Callable[[int], bool]) -> list:
    """Steps it + 1 .. limit (1-based iterations) as runs [(first, count,
    eager)]: each step for which eager(i) holds alone, the plain steps
    between them as one run."""
    runs = []
    i = it + 1
    while i <= limit:
        if eager(i):
            runs.append((i, 1, True))
            i += 1
            continue
        j = i
        while j < limit and not eager(j + 1):
            j += 1
        runs.append((i, j - i + 1, False))
        i = j + 1
    return runs


class FitPlan(NamedTuple):
    """A fit slice: `runs` (`plan_runs`), `step(state)` (one step on the
    fit's tensors and twins, eager or captured) and `after_plain(state)`
    (the host fields after a replayed plain step)."""

    runs: list
    step: Callable
    after_plain: Callable


def run_fit(state: T, plan: FitPlan, device, graph: Optional[bool],
            stop: Optional[Callable[[T], bool]] = None,
            before: Optional[Callable[[T, int], None]] = None,
            kind: str = "fit", **attrs) -> T:
    """The steps of `plan` from `state`: eager steps by plan.step, plain ones
    through `runner(device, graph)`; `stop(state, read)`, asked after each
    step, ends the fit early, reading device values only through
    `read(fn)` (the runner's `read`); `before(state, k)` runs before the
    fit's k-th step (0-based). The graph is freed when the fit returns.

    The fit is a `fit` span (`profiling.RECORDER`) with the attributes
    kind, first and last (the plan's first and last step), then the
    caller's `attrs` (the models' fits give the config's iterations and
    splats and their binning keys' layout, `models.represent.fit_attrs`),
    and, once it ends, its counts: eager steps, warmups, captures, replays
    and host reads (`read`). Inside it: a `fit.eager` span an eager step,
    the runner's `fit.warmup`, `graph.capture` and `fit.replays` spans, and
    `fit.sync` spans."""
    steps = [(i, eager) for first, count, eager in plan.runs
             for i in range(first, first + count)]
    attrs = {"kind": kind, "first": steps[0][0] if steps else None,
             "last": steps[-1][0] if steps else None, **attrs}
    eager_steps = 0
    with RECORDER("fit", device=device, **attrs) as span, runner(device, graph) as run:
        for k, (i, eager) in enumerate(steps):
            if before is not None:
                before(state, k)
            if eager:
                run.pause()
                with RECORDER("fit.eager", device=device, step=i):
                    state = plan.step(state)
                eager_steps += 1
            else:
                state = run(lambda s=state: plan.step(s), lambda s=state: plan.after_plain(s))
            if stop is not None and stop(state, run.read):
                break
        if span is not None:
            span.attrs.update(eager=eager_steps, warmups=run.warmed, captures=run.captured,
                              replays=run.replayed, reads=run.reads)
    return state


def launch_counts() -> dict:
    """{kernel wrapper name: launches} in this process, graph replays
    included: the recorder's `launches.<wrapper>` counters
    (`_build.launch`). A kernel that has not launched is absent: read it
    with `.get(name, 0)`, and the launches of a stretch of work as the
    difference of two views."""
    n = len(LAUNCHES)
    return {k[n:]: v for k, v in RECORDER.counters.items() if k.startswith(LAUNCHES)}


class Eager:
    """Runs each plain step as it comes (the CPU, or graph=False). A
    runner's counts of its fit: warm-up steps (`warmed`), captures,
    replays and host reads (`read`)."""

    warmed = captured = replayed = 0

    def __init__(self):
        self.reads = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, step: Callable[[], T], after_plain: Callable[[], T]) -> T:
        return step()

    def pause(self) -> None:
        """End the current run of replays (none here)."""

    def read(self, fn: Callable[[], T]) -> T:
        """fn(), a read of device values inside the fit (its stop rule's),
        as a `fit.sync` span: the fit's run of replays ends first, so its
        device time holds no wait for the host; the fit counts the read."""
        self.pause()
        self.reads += 1
        with RECORDER("fit.sync"):
            return fn()


class _Totals(type):
    """The graph classes' process totals, `captures`, `replays` and
    `capture_seconds`: views of the recorder's counters
    `graph.<kind>.captures`, `.replays` and `.capture_s`."""

    def _counter(suffix: str):
        def get(cls):
            return RECORDER.counters.get(f"graph.{cls.kind}.{suffix}", 0)

        def put(cls, value) -> None:
            RECORDER.counters[f"graph.{cls.kind}.{suffix}"] = value

        return property(get, put)

    captures = _counter("captures")
    replays = _counter("replays")
    capture_seconds = _counter("capture_s")
    del _counter


class StepGraph(Eager, metaclass=_Totals):
    """The plain steps of one fit as replays of one CUDA graph.

    A call `(step, after_plain)` takes one plain step: step() eagerly on a
    side stream for the first WARMUP calls, then step() captured and
    replayed (its result carries the host fields), then a replay and
    after_plain(). step() must read and write only tensors that outlive the
    graph. The totals over a process, like the kernels' launch counts:
    `captures`, `replays` and `capture_seconds` (host seconds a capture
    takes, the graph's instantiation included), the recorder's counters
    `graph.step.*`. Each warm-up step is a `fit.warmup` span; each run of
    consecutive replays a `fit.replays` span (attribute replays), which
    `pause()` ends."""

    kind = "step"

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.side: Optional[torch.cuda.Stream] = None
        self.warmed = 0
        self.captured = 0
        self.replayed = 0
        self.added: list = []
        self._run = None  # the open fit.replays span, the replays before it

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self, step: Callable[[], T], after_plain: Callable[[], T]) -> T:
        if self.graph is None:
            if self.warmed < WARMUP:
                self.warmed += 1
                return self._on_side(step)
            out = self._capture(step)
            self._replay_in_run()
            return out
        self._replay_in_run()
        return after_plain()

    def _replay_in_run(self) -> None:
        if self._run is None:
            self._run = (RECORDER.open("fit.replays", self.device), self.replayed)
        self.replay()
        self.replayed += 1

    def pause(self) -> None:
        """End the current run of replays: its `fit.replays` span closes."""
        if self._run is not None:
            span, before = self._run
            self._run = None
            RECORDER.close(span, replays=self.replayed - before)

    def _on_side(self, step: Callable[[], T]) -> T:
        if self.side is None:
            self.side = side_stream(self.device)
        with RECORDER("fit.warmup", device=self.device):
            main = torch.cuda.current_stream(self.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                out = step()
            main.wait_stream(self.side)
        return out

    def _capture(self, step: Callable[[], T]) -> T:
        self.graph, out, self.added = _capture(step, self.device, self.side, self.kind)
        self.captured += 1
        return out

    def replay(self) -> None:
        _replay(self.graph, self.added)
        RECORDER.add("graph.step.replays")

    def close(self) -> None:
        """Free the graph and its memory pool, once its replays have run
        (the pool's memory may then go to other streams)."""
        self.pause()
        if self.graph is not None:
            _free(self.graph, self.device)
            self.graph = None


def _capture(fn: Callable[[], T], device, stream, kind: str) -> tuple:
    """fn() captured into a new CUDA graph on `stream`: (the graph, fn's
    result, [(recorder counter, what the capture added to it)]). On the
    given stream, without `torch.cuda.graph`'s device sync and release of
    every cached block (which the next calls would allocate again); the
    graph's own memory pool holds what fn allocates. The capture ran
    nothing, so what it added to the counters, but the recorder's own
    `spans.*` and the graphs' `graph.*`, is taken back off: it belongs to
    each replay (`_replay`). A `graph.capture` span (attribute graph:
    `kind`); its host seconds, the graph's instantiation included, add to
    the recorder's `graph.<kind>.capture_s` and the capture to
    `graph.<kind>.captures`."""
    before = dict(RECORDER.counters)
    graph = torch.cuda.CUDAGraph()
    with RECORDER("graph.capture", device=device, graph=kind):
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn()
            finally:
                graph.capture_end()
        main.wait_stream(stream)
        RECORDER.add(f"graph.{kind}.capture_s", time.perf_counter() - t0)
    RECORDER.add(f"graph.{kind}.captures")
    counters = RECORDER.counters
    added = []
    for k, v in list(counters.items()):
        if k.startswith(("spans.", "graph.")) or v == before.get(k, 0):
            continue
        added.append((k, v - before.get(k, 0)))
        if k in before:
            counters[k] = before[k]
        else:
            del counters[k]
    return graph, out, added


def _replay(graph: torch.cuda.CUDAGraph, added: list) -> None:
    """Replay `graph` on the current stream and add to the recorder's
    counters what its capture added."""
    graph.replay()
    counters = RECORDER.counters
    for k, n in added:
        counters[k] = counters.get(k, 0) + n


def _free(graph: torch.cuda.CUDAGraph, device) -> None:
    torch.cuda.synchronize(device)
    graph.reset()


_EAGER_ONLY = False


@contextlib.contextmanager
def eager():
    """Within: every fit and render runs eagerly, as with graph=False."""
    global _EAGER_ONLY
    before, _EAGER_ONLY = _EAGER_ONLY, True
    try:
        yield
    finally:
        _EAGER_ONLY = before


def use_graph(device, graph: Optional[bool]) -> bool:
    """Whether work on `device` replays CUDA graphs: on a CUDA device unless
    graph is False or within `eager()`. graph=True on a CPU device raises
    (a graph needs a card)."""
    if torch.device(device).type == "cuda":
        return graph is not False and not _EAGER_ONLY
    if graph:
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    return False


def runner(device, graph: Optional[bool]):
    """The plain-step runner of a fit on `device`: a StepGraph where
    `use_graph(device, graph)`, else Eager."""
    return StepGraph(device) if use_graph(device, graph) else Eager()


class EagerRender:
    """A render of fixed input tensors, run eagerly (`RenderGraph`'s
    interface: the CPU, graph=False, or within `eager()`).

    `load(*values)` copies each value (a numpy array or a tensor of its
    input's shape) into its input. A numpy value for a CUDA input goes
    through the input's own pinned host buffer, without a host sync (the
    next load waits for the copy before it refills the buffer). A call
    renders, without autograd, from what the inputs hold."""

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor]):
        self.fn = fn
        self.inputs = tuple(inputs)
        self._staging: list = [None] * len(self.inputs)  # (pinned buffer, copied)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def load(self, *values) -> None:
        if len(values) != len(self.inputs):
            raise ValueError(f"{len(values)} values for {len(self.inputs)} inputs")
        for i, (inp, v) in enumerate(zip(self.inputs, values)):
            if tuple(np.shape(v)) != tuple(inp.shape):
                raise ValueError(f"a value of shape {tuple(np.shape(v))} for an input "
                                 f"of shape {tuple(inp.shape)}")
            if isinstance(v, torch.Tensor) or not inp.is_cuda:
                inp.copy_(torch.as_tensor(v))
                continue
            if self._staging[i] is None:
                self._staging[i] = (torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True),
                                    torch.cuda.Event())
            buf, copied = self._staging[i]
            copied.synchronize()  # the previous load's copy has read the buffer
            np.copyto(buf.numpy(), v, casting="same_kind")
            inp.copy_(buf, non_blocking=True)
            copied.record(torch.cuda.current_stream(inp.device))

    def __call__(self) -> torch.Tensor:
        with torch.no_grad():
            return self.fn(*self.inputs)

    @property
    def capturing(self) -> bool:
        """Whether the next call captures a graph (never, eagerly)."""
        return False

    def close(self) -> None:
        return None


class RenderGraph(EagerRender, metaclass=_Totals):
    """A render of fixed input tensors as replays of one CUDA graph.

    The first call renders eagerly on the current stream (a real render:
    its launches count, and it loads the libraries and lazy state a capture
    must not meet) and returns that result; it then captures the render on
    a side stream (`capture_begin` / `capture_end`, as `StepGraph` does).
    Every later call is a replay on the current stream, which returns the
    graph's own output tensor: the next replay overwrites it, so read or
    copy it before the next call, on the same stream. A failed capture or
    replay raises. A replay adds what the capture added to the recorder's
    counters, so the launch counts equal an eager run's. The totals over
    a process: `captures`, `replays` and `capture_seconds`, the recorder's
    counters `graph.render.*` (a render records no span of its own)."""

    kind = "render"

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 device):
        super().__init__(fn, inputs)
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.added: list = []

    def __call__(self) -> torch.Tensor:
        if self.graph is not None:
            _replay(self.graph, self.added)
            RECORDER.add("graph.render.replays")
            return self.output
        out = super().__call__()
        with torch.no_grad():
            self.graph, self.output, self.added = _capture(
                lambda: self.fn(*self.inputs), self.device, side_stream(self.device),
                self.kind)
        return out

    @property
    def capturing(self) -> bool:
        return self.graph is None

    def close(self) -> None:
        """Free the graph and its memory pool once its replays have run."""
        if self.graph is not None:
            _free(self.graph, self.device)
            self.graph, self.output = None, None


def render_graph(fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor], device,
                 graph: Optional[bool] = None) -> EagerRender:
    """A RenderGraph of fn(*inputs) where `use_graph(device, graph)`, else
    an EagerRender."""
    if use_graph(device, graph):
        return RenderGraph(fn, inputs, device)
    return EagerRender(fn, inputs)


class RenderCache:
    """Up to `maxsize` renders by key, least recently used evicted first
    (and closed): the counterpart of gsvc_tpu's `lru_cache(maxsize=8)` of
    jitted renders. The key holds all that fixes a render's shapes or code
    (`render_key`)."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._renders: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._renders)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._renders

    def get(self, key: Hashable, make: Callable[[], EagerRender]) -> EagerRender:
        """The render of `key`, made by make() when it is not held."""
        render = self._renders.pop(key, None)
        if render is None:
            render = make()
        self._renders[key] = render
        while len(self._renders) > self.maxsize:
            self._renders.popitem(last=False)[1].close()
        return render


def render_key(cfg, n: int, layout: str, device) -> tuple:
    """What fixes a render's shapes and code: the frame's size and tiles,
    the splat count, the intersection budget, the backend, the layout and
    the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (cfg.H, cfg.W, cfg.block_h, cfg.block_w, n, cfg.max_intersects, cfg.backend,
            layout, str(device))

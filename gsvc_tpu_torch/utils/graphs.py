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
raises: nothing falls back to the eager loop. The kernels' wrappers count
launches in Python, so a replay counts nothing by itself: each replay adds
the counts the capture saw. `runner(device, graph)` picks a `StepGraph` on
a CUDA device unless `graph` is False, else `Eager`, which runs every step
as it comes.

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
from typing import Callable, Hashable, NamedTuple, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

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
    row [] int64: the row of the next step;
    fresh [] bool: Adan re-seeds its previous gradient (`AdanState.fresh`);
    grace [] int32: the early-stop grace countdown (represent fits only).
    """

    table: torch.Tensor
    row: torch.Tensor
    fresh: torch.Tensor
    grace: Optional[torch.Tensor] = None

    @property
    def scalars(self) -> Tuple[torch.Tensor, ...]:
        """The next step's row of `table`, as [] tensors (no host read)."""
        return torch.index_select(self.table, 0, self.row.view(1))[0].unbind()


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
            stop: Optional[Callable[[T], bool]] = None) -> T:
    """The steps of `plan` from `state`: eager steps by plan.step, plain ones
    through `runner(device, graph)`; `stop(state)`, asked after each step,
    ends the fit early. The graph is freed when the fit returns."""
    eager_steps = (eager for _first, count, eager in plan.runs for _ in range(count))
    with runner(device, graph) as run:
        for eager in eager_steps:
            if eager:
                state = plan.step(state)
            else:
                state = run(lambda s=state: plan.step(s), lambda s=state: plan.after_plain(s))
            if stop is not None and stop(state):
                break
    return state


def kernel_counters() -> tuple:
    """The kernel wrappers whose `launches` a replay adds to."""
    from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda

    return (fill_cuda.fill_decode_keys, fill_cuda.rank_cap_decode,
            fill_cuda.segmented_cumsum, rasterize_cuda.forward_image,
            rasterize_cuda.forward_chw, rasterize_cuda.forward_rows,
            rasterize_cuda.backward_slots)


class Eager:
    """Runs each plain step as it comes (the CPU, or graph=False)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, step: Callable[[], T], after_plain: Callable[[], T]) -> T:
        return step()


class StepGraph:
    """The plain steps of one fit as replays of one CUDA graph.

    A call `(step, after_plain)` takes one plain step: step() eagerly on a
    side stream for the first WARMUP calls, then step() captured and
    replayed (its result carries the host fields), then a replay and
    after_plain(). step() must read and write only tensors that outlive the
    graph. The totals over a process, like the kernels' launch counters:
    `captures`, `replays` and `capture_seconds` (host seconds a capture
    takes, the graph's instantiation included)."""

    captures = 0
    replays = 0
    capture_seconds = 0.0

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.side: Optional[torch.cuda.Stream] = None
        self.warmed = 0
        self.counts: list = []

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
            self.replay()
            return out
        self.replay()
        return after_plain()

    def _on_side(self, step: Callable[[], T]) -> T:
        if self.side is None:
            self.side = side_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = step()
        main.wait_stream(self.side)
        return out

    def _capture(self, step: Callable[[], T]) -> T:
        self.graph, out, self.counts, secs = _capture(step, self.device, self.side)
        StepGraph.capture_seconds += secs
        StepGraph.captures += 1
        return out

    def replay(self) -> None:
        _replay(self.graph, self.counts)
        StepGraph.replays += 1

    def close(self) -> None:
        """Free the graph and its memory pool, once its replays have run
        (the pool's memory may then go to other streams)."""
        if self.graph is not None:
            _free(self.graph, self.device)
            self.graph = None


def _capture(fn: Callable[[], T], device, stream) -> tuple:
    """fn() captured into a new CUDA graph on `stream`: (the graph, fn's
    result, [(kernel wrapper, launches)] the capture saw, host seconds).
    On the given stream, without `torch.cuda.graph`'s device sync and
    release of every cached block (which the next calls would allocate
    again); the graph's own memory pool holds what fn allocates. The
    capture ran nothing, so its launch counts are taken back off the
    counters: they belong to each replay (`_replay`)."""
    counters = kernel_counters()
    before = [c.launches for c in counters]
    graph = torch.cuda.CUDAGraph()
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
    counts = [(c, c.launches - b) for c, b in zip(counters, before)]
    for c, b in zip(counters, before):
        c.launches = b
    return graph, out, counts, time.perf_counter() - t0


def _replay(graph: torch.cuda.CUDAGraph, counts: list) -> None:
    """Replay `graph` on the current stream and count its capture's launches."""
    graph.replay()
    for c, n in counts:
        c.launches += n


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


class RenderGraph(EagerRender):
    """A render of fixed input tensors as replays of one CUDA graph.

    The first call renders eagerly on the current stream (a real render:
    its launches count, and it loads the libraries and lazy state a capture
    must not meet) and returns that result; it then captures the render on
    a side stream (`capture_begin` / `capture_end`, as `StepGraph` does).
    Every later call is a replay on the current stream, which returns the
    graph's own output tensor: the next replay overwrites it, so read or
    copy it before the next call, on the same stream. A failed capture or
    replay raises. A replay adds the capture's launch counts to the
    kernels' counters, so the counts equal an eager run's. The totals over
    a process: `captures`, `replays` and `capture_seconds`."""

    captures = 0
    replays = 0
    capture_seconds = 0.0

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 device):
        super().__init__(fn, inputs)
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Optional[torch.Tensor] = None
        self.counts: list = []

    def __call__(self) -> torch.Tensor:
        if self.graph is not None:
            _replay(self.graph, self.counts)
            RenderGraph.replays += 1
            return self.output
        out = super().__call__()
        with torch.no_grad():
            self.graph, self.output, self.counts, secs = _capture(
                lambda: self.fn(*self.inputs), self.device, side_stream(self.device))
        RenderGraph.capture_seconds += secs
        RenderGraph.captures += 1
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

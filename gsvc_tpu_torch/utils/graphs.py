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
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")
WARMUP = 3  # eager plain steps on a side stream before the capture


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
            self.side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = step()
        main.wait_stream(self.side)
        return out

    def _capture(self, step: Callable[[], T]) -> T:
        # on the warm-up stream, without `torch.cuda.graph`'s device sync and
        # release of every cached block (which the next steps would allocate
        # again); the graph's own memory pool holds what the step allocates
        counters = kernel_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            graph.capture_begin()
            try:
                out = step()
            finally:
                graph.capture_end()
        main.wait_stream(self.side)
        StepGraph.capture_seconds += time.perf_counter() - t0
        StepGraph.captures += 1
        # the capture ran nothing: its counts belong to each replay
        self.counts = [(c, c.launches - b) for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b
        self.graph = graph
        return out

    def replay(self) -> None:
        self.graph.replay()
        for c, n in self.counts:
            c.launches += n
        StepGraph.replays += 1

    def close(self) -> None:
        """Free the graph and its memory pool, once its replays have run
        (the pool's memory may then go to other streams)."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None


def runner(device, graph: Optional[bool]):
    """The plain-step runner of a fit on `device`: a StepGraph on a CUDA
    device unless graph is False, else Eager. graph=True on a CPU device
    raises (a graph needs a card)."""
    if torch.device(device).type == "cuda":
        return Eager() if graph is False else StepGraph(device)
    if graph:
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    return Eager()

"""The port's recorder of spans and counters (`utils/profiling.StepTimer`,
the process-wide `RECORDER`) and the spans its layers record.

On the CPU: nesting, root and parent ids, attributes, the ring's bound
and its drop counter, the switch, a span's `record_function` range on
torch.profiler's clock, the graph classes' totals as the recorder's
counters, and the spans of an eager `fit_frame` (one `fit` root, a
`fit.eager` span for each eager run of `plan_steps`, `fit.sync` for each
host read of the stop rule, `represent.init` / `represent.render`), of a
QAT fit with `measure_bits` and `encode_frame` (`qat.*`), and of
`decode_frame` (`decode.*`, whose host seconds `times=` reports, as the
decoder's stages report theirs, with the recorder off too).

On a card (marker `cuda`, skipped without one): a represent fit on CUDA
graphs records one `graph.capture`, replays its plain steps but the
warm-ups, gives every `fit.replays` span device seconds, keeps each
child's device interval inside its parent's, and records no event on a
stream under capture, and its replays add to the binning counters what the
eager fit adds.

The binning layer's record: a fit's `fit` span names its keys' width and
gauss field (`key_bytes`, `gauss_bits`), and every K1 call adds its keys
and their bytes to the counters `binning.keys` and `binning.key_bytes`.

A graph's capture hands back what it added to the recorder's counters, and
each replay adds it again (with the CUDA graph and streams stubbed on the
CPU): the counts of a render on a graph are those of its eager renders.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from gsvc_tpu_torch.compress import bitstream
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.profiling import RECORDER, StepTimer
from torch_threads import one_thread  # noqa: F401

H, W, N, CAP = 48, 64, 150, 200



def _nested(rec: StepTimer, how: str) -> None:
    """a { b { c }, d }, then e, opened as blocks or by open / close."""
    if how == "block":
        with rec("a", kind="x"):
            with rec("b"):
                with rec("c", step=3):
                    pass
            with rec("d"):
                pass
        with rec("e"):
            pass
        return
    a = rec.open("a", kind="x")
    b = rec.open("b")
    c = rec.open("c", step=3)
    rec.close(c)
    rec.close(b)
    d = rec.open("d")
    rec.close(a)  # closes d, still open inside it
    assert d.t1 >= d.t0 > 0
    rec.close(rec.open("e"))


@pytest.mark.parametrize("how", ["block", "open_close"])
def test_spans_nest_with_parent_and_root_ids(how):
    rec = StepTimer()
    _nested(rec, how)
    by = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["c", "b", "d", "a", "e"]
    a, b, c, d, e = (by[k] for k in "abcde")
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {b.root, c.root, d.root} == {a.id} and e.root == e.id != a.id
    assert a.attrs == {"kind": "x"} and c.attrs == {"step": 3} and b.attrs is None
    assert all(s.device_s is None and s.host_s >= 0 for s in by.values())
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1 <= e.t0
    assert rec.counts == {k: 1 for k in "abcde"} and not rec._stack
    assert rec.last_id == e.id and rec.spans(after=a.id) == [c, b, d, e]
    assert rec.spans("b") == [b]


def test_close_adds_attributes_and_counters_add():
    rec = StepTimer()
    span = rec.open("fit", kind="qat")
    rec.close(span, replays=7)
    assert span.attrs == {"kind": "qat", "replays": 7}
    rec.add("graph.step.replays")
    rec.add("graph.step.replays", 2)
    rec.add("graph.step.capture_s", 0.5)
    assert rec.counters == {"graph.step.replays": 3, "graph.step.capture_s": 0.5}


@pytest.mark.parametrize("capacity,spans", [(4, 3), (4, 4), (4, 11), (65536, 100)])
def test_ring_keeps_the_newest_and_counts_the_dropped(capacity, spans):
    rec = StepTimer(capacity=capacity)
    for i in range(spans):
        with rec("s", i=i):
            pass
    kept = rec.spans()
    assert [s.attrs["i"] for s in kept] == list(range(max(0, spans - capacity), spans))
    assert rec.counters.get("spans.dropped", 0) == max(0, spans - capacity)
    assert rec.counts["s"] == spans


def test_the_process_recorder_keeps_at_least_65536_spans():
    assert RECORDER._ring.maxlen >= 65536


def test_switched_off_records_nothing():
    from torch.profiler import ProfilerActivity, profile

    rec = StepTimer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec("off") as span:
            assert span is None
        rec.close(rec.open("off"))
    assert rec.spans() == [] and rec.totals == {} and rec.counts == {}
    assert not rec._stack and rec.last_id == 0
    assert not [e for e in prof.profiler.kineto_results.events() if e.name() == "off"]


def test_process_switch_off_records_no_fit_spans(monkeypatch):
    monkeypatch.setattr(RECORDER, "enabled", False)
    mark = RECORDER.last_id
    cfg = _cfg(iterations=6)
    rep.fit_frame(rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0)),
                  _gt(), cfg)
    assert RECORDER.spans(after=mark) == [] and RECORDER.last_id == mark


def _end_ns(e) -> int:
    return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()


def test_span_is_a_record_function_range_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    rec = StepTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec("warm"):  # the first range of a session initialises lazily
            pass
        with rec("outer") as outer:
            with rec("inner") as inner:
                torch.ones(4096).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for span in (outer, inner):
        e = events[span.name]
        assert abs(e.start_ns() - span.t0) < 50_000, (e.start_ns(), span.t0)
        assert abs(_end_ns(e) - span.t1) < 50_000, (_end_ns(e), span.t1)


def test_graph_totals_are_the_recorders_counters():
    for cls, kind in ((graphs.StepGraph, "step"), (graphs.RenderGraph, "render")):
        before = cls.replays
        RECORDER.add(f"graph.{kind}.replays", 2)
        assert cls.replays == before + 2
        cls.replays += 1  # as the benchmark's replay fault adds one
        assert RECORDER.counters[f"graph.{kind}.replays"] == before + 3
        cls.replays = before
        assert cls.captures == RECORDER.counters.get(f"graph.{kind}.captures", 0)
        assert cls.capture_seconds == RECORDER.counters.get(f"graph.{kind}.capture_s", 0)


# -- the port's spans on the CPU -------------------------------------------------


def _cfg(**kw) -> FrameConfig:
    base = dict(H=H, W=W, num_points=N, max_num_points=CAP, iterations=30, lr=1e-2,
                densification_interval=10, backend="cuda")
    return FrameConfig(**{**base, **kw})


def _gt(seed: int = 1) -> torch.Tensor:
    return torch.rand((H, W, 3), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("control", ["removal", "density", "none"])
def test_eager_fit_frame_spans(control):
    cfg = _cfg(isremoval=control == "removal", isdensity=control == "density")
    mark = RECORDER.last_id
    state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    res = rep.fit_frame(state, _gt(), cfg, draws=torch.Generator().manual_seed(2))
    spans = RECORDER.spans(after=mark)
    names = [s.name for s in spans]
    fits = [s for s in spans if s.name == "fit"]
    assert len(fits) == 1
    fit = fits[0]
    inside = [s for s in spans if s.parent == fit.id]
    eager_runs = sum(1 for _first, _count, eager in rep.plan_steps(0, cfg.iterations, cfg)
                     if eager)
    assert sum(1 for s in inside if s.name == "fit.eager") == eager_runs > 0
    reads = [s for s in inside if s.name == "fit.sync"]
    assert fit.parent is None and fit.root == fit.id
    assert all(s.root == fit.id for s in inside)
    assert {s.name for s in inside} <= {"fit.eager", "fit.sync"}  # eager: no graph
    assert fit.attrs == {"kind": "represent", "first": 1, "last": cfg.iterations,
                         "iterations": cfg.iterations, "splats": N, "key_bytes": 4,
                         "gauss_bits": 16, "eager": eager_runs,
                         "warmups": 0, "captures": 0, "replays": 0, "reads": len(reads)}
    assert (len(reads) > 0) == (control == "none")  # control's grace outlasts 30 steps
    assert names.count("represent.init") == names.count("represent.render") == 1
    init, render = (next(s for s in spans if s.name == k)
                    for k in ("represent.init", "represent.render"))
    assert init.parent is None and render.parent is None
    assert init.t1 <= fit.t0 and fit.t1 <= render.t0
    assert init.attrs == render.attrs == {"splats": N}
    assert res.state.it <= cfg.iterations


@pytest.mark.parametrize("delta", [False, True])
def test_qat_spans(delta):
    n = 60
    g = torch.Generator().manual_seed(3)

    def gmodel():
        return {"_xyz": torch.randn((n, 2), generator=g).numpy() * 0.5,
                "_cholesky": torch.rand((n, 3), generator=g).numpy(),
                "_features_dc": torch.rand((n, 3), generator=g).numpy()}

    cur, prev = gmodel(), gmodel() if delta else None
    cfg = _cfg(num_points=n, max_num_points=n, iterations=6)
    mark = RECORDER.last_id
    cs = comp.init_compress_state(cur, prev)
    cs = comp.fit_compress(cs, _gt(), cfg, draws=torch.Generator().manual_seed(4))
    comp.measure_bits(cs, cfg)
    bitstream.encode_frame(cs, cfg, "P" if delta else "K")
    spans = RECORDER.spans(after=mark)
    assert [s.name for s in spans if s.parent is None] == [
        "qat.init", "fit", "qat.bits", "qat.encode"]
    by = {s.name: s for s in spans}
    fit = by["fit"]
    assert fit.attrs == {"kind": "qat", "first": 1, "last": 6, "iterations": 6, "splats": n,
                         "key_bytes": 4, "gauss_bits": 16,
                         "eager": 1, "warmups": 0, "captures": 0, "replays": 0, "reads": 0}
    assert [s.attrs["step"] for s in spans if s.name == "fit.eager"] == [1]  # k-means
    assert by["qat.init"].attrs == {"splats": n}
    assert by["qat.bits"].attrs == by["qat.encode"].attrs == {"splats": n, "iterations": 6}


# (H, W, capacity, key bytes, gauss bits): the benchmark's 1080p and 4K UHD
# points and the edges of the 16-bit field and of int32 keys
@pytest.mark.parametrize("h,w,cap,key_bytes,bits", [
    (1080, 1920, 10000, 4, 16), (1080, 1920, 50000, 4, 16), (2160, 3840, 100000, 8, 17),
    (2160, 3840, 65535, 4, 16), (1080, 1920, 262143, 4, 18), (1080, 1920, 262144, 8, 19),
])
def test_fit_span_names_its_key_layout(h, w, cap, key_bytes, bits):
    """A model's fit gives its `fit` span its binning keys' width and gauss
    field (`represent.fit_attrs`: `fill_cuda.key_layout` at the config's
    grid and the state's capacity); a fit whose caller gives no attributes
    carries none (no step runs here)."""
    from gsvc_tpu_torch.ops import fill_cuda

    cfg = _cfg(H=h, W=w, num_points=cap, max_num_points=cap, iterations=1)
    plan = graphs.FitPlan([], lambda s: s, lambda s: s)
    mark = RECORDER.last_id
    graphs.run_fit(None, plan, "cpu", None, kind="represent", **rep.fit_attrs(cfg, cap))
    graphs.run_fit(None, plan, "cpu", None, kind="represent")
    with_cap, without = RECORDER.spans("fit", after=mark)
    layout = fill_cuda.key_layout(cfg.tile_bounds[0] * cfg.tile_bounds[1], cap)
    assert (with_cap.attrs["key_bytes"], with_cap.attrs["gauss_bits"]) == (key_bytes, bits)
    assert key_bytes == layout.dtype.itemsize and bits == layout.gauss_bits
    assert "key_bytes" not in without.attrs and "gauss_bits" not in without.attrs
    assert (with_cap.attrs["iterations"], with_cap.attrs["splats"]) == (1, cap)


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph on the CPU: counts its replays."""

    def __init__(self):
        self.replays = 0

    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


def test_capture_hands_back_its_counts_and_replays_add_them(monkeypatch):
    """A render on a graph counts as its eager renders do: the capture takes
    back what it added to the recorder's counters (a kernel's launch, the
    keys), each replay adds it again, and the recorder's own `spans.*` and
    the graphs' `graph.*` counters are not replayed. No card here: the
    graph and the streams are stubbed."""
    for name, stub in (("CUDAGraph", _Graph), ("current_stream", lambda d=None: _Stream()),
                       ("device", lambda d: contextlib.nullcontext()),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("synchronize", lambda d=None: None)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(graphs, "side_stream", lambda d: _Stream())
    monkeypatch.setattr(RECORDER, "counters", dict(RECORDER.counters))  # restored after
    x = torch.ones(3)

    def render(t):
        RECORDER.add("launches.test_render")
        RECORDER.add("binning.keys", 5)
        RECORDER.add("spans.test", 1)
        return t * 2

    counters = ("launches.test_render", "binning.keys", "spans.test",
                "graph.render.captures", "graph.render.replays")
    before = {k: RECORDER.counters.get(k, 0) for k in counters}
    with graphs.RenderGraph(render, (x,), "cpu") as rg:
        assert torch.equal(rg(), x * 2)  # the eager render, then the capture
        assert dict(rg.added) == {"launches.test_render": 1, "binning.keys": 5}
        rg()
        rg()
        assert rg.graph.replays == 2
    moved = {k: RECORDER.counters.get(k, 0) - v for k, v in before.items()}
    assert moved == {"launches.test_render": 3, "binning.keys": 15, "spans.test": 2,
                     "graph.render.captures": 1, "graph.render.replays": 2}
    assert graphs.launch_counts()["test_render"] == RECORDER.counters["launches.test_render"]


def test_binning_counters_count_an_eager_fits_keys():
    """Each step of an eager CPU fit bins once through K1's wrapper (its
    plain version here): `binning.keys` grows by the budget a step and
    `binning.key_bytes` by 4 bytes a key (int32 keys at this size); the
    fit's final render bins once more."""
    cfg = _cfg(isremoval=True)
    budget = rep.intersection_budget(cfg)
    state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    before = {k: RECORDER.counters.get(k, 0) for k in ("binning.keys", "binning.key_bytes")}
    rep.fit_frame(state, _gt(), cfg, draws=torch.Generator().manual_seed(2))
    keys = RECORDER.counters["binning.keys"] - before["binning.keys"]
    assert keys == (cfg.iterations + 1) * budget
    assert RECORDER.counters["binning.key_bytes"] - before["binning.key_bytes"] == 4 * keys


def _blob(n: int = 40, seed: int = 5) -> bytes:
    """A K-frame of n random splats."""
    g = torch.Generator().manual_seed(seed)
    return bitstream.pack_frame(
        (torch.randn((n, 2), generator=g) * 0.3).numpy().astype("float16"),
        torch.full((3,), 0.1).numpy(), torch.zeros(3).numpy(),
        torch.randint(0, 64, (n, 3), generator=g).numpy().astype("int32"),
        torch.rand((2, 8, 3), generator=g).numpy(),
        torch.randint(0, 8, (n, 2), generator=g).numpy().astype("int32"), "K")


def test_decode_frame_times_are_its_spans():
    blob = _blob()
    mark = RECORDER.last_id
    times: dict = {}
    bitstream.decode_frame(blob, times=times)
    spans = RECORDER.spans(after=mark)
    assert [s.name for s in spans] == ["decode.unpack", "decode.entropy", "decode.unpack"]
    assert all(s.parent is None for s in spans)
    assert times["entropy"] == spans[1].host_s
    assert times["unpack"] == spans[0].host_s + spans[2].host_s


def test_decoder_stages_with_the_recorder_off(tmp_path, monkeypatch):
    """The decoder's stage seconds (`decode_frame(times=)`, `decode.STAGES`)
    are read with the recorder off too, and leave no span behind."""
    from gsvc_tpu_torch import decode

    monkeypatch.setattr(RECORDER, "enabled", False)
    mark, totals = RECORDER.last_id, dict(RECORDER.totals)
    times: dict = {}
    bitstream.decode_frame(_blob(), times=times)
    assert times["entropy"] > 0 and times["unpack"] > 0
    bs = tmp_path / "bitstream"
    bs.mkdir()
    for f in (1, 2):
        (bs / f"frame_{f}.gsvc").write_bytes(_blob(seed=f))
    (tmp_path / "K_frames.txt").write_text("1\n2\n")
    assert decode.main(["--bitstream", str(bs), "--height", str(H), "--width", str(W),
                        "--k_frames", str(tmp_path / "K_frames.txt"), "--no_png",
                        "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert decode.STAGES["frames"] == 2
    assert all(decode.STAGES[k] > 0 for k in ("entropy", "unpack", "render", "d2h", "write"))
    assert RECORDER.last_id == mark and RECORDER.spans(after=mark) == []
    assert RECORDER.totals == totals and not RECORDER._pending


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and timing events run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_fit_spans(dev, monkeypatch):
    """A represent fit on graphs, its step wrapped in a span of its own (so
    one span opens inside the capture); every timing event recorded on a
    stream not under capture."""
    recorded = []
    record = torch.cuda.Event.record

    def spy(self, stream=None):
        recorded.append(torch.cuda.is_current_stream_capturing())
        return record(self, stream)

    monkeypatch.setattr(torch.cuda.Event, "record", spy)
    cfg = _cfg(H=256, W=256, num_points=450, max_num_points=500, iterations=250,
               isremoval=True, densification_interval=100, removal_rate=0.2)
    gt = torch.rand((256, 256, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    plan = rep.fit_plan(state, gt, cfg.iterations, cfg,
                        draws=torch.Generator(device=dev).manual_seed(2))

    def step(s):
        with RECORDER("test.step", device=dev):
            return plan.step(s)

    mark = RECORDER.last_id
    state = graphs.run_fit(state, plan._replace(step=step), dev, None, kind="represent",
                           **rep.fit_attrs(cfg, state.alive.shape[0]))
    torch.cuda.synchronize()
    spans = RECORDER.spans(after=mark)
    assert state.it == cfg.iterations and recorded and not any(recorded)
    fit = next(s for s in spans if s.name == "fit")
    eager = sum(count for _first, count, e in plan.runs if e)
    plain = cfg.iterations - eager
    caps = [s for s in spans if s.name == "graph.capture"]
    runs = [s for s in spans if s.name == "fit.replays"]
    assert len(caps) == 1 and caps[0].parent == fit.id
    assert fit.attrs["replays"] == sum(s.attrs["replays"] for s in runs) == plain - graphs.WARMUP
    assert fit.attrs["warmups"] == graphs.WARMUP and fit.attrs["captures"] == 1
    assert all(s.device_s is not None and s.device_s > 0 for s in runs)
    steps = [s for s in spans if s.name == "test.step"]
    assert sum(s.device_s is None for s in steps) == 1  # the step captured: no events
    by = {s.id: s for s in spans}
    eps = 2e-6
    timed = [s for s in spans if s.device_s is not None and s.parent in by
             and by[s.parent].device_s is not None]
    assert len(timed) > 2 * len(runs)
    for s in timed:
        p = by[s.parent]
        assert s.device_t0 >= p.device_t0 - eps, (s, p)
        assert s.device_t0 + s.device_s <= p.device_t0 + p.device_s + eps, (s, p)


@pytest.mark.cuda
def test_card_replays_add_the_binning_counters(dev):
    """A represent fit on graphs adds to `binning.keys` and
    `binning.key_bytes` what the same fit adds eagerly: each replay adds
    what its capture's K1 launch added, the capture itself nothing."""
    cfg = _cfg(H=256, W=256, num_points=450, max_num_points=500, iterations=40,
               densification_interval=20)
    gt = torch.rand((256, 256, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    added = []
    for graph in (None, False):
        state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev)
        before = {k: RECORDER.counters.get(k, 0) for k in ("binning.keys", "binning.key_bytes")}
        replays = graphs.StepGraph.replays
        rep.fit_frame_partial(state, gt, cfg.iterations, cfg, graph=graph)
        torch.cuda.synchronize()
        added.append({k: RECORDER.counters[k] - v for k, v in before.items()})
        assert (graphs.StepGraph.replays > replays) == (graph is None)
    assert added[0] == added[1]
    assert added[0]["binning.keys"] == cfg.iterations * rep.intersection_budget(cfg)

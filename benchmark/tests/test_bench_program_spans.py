"""The readers of the program's spans (`encode.replay_ms`, `encode.eager_s`,
`encode.capture_s`, `encode.coding_s`) on a hand-built recorder: the
numbers of the window's whole fits alone (not an earlier run's, not
set-up's warm-up fits, not the checked and traced frames' slices; the
replays also of the slices that run to the end), None where there
is nothing to read, and an encode run on the CPU, whose fits record no
device time and no capture."""

from __future__ import annotations

import types

import pytest
from conftest import ROOT, tiny_cell, tiny_run

from benchmark.harness.core import metric_reader
from benchmark.harness.runner import execute
from gsvc_tpu_torch.utils import profiling

METRICS = ("encode.replay_ms", "encode.eager_s", "encode.capture_s", "encode.coding_s")
ITERS, QAT_ITERS = 100, 20


class Clock:
    def __init__(self):
        self.ns = 1_000_000_000

    def __call__(self) -> int:
        return self.ns

    def wait(self, secs: float) -> None:
        self.ns += round(secs * 1e9)


def _span(rec, clock, name, host_s=0.001, device_s=None, **attrs):
    span = rec.open(name, **attrs)
    clock.wait(host_s)
    rec.close(span)
    span.device_s = device_s
    return span


def _fit(rec, clock, kind, first, last, children=()):
    """A fit span holding `children`, (name, host_s, device_s, attrs)."""
    fit = rec.open("fit", kind=kind, first=first, last=last, iterations=last, splats=60)
    for name, host_s, device_s, attrs in children:
        _span(rec, clock, name, host_s, device_s, **attrs)
    clock.wait(0.001)
    rec.close(fit)


def _graph_fit(rec, clock, kind, first, last, scale=1.0):
    """A fit on graphs: 3 warm-ups, a capture, an eager step, two runs of replays."""
    _fit(rec, clock, kind, first, last, [
        *[("fit.warmup", 0.01, 0.01 * scale, {})] * 3,
        ("graph.capture", 0.03 * scale, 0.03, {"graph": "step"}),
        ("fit.replays", 0.5, 0.5 * scale, {"replays": 50}),
        ("fit.eager", 0.02, 0.02 * scale, {"step": 100}),
        ("fit.replays", 0.5, 0.5 * scale, {"replays": 50}),
    ])


def _coded(rec, clock, qat_iters, bits_s, encode_s):
    _span(rec, clock, "qat.bits", bits_s, splats=60, iterations=qat_iters)
    _span(rec, clock, "qat.encode", encode_s, splats=60, iterations=qat_iters)


def _hand_built(frames: int = 4):
    """An earlier run's frame, set-up's two warm-up frames, then a window of
    `frames` frames: two checked (their fits as slices, the second's
    represent fit traced: a profiled slice at scale 50 before its last
    slice), then whole ones, the last of them (frame 3) fitted twice."""
    clock = Clock()
    rec = profiling.StepTimer(clock=clock)
    _graph_fit(rec, clock, "represent", 1, ITERS, scale=9.0)  # an earlier run
    _graph_fit(rec, clock, "qat", 1, QAT_ITERS, scale=9.0)
    _coded(rec, clock, QAT_ITERS, 0.9, 0.9)
    for _ in range(2):  # set-up's warm-up frames
        _graph_fit(rec, clock, "represent", 1, 8, scale=7.0)
        _graph_fit(rec, clock, "qat", 1, 5, scale=7.0)
        _coded(rec, clock, 5, 0.7, 0.7)
    for f in range(frames):
        if f < 2:  # checked: step 1, steps 2-8, the rest (traced: 9-60, 61-80, 81-)
            slices = ((1, 1), (2, 8), (9, ITERS)) if f == 0 else (
                (1, 1), (2, 8), (9, 60), (61, 80), (81, ITERS))
            for first, last in slices:
                scale = 50.0 if (first, last) == (61, 80) else 5.0
                _graph_fit(rec, clock, "represent", first, last, scale=scale)
            for first, last in ((1, 1), (2, 8), (9, QAT_ITERS)):
                _graph_fit(rec, clock, "qat", first, last, scale=5.0)
        else:
            for _ in range(f - 1):  # frame 3 overflowed its budget: fitted twice
                _graph_fit(rec, clock, "represent", 1, ITERS, scale=f)
            _graph_fit(rec, clock, "qat", 1, QAT_ITERS, scale=0.5)
        _coded(rec, clock, QAT_ITERS, 0.001 * (f + 1), 0.002)
    return rec


def _run(frames: int = 4):
    return types.SimpleNamespace(counters={"frames": frames},
                                 config={"iterations": ITERS, "qat_iterations": QAT_ITERS})


# by the window's frames: four (whole fits: represent at scales 2, 3, 3, QAT at
# 0.5 twice; fits to the end: those and the checked frames' last slices, at 5,
# represent and QAT), or the two checked frames alone, as at 50k (no whole fit)
EXPECTED = {
    4: {
        # each run: 0.5 * scale s over 50 replays
        "encode.replay_ms": 1e3 * 0.5 / 50 * (5 + 5 + 2 + 3 + 3) / 5,
        # 3 warm-ups and an eager step, 0.05 * scale a fit, over the 3 fits
        "encode.eager_s": 0.05 * (2 + 3 + 3) / 3,
        # 0.03 * scale a capture in each fit to the end, over the 4 frames
        "encode.capture_s": 0.03 * (5 + 5 + 2 + 3 + 3 + 5 + 5 + 0.5 + 0.5) / 4,
        # bits 0.001 * (f + 1) and encode 0.002 a frame
        "encode.coding_s": (0.001 * (1 + 2 + 3 + 4) + 4 * 0.002) / 4,
    },
    2: {
        "encode.replay_ms": 1e3 * 0.5 / 50 * 5,
        "encode.eager_s": None,
        "encode.capture_s": 0.03 * (5 + 5 + 5 + 5) / 2,
        "encode.coding_s": (0.001 * (1 + 2) + 2 * 0.002) / 2,
    },
}


@pytest.mark.parametrize("frames", [4, 2])
@pytest.mark.parametrize("metric", METRICS)
def test_reader_reads_only_the_windows_whole_fits(metric, frames, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", _hand_built(frames))
    got = metric_reader(metric, ROOT)(_run(frames))
    want = EXPECTED[frames][metric]
    assert got == (None if want is None else pytest.approx(want, rel=1e-6))


@pytest.mark.parametrize("case", ["empty", "no recorder", "no window"])
@pytest.mark.parametrize("metric", METRICS)
def test_reader_finds_nothing(metric, case, monkeypatch):
    run = _run()
    if case == "no recorder":  # a program before the recorder
        monkeypatch.delattr(profiling, "RECORDER")
    else:
        monkeypatch.setattr(profiling, "RECORDER", profiling.StepTimer())
        if case == "no window":
            run.counters = {}
    assert metric_reader(metric, ROOT)(run) is None


def test_readers_on_a_cpu_encode_run():
    """On the CPU the fits run eagerly: no replay, no capture and no device
    time to read; the coding spans are read."""
    cell = tiny_cell("encode.gsvc-1080p-10k")
    run = tiny_run(cell)
    execute(run, cell.loop())
    got = {m: metric_reader(m, ROOT)(run) for m in METRICS}
    assert got["encode.coding_s"] > 0
    assert [got[m] for m in METRICS[:3]] == [None, None, None]

"""The eval render of a decoded GOP that stays on the device: a stream of
distinct frames of splats rendered in order, cycling, back to back.

Each render copies its frame's splats into the inputs of one
`utils.graphs.RenderGraph` of `models.represent.render_frame(...,
layout="chw")` (projection, K1, the sort, K2, K5, the clip), as the
drivers' fps loops do, and replays it; the window ends with one
synchronize. The stream's shapes and paths are the traffic's `scene_seed`'s;
the run's seed permutes its splats, draws their colours and the frame it
starts at (`scenes.reshuffled`), so every seed renders the same work. One
intersection budget serves the stream: the most intersections a frame of
it has, x `budget_slack`, in buckets of 8192.
The check: a sample of (frame, cycle) renders drawn from the seed keeps
its output; the reference renders those frames from the same splats.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import faults, scenes, work
from benchmark.reference import splats

# the faults this loop's cells can have: planted on any device, and those
# that only a card's run reaches
FAULTS = [faults.render_altered]
CARD_FAULTS = []
# the traffic's cut for the benchmark's CPU tests
TINY_TRAFFIC = {"frames": 6, "check_cycles": 2}


class State:
    """What set-up hands the window and the window hands the check."""


def _sizes(run) -> tuple:
    c = run.config
    return c["height"], c["width"], round(c["num_points"] * run.traffic["kept_share"])


def _samples(run) -> list:
    """(frame, cycle) of the renders whose output the check reads."""
    t = run.traffic
    g = scenes.generator(run.seed, 3, "cpu")
    frames = torch.randperm(t["frames"], generator=g)[:t["check_samples"]]
    cycles = torch.randint(0, t["check_cycles"], (t["check_samples"],), generator=g)
    return [(int(f), int(c)) for f, c in zip(frames, cycles)]


def budget_of(stream: dict, H: int, W: int, slack: float) -> int:
    """The stream's budget from the benchmark's own count of each frame's
    intersections (float32 projection)."""
    bound = splats.bound(stream["cholesky"])
    most = 0
    with torch.no_grad():
        for f in range(stream["xyz"].shape[0]):
            p = splats.project(torch.tanh(stream["xyz"][f]), stream["cholesky"][f] + bound,
                               H, W)
            most = max(most, int(p.nth.sum()))
    return splats.bucket_budget(most, slack)


def setup(run) -> State:
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import GaussianFrame
    from gsvc_tpu_torch.models import represent
    from gsvc_tpu_torch.utils import graphs

    H, W, n = _sizes(run)
    t = run.traffic
    st = State()
    st.stream = scenes.reshuffled(
        scenes.splat_stream(t["scene_seed"], t["frames"], n, run.device), run.seed, run.device)
    st.rgb_w = torch.ones((n, 1), device=run.device)
    st.alive = torch.ones((n,), dtype=torch.bool, device=run.device)
    st.budget = budget_of(st.stream, H, W, t["budget_slack"])
    st.cfg = FrameConfig(H=H, W=W, num_points=n, max_num_points=n, iterations=1,
                         backend=run.config["backend"], max_intersects=st.budget)
    frame = GaussianFrame(*(torch.zeros((n, k), device=run.device) for k in (2, 3, 3, 1)))
    frame.requires_grad_(False)
    alive = torch.zeros((n,), dtype=torch.bool, device=run.device)
    inputs = (frame.xyz, frame.cholesky, frame.features_dc, frame.rgb_w, alive)
    cfg = st.cfg
    st.graph = graphs.render_graph(
        lambda *_: represent.render_frame(frame, alive, cfg, layout="chw"), inputs, run.device)
    st.samples = _samples(run)
    st.kept = {}
    for f in range(min(3, t["frames"])):  # the eager render, the capture, a replay
        _render(st, f)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return st


def _render(st: State, f: int) -> torch.Tensor:
    s = st.stream
    st.graph.load(s["xyz"][f], s["cholesky"][f], s["features_dc"][f], st.rgb_w, st.alive)
    return st.graph()


def window(run, st: State) -> None:
    t = run.traffic
    frames = t["frames"]
    sample = set(st.samples)
    lo, hi = t["trace_renders"]
    k, traced_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        f, cycle = k % frames, k // frames
        if run.traced and k == lo:
            torch.cuda.synchronize()  # the renders queued so far are the untraced ones
            t1 = time.perf_counter()
            with run.trace.sample():
                for j in range(lo, hi):
                    _render(st, j % frames)
            traced_s = time.perf_counter() - t1
            k = hi
            continue
        out = _render(st, f)
        if (f, cycle) in sample:
            st.kept[(f, cycle)] = out.clone()
        k += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run.attempted, run.failed = k, 0
    run.e2e["render_fps"] = k / secs
    run.counters["frames"] = k
    untraced = k - (hi - lo if run.traced and k >= hi else 0)
    run.spans.add("frame", (secs - traced_s) / max(untraced, 1))


def trace_counts(run, st: State) -> None:
    if not run.traced:
        return
    H, W, _n = _sizes(run)
    s = st.stream
    bound = splats.bound(s["cholesky"])
    cs = [work.count(torch.tanh(s["xyz"][f]), s["cholesky"][f] + bound, H, W, st.budget)
          for f in range(s["xyz"].shape[0])]
    run.work["frame"] = work.Counts(*(sum(x) / len(cs) for x in zip(*cs)))


def free(st: State) -> None:
    st.graph.close()
    st.graph = None


def outputs(run, st: State) -> dict:
    return {key: st.kept.get(key) for key in st.samples}


def reference(run, st: State, dtype, control: bool = False) -> dict:
    H, W, _n = _sizes(run)
    s = st.stream
    out = {}
    with torch.no_grad():
        for f, c in st.samples:
            chol = s["cholesky"][f].to(dtype)
            img = splats.render_splats(torch.tanh(s["xyz"][f].to(dtype)), chol + splats.bound(chol),
                                       s["features_dc"][f].to(dtype), H, W, st.budget)
            out[(f, c)] = img.permute(2, 0, 1)
    return out


def compare(prog: dict, ref: dict) -> dict:
    worst = 0.0
    for key, want in ref.items():
        got = prog.get(key)
        if got is None:
            return {"render_max_abs": float("inf")}
        worst = max(worst, float((got.double() - want.double()).abs().max()))
    return {"render_max_abs": worst}

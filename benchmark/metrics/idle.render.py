"""The device's idle share of the render loop: 1 - the traced sample's
device-busy seconds a render (the union of its device intervals in
torch.profiler's trace of 3000 renders) over the untraced renders'
host-clock seconds a render."""


def read(run):
    lo, hi = run.traffic["trace_renders"]
    return None if run.trace is None else run.trace.idle_pct(hi - lo, run.spans.mean("frame"))

"""The device's idle share of the represent fit: 1 - the traced slice's
device-busy seconds a step over the untraced frames' represent seconds a
step. The slice, steps 1501-1800 of a P-frame's fit as one of the
program's `fit_frame_partial` slices, holds a fit's share of control
steps (one in 100), its warm-up steps, its capture and its replays; the
untraced seconds hold whole fits."""


def read(run):
    steps = run.counters.get("traced_steps")
    secs = run.spans.mean("represent")
    if run.trace is None or not steps or not secs:
        return None
    return run.trace.idle_pct(steps, secs / run.config["iterations"])

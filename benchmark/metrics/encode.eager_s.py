"""Device seconds a whole represent fit spends in its eager steps (control
steps) and in the StepGraph's warm-up steps: the device seconds of the
`fit.eager` and `fit.warmup` spans inside each of the window's whole
represent fits, a mean over those fits (`harness/program_spans.py` says
which spans those are)."""

from benchmark.harness import program_spans


def read(run):
    spans = program_spans.window(run) or []
    fits = program_spans.whole_fits(spans, "represent", run.config["iterations"])
    steps = program_spans.children(spans, fits, ("fit.eager", "fit.warmup"))
    if not steps or any(s.device_s is None for s in steps):
        return None
    return sum(s.device_s for s in steps) / len(fits)

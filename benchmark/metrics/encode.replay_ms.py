"""Device milliseconds a replayed represent step: the device seconds of
the `fit.replays` spans (each a run of consecutive graph replays between
two eager steps or host reads, timed by CUDA events recorded outside the
graph) over their replays, in the window's represent fits that run to
the config's last step: the whole fits and the last slices of the
checked and traced frames, so a window whose frames are all checked or
traced (50k) is read too (`harness/program_spans.py` says which spans
those are)."""

from benchmark.harness import program_spans


def read(run):
    spans = program_spans.window(run) or []
    fits = program_spans.fits_to_end(spans, "represent", run.config["iterations"])
    runs = [s for s in program_spans.children(spans, fits, ("fit.replays",))
            if s.device_s is not None and s.attrs and s.attrs.get("replays")]
    if not runs:
        return None
    return 1e3 * sum(s.device_s for s in runs) / sum(s.attrs["replays"] for s in runs)

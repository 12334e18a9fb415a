"""Host seconds a frame spends capturing CUDA graphs: the host seconds of
the `graph.capture` spans inside the window's represent and QAT fits that
run to the config's last step, over the frames those QAT fits coded. A
frame captures once in each: a whole fit, or the checked and traced
frames' last slice, which captures its own graph as a whole fit does (a
represent fit fitted again counts with its frame).
`harness/program_spans.py` says which spans those are."""

from benchmark.harness import program_spans


def read(run):
    spans = program_spans.window(run) or []
    rep = program_spans.fits_to_end(spans, "represent", run.config["iterations"])
    qat = program_spans.fits_to_end(spans, "qat", run.config["qat_iterations"])
    caps = program_spans.children(spans, rep + qat, ("graph.capture",))
    if not caps or not qat:
        return None
    return sum(s.host_s for s in caps) / len(qat)

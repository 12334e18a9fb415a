"""Seconds a frame of the represent fit: the benchmark's span around
`init_train_state`, `fit_frame` and the representation's extraction."""


def read(run):
    return run.spans.mean("represent")

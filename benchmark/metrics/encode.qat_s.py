"""Seconds a frame of QAT and coding: the benchmark's span around
`init_compress_state`, `fit_compress`, `measure_bits` and `encode_frame`."""


def read(run):
    return run.spans.mean("qat")

"""The eval render's share of the card's float32 peak: K5's per-pair
operations over the benchmark's mean count of the stream's frames, over
the window's seconds a frame, against 67 TFLOP/s."""

from benchmark.harness import work


def read(run):
    c = run.work.get("frame")
    secs = run.spans.mean("frame")
    if c is None or not secs:
        return None
    return 100.0 * work.forward_ops(c) / secs / work.PEAK_F32_OPS_PER_S

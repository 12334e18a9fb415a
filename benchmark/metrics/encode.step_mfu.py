"""The represent step's share of the card's float32 peak: the operations
a step needs (K4 rows' and K6's per-pair operations over the benchmark's
own count of pairs and gated pairs, the mean of the traced frame's splats
at the start and at the end of its fit) over the represent seconds a step
(the represent span / iterations), against 67 TFLOP/s."""

from benchmark.harness import work


def read(run):
    c = run.work.get("step")
    secs = run.spans.mean("represent")
    if c is None or not secs:
        return None
    ops = work.forward_ops(c) + work.backward_ops(c)
    return 100.0 * ops / (secs / run.config["iterations"]) / work.PEAK_F32_OPS_PER_S

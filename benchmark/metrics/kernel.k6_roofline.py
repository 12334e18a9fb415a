"""K6's share of its roofline: the least time the card could take for
the bytes and operations K6's function needs on the traced slice's splats
(the mean of the benchmark's counts at the slice's start and end) over
K6's mean device time in the slice's trace."""

from benchmark.harness import work


def read(run):
    c = run.work.get("slice")
    if c is None or run.trace is None:
        return None
    t = run.trace.kernel_mean_s(lambda name: "backward_kernel" in name)
    if not t:
        return None
    bound = work.roofline_s(work.backward_bytes(c, run.work["slice_budget"]),
                            work.backward_ops(c))
    return 100.0 * bound / t

"""K5's share of its roofline: the least time the card could take for
the bytes and operations the planar (chw) forward needs on the stream's
frames (the benchmark's mean count over them) over K5's mean device time
in the traced sample."""

from benchmark.harness import work


def read(run):
    c = run.work.get("frame")
    if c is None or run.trace is None:
        return None
    t = run.trace.kernel_mean_s(lambda name: "forward_kernel<1," in name)
    if not t:
        return None
    return 100.0 * work.roofline_s(work.forward_bytes(c, "chw"), work.forward_ops(c)) / t

"""The binning sort's share of its roofline: the least time to read and
write the traced slice's budget slots once, each at the narrowest key that
holds the tile and gauss fields of the benchmark's own grid and splat
capacity (`harness/work_keys.py`; 4 bytes in the 1080p and 3840x2160
cells), over the sort's device seconds a step in the slice (cub's
`DeviceRadixSort*` kernels over the slice's steps)."""

from benchmark.harness import work_keys
from benchmark.reference import splats


def read(run):
    steps = run.counters.get("traced_steps")
    slots = run.work.get("slice_budget")
    if run.trace is None or not steps or not slots:
        return None
    t = work_keys.kernel_seconds(run.trace, (work_keys.SORT,)) / steps
    if not t:
        return None
    c = run.config
    tb_x, tb_y = splats.grid(c["height"], c["width"])
    return 100.0 * work_keys.sort_roofline_s(slots, tb_x * tb_y, c["num_points"]) / t

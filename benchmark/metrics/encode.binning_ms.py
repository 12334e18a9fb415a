"""Device milliseconds a represent step spends binning: the traced slice's
device seconds in K1 (`fill_keys_kernel`), the radix sort of its keys
(cub's `DeviceRadixSort*` kernels, launched by `torch.sort`) and K2
(`rank_cap_kernel`), over the slice's steps (`harness/work_keys.py`
names them). Every step bins once; the slice's control steps (one in 100)
add their own small sort of the splats' weights. Which key width the
slice binned on is the program's `fit` span's `key_bytes` attribute,
where the program records it."""

from benchmark.harness import work_keys


def read(run):
    steps = run.counters.get("traced_steps")
    if run.trace is None or not steps:
        return None
    secs = work_keys.kernel_seconds(run.trace, (work_keys.K1, work_keys.SORT, work_keys.K2))
    return 1e3 * secs / steps if secs else None

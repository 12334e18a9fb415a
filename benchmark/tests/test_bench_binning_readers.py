"""The binning layer's readers (`encode.binning_ms`, `kernel.sort_roofline`)
on a hand-built trace of a traced slice: the kernels matched by the names
the profiler gives them (K1, cub's radix sort, K2), the sort's least work
from the benchmark's own grid and capacity (`harness/work_keys.py`), and
None where nothing was sampled."""

from __future__ import annotations

import types

import pytest
from conftest import ROOT

from benchmark.harness import work, work_keys
from benchmark.harness.core import Cell, metric_reader
from benchmark.harness.trace import DeviceTrace

CELLS = ["encode.gsvc-1080p-10k", "encode.gsvc-1080p-50k", "encode-uhd.gsvc-2160p-100k"]
STEPS = 300
# a traced slice's device operations as torch.profiler names them (4K UHD,
# int64 keys): 8 onesweep passes a step, a histogram, K1 and K2
NAMES = {
    "k1": "void (anonymous namespace)::fill_keys_kernel<long long>(int const*, int const*, "
          "int const*, int const*, int const*, int, int, int, long long, long long, "
          "long long*)",
    "onesweep": "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::"
                "cub::DeviceRadixSortPolicy<long, at::cuda::cub::detail::OpaqueType<8>, "
                "unsigned long long>::Policy900, false, long>(int*)",
    "histogram": "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<at_cuda_detail::"
                 "cub::DeviceRadixSortPolicy<long>::Policy900, false, long>(long const*)",
    "k2": "void (anonymous namespace)::rank_cap_kernel<long long>(long long const*, int, "
          "int, int, int, int, bool, int*, int*, int*)",
    "k6": "void gsvc_bwd::backward_kernel<2, 32, false, gsvc_bwd::Args>(gsvc_bwd::Args)",
}
SECS = {"k1": (STEPS, 1.8e-5), "onesweep": (8 * STEPS, 4.4e-5), "histogram": (STEPS, 1.7e-5),
        "k2": (STEPS, 1.8e-5), "k6": (STEPS, 6.0e-4)}


def _trace(parts=tuple(NAMES)) -> DeviceTrace:
    trace = DeviceTrace()
    for k in parts:
        count, secs = SECS[k]
        trace.kernels[NAMES[k]] = [secs] * count
    return trace


def _run(name: str, trace, steps=STEPS, budget=None):
    cell = Cell(name, ROOT)
    c = cell.config
    budget = budget or c["num_points"] * c["represent_budget_factor"]
    counters = {} if steps is None else {"traced_steps": steps}
    return types.SimpleNamespace(config=c, trace=trace, counters=counters,
                                 work={"slice_budget": budget})


def _sort_s() -> float:
    return sum(SECS[k][0] * SECS[k][1] for k in ("onesweep", "histogram"))


@pytest.mark.parametrize("name", CELLS)
def test_binning_ms_sums_k1_the_sort_and_k2(name):
    got = metric_reader("encode.binning_ms", ROOT)(_run(name, _trace()))
    want = 1e3 * (SECS["k1"][0] * SECS["k1"][1] + _sort_s()
                  + SECS["k2"][0] * SECS["k2"][1]) / STEPS
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_sort_roofline_is_the_least_time_over_the_sorts(name):
    run = _run(name, _trace())
    got = metric_reader("kernel.sort_roofline", ROOT)(run)
    budget = run.work["slice_budget"]
    bound = 2 * budget * 4 / work.PEAK_BYTES_PER_S  # 4-byte keys in every cell
    assert got == pytest.approx(100 * bound / (_sort_s() / STEPS), rel=1e-12)
    assert 0 < got < 100


def test_the_narrowest_key():
    assert work_keys.key_bytes(8160, 10000) == work_keys.key_bytes(8160, 50000) == 4
    assert work_keys.key_bytes(32400, 100000) == 4  # 15 + 17 bits
    assert work_keys.key_bytes(32400, 131072) == 4 and work_keys.key_bytes(32400, 131073) == 8
    assert work_keys.key_bits(16, 300) == 5 + 9 and work_keys.key_bytes(16, 300) == 2
    assert work_keys.sort_bytes(1000, 8160, 10000) == 8000


@pytest.mark.parametrize("metric", ["encode.binning_ms", "kernel.sort_roofline"])
def test_none_where_nothing_was_sampled(metric):
    read = metric_reader(metric, ROOT)
    name = CELLS[-1]
    assert read(_run(name, None)) is None  # an untraced run
    assert read(_run(name, _trace(), steps=None)) is None  # no slice traced
    assert read(_run(name, _trace(("k6",)))) is None  # a sample without binning
    assert read(_run(name, DeviceTrace())) is None  # an empty sample

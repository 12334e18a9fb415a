"""PyTorch port parity: gsvc_tpu_torch.utils.geometry against
gsvc_tpu.utils.geometry, and the driver-level profiling helpers (`trace`,
`time_fn`, `StepTimer`) against gsvc_tpu's.

Inputs are numpy arrays from a seed fed to both packages. Tolerances:
values rtol 1e-6 / atol 1e-6 (the same float32 formulas, by XLA and by
ATen), gradients rtol 1e-5 / atol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.utils import geometry as jgeo
from gsvc_tpu.utils import profiling as jprof
from gsvc_tpu_torch.utils import geometry, profiling

VAL = dict(rtol=1e-6, atol=1e-6)


def _inputs(name, rng):
    n = 17
    if name in ("strip_lowerdiag", "strip_symmetric"):
        return [rng.normal(size=(n, 3, 3))], [rng.normal(size=(n, 2, 2))]
    if name == "build_rotation":
        return [rng.normal(size=(n, 4))],
    if name == "build_scaling_rotation":
        return [rng.uniform(0.1, 2, (n, 3)), rng.normal(size=(n, 4))],
    if name == "build_rotation_2d":
        return [rng.uniform(-4, 4, (n, 1))],
    if name == "build_scaling_rotation_2d":
        return [rng.uniform(0.1, 2, (n, 2)), rng.uniform(-4, 4, (n, 1))],
    if name == "build_covariance_from_scaling_rotation_2d":
        return [rng.uniform(0.1, 2, (n, 2)), 1.7, rng.uniform(-4, 4, (n, 1))],
    return [rng.normal(size=(n, 3))],  # build_triangular, build_covariance_from_cholesky


NAMES = ["strip_lowerdiag", "strip_symmetric", "build_rotation", "build_scaling_rotation",
         "build_rotation_2d", "build_scaling_rotation_2d",
         "build_covariance_from_scaling_rotation_2d", "build_triangular",
         "build_covariance_from_cholesky"]


@pytest.mark.parametrize("name", NAMES)
def test_geometry_matches_jax(name):
    rng = np.random.default_rng(NAMES.index(name))
    for args in _inputs(name, rng):
        args = [a.astype(np.float32) if isinstance(a, np.ndarray) else a for a in args]
        j = getattr(jgeo, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                  for a in args))
        t = getattr(geometry, name)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a
                                      for a in args))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **VAL)
        # gradients of a random projection of the output, in every array argument
        arr = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
        w = rng.normal(size=np.asarray(j).shape).astype(np.float32)

        def jf(*xs):
            full = list(args)
            for i, x in zip(arr, xs):
                full[i] = x
            return jnp.sum(getattr(jgeo, name)(*full) * w)

        jg = jax.grad(jf, argnums=tuple(range(len(arr))))(*(jnp.asarray(args[i]) for i in arr))
        targs = [torch.tensor(a, requires_grad=True) if isinstance(a, np.ndarray) else a
                 for a in args]
        out = torch.sum(getattr(geometry, name)(*targs) * torch.tensor(w))
        tg = torch.autograd.grad(out, [targs[i] for i in arr])
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_strip_lowerdiag_rejects_other_sizes():
    with pytest.raises(ValueError):
        geometry.strip_lowerdiag(torch.zeros(2, 4, 4))


def test_step_timer_report_matches_gsvc_tpu():
    mine, theirs = profiling.StepTimer(), jprof.StepTimer()
    for timer in (mine, theirs):
        with timer("fit"):
            pass
        with timer("eval", sync=torch.ones(2) if timer is mine else jnp.ones(2)):
            pass
        with timer("fit"):
            pass
    assert mine.counts == theirs.counts == {"fit": 2, "eval": 1}
    theirs.totals = dict(mine.totals)
    assert mine.report() == theirs.report()
    assert mine.report().splitlines()[1].startswith("fit: total ")


def test_time_fn_calls_and_times():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    for every in (True, False):
        calls.clear()
        secs = profiling.time_fn(fn, torch.ones(3), iters=5, warmup=2, block_every_call=every)
        assert len(calls) == 7 and secs >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "tb").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)

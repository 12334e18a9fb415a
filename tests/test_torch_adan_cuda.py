"""Adan's update on the card (gsvc_tpu_torch/optim/adan_cuda.py, csrc/adan.cu):
what of it runs on the CPU.

- `check_inputs` refuses what the kernel does not take (a dtype, a device,
  a layout, a shape, a leaf count, the step's scalars), on CPU tensors;
- `leaf_table` splits both leaf sets (represent [N,2], [N,3], [N,3], [N,1];
  QAT [N,2], [N,3], [N,3], [3], [3]) into units of at most 4 elements of one
  leaf that cover every element once, read as the kernel reads them;
- `adan_step_` on CPU tensors takes the plain path (no launch counted), whose
  results equal the update rule in numpy float32 bitwise, op for op;
- `adan_step_` on the card counts its launch as the recorder's
  `launches.adan_update`, which `utils.graphs.launch_counts` reads as
  "adan_update" (on tensors that claim the card, the kernel's library,
  stream and SM count stubbed), and on CPU tensors none.

The kernel against the plain version on CUDA tensors is in
tests/test_torch_kernels.py (marker `cuda`).
"""

import contextlib

import numpy as np
import pytest
import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch.optim import adan, adan_cuda
from gsvc_tpu_torch.utils import graphs

REPRESENT = lambda n: [(n, 2), (n, 3), (n, 3), (n, 1)]  # noqa: E731
QAT = lambda n: [(n, 2), (n, 3), (n, 3), (3,), (3,)]  # noqa: E731
BETAS = (0.98, 0.92, 0.99)


def _launches(name: str) -> int:
    return graphs.launch_counts().get(name, 0)


def _leaves(shapes, seed=0):
    """[(p, g, m, n, d, -g_prev)] a leaf of random float32 CPU tensors."""
    rng = np.random.default_rng(seed)

    def t(s, scale=1.0, positive=False):
        a = rng.normal(size=s) * scale
        return torch.tensor(np.abs(a) if positive else a, dtype=torch.float32)

    return [(t(s), t(s, 1e-2), t(s, 1e-3), t(s, 1e-5, True), t(s, 1e-4), t(s, 1e-2))
            for s in shapes]


def _step_inputs(device="cpu"):
    table = torch.tensor(adan.adan_table([(1, 1e-3), (2, 1e-3)], BETAS, device=device))
    return (table, torch.tensor(1, dtype=torch.int64), torch.tensor(True),
            torch.tensor(0.5, dtype=torch.float32))


def test_check_inputs_takes_both_leaf_sets():
    for shapes in (REPRESENT(7), QAT(7), REPRESENT(0)):
        adan_cuda.check_inputs(_leaves(shapes), *_step_inputs(), "cpu")
    table, row, fresh, _clip = _step_inputs()
    adan_cuda.check_inputs(_leaves(QAT(5)), table, row, fresh, None, "cpu")


def _swap(leaves, i, j, t):
    leaves = [list(x) for x in leaves]
    leaves[i][j] = t
    return leaves


REFUSALS = {
    "dtype": (lambda L, s: (_swap(L, 1, 1, L[1][1].double()), *s), "float32"),
    "device": (lambda L, s: (_swap(L, 2, 3, torch.empty((7, 3), device="meta")), *s),
               "on cpu"),
    "layout": (lambda L, s: (_swap(L, 2, 0, torch.zeros((3, 7)).t()), *s), "contiguous"),
    "shape": (lambda L, s: (_swap(L, 0, 2, torch.zeros((7, 3))), *s), r"\(7, 2\)"),
    "too many leaves": (lambda L, s: (L + _leaves(REPRESENT(3)) * 2, *s), "1 to 8"),
    "no leaf": (lambda L, s: ([], *s), "1 to 8"),
    "five tensors": (lambda L, s: ([x[:5] for x in L], *s), "6"),
    "table columns": (lambda L, s: (L, s[0][:, :4].contiguous(), *s[1:]), r"\[R, 5\]"),
    "table dtype": (lambda L, s: (L, s[0].double(), *s[1:]), "table"),
    "row dtype": (lambda L, s: (L, s[0], s[1].int(), *s[2:]), "row"),
    "row values": (lambda L, s: (L, s[0], torch.zeros(2, dtype=torch.int64), *s[2:]),
                   "one value"),
    "fresh dtype": (lambda L, s: (L, *s[:2], s[2].float(), s[3]), "fresh"),
    "clip dtype": (lambda L, s: (L, *s[:3], s[3].double()), "clip"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_inputs_refuses(case):
    make, match = REFUSALS[case]
    args = make(_leaves(REPRESENT(7)), _step_inputs())
    with pytest.raises(ValueError, match=match):
        adan_cuda.check_inputs(*args, "cpu")


def test_adan_update_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        adan_cuda.adan_update(_leaves(REPRESENT(7)), *_step_inputs(), BETAS, 1e-8, False)


@pytest.mark.parametrize("leaf_set", [REPRESENT, QAT])
@pytest.mark.parametrize("n", [0, 1, 777, 10_000, 50_000])
def test_leaf_table_covers_every_element_once(leaf_set, n):
    """Each unit, read as the kernel reads it (the last leaf whose first
    unit is at or below it; elements from 4 x its rank there), holds 1 to 4
    elements of one leaf, and a leaf's units hold its elements in order,
    each once."""
    counts = [int(np.prod(s)) for s in leaf_set(n)]
    firsts, units = adan_cuda.leaf_table(counts)
    assert len(firsts) == len(counts) and firsts[0] == 0
    assert units == sum(-(-c // adan_cuda.VEC) for c in counts)
    u = np.arange(units)
    leaf = np.searchsorted(np.asarray(firsts), u, side="right") - 1
    start = (u - np.asarray(firsts)[leaf]) * adan_cuda.VEC
    size = np.minimum(adan_cuda.VEC, np.asarray(counts)[leaf] - start)
    assert (size >= 1).all()
    for i, c in enumerate(counts):
        mine = leaf == i
        assert size[mine].sum() == c
        assert np.array_equal(start[mine], np.arange(0, c, adan_cuda.VEC))


def test_leaf_table_of_the_represent_set_at_777():
    counts = [int(np.prod(s)) for s in REPRESENT(777)]  # 1554, 2331, 2331, 777
    assert adan_cuda.leaf_table(counts) == ((0, 389, 972, 1555), 1750)
    assert adan_cuda.leaf_table([0, 0, 0, 0, 3, 3]) == ((0, 0, 0, 0, 0, 1), 2)


def _numpy_update(leaf, row, fresh, clip, eps, no_prox):
    """The update rule of optim/adan.py in numpy float32, each operation
    rounded once in `_update`'s order, a CPU table row (divisors, not
    reciprocals)."""
    f32 = np.float32
    b1, b2, b3 = BETAS
    p, g, m, n, d, npg = (t.numpy() for t in leaf)
    ss, ssd, bc3, decay, shrink = (f32(x) for x in row)
    if clip is not None:
        g = g * f32(clip)
    diff = (-g if fresh else npg) + g
    m_t = f32(b1) * m + f32(1.0 - b1) * g
    d_t = f32(b2) * d + f32(1.0 - b2) * diff
    u = g + f32(b2) * diff
    n_t = f32(b3) * n + f32(1.0 - b3) * u * u
    denom = np.sqrt(n_t) / bc3 + f32(eps)
    if no_prox:
        q = p * shrink - ss * m_t / denom - ssd * d_t / denom
    else:
        q = (p - ss * m_t / denom - ssd * d_t / denom) / decay
    return q, m_t, n_t, d_t, -g


@pytest.mark.parametrize("leaf_set", [REPRESENT, QAT])
@pytest.mark.parametrize("fresh,max_grad_norm,weight_decay,no_prox", [
    (True, 0.0, 0.0, False), (False, 0.0, 0.0, False), (False, 0.05, 0.02, False),
    (False, 0.0, 0.02, True)])
def test_adan_step_on_cpu_is_the_plain_update(leaf_set, fresh, max_grad_norm, weight_decay,
                                              no_prox):
    leaves = _leaves(leaf_set(9), seed=3)
    names = [f"leaf{i}" for i in range(len(leaves))]
    # the features' gradient as autograd hands it over: transposed
    leaves[2] = (leaves[2][0], leaves[2][1].t().contiguous().t(), *leaves[2][2:])
    table = torch.tensor(adan.adan_table([(6, 2e-3), (7, 1e-3), (8, 1e-3)], BETAS,
                                         weight_decay, "cpu"))
    row = torch.tensor(1, dtype=torch.int64)
    grads = {k: leaf[1] for k, leaf in zip(names, leaves)}
    clip = adan._clip_factor(grads, 1e-8, max_grad_norm)
    want = [_numpy_update(leaf, table[1].numpy(), fresh, clip, 1e-8, no_prox)
            for leaf in leaves]
    params = {k: leaf[0].clone() for k, leaf in zip(names, leaves)}
    state = adan.AdanState(
        step=6, fresh={k: fresh for k in names},
        **{f: {k: leaf[j].clone() for k, leaf in zip(names, leaves)}
           for j, f in enumerate(("exp_avg", "exp_avg_sq", "exp_avg_diff",
                                  "neg_pre_grad"), start=2)})
    flag = torch.tensor(fresh)
    before = _launches("adan_update")
    out = adan.adan_step_(params, grads, state, table, row, flag, betas=BETAS, eps=1e-8,
                          max_grad_norm=max_grad_norm, no_prox=no_prox)
    assert _launches("adan_update") == before == 0
    assert out.step == 7 and out.fresh == {k: False for k in names} and not bool(flag)
    for i, k in enumerate(names):
        got = (params[k], state.exp_avg[k], state.exp_avg_sq[k], state.exp_avg_diff[k],
               state.neg_pre_grad[k])
        for name, a, b in zip(("p", "m", "n", "d", "-g"), got, want[i]):
            assert np.array_equal(a.numpy(), b), (k, name)


class _Claimed(torch.Tensor):
    """A CPU tensor that says it is on the card: `adan_step_` takes the
    kernel's path with it."""

    is_cuda = property(lambda self: True)
    device = property(lambda self: torch.device("cuda"))


def test_launch_counts_name_the_adan_update(monkeypatch):
    """A step on the card launches Adan's kernel once, counted as
    `launch_counts()["adan_update"]`; a step on CPU tensors (the plain path)
    counts none. No card here: the tensors claim it, and the kernel's
    library, the stream and the SM count are stubbed."""
    calls = []

    class Lib:  # adan.cu's entry: records its call, returns no error
        def adan_update(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(adan_cuda, "_adan_lib", Lib)
    monkeypatch.setattr(adan_cuda, "sm_count", lambda dev: 1)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    names = ("xyz", "cholesky", "features_dc", "rgb_w")
    for on_card in (True, False):
        def put(t):
            return t.as_subclass(_Claimed) if on_card else t

        leaves = [[put(t) for t in leaf] for leaf in _leaves(REPRESENT(5))]
        table, row, fresh, _clip = (put(t) for t in _step_inputs())
        state = adan.AdanState(
            step=6, fresh={k: False for k in names},
            **{f: {k: leaf[j] for k, leaf in zip(names, leaves)}
               for j, f in enumerate(("exp_avg", "exp_avg_sq", "exp_avg_diff",
                                      "neg_pre_grad"), start=2)})
        before = _launches("adan_update")
        adan.adan_step_({k: leaf[0] for k, leaf in zip(names, leaves)},
                        {k: leaf[1] for k, leaf in zip(names, leaves)}, state, table, row,
                        fresh, betas=BETAS)
        assert _launches("adan_update") - before == int(on_card)
        assert len(calls) == 1

"""The rows loss E1 (gsvc_tpu_torch/ops/loss_cuda.py, csrc/rows_loss.cu): what
of it runs on the CPU.

- its plain version (`rows_loss_torch`, the explicit formula) against
  autograd of the chain it replaces (the background blend of
  `rasterize_gaussians_sum`'s rows layout, `_clip01`, the masked
  difference, its square or absolute value, the sum): the gradient
  `grad * gd` and the sums bitwise, for L2 and L1, on rows holding values
  exactly 0, exactly 1, below 0 and above 1 (the clip's tie halves), with
  the kept total 0, 1 and more, a `valid_h` mask and a tile-row span;
- `rasterize_rows_loss` on the "cuda" backend (the kernel wrappers' plain
  versions on CPU tensors): its per-splat gradients and sums bitwise those
  of autograd through `rasterize_gaussians_sum` and the chain, over the
  whole grid and a ragged tile-row span;
- a represent step with the L1 rows loss against gsvc_tpu (the L2 step and
  the QAT step: tests/test_torch_train.py, tests/test_torch_compress.py);
- `rows_loss` on CPU tensors takes the plain version and counts no launch;
  `check_inputs` refuses what the kernel does not take; on the card it
  counts its launch as the recorder's `launches.rows_loss`, which
  `utils.graphs.launch_counts` reads as "rows_loss" (on rows that claim
  the card, the kernel's library, stream and SM count stubbed).

E1 against its plain version on the card: tests/test_torch_kernels.py
(marker `cuda`).
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.config import FrameConfig as JConfig
from gsvc_tpu.models import represent as jrep
from gsvc_tpu_torch import _build
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import train_state_from_numpy
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.models.represent import make_rows_target
from gsvc_tpu_torch.ops import loss_cuda
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import _clip01, rasterize_gaussians_sum, rasterize_rows_loss
from gsvc_tpu_torch.utils import graphs

H, W = 40, 56  # 3 x 4 tiles: a partial tile row and column, 3 * 4 = 12 -> 16 block rows
DENOM = 6220800  # a 1080p frame's H * W * 3: the loss's divisor in a fit


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _chain(raw, gt_rows, mask, total, l1):
    """The chain E1 replaces, as the fits ran it (the rows render's blend
    on the default background, written out): (loss, sq, dL/d(raw)) of
    loss / DENOM by autograd."""
    r = raw.clone().requires_grad_()
    live = (total >= 1).to(r.dtype)
    bg = torch.ones(3)[torch.arange(r.shape[0]) % 3][:, None]
    diff = (_clip01(r * live + bg * (1.0 - live)) - gt_rows) * mask
    sq = torch.sum(diff * diff)
    loss = torch.sum(torch.abs(diff)) if l1 else sq
    (grad,) = torch.autograd.grad(loss / DENOM, r)
    return loss.detach(), sq.detach(), grad


def _rows_case(seed, h=H, valid_h=None, span_rows=None):
    """(raw, gt_rows, mask) of a rows target of an [h, W] image (its first
    `span_rows` block rows' worth when given), raw and the target holding
    the clip's bounds and ties: exact 0 and 1, below 0, above 1, and
    differences of exactly 0."""
    g = torch.Generator().manual_seed(seed)
    cfg = FrameConfig(H=h, W=W, num_points=1, max_num_points=1, iterations=1)
    gt_rows, mask = make_rows_target(torch.rand((h, W, 3), generator=g), cfg, valid_h)
    if span_rows is not None:
        gt_rows, mask = gt_rows[:span_rows].clone(), mask[:span_rows].clone()
    raw = torch.rand(gt_rows.shape, generator=g) * 1.6 - 0.3
    raw[:, :6] = torch.tensor([0.0, 1.0, -0.25, 1.25, 0.0, 1.0])
    gt_rows[:, 4:6] = torch.tensor([0.0, 1.0])  # out == gt at the bounds
    raw[::5, 10:14] = gt_rows[::5, 10:14]  # out == gt inside
    return raw, gt_rows, mask


CASES = {
    "grid": dict(),
    "valid_h": dict(h=48, valid_h=37),  # rows past 37 masked, as a ragged shard's
    "span": dict(h=48, valid_h=45, span_rows=32),  # the first 2 of 3 tile rows' blocks
}


@pytest.mark.parametrize("l1", [False, True])
@pytest.mark.parametrize("total", [0, 1, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_the_chain_bitwise(l1, total, case):
    raw, gt_rows, mask = _rows_case(3, **CASES[case])
    kept = torch.tensor(total, dtype=torch.int32)
    loss, sq, grad = _chain(raw, gt_rows, mask, kept, l1)
    gd, got_loss, got_sq = loss_cuda.rows_loss_torch(raw, gt_rows, mask, kept, l1)
    s = torch.tensor(1.0 / DENOM)  # the loss's gradient, as autograd hands it back
    assert torch.equal(_bits(s * gd), _bits(grad))
    assert torch.equal(_bits(got_loss), _bits(loss)) and torch.equal(_bits(got_sq), _bits(sq))
    assert float(sq) > 0 and bool(grad.any()) == bool(total)  # no splat: a constant image
    if total:  # columns 0-3 hold 0, 1 (the ties: half), -0.25 and 1.25 (zero)
        m = mask[:, :4] != 0
        assert not grad[:, 2:4][m[:, 2:4]].any()
        d = (raw[:, :2].clamp(0.0, 1.0) - gt_rows[:, :2]) * mask[:, :2]
        full = torch.sign(d) * mask[:, :2] if l1 else 2.0 * d
        assert torch.equal(grad[:, :2], s * full * 0.5) and grad[:, :2].any()


@pytest.mark.parametrize("l1", [False, True])
def test_autograd_function_saves_gd_and_returns_grad_times_gd(l1):
    raw, gt_rows, mask = _rows_case(5)
    kept = torch.tensor(3, dtype=torch.int32)
    r = raw.clone().requires_grad_()
    loss, sq = loss_cuda.RowsLoss.apply(r, gt_rows, mask, kept, l1)
    assert loss.requires_grad and not sq.requires_grad
    (grad,) = torch.autograd.grad(loss / DENOM, r)
    want_loss, want_sq, want = _chain(raw, gt_rows, mask, kept, l1)
    assert torch.equal(_bits(grad), _bits(want))
    assert torch.equal(loss.detach(), want_loss) and torch.equal(sq, want_sq)


def _splats(n, seed):
    """The leaves of n splats (means, cholesky, colours up to 1.4, so that
    sums pass the clip), requiring grad."""
    g = torch.Generator().manual_seed(seed)
    means = torch.rand((n, 2), generator=g) * 1.9 - 0.95
    chol = torch.stack([torch.rand(n, generator=g) * 3 + 1, torch.randn(n, generator=g),
                        torch.rand(n, generator=g) * 3 + 1], 1)
    colors = torch.rand((n, 3), generator=g) * 1.4
    return [t.requires_grad_() for t in (means, chol, colors)]


def _render_args(leaves, h, w):
    means, chol, colors = leaves
    tb = ((w + 15) // 16, (h + 15) // 16, 1)
    xys, depths, radii, conics, nth = project_gaussians_2d(means, chol, h, w, tb)
    opacity = torch.ones((means.shape[0], 1))
    return (xys, depths, radii, conics, nth, colors, opacity, h, w)


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
@pytest.mark.parametrize("tile_rows,valid_h", [(None, None), ((2, 2), 24)])
def test_rasterize_rows_loss_gradients_are_the_chains(loss_type, tile_rows, valid_h):
    h, w, n = 56, 72, 90  # 3.5 x 4.5 tiles; the span: tile rows 2-3, pixel rows 24+ past h
    g = torch.Generator().manual_seed(7)
    cfg = FrameConfig(H=h, W=w, num_points=n, max_num_points=n, iterations=1)
    span_h = h if tile_rows is None else 16 * tile_rows[1]
    row0 = 0 if tile_rows is None else 16 * tile_rows[0]
    gt = torch.rand((h + 16, w, 3), generator=g)[row0:row0 + span_h]
    gt_rows, mask = make_rows_target(gt, cfg, valid_h)
    kw = dict(backend="cuda", max_intersects=4096, tile_rows=tile_rows)
    leaves = _splats(n, 1)
    rows = rasterize_gaussians_sum(*_render_args(leaves, h, w), layout="rows", **kw)
    diff = (_clip01(rows) - gt_rows) * mask
    sq = torch.sum(diff * diff)
    loss = sq if loss_type == "L2" else torch.sum(torch.abs(diff))
    want = torch.autograd.grad(loss / DENOM, leaves)
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    got_loss, got_sq = rasterize_rows_loss(*_render_args(leaves2, h, w), gt_rows, mask,
                                           loss_type=loss_type, **kw)
    got = torch.autograd.grad(got_loss / DENOM, leaves2)
    assert torch.equal(got_loss.detach(), loss.detach()) and torch.equal(got_sq, sq.detach())
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b)) and float(b.abs().max()) > 0


def test_rasterize_rows_loss_refuses_other_losses():
    leaves = _splats(4, 0)
    gt_rows, mask = make_rows_target(torch.zeros((H, W, 3)), FrameConfig(
        H=H, W=W, num_points=4, max_num_points=4, iterations=1))
    with pytest.raises(ValueError, match="L2 or L1"):
        rasterize_rows_loss(*_render_args(leaves, H, W), gt_rows, mask, loss_type="SSIM")


def test_represent_l1_step_matches_jax():
    """One represent step's loss, squared error and gradients with the L1
    rows loss ("cuda" on CPU tensors: K4 rows, E1, K6, K3 as plain
    versions) against gsvc_tpu's image loss on its binned backend (its rows
    loss takes the Pallas backend)."""
    kw = dict(H=48, W=64, num_points=200, max_num_points=240, iterations=50, loss_type="L1")
    jcfg, cfg = JConfig(**kw, backend="binned"), FrameConfig(**kw, backend="cuda")
    jstate = jrep.init_train_state(jax.random.PRNGKey(2), jcfg)
    gt = np.random.default_rng(3).uniform(0, 1, (48, 64, 3)).astype(np.float32)

    def f(tr, alive, gt):
        return jrep._loss_and_psnr(jrep._from_trainable(tr), alive, gt, jcfg, 0.0)

    (jloss, (jsq, _)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jrep._trainable(jstate.params), jstate.alive, jnp.asarray(gt))
    state = train_state_from_numpy(jstate)
    tgt = torch.from_numpy(gt)
    loss, sq, grads = rep._loss_and_grads(state, tgt, cfg, 0.0, rep.make_rows_target(tgt, cfg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-5)
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        assert np.abs(want).max() > 0, name
        assert np.abs(g.numpy() - want).max() <= 1e-3 * np.abs(want).max() + 1e-12, name


def _launches(name: str) -> int:
    return graphs.launch_counts().get(name, 0)


def test_rows_loss_on_cpu_tensors_is_the_plain_version():
    raw, gt_rows, mask = _rows_case(9)
    kept = torch.tensor(1, dtype=torch.int32)
    before = _launches("rows_loss")
    got = loss_cuda.rows_loss(raw, gt_rows, mask, kept, True)
    want = loss_cuda.rows_loss_torch(raw, gt_rows, mask, kept, True)
    assert _launches("rows_loss") == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_check_inputs_refuses_what_the_kernel_does_not_take():
    raw, gt_rows, mask = _rows_case(1)
    kept = torch.tensor(1, dtype=torch.int32)
    loss_cuda.check_inputs(raw, gt_rows, mask, kept)
    flat = torch.zeros(raw.numel() + 1)
    misaligned = flat[1:].view(raw.shape)
    bad = [
        (raw.double(), gt_rows, mask, kept),  # dtype
        (raw, gt_rows[:-1], mask, kept),  # shape
        (raw, gt_rows, mask.t().contiguous().t(), kept),  # layout
        (raw, misaligned, mask, kept),  # 16-byte alignment
        (raw[:, :6].contiguous(), gt_rows[:, :6].contiguous(), mask[:, :6].contiguous(),
         kept),  # columns not a multiple of 4
        (raw, gt_rows, mask, kept.long()),  # the total's dtype
        (raw, gt_rows, mask, torch.ones(2, dtype=torch.int32)),  # the total's size
    ]
    for args in bad:
        with pytest.raises(ValueError, match="rows_loss"):
            loss_cuda.check_inputs(*args)


class _Claimed(torch.Tensor):
    """A CPU tensor that says it is on the card: `rows_loss` takes E1's
    path with it."""

    is_cuda = property(lambda self: True)


def test_launch_counts_name_the_rows_loss(monkeypatch):
    """`rows_loss` on the card launches E1 once, counted as
    `launch_counts()["rows_loss"]`; on CPU tensors (the plain version) it
    counts none. No card here: the rows claim it, and E1's library, the
    stream and the SM count are stubbed."""
    calls = []

    class Lib:  # rows_loss.cu's entry: records its call, returns no error
        def rows_loss(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(loss_cuda, "_rows_loss_lib", Lib)
    monkeypatch.setattr(loss_cuda, "sm_count", lambda dev: 1)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    kept = torch.tensor(1, dtype=torch.int32)
    for on_card in (True, False):
        rows = _rows_case(4)
        if on_card:
            rows = [t.as_subclass(_Claimed) for t in rows]
        before = _launches("rows_loss")
        loss_cuda.rows_loss(*rows, kept)
        assert _launches("rows_loss") - before == int(on_card)
    assert len(calls) == 1


def test_threads_constant_is_the_kernels():
    """`THREADS`, by which the wrapper sizes E1's grid, is the CTA size
    rows_loss.cu launches."""
    src = Path(loss_cuda.__file__).parents[1] / "csrc" / "rows_loss.cu"
    assert f"constexpr int kThreads = {loss_cuda.THREADS};" in src.read_text()

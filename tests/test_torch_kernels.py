"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: every test skips without a CUDA device (a kernel has no
CPU mode). On the card they build csrc/ with nvcc on first use. Run them
with `python -m pytest tests/test_torch_kernels.py -m cuda` on a GPU
machine; `python3 chip_smoke.py` does the same at 1080p/10k.

Tolerances: K1/K2 exact (integer index work), at int32 and int64 keys,
with a 16-bit gauss field and a 17-bit one (70,000 splats at 1080p and at
4080x2080, `fill_cuda.key_layout`), K2's three outputs (tile ids, gauss
ids, tile edges) also bitwise across two launches and one kernel launch a
call (the host's launch records; every device record K2's kernel); the
forward kernel atol 1e-5 against the plain render (f32 sums in another order); the rows store
exactly `image_to_rows` of the image store (the same sums); two launches
of a kernel on the same inputs bitwise equal (a fixed order, no float
atomics); K6's per-slot
grads, K3's scan and the autograd function's per-splat grads within 1e-4
of each tensor's largest entry (f32 sums over up to 256 pixels, or a
segment, in another order); K3 at S from 1 to ~800,000 with 1 to 32 rows,
with dense flags, sparse ones whose segments cross several CTAs' spans,
and none on lane 0, on both load paths. The profiling harnesses' kernels
(gsvc_tpu_torch/scripts), at a small size and at 1080p/10k: P1's K4
variants max-abs 1e-4 and within 1e-4 of the plain version's largest
entry (no_acc's outputs are ~1e-5) against their plain versions, P5's
job-based C and D and K6's pixel splits F and G within 1e-4 of K6's
largest slot, P6's transposes exactly (each of its tile shapes, rows not
a multiple of 4 and an input that is not 16-byte aligned). Adan's update
(csrc/adan.cu, one launch for every leaf of a step) bitwise `_update` on
the same CUDA tensors, for the represent and QAT leaf sets at 0 to 50,000
splats, odd and misaligned leaves, fresh or not, a clip, no_prox, and as
a CUDA graph replayed across table rows. K4 / K5 with the eval render's
epilogue (the background blend and the clamp in the store) bitwise the
chain they fold, grid and span, no kept intersection, NaN colours; an eval
render one launch of them. The rows loss E1 (csrc/rows_loss.cu)
at 1080p's rows, 4K UHD's and a ragged tile-row span, L2 and L1, the kept
total 0, 1 and more: its gradient bitwise its plain version's, its sums
within 1e-6 relative, two launches bitwise equal; the per-splat gradients
through it bitwise autograd's through the chain it replaced; one launch a
step in replayed represent and QAT fits.

The scene "capped" (1,500 big splats on 64x64) puts more than the cap of
256 lanes on every tile, where the kernels' staged lanes fill their
shared buffers and K6 must leave the capped lanes' slots exactly 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians, default_max_intersects, key_inputs
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import image_to_rows, rasterize_gaussians_sum
from gsvc_tpu_torch.optim import adan, adan_cuda
from gsvc_tpu_torch.scripts.common import synthetic_key_inputs
from gsvc_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda


def _launches(name: str) -> int:
    return graphs.launch_counts().get(name, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _scene(dev, n, H, W, seed, big=False):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2))
    L = rng.uniform(0, 2, (n, 3)) + np.array([0.5, 0.0, 0.5])
    if big:
        L[:] = [8.0, 0.0, 8.0]
    colors = rng.uniform(0, 1, (n, 3)) / (32.0 if big else 1.0)
    opacity = rng.uniform(0.2, 1.0, (n, 1))
    t = [torch.as_tensor(a, dtype=torch.float32, device=dev)
         for a in (means, L, colors, opacity)]
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    return tb, t, project_gaussians_2d(t[0], t[1], H, W, tb)


_CAPPED = (1500, (64, 64), 6, 32768, 256, True)


@pytest.mark.parametrize("n,hw,seed,budget,cap,big", [
    (500, (37, 83), 0, 16384, 256, False), (100, (48, 64), 3, 64, 256, False),
    (400, (40, 56), 2, 8192, 256, True), (120, (32, 32), 4, 4096, 4, False),
    _CAPPED,
])
def test_kernels_match_plain_versions(dev, n, hw, seed, budget, cap, big):
    H, W = hw
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(
        dev, n, H, W, seed, big)
    ki = key_inputs(xys, radii, nth, tb, 16, 16, budget)
    launches = _launches("fill_decode_keys")
    keys = fill_cuda.fill_decode_keys(*ki.k1)
    assert _launches("fill_decode_keys") == launches + 1
    assert torch.equal(keys, fill_cuda.fill_decode_keys_torch(*ki.k1))
    skeys = torch.sort(keys).values
    got = fill_cuda.rank_cap_decode(skeys, cap, n, ki.num_tiles)
    want = fill_cuda.rank_cap_decode_torch(skeys, cap, n, ki.num_tiles)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap)
    plain = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap, kernels=False)
    for name in binned._fields:
        assert torch.equal(getattr(binned, name), getattr(plain, name)), name
    if (n, hw) == _CAPPED[:2]:
        assert int(binned.tile_counts.min()) > cap and int(binned.overflow) == 0
    args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, cap)
    ref = rasterize_cuda.rasterize_forward_torch(*args)
    img = rasterize_cuda.forward_image(*args)
    chw = rasterize_cuda.forward_chw(*args)
    rows = rasterize_cuda.forward_rows(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(chw, ref.permute(2, 0, 1), rtol=0, atol=1e-5)
    assert torch.equal(rows, image_to_rows(img, H, W))
    for store, out in (("image", img), ("chw", chw), ("rows", rows)):
        assert torch.equal(rasterize_cuda.FORWARD[store](*args), out), store


def _check_k1_k2(ki, cap=256):
    """K1 and K2 against their plain versions, exactly, on K1's inputs; K2
    at both key widths, one launch a call, two launches bitwise equal."""
    keys = fill_cuda.fill_decode_keys(*ki.k1)
    torch.cuda.synchronize()
    n = ki.starts.shape[0]
    assert keys.dtype == fill_cuda.key_layout(ki.num_tiles, n).dtype
    assert torch.equal(keys, fill_cuda.fill_decode_keys_torch(*ki.k1))
    skeys = torch.sort(keys).values
    want = fill_cuda.rank_cap_decode_torch(skeys, cap, n, ki.num_tiles)
    for k in (skeys, skeys.to(torch.int64)):  # K2 reads keys of either width
        before = _launches("rank_cap_decode")
        got = fill_cuda.rank_cap_decode(k, cap, n, ki.num_tiles)
        again = fill_cuda.rank_cap_decode(k, cap, n, ki.num_tiles)
        torch.cuda.synchronize()
        assert _launches("rank_cap_decode") == before + 2
        for a, b, c in zip(got, want, again):
            assert torch.equal(a, b) and torch.equal(a, c)
    return skeys, want


@pytest.mark.parametrize("n,hw,budget", [
    (300, (64, 96), None), (300, (64, 96), 64), (0, (48, 64), 1024),
    (400, (2080, 4080), None), (400, (2080, 4080), 512),
    (70000, (1080, 1920), None), (70000, (2080, 4080), None)])
def test_key_kernels_at_both_key_widths(dev, n, hw, budget):
    """A grid of <= 32,767 tiles (int32 keys) and 4080x2080's 33,150 (int64
    keys), at a 16-bit gauss field and, at 70,000 splats, a 17-bit one
    (int32 keys at 1080p, int64 at 4080x2080); budget overflow, no splats,
    and splats that hit no tile. K2 is one kernel launch a call: the host's
    launch records count exactly 3 in 3 calls, and every device record the
    profiler keeps is K2's kernel (CUPTI drops a device record now and
    then, never the launch's host record)."""
    from gsvc_tpu_torch.utils.profiling import device_events, launches, profile_device

    H, W = hw
    tb, _t, (xys, _d, radii, _c, nth) = _scene(dev, n, H, W, 8)
    nth = torch.where(torch.arange(n, device=dev) % 7 == 3, 0, nth)  # hit no tile
    if budget is None:
        budget = default_max_intersects(n, tb[0] * tb[1])
    ki = key_inputs(xys, radii, nth, tb, 16, 16, budget)
    if n:
        assert (ki.nth == 0).any()
    if budget < 1000:
        assert int(ki.nth.sum()) > int(ki.total_kept)
    if n > 65535:
        layout = fill_cuda.key_layout(ki.num_tiles, n)
        assert layout.gauss_bits == 17
        assert layout.dtype == (torch.int32 if hw == (1080, 1920) else torch.int64)
    skeys, _want = _check_k1_k2(ki)
    _busy, events = profile_device(
        lambda: fill_cuda.rank_cap_decode(skeys, 256, n, ki.num_tiles), 3)
    assert launches(events) == 3
    recorded = device_events(events)
    assert recorded and all("rank_cap_kernel" in e.key for e in recorded), \
        [e.key for e in recorded]
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget)
    plain = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, kernels=False)
    for name in binned._fields:
        assert torch.equal(getattr(binned, name), getattr(plain, name)), name


@pytest.mark.parametrize("n,tb,budget,cap,y_range", [
    (6000, (120, 68), 20480, 256, None), (6000, (120, 68), 4096, 256, None),
    (6000, (120, 68), 20000, 256, None), (6000, (255, 200), 20480, 256, None),
    (6000, (255, 200), 4096, 256, None), (6000, (255, 200), 20000, 256, None),
    (6000, (120, 68), "exact", 256, None),  # no sentinel lane
    (6000, (120, 68), 20480, 1, (10, 12)),  # empty tile rows at both ends, cap 1
    (6000, (255, 200), 20480, 4, (100, 104)),  # int64 keys, gaps, runs past the cap
    # a 17-bit gauss field, runs past the cap and a budget that drops the
    # tail: int32 keys at 1080p, int64 on 255 x 200 tiles
    (70000, (120, 68), 1 << 20, 4, None), (70000, (255, 200), 1 << 20, 4, None),
])
def test_key_kernels_on_hard_inputs(dev, n, tb, budget, cap, y_range):
    """`synthetic_key_inputs`, on which tests/test_torch_binning.py holds
    the plain versions to gsvc_tpu."""
    if budget == "exact":  # the budget ends where a kept splat's tiles end
        nth = synthetic_key_inputs(n, tb, 1 << 22, seed=0, device=dev).nth
        budget = int(torch.cumsum(nth, 0)[n // 2])
        ki = synthetic_key_inputs(n, tb, budget, seed=0, device=dev)
        assert int(ki.total_kept) == budget
    else:
        ki = synthetic_key_inputs(n, tb, budget, seed=budget, device=dev,
                                  y_range=y_range)
    _skeys, (_tiles, gauss, edges) = _check_k1_k2(ki, cap)
    if n > 65535:
        layout = fill_cuda.key_layout(ki.num_tiles, n)
        assert layout.gauss_bits == 17
        assert layout.dtype == (torch.int32 if tb == (120, 68) else torch.int64)
        assert int(ki.nth.sum()) > int(ki.total_kept) > 0  # the tail dropped
        assert int(torch.diff(edges).max()) > cap  # capped lanes
        assert int(edges[-1]) < budget  # sentinel lanes
        assert int((gauss == n).sum()) > budget - int(edges[-1])


def _segsum_flags(rng, s, mode):
    p = {"dense": 0.3, "sparse": 0.0005, "none_first": 0.01}[mode]
    flags = (rng.random(s) < p).astype(np.int32)
    flags[0] = mode != "none_first"
    return flags


@pytest.mark.parametrize("s", [1, 63, 4097, 81920, 800000])
@pytest.mark.parametrize("mode", ["dense", "sparse", "none_first"])
def test_segmented_cumsum_kernel(dev, s, mode):
    """K3 within 1e-4 of the plain version's largest entry; two launches
    bitwise equal; S % 4 == 0 takes the 16-byte loads, the rest (and an
    unaligned view) the 4-byte ones."""
    rng = np.random.default_rng(s)
    flags = torch.as_tensor(_segsum_flags(rng, s, mode), device=dev)
    for rows in (1, 9, 16, 32):
        vals = torch.as_tensor(rng.normal(size=(rows, s)).astype(np.float32), device=dev)
        want = fill_cuda.segmented_cumsum_torch(vals, flags)
        before = _launches("segmented_cumsum")
        got = fill_cuda.segmented_cumsum(vals, flags)
        torch.cuda.synchronize()
        assert _launches("segmented_cumsum") == before + 1
        _close(got, want)
        assert torch.equal(fill_cuda.segmented_cumsum(vals, flags), got)
    buf = torch.zeros(rows * s + 1, device=dev)
    view = buf[1:].view(rows, s)
    view.copy_(vals)
    _close(fill_cuda.segmented_cumsum(view, flags), want)
    with pytest.raises(ValueError):
        fill_cuda.segmented_cumsum(vals.double(), flags)


def test_dispatch_and_refusals(dev):
    H, W = 40, 56
    tb, (_m, _l, colors, opacity), (xys, d, radii, conics, nth) = _scene(dev, 150, H, W, 5)
    before = _launches("forward_chw")
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W,
                                  layout="chw")
    assert _launches("forward_chw") == before + 1  # auto -> cuda
    ref = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W,
                                  backend="torch", layout="chw")
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 4096)
    args = [binned, xys, conics, colors, opacity, H, W, tb]
    with pytest.raises(ValueError):
        rasterize_cuda.forward_image(binned, xys.double(), *args[2:])
    ki = key_inputs(xys, radii, nth, tb, 16, 16, 4096)
    with pytest.raises(ValueError):
        fill_cuda.fill_decode_keys(ki.starts.long(), *ki.k1[1:])


def _close(got, want, rel=1e-4):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-12, (err, scale)


@pytest.mark.parametrize("n,hw,seed,budget,cap,big", [
    (500, (37, 83), 0, 16384, 256, False), (400, (40, 56), 2, 8192, 256, True),
    (120, (32, 32), 4, 4096, 4, False), (300, (64, 48), 5, 64, 256, False),
    _CAPPED,
])
def test_train_kernels_match_plain_versions(dev, n, hw, seed, budget, cap, big):
    H, W = hw
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(
        dev, n, H, W, seed, big)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap)
    args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, cap)
    rows = rasterize_cuda.forward_rows(*args)
    img = rasterize_cuda.forward_image(*args)
    assert torch.equal(rows, image_to_rows(img, H, W))
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((H, W, 3), device=dev, generator=gen)
    want = rasterize_cuda.rasterize_backward_torch(*args[:5], v, *args[5:])
    for layout, vv in (("image", v), ("chw", v.permute(2, 0, 1).contiguous()),
                       ("rows", image_to_rows(v, H, W))):
        got = rasterize_cuda.backward_slots(*args[:5], vv, *args[5:], layout=layout)
        torch.cuda.synchronize()
        assert ((got != 0) <= (want != 0)).all()  # capped lanes' slots stay 0
        _close(got, want)
        again = rasterize_cuda.backward_slots(*args[:5], vv, *args[5:], layout=layout)
        assert torch.equal(again, got), layout
    flags = (torch.rand(want.shape[1], device=dev, generator=gen) < 0.1).int()
    _close(fill_cuda.segmented_cumsum(want, flags),
           fill_cuda.segmented_cumsum_torch(want, flags))


def test_rasterize_sum_gradients_match_plain_autograd(dev):
    H, W = 72, 88
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(dev, 600, H, W, 7)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 16384)
    wgt = torch.rand((H, W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xys, conics, colors, opacity)]
        a = (binned, *leaves, H, W, tb, 16, 16, 256)
        before = _launches("backward_slots")
        img = (rasterize_cuda.rasterize_sum(*a) if kernels
               else rasterize_cuda.rasterize_forward_torch(*a))
        grads.append(torch.autograd.grad(torch.sum((img - 0.3) ** 2 * wgt), leaves))
        assert _launches("backward_slots") == before + int(kernels)
    for a, b in zip(*grads):
        _close(a, b)


@pytest.mark.parametrize("delta", [False, True])
def test_qat_step_kernels_match_plain_backend(dev, delta):
    """One QAT step of the compress stage: the kernel path (rows loss, K4
    rows, K6, K3) against autograd through the plain renderer ("torch"),
    from the same state and the same k-means rows."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models import compress as comp
    from gsvc_tpu_torch.models.represent import _rows_target_for

    H, W, n = 72, 104, 400
    rng = np.random.default_rng(11)
    gmodel = {"_xyz": np.arctanh(rng.uniform(-0.9, 0.9, (n, 2))).astype(np.float32),
              "_cholesky": rng.uniform(0, 2, (n, 3)).astype(np.float32),
              "_features_dc": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    p_gmodel = ({k: (v - rng.normal(0, 0.05, v.shape)).astype(np.float32)
                 for k, v in gmodel.items()} if delta else None)
    gt = torch.rand((H, W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    out = {}
    for backend in ("cuda", "torch"):
        cfg = FrameConfig(H=H, W=W, num_points=n, max_num_points=n, iterations=1,
                          backend=backend)
        state = comp.init_compress_state(gmodel, p_gmodel, dev)
        before = _launches("backward_slots")
        out[backend] = comp._loss_and_grads(state, gt, cfg, _rows_target_for(gt, cfg),
                                            torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        assert _launches("backward_slots") == before + (backend == "cuda")
    (recon, vq, grads, new_vq), (recon_p, vq_p, grads_p, new_vq_p) = out["cuda"], out["torch"]
    torch.testing.assert_close(recon, recon_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(vq, vq_p, rtol=1e-6, atol=0)
    assert torch.equal(new_vq.embed, new_vq_p.embed)
    for name in grads:
        assert torch.isfinite(grads[name]).all() and grads_p[name].abs().max() > 0, name
        _close(grads[name], grads_p[name])


_SIZES = {"small": (400, 40, 56), "1080p": (10000, 1080, 1920)}


def _bench(dev, size):
    from gsvc_tpu_torch.scripts import common

    return common.scene(*_SIZES[size], dev)


@pytest.mark.parametrize("size", list(_SIZES))
def test_parts_kernels_match_plain_versions(dev, size):
    """P1: each K4 variant against its plain version, max-abs 1e-4 and
    within 1e-4 of the plain version's largest entry, which is not 0 (f32
    sums in another order; __expf against exp for fast_exp; no_acc's
    outputs are ~1e-5, where max-abs alone would pass zeros)."""
    from gsvc_tpu_torch.scripts import profile_kernel_parts as p1

    sc = _bench(dev, size)
    for v, wrapper in p1.FORWARD_PARTS.items():
        before = _launches(wrapper.__name__)
        got = wrapper(*sc.rargs)
        torch.cuda.synchronize()
        assert _launches(wrapper.__name__) == before + 1
        want = p1.render_parts_torch(v, *sc.rargs)
        err, largest = float((got - want).abs().max()), float(want.abs().max())
        assert largest > 0 and err <= 1e-4 and err <= 1e-4 * largest, (v, err, largest)


@pytest.mark.parametrize("size", list(_SIZES))
def test_job_kernels_match_k6_and_plain_versions(dev, size):
    """P5: C, D, F and G within 1e-4 of K6's largest slot (another
    summation order; one of F and G is K6's own split), A exactly its
    plain copy, B and E within 1e-4 of theirs."""
    from gsvc_tpu_torch.scripts import profile_bwd_variants as p5

    sc = _bench(dev, size)
    v = torch.randn((sc.H, sc.W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    bargs = (*sc.rargs[:5], image_to_rows(v, sc.H, sc.W), sc.H, sc.W, sc.tb)
    jobs = p5.build_jobs(sc.binned)
    k6 = rasterize_cuda.backward_slots(*bargs, 16, 16, 256, "rows")
    for name, wrapper in p5.BACKWARD_JOBS.items():
        before = _launches(wrapper.__name__)
        got = wrapper(*bargs, jobs)
        torch.cuda.synchronize()
        assert _launches(wrapper.__name__) == before + 1
        plain = p5.backward_jobs_torch(name, *bargs, jobs)
        if name == "A":
            assert torch.equal(got, plain)
        else:
            _close(got, k6 if name in p5.K6_FUNCTION else plain)
        if name in p5.K6_FUNCTION:
            assert torch.equal(got != 0, k6 != 0)
        if name == "F":  # K6's own split: the same kernel
            assert torch.equal(got, k6)


@pytest.mark.parametrize("size", list(_SIZES))
def test_transpose_kernels_are_exact(dev, size):
    """P6: the transposes and rows -> planar exactly (copies)."""
    from gsvc_tpu_torch.scripts import probe_transpose as p6

    sc = _bench(dev, size)
    gen = torch.Generator(device=dev).manual_seed(0)
    # both tiles (R <= 16: 16 x 64, else 32 x 32); R or C not a multiple of 4
    shapes = [(3, 2, 100), (3, 8, 100), (5, 3, 37), (2, 13, 50), (4, 360, 16),
              (2, 100, 7), (2, 50, 3), (3, 33, 70)]
    inputs = [torch.rand(shape, generator=gen, device=dev) for shape in shapes]
    inputs.append(torch.rand(1 + 16 * 16 * 360, generator=gen, device=dev)[1:]
                  .view(16, 16, 360))  # not 16-byte aligned: the 4-byte loads
    for x in [*p6.probe_inputs(sc, dev).values(), *inputs]:
        before = _launches("transpose_last2")
        got = p6.transpose_last2(x)
        torch.cuda.synchronize()
        assert _launches("transpose_last2") == before + 1
        assert torch.equal(got, p6.transpose_last2_torch(x)), tuple(x.shape)
    rows = rasterize_cuda.forward_rows(*sc.rargs)
    before = _launches("rows_to_chw")
    planar = p6.rows_to_chw(rows, sc.H, sc.W, sc.tb)
    assert _launches("rows_to_chw") == before + 1
    assert torch.equal(planar, p6.rows_to_chw_torch(rows, sc.H, sc.W, sc.tb))
    assert torch.equal(planar, rasterize_cuda.forward_chw(*sc.rargs))
    with pytest.raises(ValueError):
        p6.transpose_last2(rows.double())


def test_train_steps_are_deterministic(dev):
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models.represent import fit_frame, init_train_state

    cfg = FrameConfig(H=64, W=96, num_points=300, max_num_points=360, iterations=20,
                      isdensity=True, densification_interval=5, lr=1e-2)
    gt = torch.rand((64, 96, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    runs = []
    for _ in range(2):
        st = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        res = fit_frame(st, gt, cfg, draws=torch.Generator(device=dev).manual_seed(1))
        runs.append([t.detach().clone() for t in (res.state.params.xyz, res.state.params.cholesky,
                                                  res.state.params.features_dc, res.image)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- the alpha compositor: A1, A2 and the uncapped depth binning ---------------


def _alpha_scene(dev, n, H, W, c_dim, seed, kind=""):
    """Screen-space splats with depths, radii and conics (gsvc_tpu's test
    scene), on `dev`; kind "big": wide faint splats, hundreds a tile;
    "dense": wide splats of opacity 1, whose pixels break early."""
    big = kind in ("big", "dense")
    rng = np.random.default_rng(seed)
    xys = rng.uniform(0, [W, H], (n, 2))
    depths = rng.uniform(1.0, 10.0, n)
    lo, hi = (10.0, 14.0) if big else (1.0, 4.0)
    L = np.stack([rng.uniform(lo, hi, n), rng.normal(0, 0.5, n), rng.uniform(lo, hi, n)], 1)
    cov = np.stack([L[:, 0] ** 2, L[:, 0] * L[:, 1], L[:, 1] ** 2 + L[:, 2] ** 2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conics = np.stack([cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det], 1)
    tr = 0.5 * (cov[:, 0] + cov[:, 2])
    radii = np.ceil(3 * np.sqrt(tr + np.sqrt(np.maximum(0.1, tr**2 - det))))
    radii[::11] = 0
    colors = rng.uniform(0, 1, (n, c_dim))
    opacity = {"big": rng.uniform(0.01, 0.05, (n, 1)), "dense": np.ones((n, 1))}.get(
        kind, rng.uniform(0.3, 1.0, (n, 1)))
    bg = rng.uniform(0, 1, c_dim)
    f = [torch.as_tensor(a, dtype=torch.float32, device=dev)
         for a in (xys, depths, conics, colors, opacity, bg)]
    return f[0], f[1], torch.as_tensor(radii, dtype=torch.int32, device=dev), *f[2:]


_ALPHA = [(120, (33, 47), 3, 0, ""), (200, (64, 80), 5, 1, ""), (90, (40, 56), 40, 2, ""),
          (700, (48, 48), 3, 3, "big"), (300, (48, 64), 3, 5, "dense"),
          (0, (20, 30), 3, 4, "")]


def _within(a, b, tol):
    """max |a - b| <= tol x max |b| (true for empty tensors)."""
    return a.numel() == 0 or float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("n,hw,c_dim,seed,kind", _ALPHA)
def test_alpha_kernels_match_plain_versions(dev, n, hw, c_dim, seed, kind):
    """A1 against its plain version: image, alpha, T_final atol 1e-5, the last
    contributing lane exactly; A2's slots and v_background within 1e-4 of the
    largest entry; both bitwise across two launches; the depth binning's
    kernel path (K1, K2 at a cap of every intersection) equal to its plain
    one. The "big" scene puts more than 256 lanes on a tile, the "dense" one
    stops most pixels early."""
    from gsvc_tpu_torch.ops import rasterize_alpha_cuda as rac

    H, W = hw
    xys, depths, radii, conics, colors, opacity, bg = _alpha_scene(dev, n, H, W, c_dim, seed,
                                                                   kind)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    db = rac.bin_depth_ordered(xys, depths, radii, tb)
    plain = rac.bin_depth_ordered(xys, depths, radii, tb, kernels=False)
    for name in db.binned._fields:
        assert torch.equal(getattr(db.binned, name), getattr(plain.binned, name)), name
    if kind == "big":
        assert int(db.binned.tile_counts.max()) > 256
    o = db.order
    splats = (xys[o].contiguous(), conics[o].contiguous(), colors[o].contiguous(),
              opacity[o].contiguous(), bg)
    before = _launches("alpha_forward")
    got = rac.alpha_forward(db.binned, *splats, H, W, tb, True)
    torch.cuda.synchronize()
    assert _launches("alpha_forward") == before + len(rac.groups(c_dim))
    want = rac.alpha_forward_torch(db.binned, *splats, H, W, tb, True)
    for name, a, b in zip(("image", "alpha", "T"), got[:3], want[:3]):
        assert torch.isfinite(a).all() and float((a - b).abs().max()) <= 1e-5, name
    assert torch.equal(got[3], want[3])
    if kind == "dense":  # the pixels break early: A1 walks under half the pairs
        fwd_pairs = rac.pair_counts(db.binned, splats[0], splats[1], splats[3], H, W, tb)[0]
        assert fwd_pairs < 0.5 * 256 * db.total
    again = rac.alpha_forward(db.binned, *splats, H, W, tb, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    gen = torch.Generator(device=dev).manual_seed(seed)
    v_img = torch.randn((H, W, c_dim), device=dev, generator=gen)
    v_alpha = torch.randn((H, W), device=dev, generator=gen)
    before = _launches("alpha_backward_slots")
    slots, v_bg = rac.alpha_backward_slots(db.binned, *splats, got[2], got[3], v_img, v_alpha,
                                           H, W, tb)
    torch.cuda.synchronize()
    assert _launches("alpha_backward_slots") == before + len(rac.groups(c_dim))
    slots_p, v_bg_p = rac.alpha_backward_torch(db.binned, *splats, got[2], v_img, v_alpha,
                                               H, W, tb)
    for a, b in ((slots, slots_p), (v_bg, v_bg_p)):
        assert torch.isfinite(a).all() and _within(a, b, 1e-4)
    again = rac.alpha_backward_slots(db.binned, *splats, got[2], got[3], v_img, v_alpha,
                                     H, W, tb)
    assert torch.equal(slots, again[0]) and torch.equal(v_bg, again[1])


def test_alpha_gradients_match_plain_autograd(dev):
    """The public compositor on the card (A1, A2, K3) against autograd
    through its plain version (gsvc_tpu's scan) on the card: the image
    within 1e-4, every gradient within 1e-4 of its largest entry."""
    from gsvc_tpu_torch.ops import rasterize_alpha

    H, W = 72, 96
    xys, depths, radii, conics, colors, opacity, bg = _alpha_scene(dev, 400, H, W, 3, 5)
    gen = torch.Generator(device=dev).manual_seed(5)
    v_img = torch.randn((H, W, 3), device=dev, generator=gen)
    v_alpha = torch.randn((H, W), device=dev, generator=gen)
    grads, images = [], []
    for backend in ("auto", "torch"):
        leaves = [t.clone().requires_grad_() for t in (xys, conics, colors, opacity, bg)]
        img, alpha = rasterize_alpha.rasterize_gaussians_alpha(
            leaves[0], depths, radii, leaves[1], None, leaves[2], leaves[3], H, W,
            background=leaves[4], return_alpha=True, chunk=64, backend=backend)
        images.append(img.detach())
        grads.append(torch.autograd.grad((img * v_img).sum() + (alpha * v_alpha).sum(), leaves))
    assert float((images[0] - images[1]).abs().max()) <= 1e-4
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# -- the fast-colour mode (`fast_color=True`) -------------------------------------


@pytest.mark.parametrize("n,hw,seed,budget,cap,big", [
    (500, (37, 83), 0, 16384, 256, False), (400, (40, 56), 2, 8192, 256, True),
    (120, (32, 32), 4, 4096, 4, False), (0, (48, 64), 1, 64, 256, False), _CAPPED,
])
def test_fast_color_kernels_match_plain_versions(dev, n, hw, seed, budget, cap, big):
    """K4 (image, rows), K5 and K6's fast-colour variants against their plain
    versions (renders max-abs 1e-4 off the pixels near the alpha gate, K6
    within 1e-4 of the largest entry), two launches bitwise equal, each
    counted on its own counter and not on the exact kernel's."""
    H, W = hw
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(
        dev, n, H, W, seed, big)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap)
    args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, cap)
    ref = rasterize_cuda.rasterize_forward_torch(*args, fast_color=True)
    near = rasterize_cuda.near_gate(binned, xys, conics, opacity, H, W, tb, cap, True)
    for store in ("image", "chw", "rows"):
        wrapper = rasterize_cuda.FORWARD[store]
        names = (wrapper.__name__, wrapper.__name__ + "_fast")
        before = [_launches(k) for k in names]
        out = wrapper(*args, fast_color=True)
        again = wrapper(*args, fast_color=True)
        torch.cuda.synchronize()
        assert [_launches(k) for k in names] == [before[0], before[1] + 2]
        assert torch.equal(out, again), store
        img = (out if store == "image" else out.permute(1, 2, 0) if store == "chw"
               else rasterize_cuda.rows_to_image(out, tb[0], tb[1], H, W))
        err = (img - ref).abs().amax(-1)
        assert float(torch.where(near, 0.0, err).max()) <= 1e-4, store
        assert not torch.equal(out, wrapper(*args)) or n == 0  # the exact kernel differs
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((H, W, 3), device=dev, generator=gen)
    want = rasterize_cuda.rasterize_backward_torch(*args[:5], v, *args[5:], fast_color=True)
    for layout, vv in (("image", v), ("chw", v.permute(2, 0, 1).contiguous()),
                       ("rows", image_to_rows(v, H, W))):
        before = _launches("backward_slots_fast")
        got = rasterize_cuda.backward_slots(*args[:5], vv, *args[5:], layout=layout,
                                            fast_color=True)
        again = rasterize_cuda.backward_slots(*args[:5], vv, *args[5:], layout=layout,
                                              fast_color=True)
        torch.cuda.synchronize()
        assert _launches("backward_slots_fast") == before + 2
        assert torch.equal(got, again), layout
        _close(got, want)


def test_fast_color_gradients_match_plain_autograd(dev):
    H, W = 72, 88
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(dev, 600, H, W, 7)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 16384)
    wgt = torch.rand((H, W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xys, conics, colors, opacity)]
        a = (binned, *leaves, H, W, tb, 16, 16, 256)
        img = (rasterize_cuda.rasterize_sum(*a, fast_color=True) if kernels
               else rasterize_cuda.rasterize_forward_torch(*a, fast_color=True))
        grads.append(torch.autograd.grad(torch.sum((img - 0.3) ** 2 * wgt), leaves))
    for a, b in zip(*grads):
        _close(a, b)


# -- the eval render's epilogue: K4 / K5 writing the clipped image ---------------


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("layout", ["image", "chw"])
def test_clipped_forward_is_the_chain_bitwise(dev, layout):
    """K4 / K5 with the eval render's epilogue against the chain it folds,
    clamp(blend_background(raw)) on ones of the same kernel's raw render,
    bit for bit: the whole grid and a tile-row span whose rows pass the
    image's edge and the grid's, a frame with no kept intersection (ones
    everywhere, the span's padding too), colour sums below 0 and above 1,
    NaN colours (passed on as torch.clamp passes them); one launch a call
    on the clipped counter, none on the raw one."""
    H, W = 40, 56
    names = (f"forward_{layout}_clipped", f"forward_{layout}")
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(dev, 300, H, W, 8)
    colors = colors * 2.0 - 0.5
    colors[::60] = float("nan")
    ones = torch.ones(3, device=dev)
    for empty in (False, True):
        binned = bin_gaussians(xys, radii, nth * 0 if empty else nth, tb, 16, 16, 8192)
        assert (int(binned.num_intersects) == 0) == empty
        args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, 256)
        for span in (None, (2, 2)):
            raw = rasterize_cuda.FORWARD[layout](*args, span)
            if not empty and span is None:
                finite = raw.nan_to_num()
                assert raw.isnan().any() and finite.min() < 0 and finite.max() > 1
            want = torch.clamp(rasterize_cuda.blend_background(
                raw, binned.num_intersects, ones, layout), 0.0, 1.0)
            before = [_launches(k) for k in names]
            got = rasterize_cuda.CLIPPED[layout](*args, span)
            again = rasterize_cuda.CLIPPED[layout](*args, span)
            torch.cuda.synchronize()
            assert [_launches(k) for k in names] == [before[0] + 2, before[1]]
            assert torch.equal(_bits(got), _bits(want)), (empty, span)
            assert torch.equal(_bits(again), _bits(got)), (empty, span)
            if empty:
                assert torch.equal(got, torch.ones_like(got)), span


def test_clipped_render_launches_once(dev):
    """An eval render through `rasterize_gaussians_sum_clipped` and
    `render_frame` is one clipped launch and no raw one, bitwise
    `torch.clamp(rasterize_gaussians_sum(...))`; in fast colour, and with
    an autograd node, the render is the raw kernel and the chain, the
    latter differentiable."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import init_splats
    from gsvc_tpu_torch.models.represent import render_frame
    from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum_clipped

    H, W = 72, 88
    _tb, (_m, _l, colors, opacity), splats = _scene(dev, 600, H, W, 9)
    args = (*splats, colors, opacity, H, W)
    for layout in ("image", "chw"):
        before = [_launches(k) for k in (f"forward_{layout}_clipped", f"forward_{layout}")]
        got = rasterize_gaussians_sum_clipped(*args, layout=layout)
        torch.cuda.synchronize()
        assert [_launches(k) for k in (f"forward_{layout}_clipped", f"forward_{layout}")] \
            == [before[0] + 1, before[1]]
        want = torch.clamp(rasterize_gaussians_sum(*args, layout=layout), 0.0, 1.0)
        assert torch.equal(_bits(got), _bits(want)), layout
    before = [_launches(k) for k in ("forward_chw_clipped", "forward_chw_fast")]
    got = rasterize_gaussians_sum_clipped(*args, layout="chw", fast_color=True)
    torch.cuda.synchronize()
    assert [_launches(k) for k in ("forward_chw_clipped", "forward_chw_fast")] \
        == [before[0], before[1] + 1]
    want = torch.clamp(rasterize_gaussians_sum(*args, layout="chw", fast_color=True), 0.0, 1.0)
    assert torch.equal(_bits(got), _bits(want))
    leaf = colors.clone().requires_grad_()
    before = _launches("forward_chw")
    img = rasterize_gaussians_sum_clipped(*splats, leaf, opacity, H, W, layout="chw")
    assert img.requires_grad and _launches("forward_chw") == before + 1
    assert torch.isfinite(torch.autograd.grad(img.sum(), leaf)[0]).all()

    cfg = FrameConfig(H=H, W=W, num_points=500, max_num_points=500, iterations=1)
    params, alive = init_splats(500, generator=torch.Generator().manual_seed(0), device=dev)
    before = graphs.launch_counts()
    frame = render_frame(params, alive, cfg, layout="chw")
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0) for k, v in graphs.launch_counts().items()
             if v != before.get(k, 0)}
    assert delta == {"fill_decode_keys": 1, "rank_cap_decode": 1, "forward_chw_clipped": 1}
    assert frame.shape == (3, H, W) and float(frame.min()) >= 0 and float(frame.max()) <= 1


# -- Adan's update: every leaf of a step in one launch -----------------------------


_ADAN_SETS = {"represent": lambda n: [(n, 2), (n, 3), (n, 3), (n, 1)],
              "qat": lambda n: [(n, 2), (n, 3), (n, 3), (3,), (3,)]}
# fresh, max_grad_norm, weight_decay, no_prox
_ADAN_CASES = [(True, 0.0, 0.0, False), (False, 0.0, 0.0, False),
               (False, 0.05, 0.02, False), (False, 0.0, 0.02, True)]
_MOMENTS = ("exp_avg", "exp_avg_sq", "exp_avg_diff", "neg_pre_grad")


def _adan_inputs(shapes, dev, seed, offset=0):
    """(params, grads, AdanState) of random float32 leaves on dev. With an
    offset each tensor is a contiguous view `offset` floats into a buffer of
    its own (not 16-byte aligned where offset % 4 != 0); without, the
    features' gradient is transposed, as autograd hands it over."""
    rng = np.random.default_rng(seed)

    def t(s, scale, positive=False):
        a = rng.normal(size=s) * scale
        a = torch.as_tensor(np.abs(a) if positive else a, dtype=torch.float32)
        if not offset:
            return a.to(dev)
        buf = torch.zeros(a.numel() + offset, device=dev)
        view = buf[offset:].view(s)
        view.copy_(a)
        return view

    names = [f"leaf{i}" for i in range(len(shapes))]
    params = {k: t(s, 1.0) for k, s in zip(names, shapes)}
    grads = {k: t(s, 1e-2) for k, s in zip(names, shapes)}
    if not offset:
        grads["leaf2"] = grads["leaf2"].t().contiguous().t()
    moments = {f: {k: t(s, sc, f == "exp_avg_sq") for k, s in zip(names, shapes)}
               for f, sc in zip(_MOMENTS, (1e-3, 1e-5, 1e-4, 1e-2))}
    return params, grads, adan.AdanState(step=6, fresh={k: False for k in names}, **moments)


def _adan_tensors(params, state):
    return [*params.values(), *(t for f in _MOMENTS for t in getattr(state, f).values())]


@pytest.mark.parametrize("leaf_set", sorted(_ADAN_SETS))
@pytest.mark.parametrize("n,offset", [(0, 0), (1, 0), (777, 0), (10_000, 0), (50_000, 0),
                                      (1, 1), (777, 1), (10_001, 3)])
@pytest.mark.parametrize("fresh,max_grad_norm,weight_decay,no_prox", _ADAN_CASES)
def test_adan_kernel_equals_plain_update(dev, leaf_set, n, offset, fresh, max_grad_norm,
                                         weight_decay, no_prox):
    """One launch a call, bitwise `_update` on the same CUDA tensors: the
    represent and QAT leaf sets, empty, single and odd leaves, misaligned
    ones (the scalar path), fresh or not, a clip, no_prox."""
    shapes = _ADAN_SETS[leaf_set](n)
    table = torch.tensor(adan.adan_table([(6, 2e-3), (7, 1e-3), (8, 5e-4)], (0.98, 0.92, 0.99),
                                         weight_decay, dev), device=dev)
    row = torch.tensor(1, dtype=torch.int64, device=dev)
    kw = dict(betas=(0.98, 0.92, 0.99), eps=1e-8, max_grad_norm=max_grad_norm,
              no_prox=no_prox)
    params, grads, state = _adan_inputs(shapes, dev, seed=n + offset, offset=offset)
    flag = torch.tensor(fresh, device=dev)
    scalars = torch.index_select(table, 0, row.view(1))[0].unbind()
    want = adan._update(params, grads, state, scalars, flag.clone(), **kw)
    before = _launches("adan_update")
    out = adan.adan_step_(params, grads, state, table, row, flag, **kw)
    torch.cuda.synchronize()
    assert _launches("adan_update") == before + 1
    assert out.step == 7 and not bool(flag)
    got = [params, state.exp_avg, state.exp_avg_sq, state.exp_avg_diff, state.neg_pre_grad]
    for name, g, w in zip(("p", "m", "n", "d", "-g"), got, want):
        for k in g:
            assert torch.equal(g[k], w[k]), (name, k)


def test_adan_kernel_replays_equal_eager_updates(dev):
    """A `StepGraph` of the update (3 eager warm-ups, then a capture replayed
    5 times, each on the next table row) equals 8 eager updates bitwise;
    each counts one launch an update."""
    steps = [(s, 1e-3 * 0.9 ** s) for s in range(1, 9)]
    table = torch.tensor(adan.adan_table(steps, device=dev), device=dev)
    runs = []
    for graph in (True, False):
        params, grads, state = _adan_inputs(_ADAN_SETS["represent"](10_000), dev, seed=5)
        row = torch.zeros((), dtype=torch.int64, device=dev)
        fresh = torch.ones((), dtype=torch.bool, device=dev)
        box = [dataclasses.replace(state, fresh={k: True for k in state.fresh})]

        def step(box=box, params=params, grads=grads, row=row, fresh=fresh):
            box[0] = adan.adan_step_(params, grads, box[0], table, row, fresh)
            row.add_(1)
            return box[0]

        def after(box=box):
            box[0] = adan.adan_host_step(box[0])
            return box[0]

        before, replays = _launches("adan_update"), graphs.StepGraph.replays
        with graphs.StepGraph(dev) if graph else graphs.Eager() as run:
            for _ in steps:
                run(step, after)
        torch.cuda.synchronize()
        assert _launches("adan_update") - before == len(steps)
        assert graphs.StepGraph.replays - replays == (5 if graph else 0)
        assert box[0].step == 6 + len(steps) and int(row) == len(steps)
        runs.append(_adan_tensors(params, box[0]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- the rows loss: E1 -------------------------------------------------------------

# (image rows, width, valid_h) of E1's cases: 1080p's rows (24,480 x 256), 4K
# UHD's (97,200 x 256), and the ragged last span of 3 tile-row shards at
# 1080p (23 tile rows from row 46: 344 pixel rows inside the image, 8,280 x 256)
_E1_ROWS = {"1080p": (1080, 1920, None), "2160p": (2160, 3840, None),
            "span": (368, 1920, 344)}


def _e1_inputs(dev, size, seed, total=5):
    """E1's inputs: a rows target and mask (`make_rows_target`), raw rows
    holding the clip's bounds and ties (exact 0 and 1, below 0, above 1,
    differences of exactly 0), and the kept total."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models.represent import make_rows_target

    h, w, valid_h = _E1_ROWS[size]
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = FrameConfig(H=h, W=w, num_points=1, max_num_points=1, iterations=1)
    gt_rows, mask = make_rows_target(torch.rand((h, w, 3), device=dev, generator=g), cfg,
                                     valid_h)
    raw = torch.rand(gt_rows.shape, device=dev, generator=g) * 1.6 - 0.3
    raw[:, :6] = torch.tensor([0.0, 1.0, -0.25, 1.25, 0.0, 1.0], device=dev)
    gt_rows[:, 4:6] = torch.tensor([0.0, 1.0], device=dev)
    raw[::5, 10:14] = gt_rows[::5, 10:14]
    return raw, gt_rows, mask, torch.tensor(total, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("size", sorted(_E1_ROWS))
@pytest.mark.parametrize("l1", [False, True])
@pytest.mark.parametrize("total", [5, 0, 1])
def test_rows_loss_kernel_matches_plain_version(dev, size, l1, total):
    """E1's gradient bitwise its plain version's, its sums within 1e-6
    relative, two launches bitwise equal, one launch a call."""
    from gsvc_tpu_torch.ops import loss_cuda

    args = _e1_inputs(dev, size, 7, total)
    before = _launches("rows_loss")
    got = loss_cuda.rows_loss(*args, l1)
    again = loss_cuda.rows_loss(*args, l1)
    torch.cuda.synchronize()
    assert _launches("rows_loss") == before + 2
    want = loss_cuda.rows_loss_torch(*args, l1)
    assert torch.equal(got[0], want[0]) and bool(got[0].any()) == bool(total)
    for a, b in zip(got[1:], want[1:]):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)) and float(b) > 0
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_rows_loss_kernel_refuses_what_it_does_not_take(dev):
    from gsvc_tpu_torch.ops import loss_cuda

    raw, gt_rows, mask, total = _e1_inputs(dev, "span", 1)
    with pytest.raises(ValueError, match="rows_loss"):
        loss_cuda.rows_loss(raw, gt_rows.cpu(), mask, total)
    with pytest.raises(ValueError, match="rows_loss"):
        loss_cuda.rows_loss(raw, gt_rows, mask, total.long())


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
def test_rows_loss_gradients_are_the_chains_on_the_card(dev, loss_type):
    """Through E1 (`rasterize_rows_loss`), the per-splat gradients at
    1080p/10k are bitwise those of autograd through the rows render, the
    clip and the masked sum: the gradient K6 reads is the same."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models.represent import make_rows_target
    from gsvc_tpu_torch.ops import loss_cuda
    from gsvc_tpu_torch.ops.rasterize import _clip01, rasterize_rows_loss

    sc = _bench(dev, "1080p")
    cfg = FrameConfig(H=sc.H, W=sc.W, num_points=sc.n, max_num_points=sc.n, iterations=1)
    gt = torch.rand((sc.H, sc.W, 3), device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(3))
    gt_rows, mask = make_rows_target(gt, cfg)
    denom = sc.H * sc.W * 3
    out = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_() for t in (sc.means, sc.L, sc.colors)]
        xys, depths, radii, conics, nth = project_gaussians_2d(leaves[0], leaves[1], sc.H,
                                                               sc.W, sc.tb)
        splats = (xys, depths, radii, conics, nth, leaves[2], sc.opacity, sc.H, sc.W)
        kw = dict(backend="cuda", max_intersects=sc.budget)
        before = _launches("rows_loss")
        if fused:
            loss, sq = rasterize_rows_loss(*splats, gt_rows, mask, loss_type=loss_type, **kw)
        else:
            diff = (_clip01(rasterize_gaussians_sum(*splats, layout="rows", **kw))
                    - gt_rows) * mask
            sq = torch.sum(diff * diff)
            loss = sq if loss_type == "L2" else torch.sum(torch.abs(diff))
        out.append((loss.detach(), sq.detach(),
                    torch.autograd.grad(loss / denom, leaves)))
        assert _launches("rows_loss") == before + fused
    (loss, sq, grads), (loss_p, sq_p, grads_p) = out
    torch.testing.assert_close(loss, loss_p, rtol=1e-6, atol=0)
    torch.testing.assert_close(sq, sq_p, rtol=1e-6, atol=0)
    for a, b in zip(grads, grads_p):
        assert torch.equal(a, b) and float(b.abs().max()) > 0


@pytest.mark.parametrize("kind", ["represent", "qat"])
def test_rows_loss_launches_once_a_replayed_step(dev, kind):
    """A represent fit and a QAT fit on CUDA graphs launch E1 once a step,
    replays included (a replay adds the launches its capture counted)."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models import compress as comp
    from gsvc_tpu_torch.models import represent as rep

    H, W, n, its = 128, 160, 300, 30
    gen = torch.Generator(device=dev).manual_seed(2)
    gt = torch.rand((H, W, 3), device=dev, generator=gen)
    cfg = FrameConfig(H=H, W=W, num_points=n, max_num_points=n, iterations=its,
                      max_intersects=16384)
    before = graphs.launch_counts()
    replays = graphs.StepGraph.replays
    if kind == "represent":
        state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                     device=dev)
        rep.fit_frame_partial(state, gt, its, cfg)
    else:
        rng = np.random.default_rng(4)
        gmodel = {"_xyz": np.arctanh(rng.uniform(-0.9, 0.9, (n, 2))).astype(np.float32),
                  "_cholesky": rng.uniform(0, 2, (n, 3)).astype(np.float32),
                  "_features_dc": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
        comp.fit_compress(comp.init_compress_state(gmodel, None, dev), gt, cfg,
                          reload_best=False, draws=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    delta = {k: v - before.get(k, 0) for k, v in graphs.launch_counts().items()}
    assert graphs.StepGraph.replays - replays > 0
    assert delta["rows_loss"] == delta["forward_rows"] == delta["backward_slots"] == its

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: every test skips without a CUDA device (a kernel has no
CPU mode). On the card they build csrc/ with nvcc on first use. Run them
with `python -m pytest tests/test_torch_kernels.py -m cuda` on a GPU
machine; `python3 chip_smoke.py` does the same at 1080p/10k.

Tolerances: K1/K2 exact (integer index work); the forward kernel atol
1e-5 against the plain render (f32 sums in another order); the rows store
exactly `image_to_rows` of the image store (the same sums); K6's per-slot
grads, K3's scan and the autograd function's per-splat grads within 1e-4
of each tensor's largest entry (f32 sums over up to 256 pixels, or a
segment, in another order). The profiling harnesses' kernels
(gsvc_tpu_torch/scripts), at a small size and at 1080p/10k: P1's K4
variants max-abs 1e-4 and within 1e-4 of the plain version's largest
entry (no_acc's outputs are ~1e-5) against their plain versions, P5's job-based C and
D within 1e-4 of K6's largest slot, P6's transposes exactly.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians, key_inputs
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import image_to_rows, rasterize_gaussians_sum

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("n,hw,seed,budget,cap,big", [
    (500, (37, 83), 0, 16384, 256, False), (100, (48, 64), 3, 64, 256, False),
    (400, (40, 56), 2, 8192, 256, True), (120, (32, 32), 4, 4096, 4, False),
])
def test_kernels_match_plain_versions(dev, n, hw, seed, budget, cap, big):
    H, W = hw
    tb, (_m, _l, colors, opacity), (xys, _d, radii, conics, nth) = _scene(
        dev, n, H, W, seed, big)
    ki = key_inputs(xys, radii, nth, tb, 16, 16, budget)
    launches = fill_cuda.fill_decode_keys.launches
    keys = fill_cuda.fill_decode_keys(*ki)
    assert fill_cuda.fill_decode_keys.launches == launches + 1
    assert torch.equal(keys, fill_cuda.fill_decode_keys_torch(*ki))
    skeys = torch.sort(keys).values
    got = fill_cuda.rank_cap_decode(skeys, cap, n, ki.num_tiles)
    want = fill_cuda.rank_cap_decode_torch(skeys, cap, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap)
    plain = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap, kernels=False)
    for name in binned._fields:
        assert torch.equal(getattr(binned, name), getattr(plain, name)), name
    args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, cap)
    ref = rasterize_cuda.rasterize_forward_torch(*args)
    img = rasterize_cuda.forward_image(*args)
    chw = rasterize_cuda.forward_chw(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(chw, ref.permute(2, 0, 1), rtol=0, atol=1e-5)


def test_dispatch_and_refusals(dev):
    H, W = 40, 56
    tb, (_m, _l, colors, opacity), (xys, d, radii, conics, nth) = _scene(dev, 150, H, W, 5)
    before = rasterize_cuda.forward_chw.launches
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W,
                                  layout="chw")
    assert rasterize_cuda.forward_chw.launches == before + 1  # auto -> cuda
    ref = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W,
                                  backend="torch", layout="chw")
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-5)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 4096)
    args = [binned, xys, conics, colors, opacity, H, W, tb]
    with pytest.raises(ValueError):
        rasterize_cuda.forward_image(binned, xys.double(), *args[2:])
    ki = key_inputs(xys, radii, nth, tb, 16, 16, 4096)
    with pytest.raises(ValueError):
        fill_cuda.fill_decode_keys(ki.starts.long(), *ki[1:])


def _close(got, want, rel=1e-4):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-12, (err, scale)


@pytest.mark.parametrize("n,hw,seed,budget,cap,big", [
    (500, (37, 83), 0, 16384, 256, False), (400, (40, 56), 2, 8192, 256, True),
    (120, (32, 32), 4, 4096, 4, False), (300, (64, 48), 5, 64, 256, False),
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
        before = rasterize_cuda.backward_slots.launches
        img = (rasterize_cuda.rasterize_sum(*a) if kernels
               else rasterize_cuda.rasterize_forward_torch(*a))
        grads.append(torch.autograd.grad(torch.sum((img - 0.3) ** 2 * wgt), leaves))
        assert rasterize_cuda.backward_slots.launches == before + int(kernels)
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
        before = rasterize_cuda.backward_slots.launches
        out[backend] = comp._loss_and_grads(state, gt, cfg, _rows_target_for(gt, cfg),
                                            torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        assert rasterize_cuda.backward_slots.launches == before + (backend == "cuda")
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
        before = wrapper.launches
        got = wrapper(*sc.rargs)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = p1.render_parts_torch(v, *sc.rargs)
        err, largest = float((got - want).abs().max()), float(want.abs().max())
        assert largest > 0 and err <= 1e-4 and err <= 1e-4 * largest, (v, err, largest)


@pytest.mark.parametrize("size", list(_SIZES))
def test_job_kernels_match_k6_and_plain_versions(dev, size):
    """P5: C and D within 1e-4 of K6's largest slot (another summation
    order), A exactly its plain copy, B and E within 1e-4 of theirs."""
    from gsvc_tpu_torch.scripts import profile_bwd_variants as p5

    sc = _bench(dev, size)
    v = torch.randn((sc.H, sc.W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    bargs = (*sc.rargs[:5], image_to_rows(v, sc.H, sc.W), sc.H, sc.W, sc.tb)
    jobs = p5.build_jobs(sc.binned)
    k6 = rasterize_cuda.backward_slots(*bargs, 16, 16, 256, "rows")
    for name, wrapper in p5.BACKWARD_JOBS.items():
        before = wrapper.launches
        got = wrapper(*bargs, jobs)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        plain = p5.backward_jobs_torch(name, *bargs, jobs)
        if name == "A":
            assert torch.equal(got, plain)
        else:
            _close(got, k6 if name in "CD" else plain)
        if name in "CD":
            assert torch.equal(got != 0, k6 != 0)


@pytest.mark.parametrize("size", list(_SIZES))
def test_transpose_kernels_are_exact(dev, size):
    """P6: the transposes and rows -> planar exactly (copies)."""
    from gsvc_tpu_torch.scripts import probe_transpose as p6

    sc = _bench(dev, size)
    for x in p6.probe_inputs(sc, dev).values():
        assert torch.equal(p6.transpose_last2(x), p6.transpose_last2_torch(x))
    rows = rasterize_cuda.forward_rows(*sc.rargs)
    before = p6.rows_to_chw.launches
    planar = p6.rows_to_chw(rows, sc.H, sc.W, sc.tb)
    assert p6.rows_to_chw.launches == before + 1
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

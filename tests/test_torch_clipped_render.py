"""The eval render's clipped entry point on the CPU.

`ops.rasterize.rasterize_gaussians_sum_clipped` is, by its contract,
`torch.clamp(rasterize_gaussians_sum(...), 0, 1)` bitwise (the default
background); on the kernel path K4 / K5 fold the blend and the clamp into
their store (`rasterize_cuda.CLIPPED`, held to the chain bitwise on the
card in tests/test_torch_kernels.py), whose plain version runs here. So
every comparison below is exact: the plain version, the "torch" and "dense"
backends against the chain; `render_frame` and `forward_quantize` against
the chain they ran before; fast colour, C != 3 and the autograd path
taking the chain, the last still clipping with `_clip01`, with unchanged
gradients; the training loss still the rows layout through E1.
"""

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import init_splats
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.ops import loss_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import (
    _clip01,
    rasterize_gaussians_sum,
    rasterize_gaussians_sum_clipped,
)
from gsvc_tpu_torch.utils import graphs

H, W = 40, 56  # 3 x 4 tiles, the last tile row half past the image
TB = ((W + 15) // 16, (H + 15) // 16, 1)


def _splats(n=150, seed=0, dead=False, c_dim=3):
    """Projected splats whose colour sums fall below 0 and above 1."""
    rng = np.random.default_rng(seed)
    means = torch.as_tensor(rng.uniform(-1.1, 1.1, (n, 2)), dtype=torch.float32)
    L = torch.as_tensor(rng.uniform(0, 1, (n, 3)) + [0.5, 0.0, 0.5], dtype=torch.float32)
    colors = torch.as_tensor(rng.uniform(-0.5, 1.5, (n, c_dim)), dtype=torch.float32)
    opacity = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 1)), dtype=torch.float32)
    alive = torch.zeros(n, dtype=torch.bool) if dead else None
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, TB, alive=alive)
    return xys, d, radii, conics, nth, colors, opacity


def _same(a, b):
    """Bitwise equal, NaNs included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# the dense oracle takes no tile_rows and no fast_color
_CASES = [(b, c) for b in ("cuda", "torch", "dense", "auto")
          for c in ("default", "dead", "span", "fast")
          if b != "dense" or c not in ("span", "fast")]


@pytest.mark.parametrize("layout", ["image", "chw", "rows"])
@pytest.mark.parametrize("backend,case", _CASES)
def test_clipped_entry_is_the_chain(backend, case, layout):
    splats = _splats(seed=1, dead=case == "dead")
    kw = dict(backend=backend, layout=layout, tile_rows=(2, 2) if case == "span" else None,
              fast_color=case == "fast")
    got = rasterize_gaussians_sum_clipped(*splats, H, W, **kw)
    want = torch.clamp(rasterize_gaussians_sum(*splats, H, W, **kw), 0.0, 1.0)
    assert _same(got, want)
    if case == "dead":  # the background, ones, everywhere
        assert torch.equal(got, torch.ones_like(got))


@pytest.mark.parametrize("layout", ["image", "chw"])
@pytest.mark.parametrize("span", [None, (2, 2)])
@pytest.mark.parametrize("dead", [False, True])
def test_clipped_wrappers_on_cpu_are_the_plain_version(layout, span, dead):
    """The clipped K4 / K5 wrappers on CPU tensors: `forward_clipped_torch`,
    the chain on the raw wrapper's render, span padding included; no
    launch counted."""
    xys, _d, radii, conics, nth, colors, opacity = _splats(seed=2, dead=dead)
    colors[3] = float("nan")
    binned = bin_gaussians(xys, radii, nth, TB, 16, 16, 4096)
    args = (binned, xys, conics, colors, opacity, H, W, TB, 16, 16, 256, span)
    before = graphs.launch_counts()
    got = rasterize_cuda.CLIPPED[layout](*args)
    raw = rasterize_cuda.FORWARD[layout](*args)
    want = torch.clamp(rasterize_cuda.blend_background(
        raw, binned.num_intersects, torch.ones(3), layout), 0.0, 1.0)
    assert _same(got, want)
    assert _same(got, rasterize_cuda.forward_clipped_torch(*args[:11], layout, span))
    assert bool(got.isnan().any()) == (not dead and span is None)
    assert graphs.launch_counts() == before


def test_five_channels_fast_colour_and_gradients_take_the_chain(monkeypatch):
    """C != 3, fast colour and a render with an autograd node never reach
    the clipped wrappers; the last stays differentiable (`_clip01`)."""
    def refuse(*_a, **_k):
        raise AssertionError("the clipped wrapper ran")

    monkeypatch.setattr(rasterize_cuda, "CLIPPED", {k: refuse for k in ("image", "chw")})
    splats = _splats(seed=4, c_dim=5)
    got = rasterize_gaussians_sum_clipped(*splats, H, W, backend="cuda")
    assert got.shape == (H, W, 5)
    assert _same(got, torch.clamp(rasterize_gaussians_sum(*splats, H, W, backend="cuda"),
                                  0.0, 1.0))
    splats = _splats(seed=4)
    for layout in ("image", "chw"):
        got = rasterize_gaussians_sum_clipped(*splats, H, W, backend="cuda", layout=layout,
                                              fast_color=True)
        assert _same(got, torch.clamp(rasterize_gaussians_sum(
            *splats, H, W, backend="cuda", layout=layout, fast_color=True), 0.0, 1.0))
    xys, d, radii, conics, nth, colors, opacity = splats
    colors.requires_grad_()
    img = rasterize_gaussians_sum_clipped(xys, d, radii, conics, nth, colors, opacity, H, W,
                                          backend="cuda", layout="chw")
    assert img.requires_grad
    (g,) = torch.autograd.grad(img.sum(), colors)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def _cfg(backend):
    return FrameConfig(H=H, W=W, num_points=120, max_num_points=120, iterations=4,
                       backend=backend)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("layout", ["image", "chw", "rows"])
def test_render_frame_is_unchanged(backend, layout):
    """`render_frame` (no_grad) against the chain it ran before, bitwise:
    `torch.clamp` of `rasterize_gaussians_sum` on the same splats, whole
    grid and a span."""
    cfg = _cfg(backend)
    params, alive = init_splats(120, generator=torch.Generator().manual_seed(0))
    alive[::5] = False
    for span in (None, (1, 2)):
        got = rep.render_frame(params, alive, cfg, layout=layout, tile_rows=span)
        with torch.no_grad():
            img = rasterize_gaussians_sum(*rep._splats(params, alive, cfg), H, W,
                                          backend=backend, layout=layout, tile_rows=span)
        assert _same(got, torch.clamp(img, 0.0, 1.0))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_forward_quantize_is_unchanged_and_keeps_clip01(backend):
    """`forward_quantize`: the eval render bitwise the chain it ran before;
    with an autograd node, `_clip01` of the render, value and gradients."""
    cfg = _cfg(backend)
    rng = np.random.default_rng(5)
    gmodel = {"_xyz": np.arctanh(rng.uniform(-0.85, 0.85, (120, 2))).astype(np.float32),
              "_cholesky": rng.uniform(0, 1.5, (120, 3)).astype(np.float32),
              "_features_dc": rng.uniform(-0.5, 1.5, (120, 3)).astype(np.float32)}
    st = comp.init_compress_state(gmodel)
    args = (st.params, st.vq, st.p_xyz, st.p_cholesky, st.p_features_dc, cfg, False)
    for layout in ("image", "chw"):
        got = comp.forward_quantize(*args, layout=layout)[0]
        splats = comp._quantized_splats(*args)[0]
        img = rasterize_gaussians_sum(*splats, H, W, backend=backend, layout=layout)
        assert _same(got, torch.clamp(img, 0.0, 1.0))
    leaf = st.params.features_dc.clone().requires_grad_()
    params = type(st.params)(**{**vars(st.params), "features_dc": leaf})
    args = (params,) + args[1:]
    wgt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(6))
    got = comp.forward_quantize(*args)[0]
    (g_got,) = torch.autograd.grad((got * wgt).sum(), leaf)
    want = _clip01(rasterize_gaussians_sum(*comp._quantized_splats(*args)[0], H, W,
                                               backend=backend))
    (g_want,) = torch.autograd.grad((want * wgt).sum(), leaf)
    assert _same(got.detach(), want.detach()) and _same(g_got, g_want)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_autograd_render_keeps_clip01(backend):
    """`_render` with an autograd node: `_clip01` of `rasterize_gaussians_sum`
    (its gradient halves at a tie, where torch.clamp's would not), the
    clipped wrappers untouched."""
    cfg = _cfg(backend)
    params, alive = init_splats(120, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        params.features_dc.mul_(2.0).sub_(0.5)  # sums past both bounds
    leaves = [t.requires_grad_() for t in (params.xyz, params.cholesky, params.features_dc)]
    wgt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(8))
    before = graphs.launch_counts()
    got = rep._render(params, alive, cfg)
    g_got = torch.autograd.grad((got * wgt).sum(), leaves)
    want = _clip01(rasterize_gaussians_sum(*rep._splats(params, alive, cfg), H, W,
                                               backend=backend))
    g_want = torch.autograd.grad((want * wgt).sum(), leaves)
    assert _same(got.detach(), want.detach())
    assert all(_same(a, b) for a, b in zip(g_got, g_want))
    assert graphs.launch_counts() == before


def test_training_loss_still_runs_e1(monkeypatch):
    """The represent step's L2 loss on the kernel path stays the rows layout
    through E1 (`loss_cuda.rows_loss`), and never the clipped wrappers."""
    calls = []
    rows_loss = loss_cuda.rows_loss

    def counted(*a, **k):
        calls.append(a[0].shape)
        return rows_loss(*a, **k)

    def refuse(*_a, **_k):
        raise AssertionError("a training step ran the clipped wrapper")

    monkeypatch.setattr(loss_cuda, "rows_loss", counted)
    monkeypatch.setattr(rasterize_cuda, "forward_clipped_torch", refuse)
    cfg = _cfg("cuda")
    state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(9))
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(10))
    rows_target = rep._rows_target_for(gt, cfg)
    assert rows_target is not None
    rep.make_train_step(cfg)(state, gt, rows_target)
    assert calls and all(len(s) == 2 for s in calls)  # [rows, 256] tile-row blocks

"""The fast-colour mode of the sum rasterizer against gsvc_tpu's COLOR_BF16.

gsvc_tpu's mode (gsvc_tpu/ops/rasterize_pallas.py:279-287) runs the Pallas
kernels' colour and gradient matmuls as single bf16 products and the CHW
store's relayout in bf16; its stated bound is "max ~6.5e-3 absolute
output delta". The port's mode takes the card's fast exponential instead
(`__expf`; on CPU tensors the plain versions emulate it,
`ops.rasterize_binned.splat_vis`). The same numpy inputs go through
gsvc_tpu's Pallas kernels in interpret mode with COLOR_BF16 set (the
fixture sets and resets both module flags, clearing JAX's caches around
them; nothing in gsvc_tpu changes) and through the port's "cuda" backend
with fast_color=True, whose kernel wrappers run their plain versions on
the CPU. Limits: image, rows and CHW max-abs 6.5e-3; gradients within
4e-3 of each leaf's largest entry (gsvc_tpu states no bound for them), or
where gsvc_tpu's mode itself lies further from its exact mode (its
gradients through the same kernels with COLOR_BF16 unset), within that
distance and the exact modes' parity tolerance (1e-4 of the largest
entry, tests/test_rasterize_pallas.py). The rows store is compared on the
image's pixels (gsvc_tpu renders splats past the image edge there, the
port writes 0; the rows loss masks them, as training does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsvc_tpu.ops.rasterize_pallas as rp
from gsvc_tpu.ops.projection import project_gaussians_2d as jproject
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum as jrasterize
from gsvc_tpu_torch.ops import rasterize_cuda
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import (
    image_to_rows,
    rasterize_gaussians_sum,
    rows_to_image,
)
from gsvc_tpu_torch.ops.rasterize_binned import LOG2E, splat_vis

OUT_TOL = 6.5e-3  # gsvc_tpu's stated bound for its fast mode
GRAD_TOL = 4e-3  # of the largest entry
# (H, W, splats, seed): the scene of tests/test_rasterize_pallas.py:35-41
# at 37x51 and a ragged second size (neither side a multiple of 16)
SIZES = {"37x51": (37, 51, 150, 2), "45x70": (45, 70, 220, 5)}
PARITY = 1e-4  # the exact modes' gradient parity, of the largest entry


@pytest.fixture
def color_bf16():
    """gsvc_tpu's Pallas kernels in interpret mode; the test sets
    COLOR_BF16 with `_mode`. Both flags reset after, JAX's caches cleared."""
    jax.clear_caches()
    rp.INTERPRET = True
    yield _mode
    rp.INTERPRET, rp.COLOR_BF16 = False, False
    jax.clear_caches()


def _mode(bf16: bool) -> None:
    jax.clear_caches()  # a traced kernel keeps the flag it saw
    rp.COLOR_BF16 = bf16


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 1, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    return means, L, colors, opacity


def _jax(H, W, layout, target, mask, scene):
    """gsvc_tpu's render and the gradients of its masked L2 loss."""
    tb = ((W + 15) // 16, (H + 15) // 16, 1)

    def render(m, l, c, o):
        xys, d, radii, conics, nth = jproject(m, l, H, W, tb)
        return jrasterize(xys, d, radii, conics, nth, c, o, H, W, backend="pallas",
                          layout=layout)

    def loss(m, l, c, o):
        return jnp.mean(((render(m, l, c, o) - target) * mask) ** 2)

    args = [jnp.asarray(a) for a in scene]
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    return np.asarray(jax.jit(render)(*args)), [np.asarray(g) for g in grads]


def _torch_loss(H, W, layout, target, scene, fast_color, mask=1.0):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in scene]
    m, l, c, o = leaves
    xys, d, radii, conics, nth = project_gaussians_2d(m, l, H, W, tb)
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, c, o, H, W, backend="cuda",
                                  layout=layout, fast_color=fast_color)
    grads = torch.autograd.grad(torch.mean(((img - target) * mask) ** 2), leaves)
    return img.detach(), grads


def _rel(a, b) -> float:
    """max-abs of a - b over the largest entry of b."""
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("layout", ["image", "rows", "chw"])
@pytest.mark.parametrize("size", list(SIZES))
def test_fast_color_matches_gsvc_tpu_color_bf16(color_bf16, size, layout):
    H, W, n, seed = SIZES[size]
    scene = _scene(n, seed)
    shape = {"image": (H, W, 3), "chw": (3, H, W)}.get(layout)
    if layout == "rows":
        tb_x, tb_y = (W + 15) // 16, (H + 15) // 16
        shape = (tb_y * rasterize_cuda.round8(3 * tb_x), 256)
    target = np.full(shape, 0.4, np.float32)
    mask = np.ones(shape, np.float32)
    if layout == "rows":  # the image's pixels
        mask = image_to_rows(torch.ones((H, W, 3)), H, W).numpy()
    color_bf16(False)
    _, jexact = _jax(H, W, layout, target, mask, scene)
    color_bf16(True)
    jimg, jgrads = _jax(H, W, layout, target, mask, scene)
    img, grads = _torch_loss(H, W, layout, torch.from_numpy(target), scene, True,
                             torch.from_numpy(mask))
    assert img.shape == shape
    out_err = float(np.abs((img.numpy() - jimg) * mask).max())
    names = ("means", "L", "colors", "opacity")
    rel = {k: _rel(g, jg) for k, g, jg in zip(names, grads, jgrads)}
    own = {k: _rel(je, jg) for k, je, jg in zip(names, jexact, jgrads)}
    print(f"fast colour {size} {layout}: output max-abs {out_err:.3g}; gradients, the "
          "port's fast mode (gsvc_tpu's exact mode) against gsvc_tpu's fast mode, "
          "max-abs over the largest entry: "
          + ", ".join(f"{k} {rel[k]:.3g} ({own[k]:.3g})" for k in names))
    assert out_err <= OUT_TOL
    for k in names:
        assert rel[k] <= max(GRAD_TOL, own[k] + PARITY), (k, rel[k], own[k])
    if layout == "rows":  # the rows store is the image store, tiled
        img_store, _ = _torch_loss(H, W, "image", torch.full((H, W, 3), 0.4), scene, True)
        assert torch.equal(rows_to_image(img, H, W), img_store)


@pytest.mark.parametrize("layout", ["image", "rows", "chw"])
def test_fast_color_off_is_bitwise_the_default(layout):
    H, W, n, seed = SIZES["45x70"]
    scene = [torch.from_numpy(a) for a in _scene(n, seed)]
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, d, radii, conics, nth = project_gaussians_2d(*scene[:2], H, W, tb)
    for backend in ("cuda", "torch"):
        args = (xys, d, radii, conics, nth, scene[2], scene[3], H, W)
        if backend == "torch" and layout == "rows":
            continue
        want = rasterize_gaussians_sum(*args, backend=backend, layout=layout)
        off = rasterize_gaussians_sum(*args, backend=backend, layout=layout,
                                      fast_color=False)
        fast = rasterize_gaussians_sum(*args, backend=backend, layout=layout,
                                       fast_color=True)
        assert torch.equal(off, want), backend
        assert not torch.equal(fast, want), backend  # the mode reaches the render
        assert float((fast - want).abs().max()) < 1e-5, backend


def test_fast_plain_versions_take_the_fast_exponential():
    """splat_vis(., True) is exp2 of the float32 product -sigma * log2(e)
    (the card's __expf before ex2.approx's own ~2 ulp), and K6's plain
    version differentiates the same alpha as K4's."""
    assert np.float32(LOG2E) == np.float32(np.log2(np.e)) and float(np.float32(LOG2E)) == LOG2E
    sigma = torch.linspace(0.0, 12.0, 4001)
    fast = splat_vis(sigma, True)
    assert torch.equal(fast, torch.exp2(sigma * torch.tensor(-LOG2E)))
    assert torch.equal(splat_vis(sigma), torch.exp(-sigma))
    assert float(((fast - torch.exp(-sigma)) / torch.exp(-sigma)).abs().max()) < 1e-6
    H, W, n, seed = SIZES["37x51"]
    m, l, c, o = (torch.from_numpy(a) for a in _scene(n, seed))
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _d, radii, conics, nth = project_gaussians_2d(m, l, H, W, tb)
    from gsvc_tpu_torch.ops.binning import bin_gaussians, default_max_intersects

    binned = bin_gaussians(xys, radii, nth, tb, 16, 16,
                           default_max_intersects(n, tb[0] * tb[1]))
    geom = (H, W, tb, 16, 16, 256)
    v = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (xys, conics, c, o)]
    img = rasterize_cuda.rasterize_forward_torch(binned, *leaves, *geom, fast_color=True)
    want = torch.autograd.grad((img * v).sum(), leaves)
    slots = rasterize_cuda.backward_slots(binned, xys, conics, c, o, v, *geom,
                                          fast_color=True)
    got = rasterize_cuda.reduce_slot_grads(slots, binned.gauss_slot_start)
    for g, w, name in zip(got, want, ("xys", "conics", "colors", "opacity")):
        scale = float(w.abs().max())
        assert float((g.reshape(w.shape) - w).abs().max()) <= 1e-5 * scale, name
    exact = rasterize_cuda.backward_slots(binned, xys, conics, c, o, v, *geom)
    assert not torch.equal(slots, exact)

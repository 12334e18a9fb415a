"""PyTorch port parity: the sum rasterizer against gsvc_tpu.

The port's backends (cuda, whose wrappers run their plain versions on CPU
tensors; torch; dense) render in both layouts and are held against JAX's
`binned` and `dense` backends at atol 1e-5 (f32 sums over at most 256
splats per pixel, taken in another order).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.ops.projection import project_gaussians_2d as jproject
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum as jrasterize
from gsvc_tpu_torch.ops import rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians, default_max_intersects
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import blend_background, rasterize_gaussians_sum
from gsvc_tpu_torch.ops.rasterize_binned import rasterize_binned
from gsvc_tpu_torch.utils import graphs

ATOL = 1e-5
H, W = 40, 56  # H, W not multiples of 16


def _scene(n, c_dim=3, seed=0, alive_frac=1.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 1, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    colors = rng.uniform(0, 1, (n, c_dim)).astype(np.float32)
    opacity = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    alive = rng.uniform(size=n) < alive_frac
    return means, L, colors, opacity, alive


@lru_cache(maxsize=None)
def _jax_render(backend):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)

    def f(m, l, c, o, alive, bg):
        xys, d, radii, conics, nth = jproject(m, l, H, W, tb, alive=alive)
        return jrasterize(xys, d, radii, conics, nth, c, o, H, W,
                          background=bg, backend=backend)

    return jax.jit(f)


def _torch_render(scene, backend, layout="image", background=None, **kw):
    means, L, colors, opacity, alive = (torch.from_numpy(a) for a in scene)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb, alive=alive)
    return rasterize_gaussians_sum(
        xys, d, radii, conics, nth, colors, opacity, H, W,
        background=background, backend=backend, layout=layout, **kw,
    )


def _jax(scene, backend, background=None):
    c_dim = scene[2].shape[1]
    bg = np.ones(c_dim, np.float32) if background is None else background
    return np.asarray(_jax_render(backend)(*(jnp.asarray(a) for a in scene),
                                           jnp.asarray(bg)))


@pytest.mark.parametrize("backend", ["cuda", "torch", "dense", "auto"])
@pytest.mark.parametrize("layout", ["image", "chw"])
def test_render_matches_jax_binned_and_dense(backend, layout):
    scene = _scene(150, seed=1, alive_frac=0.9)
    img = _torch_render(scene, backend, layout).numpy()
    if layout == "chw":
        assert img.shape == (3, H, W)
        img = img.transpose(1, 2, 0)
    assert img.shape == (H, W, 3)
    for jb in ("binned", "dense"):
        np.testing.assert_allclose(img, _jax(scene, jb), rtol=0, atol=ATOL,
                                   err_msg=jb)


def test_tile_cap_saturation_matches_jax():
    # 400 large splats on a 3x4 tile grid saturate the 256 cap; colours are
    # scaled so the sums stay O(1), where atol 1e-5 is ~100 f32 ulps
    scene = _scene(400, seed=2)
    scene[1][:] = np.array([8.0, 0.0, 8.0], np.float32)
    scene[2][:] /= 32.0
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _d, radii, _c, nth = project_gaussians_2d(
        torch.from_numpy(scene[0]), torch.from_numpy(scene[1]), H, W, tb)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16,
                           default_max_intersects(400, tb[0] * tb[1]))
    assert int(binned.tile_counts.max()) > 256
    img = _torch_render(scene, "auto").numpy()
    np.testing.assert_allclose(img, _jax(scene, "binned"), rtol=0, atol=ATOL)
    np.testing.assert_allclose(img, _jax(scene, "dense"), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["image", "chw"])
def test_zero_intersects_returns_background(layout):
    scene = _scene(20, seed=3, alive_frac=0.0)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    for backend in ("cuda", "torch", "dense"):
        img, alpha = _torch_render(scene, backend, layout, torch.from_numpy(bg),
                                   return_alpha=True)
        want = _jax(scene, "binned", bg)
        got = img.numpy().transpose(1, 2, 0) if layout == "chw" else img.numpy()
        np.testing.assert_array_equal(got, want)
        assert alpha.shape == (H, W) and not alpha.any()


@pytest.mark.parametrize("total", [0, 1])
@pytest.mark.parametrize("layout", ["image", "chw", "rows"])
def test_blend_background_per_layout(layout, total):
    """`blend_background`, shared by the renders and E1's plain version:
    the render where an intersection was kept, else the background in the
    layout's channel order (rows: block row r holds channel r % 3)."""
    bg = torch.tensor([0.25, 0.5, 0.75])
    shape = {"image": (5, 4, 3), "chw": (3, 5, 4), "rows": (7, 8)}[layout]
    img = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    got = blend_background(img, torch.tensor(total, dtype=torch.int32), bg, layout)
    if total:
        assert torch.equal(got, img)
        return
    want = {"image": bg.expand(5, 4, 3), "chw": bg[:, None, None].expand(3, 5, 4),
            "rows": bg[torch.arange(7) % 3][:, None].expand(7, 8)}[layout]
    assert torch.equal(got, want)


def test_five_channels_route_to_binned():
    scene = _scene(150, c_dim=5, seed=4)
    want = _jax(scene, "binned")
    for backend in ("cuda", "torch"):
        img = _torch_render(scene, backend).numpy()
        assert img.shape == (H, W, 5)
        np.testing.assert_allclose(img, want, rtol=0, atol=ATOL)
    chw = _torch_render(scene, "cuda", "chw").numpy()
    np.testing.assert_allclose(chw.transpose(1, 2, 0), want, rtol=0, atol=ATOL)


def test_forward_wrappers_on_cpu_are_the_plain_version():
    means, L, colors, opacity, _ = (torch.from_numpy(a) for a in _scene(150, seed=5))
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 4096)
    args = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, 256)
    ref = rasterize_binned(*args)
    before = graphs.launch_counts()
    assert torch.equal(rasterize_cuda.forward_image(*args), ref)
    assert torch.equal(rasterize_cuda.forward_chw(*args), ref.permute(2, 0, 1))
    assert graphs.launch_counts() == before  # no kernel launch for CPU tensors


@lru_cache(maxsize=None)
def _jax_grad_fn(backend):
    tb = ((W + 15) // 16, (H + 15) // 16, 1)

    def loss(m, l, c, o, wgt):
        xys, d, radii, conics, nth = jproject(m, l, H, W, tb)
        img = jrasterize(xys, d, radii, conics, nth, c, o, H, W, backend=backend)
        return jnp.mean((img - 0.3) ** 2 * wgt)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))


def _torch_grads(scene, wgt, backend):
    means, L, colors, opacity = (torch.from_numpy(a).requires_grad_() for a in scene[:4])
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W,
                                  backend=backend)
    loss = torch.mean((img - 0.3) ** 2 * torch.from_numpy(wgt))
    return torch.autograd.grad(loss, (means, L, colors, opacity))


@pytest.mark.parametrize("backend", ["torch", "dense", "cuda"])
def test_gradients_with_opacity_above_one_match_jax(backend):
    # opacity up to 2 puts opac * vis > 1 near many centres, where alpha's
    # min(1, .) must pass the gradient through (forward-only, as gsvc_tpu's
    # `_min1_forward_only`); a plain clamp would zero it there
    scene = list(_scene(120, seed=7))
    scene[3] = np.random.default_rng(8).uniform(0.2, 2.0, (120, 1)).astype(np.float32)
    wgt = np.random.default_rng(9).uniform(0.5, 1.5, (H, W, 3)).astype(np.float32)
    want = _jax_grad_fn("binned")(*(jnp.asarray(a) for a in scene[:4]), jnp.asarray(wgt))
    got = _torch_grads(scene, wgt, backend)
    for name, g, w in zip(("means", "L", "colors", "opacity"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-6,
                                   err_msg=name)


def test_unported_options_raise():
    scene = _scene(10, seed=6)
    with pytest.raises(ValueError):  # rows hold exactly 3 channels
        _torch_render(_scene(10, c_dim=5, seed=6), "auto", "rows")
    with pytest.raises(ValueError):
        _torch_render(scene, "auto", "rows", return_alpha=True)
    # a tile-row span renders on the binned backends (16 pixel rows of the
    # 3-row grid here); the dense oracle refuses it, as gsvc_tpu's does
    assert _torch_render(scene, "auto", tile_rows=(0, 1)).shape == (16, W, 3)
    with pytest.raises(ValueError):
        _torch_render(scene, "dense", tile_rows=(0, 1))
    with pytest.raises(ValueError):
        _torch_render(scene, "pallas")


# -- the kernels' launch geometry (host side: the kernels run on a card) -----


@pytest.mark.parametrize("cap", [4, 24, 256])
def test_shared_bytes_are_the_kernels_staging(cap):
    # rasterize_bwd.cuh stages the gradient float [3][256], then Lane [cap]
    # of 48 bytes (two float4, the third colour, the slot)
    assert rasterize_cuda.backward_smem_bytes(cap) == 4 * 3 * 256 + 48 * cap
    assert rasterize_cuda.backward_smem_bytes(cap) <= rasterize_cuda.SMEM_LIMIT


@pytest.mark.parametrize("num_tiles,sms,want", [
    (8160, 132, 4224), (12, 132, 12), (0, 132, 0), (2000, 1, 32)])
def test_forward_grid_covers_every_tile_once(num_tiles, sms, want):
    grid = rasterize_cuda.forward_grid(num_tiles, sms)
    assert grid == want
    # CTA b takes tiles b, b + grid, b + 2 * grid, ...
    taken = [t for b in range(grid) for t in range(b, num_tiles, grid)]
    assert sorted(taken) == list(range(num_tiles))


def test_check_inputs_refuses_what_the_kernels_cannot_take():
    means, L, colors, opacity, _ = (torch.from_numpy(a) for a in _scene(60, seed=4))
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, _d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 4096)
    args = ("t", binned, xys, conics, colors, opacity, tb)
    most = (rasterize_cuda.SMEM_LIMIT - 3072) // 48  # K6's: 960 lanes
    assert len(rasterize_cuda.check_inputs(*args, 16, 16, most)) == 4
    with pytest.raises(ValueError, match="16x16 tiles"):
        rasterize_cuda.check_inputs(*args, 8, 8, 256)
    with pytest.raises(ValueError, match="shared bytes"):
        rasterize_cuda.check_inputs(*args, 16, 16, most + 1)
    with pytest.raises(ValueError, match="shared bytes"):
        rasterize_cuda.check_inputs(*args, 16, 16, 0)

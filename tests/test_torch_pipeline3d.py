"""PyTorch port parity: the 3D splat pipeline against gsvc_tpu.

`project_gaussians_2d_scale_rot`, ops/projection3d.py, ops/sh.py and the
depth-ordered alpha compositor (ops/rasterize_alpha.py, and the card's
route, ops/rasterize_alpha_cuda.py, whose wrappers run their plain
versions on these CPU tensors), on the same numpy inputs drawn from a seed.

Tolerances: values rtol 1e-5 / atol 1e-5, gradients (jax.grad against
torch.autograd) rtol 1e-4 / atol 1e-5 (the same float32 formulas, summed
in another order); int32 radii and tile counts exactly. gsvc_tpu's
compositor runs its XLA scan on the CPU (it has no Pallas kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.ops import projection as jproj
from gsvc_tpu.ops import projection3d as jp3
from gsvc_tpu.ops import rasterize_alpha as jra
from gsvc_tpu.ops import sh as jsh
from gsvc_tpu_torch.ops import projection, projection3d, rasterize_alpha, sh
from gsvc_tpu_torch.ops import rasterize_alpha_cuda as rac

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _outputs_match(t_out, j_out, names):
    for name, a, b in zip(names, t_out, j_out):
        b = np.asarray(b)
        if name in ("radii", "num_tiles_hit"):
            assert a.dtype == torch.int32 and b.dtype == np.int32, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            _close(a, b, VAL, name)


def _arr(lib, a):
    """A numpy array as a tensor of `lib` (torch or jax.numpy)."""
    return torch.tensor(a) if lib is torch else jnp.asarray(a)


_JAX = {}  # gsvc_tpu's results by key, shared by a test's parametrised routes


def _jax_grads(j_fn, arrays, key=None):
    """jit(grad(j_fn)) in every argument (cached under `key`)."""
    if key is None or key not in _JAX:
        out = jax.jit(jax.grad(j_fn, argnums=tuple(range(len(arrays)))))(
            *map(jnp.asarray, arrays))
        if key is None:
            return out
        _JAX[key] = out
    return _JAX[key]


def _grads_match(t_fn, j_fn, arrays, key=None):
    """jax.grad of j_fn against torch.autograd of t_fn, in every argument
    (an argument the loss does not reach: zeros)."""
    jg = _jax_grads(j_fn, arrays, key)
    targs = _t(*arrays, grad=True)
    tg = torch.autograd.grad(t_fn(*targs), targs, allow_unused=True)
    tg = [torch.zeros_like(t) if g is None else g for g, t in zip(tg, targs)]
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert np.all(np.isfinite(a.numpy()))
        _close(a, b, GRAD, f"grad {i}")


# ------------------------------------------------------------ 2D scale + rotation


@pytest.mark.parametrize("hw,seed,use_alive", [((64, 64), 1, False), ((37, 51), 2, True)])
def test_scale_rot_matches_jax(hw, seed, use_alive):
    H, W = hw
    rng = np.random.default_rng(seed)
    n = 150
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 3.0, (n, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32)
    scales[:4] = 0.0  # det == 0: rejected
    alive = rng.uniform(size=n) > 0.2
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    j = jproj.project_gaussians_2d_scale_rot(
        *map(jnp.asarray, (means, scales, theta)), H, W, tb,
        alive=jnp.asarray(alive) if use_alive else None)
    t = projection.project_gaussians_2d_scale_rot(
        *_t(means, scales, theta), H, W, tb,
        alive=torch.from_numpy(alive) if use_alive else None)
    _outputs_match(t, j, ("xys", "depths", "radii", "conics", "num_tiles_hit"))
    assert (t[2][:4] == 0).all()
    if use_alive:
        assert (t[2].numpy()[~alive] == 0).all() and (t[4].numpy()[~alive] == 0).all()
    w = rng.normal(size=(n, 5)).astype(np.float32)

    def loss(proj, lib):
        def f(m, s, r):
            xys, _d, _r, conics, _k = proj(m, s, r, H, W, tb)
            wl = _arr(lib, w)
            return lib.sum(xys * wl[:, :2]) + lib.sum(conics * wl[:, 2:])
        return f

    _grads_match(loss(projection.project_gaussians_2d_scale_rot, torch),
                 loss(jproj.project_gaussians_2d_scale_rot, jnp), (means, scales, theta))


# ------------------------------------------------------------ 3D projection


def _camera(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4) * [1.0, 0.15, 0.15, 0.15] + [3.0, 0, 0, 0]
    R = np.asarray(jp3.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R
    view[:3, 3] = rng.normal(scale=0.2, size=3)
    return view


def _gaussians3d(n, seed):
    """n gaussians placed in the view space of `_camera(seed)` (two behind
    the camera or inside the clip distance, two far outside the frustum),
    returned in world space."""
    rng = np.random.default_rng(seed)
    p_view = np.concatenate([
        rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 8.0], (n - 8, 3)),
        [[0.0, 0.0, -2.0], [0.1, 0.0, 0.005]],  # behind the camera, inside clip
        [[30.0, 0.0, 3.0], [-25.0, 12.0, 2.5]],  # far outside: the 1.3 tan_fov clamp
        rng.uniform([-1.0, -1.0, 3.0], [1.0, 1.0, 4.0], (4, 3)),
    ])
    view = _camera(seed).astype(np.float64)
    means = ((p_view - view[:3, 3]) @ view[:3, :3]).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return means, scales, quats


def test_rotation_and_cov3d_match_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    q[0] = 0.0  # a zero quaternion: the 1e-12 guard
    s = rng.uniform(0.1, 2.0, (40, 3)).astype(np.float32)
    _close(projection3d.quat_to_rotmat(torch.tensor(q)), jp3.quat_to_rotmat(jnp.asarray(q)),
           VAL, "rotmat")
    _close(projection3d.scale_rot_to_cov3d(torch.tensor(s), 1.5, torch.tensor(q)),
           jp3.scale_rot_to_cov3d(jnp.asarray(s), 1.5, jnp.asarray(q)), VAL, "cov3d")
    w = rng.normal(size=(40, 3, 3)).astype(np.float32)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    _grads_match(lambda a, b: torch.sum(projection3d.scale_rot_to_cov3d(a, 1.5, b) * torch.tensor(w)),
                 lambda a, b: jnp.sum(jp3.scale_rot_to_cov3d(a, 1.5, b) * w), (s, q))


def test_ewa_and_pix_match_jax():
    means, scales, quats = _gaussians3d(40, 5)
    view = _camera(5)
    cov3d = np.asarray(jp3.scale_rot_to_cov3d(jnp.asarray(scales), 1.0, jnp.asarray(quats)))
    args = (60.0, 55.0, 0.6, 0.45)
    _close(projection3d.project_cov3d_ewa(*_t(means, cov3d, view), *args),
           jp3.project_cov3d_ewa(*map(jnp.asarray, (means, cov3d, view)), *args), VAL, "ewa")
    keep = means[:, 2] > 0.5
    p = means[keep]
    _close(projection3d.project_pix((60.0, 55.0), torch.tensor(p), (32.0, 24.0)),
           jp3.project_pix((60.0, 55.0), jnp.asarray(p), (32.0, 24.0)), VAL, "pix")
    w = np.random.default_rng(6).normal(size=(40, 3)).astype(np.float32)
    _grads_match(
        lambda m, c: torch.sum(projection3d.project_cov3d_ewa(m, c, torch.tensor(view), *args)
                               * torch.tensor(w)),
        lambda m, c: jnp.sum(jp3.project_cov3d_ewa(m, c, jnp.asarray(view), *args) * w),
        (means, cov3d))


@pytest.mark.parametrize("hw,seed", [((48, 64), 0), ((33, 47), 1)])
def test_project_gaussians_matches_jax(hw, seed):
    H, W = hw
    n = 80
    means, scales, quats = _gaussians3d(n, seed)
    view = _camera(seed)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    cam = (60.0, 58.0, W / 2, H / 2, H, W, tb)
    j = jp3.project_gaussians(*map(jnp.asarray, (means, scales)), 1.2, jnp.asarray(quats),
                              jnp.asarray(view), *cam)
    t = projection3d.project_gaussians(*_t(means, scales), 1.2, torch.tensor(quats),
                                       torch.tensor(view), *cam)
    names = ("xys", "depths", "radii", "conics", "num_tiles_hit", "cov3d")
    _outputs_match(t, j, names)
    radii, nth, depths = t[2].numpy(), t[4].numpy(), t[1].numpy()
    culled = (means @ view[:3, :3].T + view[:3, 3])[:, 2] <= 0.01
    assert culled.sum() >= 2 and (radii[culled] == 0).all() and (nth[culled] == 0).all()
    assert (depths[culled] == 0).all() and np.isfinite(t[0].numpy()).all()
    assert (radii[~culled] > 0).sum() > n // 2
    w = np.random.default_rng(seed + 10).normal(size=(n, 9)).astype(np.float32)

    def loss(fn, lib, mat):
        def f(m, s, q):
            xys, d, _r, conics, _k, cov3d = fn(m, s, 1.2, q, mat, *cam)
            wl = _arr(lib, w)
            return (lib.sum(xys * wl[:, :2]) + lib.sum(conics * wl[:, 2:5])
                    + lib.sum(d * wl[:, 5]) + lib.sum(cov3d[:, 0] * wl[:, 6:9]))
        return f

    _grads_match(loss(projection3d.project_gaussians, torch, torch.tensor(view)),
                 loss(jp3.project_gaussians, jnp, jnp.asarray(view)), (means, scales, quats))


# ------------------------------------------------------------ spherical harmonics


def test_sh_bases_and_errors():
    assert [sh.num_sh_bases(d) for d in range(5)] == [jsh.num_sh_bases(d) for d in range(5)]
    assert [sh.deg_from_sh(k) for k in (1, 4, 9, 16, 25)] == [0, 1, 2, 3, 4]
    for bad in (lambda: sh.num_sh_bases(5), lambda: sh.num_sh_bases(-1),
                lambda: sh.deg_from_sh(7),
                lambda: sh.spherical_harmonics(3, torch.ones(2, 3), torch.ones(2, 9, 3)),
                lambda: sh.spherical_harmonics(1, torch.ones(2, 3), torch.ones(2, 5, 3))):
        with pytest.raises(ValueError):
            bad()
    d = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(sh.eval_sh_bases(25, torch.tensor(d)), jsh.eval_sh_bases(25, jnp.asarray(d)),
           VAL, "bases")


@pytest.mark.parametrize("degree,use", [(0, 0), (1, 1), (2, 1), (3, 3), (4, 4), (4, 2)])
def test_spherical_harmonics_matches_jax(degree, use):
    rng = np.random.default_rng(degree * 7 + use)
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(30, k, 3)).astype(np.float32)
    dirs = rng.normal(size=(30, 3)).astype(np.float32) * 3.0
    _close(sh.spherical_harmonics(use, *_t(dirs, coeffs)),
           jsh.spherical_harmonics(use, *map(jnp.asarray, (dirs, coeffs))), VAL, "sh")
    w = rng.normal(size=(30, 3)).astype(np.float32)
    _grads_match(lambda d, c: torch.sum(sh.spherical_harmonics(use, d, c) * torch.tensor(w)),
                 lambda d, c: jnp.sum(jsh.spherical_harmonics(use, d, c) * w), (dirs, coeffs))


# ------------------------------------------------------------ alpha compositor


def _alpha_scene(rng, n, H, W, c_dim=3):
    """gsvc_tpu's test scene (tests/test_pipeline3d.py `_random_scene`)."""
    xys = rng.uniform(0, [W, H], (n, 2)).astype(np.float32)
    depths = rng.uniform(1.0, 10.0, n).astype(np.float32)
    L = np.stack(
        [rng.uniform(1.0, 4.0, n), rng.normal(0, 0.5, n), rng.uniform(1.0, 4.0, n)], axis=1)
    cov = np.stack([L[:, 0] ** 2, L[:, 0] * L[:, 1], L[:, 1] ** 2 + L[:, 2] ** 2], axis=1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conics = np.stack([cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det],
                      axis=1).astype(np.float32)
    tr = 0.5 * (cov[:, 0] + cov[:, 2])
    radii = np.ceil(3 * np.sqrt(tr + np.sqrt(np.maximum(0.1, tr**2 - det)))).astype(np.int32)
    colors = rng.uniform(0, 1, (n, c_dim)).astype(np.float32)
    opacity = rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    return xys, depths, radii, conics, colors, opacity


def _port_alpha(route):
    """The port's compositor: the plain version ("torch") or the card's
    route through ops/rasterize_alpha_cuda.py ("route")."""
    def f(xys, depths, radii, conics, colors, opacity, H, W, background=None,
          return_alpha=False, chunk=256, num_tiles_hit=None):
        if route == "torch":
            return rasterize_alpha.rasterize_gaussians_alpha(
                xys, depths, radii, conics, num_tiles_hit, colors, opacity, H, W,
                background=background, return_alpha=return_alpha, chunk=chunk,
                backend="torch")
        return rac.rasterize_alpha(xys, depths, radii, conics, colors, opacity, H, W,
                                   background=background, return_alpha=return_alpha)
    return f


def _compare_alpha(route, scene, H, W, bg, chunk, seed, grads=True):
    """Values (image and alpha) and gradients in xys, conics, colors,
    opacity and background of a random loss, port against gsvc_tpu."""
    xys, depths, radii, conics, colors, opacity = scene
    c_dim = colors.shape[1]
    rng = np.random.default_rng(seed)
    v_img = rng.normal(size=(H, W, c_dim)).astype(np.float32)
    v_alpha = rng.normal(size=(H, W)).astype(np.float32)

    def jf(x, c, col, op, b):
        img, a = jra.rasterize_gaussians_alpha(
            x, jnp.asarray(depths), jnp.asarray(radii), c, None, col, op, H, W,
            background=b, return_alpha=True, chunk=chunk)
        return jnp.sum(img * v_img) + jnp.sum(a * v_alpha), (img, a)

    arrays = (xys, conics, colors, opacity, bg)
    key = ("alpha", H, W, chunk, seed, c_dim, xys.tobytes(), depths.tobytes())
    if key not in _JAX:
        _JAX[key] = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *map(jnp.asarray, arrays))
    (_l, (jimg, jalpha)), jg = _JAX[key]
    targs = _t(*arrays, grad=True)
    img, alpha = _port_alpha(route)(targs[0], torch.tensor(depths), torch.tensor(radii),
                                    targs[1], targs[2], targs[3], H, W, background=targs[4],
                                    return_alpha=True, chunk=chunk)
    _close(img, jimg, VAL, "image")
    _close(alpha, jalpha, VAL, "alpha")
    if grads:
        loss = torch.sum(img * torch.tensor(v_img)) + torch.sum(alpha * torch.tensor(v_alpha))
        tg = torch.autograd.grad(loss, targs)
        for name, a, b in zip(("xys", "conics", "colors", "opacity", "background"), tg, jg):
            assert np.all(np.isfinite(a.numpy())), name
            _close(a, b, GRAD, name)
    return img


@pytest.mark.parametrize("route", ["torch", "route"])
@pytest.mark.parametrize("c_dim", [1, 3, 5, 40])
def test_alpha_matches_jax(route, c_dim):
    """33x47 (no multiple of 16), a background and the alpha channel; C = 40
    runs the card route's channel groups (32 + 8)."""
    H, W = 33, 47
    rng = np.random.default_rng(7 + c_dim)
    scene = _alpha_scene(rng, 120, H, W, c_dim)
    scene[2][:6] = 0  # invalid splats
    bg = rng.uniform(0, 1, c_dim).astype(np.float32)
    _compare_alpha(route, scene, H, W, bg, 16, c_dim)


def test_alpha_numpy_oracle_matches_jax_and_port():
    H, W = 19, 23
    rng = np.random.default_rng(11)
    xys, depths, radii, conics, colors, opacity = _alpha_scene(rng, 25, H, W)
    bg = rng.uniform(0, 1, 3).astype(np.float32)
    mine = rasterize_alpha.rasterize_gaussians_alpha_np_oracle(
        xys, depths, radii, conics, colors, opacity, H, W, background=bg)
    theirs = jra.rasterize_gaussians_alpha_np_oracle(
        xys, depths, radii, conics, colors, opacity, H, W, background=bg)
    np.testing.assert_array_equal(mine, theirs)
    for route in ("torch", "route"):
        img = _port_alpha(route)(*_t(xys, depths, radii, conics, colors, opacity), H, W,
                                 background=torch.tensor(bg))
        _close(img, mine, dict(rtol=1e-4, atol=1e-4), route)


@pytest.mark.parametrize("route", ["torch", "route"])
def test_alpha_occlusion_order(route):
    """gsvc_tpu's occlusion scene (tests/test_pipeline3d.py:220-241): the
    near splat wins whatever its index, background where nothing renders."""
    H = W = 32
    xys = np.array([[16.0, 16.0], [16.0, 16.0]], np.float32)
    conics = np.tile(np.array([[0.5, 0.0, 0.5]], np.float32), (2, 1))
    radii = np.array([10, 10], np.int32)
    colors = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32)
    opacity = np.array([[50.0], [50.0]], np.float32)  # alpha -> 0.999
    bg = np.array([0.0, 0.0, 1.0], np.float32)
    depths = np.array([5.0, 1.0], np.float32)
    img = _compare_alpha(route, (xys, depths, radii, conics, colors, opacity), H, W, bg,
                         256, 3).detach().numpy()
    assert img[16, 16, 1] > 0.99 and img[16, 16, 0] < 0.01
    np.testing.assert_allclose(img[0, 0], [0, 0, 1.0], atol=1e-3)


@pytest.mark.parametrize("route", ["torch", "route"])
def test_alpha_early_termination(route):
    """gsvc_tpu's scene (tests/test_pipeline3d.py:268-285): once T <= 1e-4 a
    pixel composites nothing more, so a bright splat behind five opaque ones
    adds nothing; no gradient reaches it."""
    H = W = 16
    n = 6
    xys = np.tile(np.array([[8.0, 8.0]], np.float32), (n, 1))
    conics = np.tile(np.array([[0.02, 0.0, 0.02]], np.float32), (n, 1))
    radii = np.full((n,), 30, np.int32)
    colors = np.zeros((n, 3), np.float32)
    colors[5] = 1e6
    opacity = np.full((n, 1), 10.0, np.float32)
    depths = np.arange(1, 7, dtype=np.float32)
    args = _t(xys, depths, radii, conics, colors, opacity)
    args[4].requires_grad_()
    img = _port_alpha(route)(*args, H, W, chunk=2)
    assert float(img.detach().abs().max()) < 1e-3
    (g,) = torch.autograd.grad(img.sum(), [args[4]])
    assert float(g[5].abs().max()) == 0.0
    jimg = jra.rasterize_gaussians_alpha(*map(jnp.asarray, (xys, depths, radii, conics)),
                                         None, jnp.asarray(colors), jnp.asarray(opacity),
                                         H, W, chunk=2)
    _close(img, jimg, VAL, "image")


@pytest.mark.parametrize("route", ["torch", "route"])
def test_alpha_tile_past_256_members(route):
    """300 faint splats over one 16x16 tile: every one composites (the
    sum rasterizer's cap of 256 does not apply), as in gsvc_tpu."""
    H = W = 16
    n = 300
    rng = np.random.default_rng(12)
    xys = rng.uniform(4, 12, (n, 2)).astype(np.float32)
    conics = np.tile(np.array([[0.01, 0.0, 0.01]], np.float32), (n, 1))
    radii = np.full((n,), 20, np.int32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.01, 0.02, (n, 1)).astype(np.float32)
    depths = rng.uniform(1, 5, n).astype(np.float32)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    scene = (xys, depths, radii, conics, colors, opacity)
    _compare_alpha(route, scene, H, W, bg, 64, 13)
    db = rac.bin_depth_ordered(*_t(xys, depths, radii), (1, 1, 1))
    assert int(db.binned.tile_counts[0]) == n and db.total == n
    _img, _a, T, last = rac.alpha_forward(db.binned, *_t(xys, conics, colors, opacity, bg),
                                          H, W, (1, 1, 1))
    assert int(last.min()) == n - 1 and float(T.min()) > 1e-4  # the last lane composites


def test_alpha_ignores_num_tiles_hit():
    H, W = 33, 47
    scene = _alpha_scene(np.random.default_rng(3), 60, H, W)
    xys, depths, radii, conics, colors, opacity = _t(*scene)
    ref = rasterize_alpha.rasterize_gaussians_alpha(
        xys, depths, radii, conics, None, colors, opacity, H, W)
    wrong = torch.zeros_like(radii)
    for backend in ("auto", "torch"):
        out = rasterize_alpha.rasterize_gaussians_alpha(
            xys, depths, radii, conics, wrong, colors, opacity, H, W, backend=backend)
        assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        rasterize_alpha.rasterize_gaussians_alpha(
            xys, depths, radii, conics, None, colors, opacity, H, W, backend="cuda")


def test_depth_binning_gives_gsvc_tpu_members():
    """The card route's binning (depth permutation, the exact budget, no cap,
    K1 / K2 through their wrappers) holds, tile by tile and in depth order,
    the splats gsvc_tpu's compositor masks in: valid (radii > 0) and the
    tile inside `_tile_bbox` of the radius."""
    H, W = 70, 90
    rng = np.random.default_rng(14)
    xys, depths, radii, _c, _col, _op = _alpha_scene(rng, 200, H, W)
    depths[::7] = depths[0]  # ties: broken by index
    radii[::9] = 0
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    db = rac.bin_depth_ordered(*_t(xys, depths, radii), tb)
    order = np.asarray(jnp.argsort(jnp.asarray(depths), stable=True))
    np.testing.assert_array_equal(db.order.numpy(), order)
    x0, y0, x1, y1 = map(np.asarray, jproj._tile_bbox(
        jnp.asarray(xys[order]), jnp.asarray(radii[order], jnp.float32), tb, 16, 16))
    valid = radii[order] > 0
    b = db.binned
    assert int(b.overflow) == 0 and db.total == int(b.num_intersects)
    assert db.total == b.sorted_gauss_ids.shape[0] and int(b.tile_counts.max()) > 1
    for t in range(tb[0] * tb[1]):
        tx, ty = t % tb[0], t // tb[0]
        want = np.nonzero(valid & (x0 <= tx) & (tx < x1) & (y0 <= ty) & (ty < y1))[0]
        s0, cnt = int(b.tile_bin_start[t]), int(b.tile_counts[t])
        np.testing.assert_array_equal(b.sorted_gauss_ids[s0:s0 + cnt].numpy(), want)


def test_pipeline_project_sh_composite_matches_jax():
    """project_gaussians -> spherical_harmonics (view directions from the
    camera) -> the compositor (the card's route and the plain version), an
    L2 loss, gradients in means3d, scales, quats, the SH coefficients and
    opacity."""
    H, W = 40, 56
    n = 90
    means, scales, quats = _gaussians3d(n, 15)
    view = _camera(15)
    rng = np.random.default_rng(15)
    coeffs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    target = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    cam = (50.0, 50.0, W / 2, H / 2, H, W, tb)
    eye = -view[:3, :3].T @ view[:3, 3]

    def make(proj, sh_fn, comp, lib, mat, bgv, tgt):
        def f(m, s, q, c, op):
            xys, depths, radii, conics, nth, _cov = proj(m, s, 0.8, q, mat, *cam)
            colors = sh_fn(3, m - _arr(lib, eye.astype(np.float32)), c)
            img = comp(xys, depths, radii, conics, nth, colors, op, H, W, bgv)
            return lib.sum((img - tgt) ** 2)
        return f

    def jcomp(xys, depths, radii, conics, nth, colors, op, H, W, bgv):
        return jra.rasterize_gaussians_alpha(xys, depths, radii, conics, nth, colors, op,
                                             H, W, background=bgv, chunk=32)

    jfn = make(jp3.project_gaussians, jsh.spherical_harmonics, jcomp, jnp,
               jnp.asarray(view), jnp.asarray(bg), jnp.asarray(target))
    arrays = (means, scales, quats, coeffs, opacity)
    j_loss = float(jax.jit(jfn)(*map(jnp.asarray, arrays)))
    for route in ("route", "torch"):
        port = _port_alpha(route)

        def tcomp(xys, depths, radii, conics, nth, colors, op, H, W, bgv, port=port):
            return port(xys, depths, radii, conics, colors, op, H, W, background=bgv,
                        chunk=32, num_tiles_hit=nth)

        tfn = make(projection3d.project_gaussians, sh.spherical_harmonics, tcomp, torch,
                   torch.tensor(view), torch.tensor(bg), torch.tensor(target))
        np.testing.assert_allclose(float(tfn(*_t(*arrays))), j_loss, rtol=1e-5)
        _grads_match(tfn, jfn, arrays, key="pipeline")

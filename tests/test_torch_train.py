"""PyTorch port parity: the training slice against gsvc_tpu.

The same numpy inputs go through both packages. gsvc_tpu runs its `binned`
backend (and `segmented_cumsum` in Pallas interpret mode); the port runs
"torch" (autograd through the plain renderer) and "cuda", whose wrappers
take their plain versions on CPU tensors: the K4 rows store, K6 into the
expansion slots and the K3 reduction.

Tolerances: one step's gradients rtol 1e-3 / atol 1e-4 (the bound of
tests/test_rasterize_pallas.py:85), and within 1e-3 of each tensor's
largest entry (f32 sums over up to 256 pixels per lane taken in another
order); Adan atol 1e-6 (float32 elementwise, XLA may fuse multiply-adds);
alive masks, iteration and step counters exactly. Multi-step losses within
1e-4 relative: Adan's first steps move a parameter by ~lr * sign(g), so
gradients that differ at round-off move parameters apart elementwise.
"""

import dataclasses
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsvc_tpu.ops.fill_pallas as fp
import gsvc_tpu.ops.rasterize as jrz
from gsvc_tpu.config import FrameConfig as JConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.models import represent as jrep
from gsvc_tpu.ops.projection import project_gaussians_2d as jproject
from gsvc_tpu.optim import adan as jadan
from gsvc_tpu.optim.schedule import step_lr as jstep_lr
from gsvc_tpu.utils.losses import loss_fn as jloss_fn
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import GaussianFrame, from_numpy, train_state_from_numpy
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import (
    image_to_rows,
    rasterize_gaussians_sum,
    rows_to_image,
)
from gsvc_tpu_torch.optim import adan
from gsvc_tpu_torch.optim.schedule import step_lr
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.control import EarlyStopping, detect_outliers_mean_diff
from gsvc_tpu_torch.utils.losses import loss_fn

H, W, N, CAP = 48, 64, 200, 240
BASE = dict(H=H, W=W, num_points=N, max_num_points=CAP, iterations=50)


def _cfgs(**kw):
    """(gsvc_tpu config on `binned`, port config on `backend`)."""
    backend = kw.pop("backend", "torch")
    kw = {**BASE, **kw}
    return JConfig(**kw, backend="binned"), FrameConfig(**kw, backend=backend)


def _gt(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _jax_state(jcfg, seed=0, rgb_w_spread=True):
    """A gsvc_tpu TrainState with splats spread as training leaves them:
    rgb_w varied, so ranks by weight are distinct."""
    state = jrep.init_train_state(jax.random.PRNGKey(seed), jcfg)
    if rgb_w_spread:
        rng = np.random.default_rng(seed + 10)
        p = state.params
        state = dataclasses.replace(state, params=SplatParams(
            xyz=p.xyz, cholesky=p.cholesky + 0.5, features_dc=p.features_dc,
            rgb_w=jnp.asarray(rng.uniform(0.2, 1.5, (CAP, 1)), jnp.float32)))
    return state


@lru_cache(maxsize=None)
def _jax_grad_fn(jcfg):
    def f(tr, alive, gt):
        return jrep._loss_and_psnr(jrep._from_trainable(tr), alive, gt, jcfg, 0.0)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _assert_grads_close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=err_msg)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale + 1e-12, err_msg


@pytest.mark.parametrize("backend,mode", [("torch", None), ("cuda", None),
                                          ("cuda", "isremoval"), ("torch", "isdensity")])
def test_train_step_gradients_match_jax(backend, mode):
    # "cuda" on CPU tensors: the rows loss through K4-rows / K6 / K3's plain
    # versions; "torch": the image loss through autograd
    jcfg, cfg = _cfgs(backend=backend, **({mode: True} if mode else {}))
    jstate = _jax_state(jcfg)
    gt = _gt()
    (jloss, (jsq, _)), jgrads = _jax_grad_fn(jcfg)(
        jrep._trainable(jstate.params), jstate.alive, jnp.asarray(gt))
    state = train_state_from_numpy(jstate)
    tgt = torch.from_numpy(gt)
    rows = rep.make_rows_target(tgt, cfg) if rep._use_rows_loss(cfg, "cpu") else None
    assert (rows is not None) == (backend == "cuda")
    loss, sq, grads = rep._loss_and_grads(state, tgt, cfg, 0.0, rows)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-5)
    for name, g in grads.items():
        _assert_grads_close(g.numpy(), jgrads[name], name)
        assert np.abs(np.asarray(jgrads[name])).max() > 0, name


def test_rows_loss_gradients_equal_image_loss():
    _jcfg, cfg = _cfgs(backend="cuda")
    state = train_state_from_numpy(_jax_state(_cfgs()[0], seed=3))
    gt = torch.from_numpy(_gt(4))
    l_img, sq_img, g_img = rep._loss_and_grads(state, gt, cfg, 0.0, None)
    l_rows, sq_rows, g_rows = rep._loss_and_grads(
        state, gt, cfg, 0.0, rep.make_rows_target(gt, cfg))
    np.testing.assert_allclose(float(l_rows), float(l_img), rtol=1e-6)
    np.testing.assert_allclose(float(sq_rows), float(sq_img), rtol=1e-6)
    for name in g_img:
        np.testing.assert_allclose(g_rows[name].numpy(), g_img[name].numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("hw", [(48, 64), (37, 51), (40, 40)])
def test_rows_layout_matches_jax(hw):
    h, w = hw
    img = np.random.default_rng(5).uniform(0, 1, (h, w, 3)).astype(np.float32)
    want = np.asarray(jrz.image_to_rows(jnp.asarray(img), h, w))
    rows = image_to_rows(torch.from_numpy(img), h, w)
    np.testing.assert_array_equal(rows.numpy(), want)
    back = rows_to_image(rows, h, w)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jrz.rows_to_image(jnp.asarray(want), h, w)))
    np.testing.assert_array_equal(back.numpy(), img)


def test_rows_render_on_every_backend():
    means, L = (torch.from_numpy(a) for a in _scene_np(150, 6)[:2])
    colors = torch.rand((150, 3), generator=torch.Generator().manual_seed(0))
    opacity = torch.ones((150, 1))
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, H, W)
    want = image_to_rows(img, H, W)
    for backend in ("cuda", "torch", "dense"):
        rows = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity,
                                       H, W, backend=backend, layout="rows")
        np.testing.assert_allclose(rows.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _adan_inputs(seed, fresh):
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (7, 2), "cholesky": (7, 3), "features_dc": (7, 3), "rgb_w": (7, 1)}

    def tree(scale=1.0, positive=False):
        return {k: (np.abs if positive else np.asarray)(
            rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}

    params, grads = tree(), tree(1e-2)
    moments = dict(exp_avg=tree(1e-3), exp_avg_sq=tree(1e-5, True),
                   exp_avg_diff=tree(1e-4), neg_pre_grad=tree(1e-2))
    return params, grads, moments, {k: fresh for k in shapes}


@pytest.mark.parametrize("fresh,max_grad_norm,weight_decay,no_prox", [
    (True, 0.0, 0.0, False), (False, 0.0, 0.0, False),
    (False, 0.05, 0.02, False), (False, 0.0, 0.02, True),
])
def test_adan_step_matches_jax(fresh, max_grad_norm, weight_decay, no_prox):
    params, grads, moments, fr = _adan_inputs(0, fresh)
    jstate = jadan.AdanState(
        step=jnp.int32(6), fresh={k: jnp.bool_(v) for k, v in fr.items()},
        **{k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in moments.items()})
    kw = dict(betas=(0.98, 0.92, 0.99), eps=1e-8, weight_decay=weight_decay,
              max_grad_norm=max_grad_norm, no_prox=no_prox)
    jp, js = jadan.adan_step({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in grads.items()},
                             jstate, jnp.float32(2e-3), **kw)

    def t(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}

    state = adan.AdanState(step=6, fresh=dict(fr), **{k: t(v) for k, v in moments.items()})
    p, s = adan.adan_step(t(params), t(grads), state, 2e-3, **kw)
    assert s.step == int(js.step) == 7 and s.fresh == {k: False for k in fr}
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        for field in moments:
            np.testing.assert_allclose(getattr(s, field)[k].numpy(),
                                       np.asarray(getattr(js, field)[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=field)
    r = adan.adan_reset_moments(s)
    jr = jadan.adan_reset_moments(js)
    assert r.step == int(jr.step) == 7
    assert r.fresh == {k: bool(v) for k, v in jr.fresh.items()}
    for field in moments:
        for k in params:
            assert not getattr(r, field)[k].any()


def test_step_lr_matches_jax():
    for step in (0, 1, 19999, 20000, 45000, 100000):
        assert step_lr(1e-3, step) == float(jstep_lr(1e-3, jnp.int32(step)))


@pytest.mark.parametrize("loss_type", ["L2", "L1", "SSIM", "Fusion1", "Fusion2",
                                       "Fusion3", "Fusion4", "Fusion_hinerv"])
def test_loss_fn_matches_jax(loss_type):
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, (3, 96, 96)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    want = float(jloss_fn(jnp.asarray(pred), jnp.asarray(target), loss_type, 0.6))
    got = float(loss_fn(torch.from_numpy(pred), torch.from_numpy(target), loss_type, 0.6))
    np.testing.assert_allclose(got, want, rtol=2e-5)
    with pytest.raises(ValueError):
        loss_fn(torch.from_numpy(pred), torch.from_numpy(target), "nope")


def test_control_utils_match_jax():
    from gsvc_tpu.utils import control as jcontrol

    vals = np.random.default_rng(3).uniform(1, 2, 40)
    vals[[7, 23]] = 9.0
    assert detect_outliers_mean_diff(vals) == jcontrol.detect_outliers_mean_diff(vals)
    seq = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.8]
    mine, ref = EarlyStopping(3, 0.0), jcontrol.EarlyStopping(3, 0.0)
    assert [mine(x) for x in seq] == [ref(x) for x in seq]


def _revive_draws(key, n):
    """gsvc_tpu's `_revive` draws from the step's key split (:524, :394)."""
    _key, sub = jax.random.split(key)
    k1, k2, k3 = jax.random.split(sub, 3)
    return (np.asarray(jax.random.uniform(k1, (n, 2), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.uniform(k2, (n, 3))),
            np.asarray(jax.random.uniform(k3, (n, 3))))


@pytest.mark.parametrize("mode,it", [
    ("removal", 3900), ("removal", 4000), ("removal", 4100),
    ("adaptive", 1), ("adaptive", 600), ("adaptive", 1000),
])
def test_control_matches_jax(mode, it):
    jcfg, cfg = _cfgs(isremoval=mode == "removal", isdensity=mode == "adaptive",
                      removal_rate=0.2)
    jstate = _jax_state(jcfg, seed=4)
    # some slots dead, so revive has room and the threshold has work
    alive = np.random.default_rng(6).uniform(size=CAP) < 0.9
    params = from_numpy(jstate.params)
    key = jax.random.PRNGKey(9)
    if mode == "removal":
        jp, ja, jreb, jhit = jrep._removal_control(
            jstate.params, jnp.asarray(alive), jnp.int32(it), jcfg)
        p, a, reb, hit = rep._removal_control(params, torch.from_numpy(alive), it, cfg)
    else:
        _k, sub = jax.random.split(key)
        jp, ja, jreb, jhit = jrep._adaptive_control(
            jstate.params, jnp.asarray(alive), sub, jnp.int32(it), jcfg)
        p, a, reb, hit = rep._adaptive_control(
            params, torch.from_numpy(alive), lambda n: _revive_draws(key, n), it, cfg)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert (reb, hit) == (bool(jreb), bool(jhit))
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        np.testing.assert_allclose(getattr(p, name).detach().numpy(),
                                   np.asarray(getattr(jp, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    if mode == "adaptive" and it == 1:
        assert int(a.sum()) > int(alive.sum())


@lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(jrep.make_train_step(jcfg))


@pytest.mark.parametrize("mode,start", [("removal", 3997), ("density", 0),
                                        ("density", 998)])
def test_full_steps_match_jax(mode, start):
    # every slot alive but at it == 0, so the thresholds have splats to prune
    jcfg, cfg = _cfgs(isremoval=mode == "removal", isdensity=mode == "density",
                      densification_interval=2 if start == 998 else 100,
                      num_points=N if start == 0 else CAP)
    jstate = _jax_state(jcfg, seed=5)
    jstate = dataclasses.replace(jstate, it=jnp.int32(start))
    state = train_state_from_numpy(jstate)
    gt = _gt(7)
    keys = {"key": jstate.key}

    def draws(n):
        return _revive_draws(keys["key"], n)

    step = rep.make_train_step(cfg, draws=draws)
    for _ in range(4):
        keys["key"] = jstate.key
        jstate = _jax_step(jcfg)(jstate, jnp.asarray(gt))
        state = step(state, torch.from_numpy(gt))
        assert state.it == int(jstate.it)
        np.testing.assert_array_equal(state.alive.numpy(), np.asarray(jstate.alive))
        assert state.lr_frozen == bool(jstate.lr_frozen)
        assert state.opt.step == int(jstate.opt.step)
        assert state.grace == int(jstate.grace)
        assert int(state.patience) == int(jstate.patience)
        assert int(state.max_overflow) == int(jstate.max_overflow)
        np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-4)
        np.testing.assert_allclose(float(state.psnr), float(jstate.psnr), rtol=1e-4)
    if start == 3997 or start == 998:
        assert state.lr_frozen and state.opt.step < 4  # crossed the threshold
    if start == 0:
        assert int(state.alive.sum()) > N  # revived at it == 1


def test_fit_frame_stops_where_jax_stops():
    # a patience of 3 with the lr at 0 plateaus at once: the JAX while_loop
    # stops at it == 4; the port must stop at the same iteration
    jcfg, cfg = _cfgs(lr=0.0, early_stop_patience=3, iterations=30)
    jstate = _jax_state(jcfg, seed=8)
    gt = _gt(2)
    jres = jrep.fit_frame(jstate, jnp.asarray(gt), jcfg)
    res = rep.fit_frame(train_state_from_numpy(jstate), torch.from_numpy(gt), cfg)
    assert res.state.it == int(jres.state.it) == 4
    assert bool(res.state.stop) and bool(jres.state.stop)
    np.testing.assert_allclose(res.image.numpy(), np.asarray(jres.image), atol=1e-5)


def test_fit_frame_at_wide_keys_matches_jax():
    """Six steps of fit_frame at 70,000 splats on a 48x32 frame (a 17-bit
    gauss field; gsvc_tpu bins by its pair sort), the port on the kernels'
    plain versions: the iteration, the loss (1e-4 relative, the multi-step
    bound above) and the image (atol 1e-5, test_fit_frame_stops_where_jax_stops's)
    as gsvc_tpu's; no budget overflow."""
    n, h, w = 70000, 32, 48
    kw = dict(H=h, W=w, num_points=n, max_num_points=n, iterations=6, lr=0.01,
              max_intersects=6 * n)  # 6 tiles: no splat can overflow it
    jcfg, cfg = JConfig(**kw, backend="binned"), FrameConfig(**kw, backend="cuda")
    jstate = jrep.init_train_state(jax.random.PRNGKey(0), jcfg)
    gt = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    jres = jrep.fit_frame(jstate, jnp.asarray(gt), jcfg)
    state = train_state_from_numpy(jstate)
    first = rep.render_frame(state.params, state.alive, cfg)
    res = rep.fit_frame(state, torch.from_numpy(gt), cfg)
    assert res.state.it == int(jres.state.it) == 6
    assert int(res.state.max_overflow) == int(jres.state.max_overflow) == 0
    np.testing.assert_allclose(float(res.state.loss), float(jres.state.loss), rtol=1e-4)
    np.testing.assert_allclose(res.image.numpy(), np.asarray(jres.image), atol=1e-5)
    assert np.abs(res.image.numpy() - first.numpy()).max() > 1e-3  # the fit moved


def test_fit_frame_and_pre_train_run_on_both_backends():
    gt = torch.from_numpy(_gt(3))
    finals = []
    for backend in ("torch", "cuda"):
        cfg = FrameConfig(**{**BASE, "iterations": 12}, backend=backend, lr=1e-2,
                          isremoval=True, densification_interval=4)
        state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0))
        res = rep.fit_frame(state, gt, cfg)
        assert res.state.it == 12 and res.image.shape == (H, W, 3)
        assert float(res.state.loss) < float(rep._loss_and_grads(
            rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0)),
            gt, cfg, 0.0, None)[0])
        finals.append(res.image)
        pre = rep.pre_train_frame(
            rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0)),
            gt, dataclasses.replace(cfg, iterations=3))
        assert pre.state.it == 3 and pre.state.opt.step == 3
    np.testing.assert_allclose(finals[0].numpy(), finals[1].numpy(), atol=1e-4)


def test_warm_start_matches_jax():
    jcfg, cfg = _cfgs(isremoval=True)
    warm = _jax_state(jcfg, seed=11).params
    key = jax.random.PRNGKey(0)
    jstate = jrep.init_train_state(key, jcfg, warm=warm, warm_count=150)
    k1, k2, k3 = jax.random.split(jax.random.split(key)[0], 3)  # init_splats'
    uniforms = (np.array(jax.random.uniform(k1, (CAP, 2), minval=-1.0, maxval=1.0)),
                np.array(jax.random.uniform(k2, (CAP, 3))),
                np.array(jax.random.uniform(k3, (CAP, 3))))
    state = rep.init_train_state(cfg, warm=from_numpy(warm), warm_count=150,
                                 uniforms=uniforms)
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(jstate.alive))
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        np.testing.assert_allclose(getattr(state.params, name).detach().numpy(),
                                   np.asarray(getattr(jstate.params, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert state.grace == int(jstate.grace) and state.opt.step == 0


# -- the kernels' plain versions ---------------------------------------------


def _scene_np(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
    L = (rng.uniform(0, 1.5, (n, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 2.0, (n, 1)).astype(np.float32)
    return means, L, colors, opacity


def _k6_and_reduction_against_jax_vjp(n, seed, budget, cap) -> int:
    """Plain K6 into the expansion slots (each image layout, bitwise equal),
    then the K3 reduction, against jax.vjp of gsvc_tpu's binned render
    w.r.t. (xys, conics, colors, opacity), both with `budget`
    intersections and the per-tile `cap`; the slots of lanes past the cap
    must stay exactly zero. Returns how many such lanes there are."""
    means, L, colors, opacity = _scene_np(n, seed)
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    v_img = np.random.default_rng(seed + 1).normal(size=(H, W, 3)).astype(np.float32)

    def jax_vjp(m, l, col, o, v):
        x, d, r, c, nth = jproject(m, l, H, W, tb)
        return jax.vjp(lambda x, c, col, o: jrz.rasterize_gaussians_sum(
            x, d, r, c, nth, col, o, H, W, backend="binned", max_intersects=budget),
            x, c, col, o)[1](v)

    old_cap = jrz.TILE_CAP
    jrz.TILE_CAP = cap  # read while tracing
    try:
        want = jax.jit(jax_vjp)(*(jnp.asarray(a) for a in (means, L, colors, opacity,
                                                            v_img)))
    finally:
        jrz.TILE_CAP = old_cap

    xys, _d, radii, conics, nth = project_gaussians_2d(
        torch.from_numpy(means), torch.from_numpy(L), H, W, tb)
    assert 0 < int(nth.sum()) <= budget
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, cap=cap)
    args = (binned, xys, conics, torch.from_numpy(colors), torch.from_numpy(opacity))
    slots = {}
    v = torch.from_numpy(v_img)
    for layout, vv in (("image", v), ("chw", v.permute(2, 0, 1).contiguous()),
                       ("rows", image_to_rows(v, H, W))):
        slots[layout] = rasterize_cuda.backward_slots(
            *args, vv, H, W, tb, 16, 16, cap, layout)
    assert torch.equal(slots["image"], slots["chw"])
    assert torch.equal(slots["image"], slots["rows"])
    got = rasterize_cuda.reduce_slot_grads(slots["image"], binned.gauss_slot_start)
    for name, g, w in zip(("xys", "conics", "colors", "opacity"), got, want):
        _assert_grads_close(g.numpy(), w, name)
        assert np.abs(np.asarray(w)).max() > 0, name

    # every slot past the cap holds exact zeros; a lane's splat is its
    # sorted key's gauss field (`fill_cuda.key_layout`)
    counts = binned.tile_counts.numpy().astype(np.int64)
    past = np.maximum(counts - cap, 0)
    t = np.repeat(np.arange(len(counts)), past)
    first = binned.tile_bin_start.numpy().astype(np.int64) + cap
    rank = np.arange(past.sum()) - np.repeat(np.cumsum(past) - past, past)
    lane = np.repeat(first, past) + rank
    g = binned.sorted_keys.numpy()[lane] & fill_cuda.key_layout(tb[0] * tb[1], n).gauss_mask
    pack = binned.bbox_pack.numpy().astype(np.int64)[g]
    bw, ty0, tx0 = pack >> 16, (pack >> 8) & 0xFF, pack & 0xFF
    slot = binned.gauss_slot_start.numpy()[g] + (t // tb[0] - ty0) * bw + (t % tb[0] - tx0)
    assert not slots["image"][:, slot].any()
    return len(lane)


@pytest.mark.parametrize("cap", [256, 24])
def test_plain_k6_and_reduction_match_jax_vjp(cap):
    """cap 24 puts lanes past the cap: their slots must stay exactly zero
    (the invariant of test_fast_grad_reduction_matches_segment_sum[24])."""
    capped = _k6_and_reduction_against_jax_vjp(200, 13, 4096, cap)
    assert capped > 0 or cap == 256


def test_plain_k6_and_reduction_match_jax_vjp_at_wide_keys():
    """The same at 70,000 splats (a 17-bit gauss field; gsvc_tpu bins by its
    pair sort): every tile holds more than the cap of 256 lanes."""
    assert fill_cuda.key_layout(12, 70000).gauss_bits == 17
    assert _k6_and_reduction_against_jax_vjp(70000, 17, 212992, 256) > 100000


def test_rasterize_sum_backward_matches_autograd_of_plain_render():
    means, L, colors, opacity = (torch.from_numpy(a) for a in _scene_np(150, 15))
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    wgt = torch.from_numpy(np.random.default_rng(16).uniform(0.5, 1.5, (H, W, 3))
                           .astype(np.float32))
    xys, _d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, 4096)
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (xys, conics, colors, opacity)]
        args = (binned, *leaves, H, W, tb, 16, 16, 256)
        img = (rasterize_cuda.rasterize_sum(*args) if kernels
               else rasterize_cuda.rasterize_forward_torch(*args))
        grads.append(torch.autograd.grad(torch.sum((img - 0.3) ** 2 * wgt), leaves))
    for name, a, b in zip(("xys", "conics", "colors", "opacity"), *grads):
        _assert_grads_close(a.numpy(), b.numpy(), name)


@pytest.fixture
def _pallas_interpret():
    fp.INTERPRET = True
    yield
    fp.INTERPRET = False


@pytest.mark.parametrize("s,rows,p_flag", [(1000, 9, 0.05), (3000, 16, 0.3),
                                           (700, 1, 0.001)])
def test_plain_k3_matches_pallas_segmented_cumsum(_pallas_interpret, s, rows, p_flag):
    rng = np.random.default_rng(s)
    vals = rng.normal(size=(rows, s)).astype(np.float32)
    flags = (rng.uniform(size=s) < p_flag).astype(np.int32)
    flags[0] = 1
    want = np.asarray(fp.segmented_cumsum(jnp.asarray(vals), jnp.asarray(flags)))
    got = fill_cuda.segmented_cumsum_torch(torch.from_numpy(vals), torch.from_numpy(flags))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    before = graphs.launch_counts()
    wrapped = fill_cuda.segmented_cumsum(torch.from_numpy(vals), torch.from_numpy(flags))
    assert torch.equal(wrapped, got) and graphs.launch_counts() == before


def test_k3_cluster_constant_is_the_kernels():
    """`SEG_CLUSTER`, by which chip_smoke.py sizes K3's CTA spans, is the
    cluster size segsum.cu launches."""
    src = Path(fill_cuda.__file__).parents[1] / "csrc" / "segsum.cu"
    assert f"constexpr int kCluster = {fill_cuda.SEG_CLUSTER};" in src.read_text()


def test_train_state_from_numpy_round_trip():
    jcfg, _cfg = _cfgs(isdensity=True)
    jstate = dataclasses.replace(_jax_state(jcfg, seed=12), it=jnp.int32(77),
                                 lr_frozen=jnp.bool_(True))
    state = train_state_from_numpy(jstate)
    assert isinstance(state.params, GaussianFrame)
    assert (state.it, state.lr_frozen, state.grace) == (77, True, int(jstate.grace))
    assert state.opt.step == 0 and all(state.opt.fresh.values())
    assert torch.isinf(state.best_loss) and state.alive.dtype == torch.bool
    np.testing.assert_array_equal(state.params.rgb_w.detach().numpy(),
                                  np.asarray(jstate.params.rgb_w))

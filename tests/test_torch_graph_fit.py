"""The port's fits as CUDA-graph replays (gsvc_tpu_torch/utils/graphs.py),
held to the eager path and to the steps they replaced.

On the CPU (48x64, 150 splats at a capacity of 200, densification
interval 10; the "cuda" backend, whose kernel wrappers take their plain
versions on CPU tensors):
- the fits' Adan (`adan_step_`: scalars from `adan_table` on the device,
  results written in place) equals the host-float `adan_step` bitwise,
  fresh and not, across a moment reset; its first step equals gsvc_tpu's
  `adan_step` within test_adan_step_matches_jax's tolerance (atol 1e-6 on
  the parameters, rtol 1e-6 on the moments);
- the fits, whose steps now write the state's own tensors and read device
  twins, equal the steps they replaced (`_old_train_step`,
  `_old_pre_train`, `_old_qat_step` below, the code as it stood) bitwise
  over 40+ steps: removal control across its threshold, adaptive control
  from its revive and across its threshold, an early stop under removal
  control, the pre-train, and QAT in frame and delta mode; and a fit with
  control and a grace period stops where gsvc_tpu's `while_loop` stops;
- `plan_steps` puts the eager steps exactly at it == 1, at every
  interval-th iteration (the thresholds among them) and at QAT step 1,
  whatever the --fit_chunk slices.

On a card (marker `cuda`, skipped without one; JAX is imported only inside
the CPU tests, so `python -m pytest --noconftest tests/test_torch_graph_fit.py
-m cuda` runs where JAX is not installed), at 256x256 with 500 splat slots
(450 alive; QAT: 450 splats) and 250 iterations: a represent fit (removal, density), a pre-train and a QAT
fit (frame, delta) with graphs equal the same fit with graph=False bitwise
in parameters, mask, moments, counters, loss, best loss and patience, and
two graph fits equal each other; each replays and counts the eager fit's
kernel launches; the fits' Adan equals the host-float Adan bitwise on CUDA
tensors (PyTorch divides a CUDA tensor by a Python float as a multiply by
its float32 reciprocal); the new eager fit equals the replaced step there.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.ops.binning import budget_overflow, default_max_intersects
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.optim import adan
from gsvc_tpu_torch.optim.schedule import step_lr
from gsvc_tpu_torch.utils import graphs

H, W, N, CAP = 48, 64, 150, 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    several worker processes at once, whose thread pools would otherwise
    contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the steps as they stood before the fits wrote in place ------------------


def _old_train_step(cfg, lambda_value=0.0, draws=None):
    num_tiles = cfg.tile_bounds[0] * cfg.tile_bounds[1]
    mi = (cfg.max_intersects if cfg.max_intersects is not None
          else default_max_intersects(cfg.max_num_points, num_tiles))
    interval = cfg.densification_interval

    def step(state, gt, rows_target=None):
        it = state.it + 1
        loss, sq, grads = rep._loss_and_grads(state, gt, cfg, lambda_value, rows_target)
        psnr = rep._psnr(cfg, sq)
        params, alive = state.params, state.alive
        rebuilt = hit_threshold = False
        with torch.no_grad():
            if cfg.isdensity and (it == 1 or it % interval == 0):
                params, alive, rebuilt, hit_threshold = rep._adaptive_control(
                    params, alive, draws, it, cfg)
            elif cfg.isremoval and not cfg.isdensity and it % interval == 0:
                params, alive, rebuilt, hit_threshold = rep._removal_control(
                    params, alive, it, cfg)
            max_overflow = state.max_overflow
            if it == 1 or it % interval == 0:
                nth = project_gaussians_2d(
                    params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
                    cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive)[4]
                max_overflow = torch.maximum(max_overflow, budget_overflow(nth, mi))
            lr_frozen = state.lr_frozen or hit_threshold
            lr = cfg.lr if lr_frozen else step_lr(cfg.lr, it - 1)
            if rebuilt:
                opt = adan.adan_reset_moments(state.opt)
                opt.step += 1
            else:
                tr = rep._trainable(params)
                new_tr, opt = adan.adan_step(tr, grads, state.opt, lr,
                                             betas=cfg.betas, eps=cfg.eps)
                for k, p in tr.items():
                    p.copy_(new_tr[k])
            if hit_threshold:
                opt.step = 0
            improved = state.best_loss - loss > cfg.early_stop_min_delta
            first = torch.isinf(state.best_loss)
            best_loss = torch.where(improved | first, loss, state.best_loss)
            patience = torch.where(improved | first, 0, state.patience + 1)
            grace = state.grace - 1
            stop = (patience >= cfg.early_stop_patience) & (grace < 0)
        return rep.TrainState(
            params=params, alive=alive, opt=opt, it=it, lr_frozen=lr_frozen,
            best_loss=best_loss, patience=patience.to(torch.int32), grace=grace,
            stop=stop, loss=loss, psnr=psnr, max_overflow=max_overflow)

    return step


def _old_fit(state, gt, limit, cfg, draws=None):
    step = _old_train_step(cfg, 0.0, draws)
    rows_target = rep._rows_target_for(gt, cfg)
    lim = min(int(limit), cfg.iterations)
    next_check = state.it
    stopped = bool(state.stop)
    while not stopped and state.it < lim:
        state = step(state, gt, rows_target)
        if state.grace < 0 and state.it >= next_check:
            p = int(state.patience)
            stopped = p >= cfg.early_stop_patience
            next_check = state.it + cfg.early_stop_patience - p
    return state


def _old_pre_train(state, gt, cfg, lambda_value=0.7):
    rows_target = rep._rows_target_for(gt, cfg)
    for _ in range(cfg.iterations):
        it = state.it + 1
        loss, sq, grads = rep._loss_and_grads(state, gt, cfg, lambda_value, rows_target)
        tr = rep._trainable(state.params)
        with torch.no_grad():
            new_tr, opt = adan.adan_step(tr, grads, state.opt, step_lr(cfg.lr, it - 1),
                                         betas=cfg.betas, eps=cfg.eps)
            for k, p in tr.items():
                p.copy_(new_tr[k])
        state = dataclasses.replace(state, opt=opt, it=it, loss=loss,
                                    psnr=rep._psnr(cfg, sq))
    return state


def _pick(improved, new, old):
    return dataclasses.replace(new, **{
        f.name: torch.where(improved, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new) if isinstance(getattr(new, f.name), torch.Tensor)})


def _old_qat_step(cfg, draws=None):
    def step(state, gt, rows_target=None):
        it = state.it + 1
        recon, vq_loss, grads, new_vq = comp._loss_and_grads(state, gt, cfg, rows_target,
                                                             draws)
        with torch.no_grad():
            psnr = 10.0 * torch.log10(1.0 / torch.clamp(recon, min=1e-20))
            new_tr, new_opt = adan.adan_step(comp._p2d(state.params), grads, state.opt,
                                             step_lr(cfg.lr, it - 1), betas=cfg.betas,
                                             eps=cfg.eps)
            new_params = comp.CompressParams(**new_tr)
            improved = psnr > state.best_psnr
            return dataclasses.replace(
                state, params=new_params, vq=new_vq, opt=new_opt, it=it,
                best_psnr=torch.maximum(psnr, state.best_psnr),
                best_params=_pick(improved, new_params, state.best_params),
                best_vq=_pick(improved, new_vq, state.best_vq),
                loss=recon + vq_loss, psnr=psnr)

    return step


def _old_qat_fit(state, gt, cfg, draws=None):
    step = _old_qat_step(cfg, draws)
    rows_target = rep._rows_target_for(gt, cfg)
    for _ in range(cfg.iterations):
        state = step(state, gt, rows_target)
    return state


# -- states, scenes and comparisons ------------------------------------------


def _cfg(h=H, w=W, n=N, cap=CAP, **kw):
    base = dict(H=h, W=w, num_points=n, max_num_points=cap, iterations=10**6, lr=1e-2,
                densification_interval=10, backend="cuda")
    return FrameConfig(**{**base, **kw})


def _gt(h=H, w=W, seed=1, device="cpu"):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    img = np.clip(np.stack([xx / w, yy / h, 0.5 + 0 * xx], -1)
                  + rng.normal(0, 0.1, (h, w, 3)), 0, 1).astype(np.float32)
    return torch.tensor(img, device=device)


def _rep_state(cfg, seed=0, start=0, device="cpu"):
    """A represent state at iteration `start` with distinct splat weights (so
    ranks by weight are distinct), made anew for each run."""
    st = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                              device=device)
    rng = np.random.default_rng(seed + 10)
    with torch.no_grad():
        st.params.rgb_w.copy_(torch.tensor(rng.uniform(0.2, 1.5, (cfg.max_num_points, 1)),
                                           dtype=torch.float32))
    return dataclasses.replace(st, it=start)


def _gmodels(n, seed, delta):
    rng = np.random.default_rng(seed)
    g = {"_xyz": np.arctanh(rng.uniform(-0.85, 0.85, (n, 2))).astype(np.float32),
         "_cholesky": rng.uniform(0, 1.5, (n, 3)).astype(np.float32),
         "_features_dc": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    if not delta:
        return g, None
    return {k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32) for k, v in g.items()}, g


def _moments(opt):
    return [t for f in ("exp_avg", "exp_avg_sq", "exp_avg_diff", "neg_pre_grad")
            for t in getattr(opt, f).values()]


def _rep_tensors(s):
    return [*rep._trainable(s.params).values(), s.alive, *_moments(s.opt), s.best_loss,
            s.patience, s.stop, s.loss, s.psnr, s.max_overflow]


def _qat_tensors(s):
    return [*comp._p2d(s.params).values(), *comp._p2d(s.best_params).values(),
            s.vq.embed, s.vq.cluster_size, s.vq.embed_avg, s.best_vq.embed,
            s.best_vq.cluster_size, s.best_vq.embed_avg, *_moments(s.opt), s.best_psnr,
            s.loss, s.psnr]


def _assert_same_rep(a, b):
    assert (a.it, a.lr_frozen, a.grace, a.opt.step, a.opt.fresh) == \
        (b.it, b.lr_frozen, b.grace, b.opt.step, b.opt.fresh)
    for i, (x, y) in enumerate(zip(_rep_tensors(a), _rep_tensors(b))):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _assert_same_qat(a, b):
    assert (a.it, a.opt.step, a.opt.fresh, a.vq.initted, a.best_vq.initted) == \
        (b.it, b.opt.step, b.opt.fresh, b.vq.initted, b.best_vq.initted)
    for i, (x, y) in enumerate(zip(_qat_tensors(a), _qat_tensors(b))):
        assert torch.equal(x, y), i


# -- Adan ---------------------------------------------------------------------


def _adan_inputs(seed, device="cpu"):
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (7, 2), "cholesky": (7, 3), "features_dc": (7, 3), "rgb_w": (7, 1)}

    def tree(scale=1.0, positive=False):
        return {k: (np.abs if positive else np.asarray)(rng.normal(size=s) * scale)
                .astype(np.float32) for k, s in shapes.items()}

    moments = dict(exp_avg=tree(1e-3), exp_avg_sq=tree(1e-5, True),
                   exp_avg_diff=tree(1e-4), neg_pre_grad=tree(1e-2))
    grads = [tree(1e-2) for _ in range(4)]
    return tree(), grads, moments


def _adan_both(fresh, max_grad_norm, weight_decay, no_prox, device):
    """Four steps with a moment reset after the second, through the
    host-float Adan and the fits' Adan: (host params, host state, fit
    params, fit state, the first host step's params)."""
    params, grads, moments = _adan_inputs(0)

    def t(tree):
        return {k: torch.tensor(v, device=device) for k, v in tree.items()}

    kw = dict(betas=(0.98, 0.92, 0.99), eps=1e-8, max_grad_norm=max_grad_norm,
              no_prox=no_prox)
    lrs = [2e-3, 2e-3, 1e-3, 1e-3]
    flags = {k: fresh for k in params}
    host = adan.AdanState(step=6, fresh=dict(flags), **{k: t(v) for k, v in moments.items()})
    fit = adan.AdanState(step=6, fresh=dict(flags), **{k: t(v) for k, v in moments.items()})
    hp, fp = t(params), t(params)
    steps = [(7, lrs[0]), (8, lrs[1]), (9, lrs[2]), (10, lrs[3])]
    twins = graphs.make_twins(adan.adan_table(steps, kw["betas"], weight_decay, device),
                              fit.fresh, None, device)
    first = None
    for i, lr in enumerate(lrs):
        if i == 2:
            host = adan.adan_reset_moments(host)
            fit = adan.adan_reset_moments_(fit, twins.fresh)
        hp, host = adan.adan_step(hp, t(grads[i]), host, lr, weight_decay=weight_decay, **kw)
        fit = adan.adan_step_(fp, t(grads[i]), fit, twins.scalars, twins.fresh, **kw)
        twins.row.add_(1)
        first = hp if first is None else first
    return hp, host, fp, fit, first


ADAN_CASES = [(True, 0.0, 0.0, False), (False, 0.0, 0.0, False),
              (False, 0.05, 0.02, False), (False, 0.0, 0.02, True)]


@pytest.mark.parametrize("fresh,max_grad_norm,weight_decay,no_prox", ADAN_CASES)
def test_fit_adan_equals_host_adan_and_jax(fresh, max_grad_norm, weight_decay, no_prox):
    import jax.numpy as jnp

    from gsvc_tpu.optim import adan as jadan

    hp, host, fp, fit, first = _adan_both(fresh, max_grad_norm, weight_decay, no_prox, "cpu")
    assert fit.step == host.step == 10 and fit.fresh == host.fresh
    for k in hp:
        assert torch.equal(hp[k], fp[k]), k
    for a, b in zip(_moments(host), _moments(fit)):
        assert torch.equal(a, b)
    # the first step against gsvc_tpu
    params, grads, moments = _adan_inputs(0)
    jstate = jadan.AdanState(
        step=jnp.int32(6), fresh={k: jnp.bool_(fresh) for k in params},
        **{k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in moments.items()})
    jp, _js = jadan.adan_step({k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in grads[0].items()}, jstate,
                              jnp.float32(2e-3), betas=(0.98, 0.92, 0.99), eps=1e-8,
                              weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                              no_prox=no_prox)
    for k in params:
        np.testing.assert_allclose(first[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("device,reciprocal", [("cpu", False), ("cuda", True)])
def test_adan_table_holds_what_the_device_divides_by(device, reciprocal):
    """The divisors' columns hold the float32 reciprocal for a CUDA device
    (PyTorch's division of a CUDA tensor by a Python float) and the divisor
    on the CPU; the other columns are `adan_scalars` as they are."""
    steps = [(1, 1e-3), (2, 1e-3), (4001, 5e-4)]
    table = adan.adan_table(steps, weight_decay=0.02, device=device)
    for row, (s, lr) in zip(table, steps):
        want = np.array(adan.adan_scalars(s, lr, weight_decay=0.02), np.float32)
        if reciprocal:
            want[2:4] = np.float32(1.0) / want[2:4]
        np.testing.assert_array_equal(row, want)


def test_twins_refuse_fresh_flags_that_differ():
    with pytest.raises(ValueError, match="fresh"):
        graphs.make_twins(np.zeros((1, 5), np.float32), {"a": True, "b": False}, None, "cpu")


# -- the fits against the steps they replaced ----------------------------------


REP_CASES = {
    # mode: (config overrides, start iteration, steps)
    "removal_threshold": (dict(isremoval=True), 3985, 45),
    "density_revive": (dict(isdensity=True, removal_rate=0.2), 0, 45),
    "density_threshold": (dict(isdensity=True, removal_rate=0.2), 975, 45),
    "removal_early_stop": (dict(isremoval=True, lr=0.0, stable_control=12,
                                early_stop_patience=4), 0, 45),
}


@pytest.mark.parametrize("mode", sorted(REP_CASES))
def test_fit_equals_the_replaced_steps(mode):
    kw, start, n = REP_CASES[mode]
    cfg = _cfg(**kw)
    gt = _gt()
    old = _old_fit(_rep_state(cfg, start=start), gt, start + n, cfg,
                   draws=torch.Generator().manual_seed(5))
    new = rep.fit_frame_partial(_rep_state(cfg, start=start), gt, start + n, cfg,
                                draws=torch.Generator().manual_seed(5))
    _assert_same_rep(new, old)
    if mode == "removal_early_stop":
        assert bool(new.stop) and new.it < start + n
    else:
        assert new.it == start + n
    if mode.endswith("threshold"):
        assert new.lr_frozen and new.opt.step < n


def test_fit_in_chunks_equals_one_fit():
    cfg = _cfg(isremoval=True)
    gt = _gt()
    one = rep.fit_frame_partial(_rep_state(cfg, start=3985), gt, 4030, cfg)
    s = _rep_state(cfg, start=3985)
    for lim in (3993, 4000, 4001, 4017, 4030):
        s = rep.fit_frame_partial(s, gt, lim, cfg)
    _assert_same_rep(s, one)


def test_pre_train_equals_the_replaced_loop():
    cfg = _cfg(iterations=42)
    gt = _gt(seed=2)
    old = _old_pre_train(_rep_state(cfg, start=7), gt, cfg)
    new = rep.pre_train_frame(_rep_state(cfg, start=7), gt, cfg).state
    assert new.it == 49 and new.opt.step == 42
    _assert_same_rep(new, old)


@pytest.mark.parametrize("delta", [False, True])
def test_qat_fit_equals_the_replaced_steps(delta):
    cfg = _cfg(n=N, cap=N, iterations=41, lr=1e-3)
    gt = _gt(seed=3)
    g, pg = _gmodels(N, 4, delta)
    old = _old_qat_fit(comp.init_compress_state(g, pg), gt, cfg,
                       torch.Generator().manual_seed(0))
    new = comp.fit_compress(comp.init_compress_state(g, pg), gt, cfg, reload_best=False,
                            draws=torch.Generator().manual_seed(0))
    assert new.it == 41 and new.vq.initted
    _assert_same_qat(new, old)
    chunked = comp.fit_compress_chunked(comp.init_compress_state(g, pg), gt, cfg, 9,
                                        draws=torch.Generator().manual_seed(0))
    _assert_same_qat(chunked, comp._reload_best(new))


def test_fit_with_control_stops_where_jax_stops():
    """Removal control and a grace of 12 steps at lr 0: the patience of 4
    runs out only after the grace; gsvc_tpu's while_loop and the port stop
    at the same iteration."""
    import jax
    import jax.numpy as jnp

    from gsvc_tpu.config import FrameConfig as JConfig
    from gsvc_tpu.models import represent as jrep
    from gsvc_tpu_torch.core import train_state_from_numpy

    kw = dict(H=H, W=W, num_points=N, max_num_points=CAP, iterations=60, lr=0.0,
              densification_interval=10, isremoval=True, stable_control=12,
              early_stop_patience=4)
    jcfg, cfg = JConfig(**kw, backend="binned"), FrameConfig(**kw, backend="cuda")
    jstate = jrep.init_train_state(jax.random.key(3), jcfg)
    gt = _gt(seed=4)
    jres = jrep.fit_frame(jstate, jnp.asarray(gt.numpy()), jcfg)
    res = rep.fit_frame(train_state_from_numpy(jstate), gt, cfg)
    assert bool(res.state.stop) and bool(jres.state.stop)
    assert res.state.it == int(jres.state.it) < 60
    np.testing.assert_array_equal(res.state.alive.numpy(), np.asarray(jres.state.alive))


# -- the schedule -------------------------------------------------------------


def _eager(runs):
    return [first for first, _count, eager in runs if eager]


def _covers(runs, it, limit):
    steps = [i for first, count, _e in runs for i in range(first, first + count)]
    return steps == list(range(it + 1, limit + 1))


@pytest.mark.parametrize("mode", ["none", "removal", "density"])
@pytest.mark.parametrize("interval,it,limit", [(10, 0, 45), (100, 0, 4200), (7, 3, 60),
                                               (100, 3990, 4010)])
@pytest.mark.parametrize("chunk", [0, 1, 13, 100])
def test_plan_steps_puts_eager_steps_at_control_steps(mode, interval, it, limit, chunk):
    cfg = _cfg(densification_interval=interval, isremoval=mode == "removal",
               isdensity=mode == "density")
    want = [i for i in range(it + 1, limit + 1) if i == 1 or i % interval == 0]
    bounds = [it, limit] if not chunk else list(range(it, limit, chunk)) + [limit]
    eager = []
    for lo, hi in zip(bounds, bounds[1:]):
        runs = rep.plan_steps(lo, hi, cfg)
        assert _covers(runs, lo, hi)
        assert all(count == 1 for _f, count, e in runs if e)
        # plain runs end only at an eager step or the slice's end
        assert all(e or first + count - 1 == hi or first + count in want
                   for first, count, e in runs)
        eager += _eager(runs)
    assert eager == want
    thresholds = {"removal": rep.REMOVAL_THRESHOLD,
                  "density": rep.DENSITY_ADD + rep.DENSITY_REMOVE}.get(mode)
    if thresholds is not None and it < thresholds <= limit and thresholds % interval == 0:
        assert thresholds in eager


@pytest.mark.parametrize("chunk", [0, 1, 4, 300])
def test_qat_plan_steps_runs_step_one_eagerly(chunk):
    limit = 300
    bounds = [0, limit] if not chunk else list(range(0, limit, chunk)) + [limit]
    eager, initted = [], False
    for lo, hi in zip(bounds, bounds[1:]):
        runs = comp.plan_steps(lo, hi, initted)
        assert _covers(runs, lo, hi)
        eager += _eager(runs)
        initted = True
    assert eager == [1]


@pytest.mark.parametrize("mode", ["removal", "density"])
def test_hits_threshold_agrees_with_control(mode):
    """`fit_twins` freezes the rate and restarts Adan's step where the
    control functions report the threshold."""
    cfg = _cfg(isremoval=mode == "removal", isdensity=mode == "density",
               removal_rate=0.2)
    st = _rep_state(cfg)
    control = rep._removal_control if mode == "removal" else (
        lambda p, a, it, c: rep._adaptive_control(p, a, torch.Generator(), it, c))
    thresh = 4000 if mode == "removal" else 1000
    for it in list(range(1, 40)) + list(range(thresh - 25, thresh + 25)):
        hit = False
        if rep.control_step(it, cfg) and (mode == "density" or it % 10 == 0):
            hit = control(st.params, st.alive, it, cfg)[3]
        assert rep._hits_threshold(it, cfg) == hit, it


def test_plan_runs_and_runner():
    assert graphs.plan_runs(0, 5, lambda i: i in (1, 4)) == [
        (1, 1, True), (2, 2, False), (4, 1, True), (5, 1, False)]
    assert graphs.plan_runs(5, 5, lambda i: True) == []
    assert isinstance(graphs.runner("cpu", None), graphs.Eager)
    assert isinstance(graphs.runner("cpu", False), graphs.Eager)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.runner("cpu", True)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


def _counts():
    return [c.launches for c in graphs.kernel_counters()]


def _three(fit):
    """fit(graph) three times: with graphs twice, then eagerly; the kernel
    launches each counted; checks the graph replayed."""
    out, launches = [], []
    for graph in (None, None, False):
        before, replays = _counts(), graphs.StepGraph.replays
        out.append(fit(graph))
        torch.cuda.synchronize()
        launches.append([a - b for a, b in zip(_counts(), before)])
        assert (graphs.StepGraph.replays > replays) == (graph is None)
    assert launches[0] == launches[1] == launches[2] and sum(launches[0]) > 0
    return out


CARD = dict(h=256, w=256, n=450, cap=500)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,start", [("removal", 3900), ("density", 900)])
def test_graph_fit_equals_eager_fit(dev, mode, start):
    cfg = _cfg(**CARD, isremoval=mode == "removal", isdensity=mode == "density",
               removal_rate=0.2, iterations=start + 250)
    gt = _gt(256, 256, device=dev)

    def fit(graph):
        return rep.fit_frame_partial(_rep_state(cfg, start=start, device=dev), gt,
                                     cfg.iterations, cfg,
                                     draws=torch.Generator(device=dev).manual_seed(3),
                                     graph=graph)

    a, b, eager = _three(fit)
    assert eager.it == start + 250 and eager.lr_frozen
    _assert_same_rep(a, eager)
    _assert_same_rep(b, eager)


@pytest.mark.cuda
def test_graph_pre_train_equals_eager(dev):
    cfg = _cfg(**CARD, iterations=250)
    gt = _gt(256, 256, seed=2, device=dev)
    a, b, eager = _three(lambda graph: rep.pre_train_frame(
        _rep_state(cfg, device=dev), gt, cfg, graph=graph).state)
    _assert_same_rep(a, eager)
    _assert_same_rep(b, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True])
def test_graph_qat_fit_equals_eager(dev, delta):
    cfg = _cfg(**{**CARD, "cap": CARD["n"]}, iterations=250, lr=1e-3)
    gt = _gt(256, 256, seed=3, device=dev)
    g, pg = _gmodels(CARD["n"], 4, delta)
    a, b, eager = _three(lambda graph: comp.fit_compress(
        comp.init_compress_state(g, pg, dev), gt, cfg, reload_best=False,
        draws=torch.Generator().manual_seed(0), graph=graph))
    _assert_same_qat(a, eager)
    _assert_same_qat(b, eager)


@pytest.mark.cuda
def test_graph_qat_fits_leave_no_memory_allocated(dev):
    """QAT fits on graphs, one after another, leave no device memory
    allocated once the first has made what the process keeps (ROADMAP
    Queue 3: a new side stream a graph kept 32 MiB of cuBLAS workspace,
    so the compress CLI held ~0.78 GiB after 10 frames)."""
    cfg = _cfg(**{**CARD, "cap": CARD["n"]}, iterations=60, lr=1e-3)
    gt = _gt(256, 256, seed=3, device=dev)
    g, _pg = _gmodels(CARD["n"], 4, False)
    held = []
    for _ in range(4):
        comp.fit_compress(comp.init_compress_state(g, None, dev), gt, cfg,
                          draws=torch.Generator().manual_seed(0))
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(dev))
    assert held[1] == held[2] == held[3], held


@pytest.mark.cuda
@pytest.mark.parametrize("fresh,max_grad_norm,weight_decay,no_prox", ADAN_CASES)
def test_fit_adan_equals_host_adan_on_the_card(dev, fresh, max_grad_norm, weight_decay,
                                               no_prox):
    hp, host, fp, fit, _first = _adan_both(fresh, max_grad_norm, weight_decay, no_prox, dev)
    for k in hp:
        assert torch.equal(hp[k], fp[k]), k
    for a, b in zip(_moments(host), _moments(fit)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_eager_fit_equals_the_replaced_steps_on_the_card(dev):
    cfg = _cfg(**CARD, isremoval=True, iterations=4030)
    gt = _gt(256, 256, device=dev)
    old = _old_fit(_rep_state(cfg, start=3960, device=dev), gt, 4030, cfg)
    new = rep.fit_frame_partial(_rep_state(cfg, start=3960, device=dev), gt, 4030, cfg)
    _assert_same_rep(new, old)
    g, pg = _gmodels(CARD["n"], 4, True)
    qcfg = _cfg(**{**CARD, "cap": CARD["n"]}, iterations=40, lr=1e-3)
    old = _old_qat_fit(comp.init_compress_state(g, pg, dev), gt, qcfg,
                       torch.Generator().manual_seed(0))
    new = comp.fit_compress(comp.init_compress_state(g, pg, dev), gt, qcfg,
                            reload_best=False, draws=torch.Generator().manual_seed(0))
    _assert_same_qat(new, old)

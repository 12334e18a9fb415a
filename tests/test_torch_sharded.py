"""PyTorch port parity: the tile-sharded trainer (gsvc_tpu_torch/parallel/
sharded.py, the `tile_rows` span of the rasterizer) against gsvc_tpu, on
the CPU.

- The rasterizer at a span, no ranks: the port's "torch" and "cuda"
  backends (the kernels' plain versions on CPU tensors) against gsvc_tpu's
  `binned` backend at the same `tile_rows`, over spans inside the grid, the
  ragged last span and a span wholly past the grid. Forward atol 1e-5
  (tests/test_torch_rasterize.py's: f32 sums over up to 256 splats a pixel
  in another order, 4.3e-6 seen) on the pixel rows inside the image (the
  port writes 0 past it, gsvc_tpu the splats there); the VJP of a loss on
  those rows at rtol 1e-3 / atol 1e-4 (gsvc_tpu's kernel-against-binned
  gradient bound, tests/test_rasterize_pallas.py:85; 4.8e-6 seen on a
  gradient of 3.7e-4 summed in another order).
- Spawned gloo ranks (`parallel.launch`; the rank side is
  tests/torch_sharded_ranks.py): sharded steps (plain, removal and
  adaptive control), fits and a QAT fit at 2 and 4 ranks, and the frame
  axis on a 2 x 2 mesh, each against the port's unsharded step or fit and
  gsvc_tpu's on one device, at gsvc_tpu's sharding tolerances
  (tests/test_sharding.py): a step params atol 2e-4 (5e-4 with control),
  loss rtol 1e-4, `it` and `alive` exact, and its first iteration's
  all-reduced gradients, read before Adan, rtol 1e-3 / atol 1e-6 (Adan's
  near scale invariance would hide a gradient counted once a rank from
  the params); a fit params atol 2e-3, image
  atol 5e-3; QAT gradients rtol 1e-3 / atol 1e-6, loss rtol 5e-3, params
  atol 2.5 * lr * iterations. The ranks' results are bitwise equal.
- `--tile_shards 2 --device cpu` through the represent and compress CLIs
  against `--tile_shards 1`: the same files, written once, K-frames and
  splat counts exact, PSNR a frame within 0.1 dB, decoded PSNR within
  0.1 dB of the encoder's.
- `scripts/validate_1080p_sharding.py`'s twin at a ragged 72-row frame
  (4.5 tile rows) on 2 and 4 ranks: every shard count MATCH within the JAX
  script's limits (|dloss| 1e-5, params 2e-3, image 5e-3).
"""

import dataclasses
import time
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from test_torch_drivers import _files, _frames, _psnrs, _write_yuv
from gsvc_tpu.config import FrameConfig as JConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.models import compress as jcomp
from gsvc_tpu.models import represent as jrep
from gsvc_tpu.ops.projection import project_gaussians_2d as jproject
from gsvc_tpu.ops.rasterize import rasterize_gaussians_sum as jrasterize
from gsvc_tpu_torch import decode
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import compress_state_from_numpy, train_state_from_numpy
from gsvc_tpu_torch.drivers import compress as cdrv
from gsvc_tpu_torch.drivers import represent as drv
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum, rows_to_image
from gsvc_tpu_torch.ops.rasterize_binned import span_height
from gsvc_tpu_torch.parallel.launch import RankFailed, launch
from torch_threads import one_thread  # noqa: F401




# -- the rasterizer at a tile-row span (no ranks) -----------------------------

RH, RW, RN = 88, 56, 120  # 5.5 tile rows: a 6-row grid, its last row partial
RTB = ((RW + 15) // 16, (RH + 15) // 16, 1)
SPANS = [(0, 2), (2, 2), (4, 2), (6, 2), (3, 3), (0, 6)]


def _raster_scene():
    rng = np.random.default_rng(11)
    return (rng.uniform(-1.1, 1.1, (RN, 2)).astype(np.float32),
            (rng.uniform(0, 1, (RN, 3)) + np.array([0.5, 0.0, 0.5])).astype(np.float32),
            rng.uniform(0, 1, (RN, 3)).astype(np.float32),
            rng.uniform(0.2, 1.0, (RN, 1)).astype(np.float32))


def _valid_rows(span) -> int:
    """Pixel rows of the span's render that lie inside the image."""
    out_h = span_height(span, RTB[1], RH)
    return max(0, min(out_h, RH - span[0] * 16))


@lru_cache(maxsize=None)
def _jax_span(span):
    valid = _valid_rows(span)

    def render(m, l, c, o):
        xys, d, radii, conics, nth = jproject(m, l, RH, RW, RTB)
        return jrasterize(xys, d, radii, conics, nth, c, o, RH, RW, backend="binned",
                          tile_rows=span)

    def loss(m, l, c, o, wgt):
        return jnp.sum((render(m, l, c, o)[:valid] - 0.3) ** 2 * wgt[:valid])

    return jax.jit(render), jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))


def _port_span(scene, backend, span, layout):
    means, L, colors, opacity = (torch.from_numpy(a).requires_grad_() for a in scene)
    xys, d, radii, conics, nth = project_gaussians_2d(means, L, RH, RW, RTB)
    img = rasterize_gaussians_sum(xys, d, radii, conics, nth, colors, opacity, RH, RW,
                                  backend=backend, layout=layout, tile_rows=span)
    return img, (means, L, colors, opacity)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("span", SPANS, ids=[f"rows{a}+{b}" for a, b in SPANS])
def test_span_render_and_vjp_match_jax(span, backend):
    scene = _raster_scene()
    wgt = np.random.default_rng(12).uniform(0.5, 1.5, (16 * span[1], RW, 3)).astype(
        np.float32)
    jrender, jgrad = _jax_span(span)
    # the shapes of gsvc_tpu's pallas path (rasterize_pallas.py:925-926): H
    # rows for a span of the whole grid (its binned path keeps 16 * 6 there)
    out_h = RH if span[1] == RTB[1] else 16 * span[1]
    assert span_height(span, RTB[1], RH) == out_h
    want = np.asarray(jrender(*map(jnp.asarray, scene)))[:out_h]
    valid = _valid_rows(span)
    for layout in ("image", "chw", "rows"):
        img, _ = _port_span(scene, backend, span, layout)
        if layout == "chw":
            img = img.permute(1, 2, 0)
        elif layout == "rows":
            assert img.shape == (span[1] * 16, 256)  # round8(3 * 4) rows a tile row
            img = rows_to_image(img, out_h, RW)
        img = img.detach().numpy()
        assert img.shape == want.shape, layout
        np.testing.assert_allclose(img[:valid], want[:valid], rtol=0, atol=1e-5,
                                   err_msg=layout)
        np.testing.assert_array_equal(img[valid:], 0.0)  # the port's rows past H
    jgrads = jgrad(*map(jnp.asarray, scene), jnp.asarray(wgt))
    img, leaves = _port_span(scene, backend, span, "image")
    loss = torch.sum((img[:valid] - 0.3) ** 2 * torch.from_numpy(wgt[:valid]))
    for name, g, jg in zip(("means", "L", "colors", "opacity"),
                           torch.autograd.grad(loss, leaves), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
        if valid:
            assert np.abs(np.asarray(jg)).max() > 0, name


def test_span_gradients_sum_to_the_whole_grid():
    """The per-splat gradients of the shards' spans (2 shards of the 6-row
    grid, and 4 of 2 rows, the last wholly past it) add up to the whole
    grid's, as their all_reduce adds them."""
    scene = _raster_scene()
    whole, leaves = _port_span(scene, "cuda", None, "rows")
    want = torch.autograd.grad(torch.sum(whole ** 2), leaves)
    for spans in ([(0, 3), (3, 3)], [(0, 2), (2, 2), (4, 2), (6, 2)]):
        total = [torch.zeros_like(g) for g in want]
        for span in spans:
            img, leaves = _port_span(scene, "cuda", span, "rows")
            for t, g in zip(total, torch.autograd.grad(torch.sum(img ** 2), leaves)):
                t += g
        for name, t, w in zip(("means", "L", "colors", "opacity"), total, want):
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_shard_geometry_matches_jax():
    for h, shards in ((64, 2), (88, 2), (88, 3), (88, 4), (1080, 2), (1080, 3), (1080, 8)):
        cfg, jcfg = FrameConfig(H=h, W=48, num_points=8, max_num_points=8, iterations=1), \
            JConfig(H=h, W=48, num_points=8, max_num_points=8, iterations=1)
        assert rep.shard_rows_per(cfg, shards) == jrep.shard_rows_per(jcfg, shards)
        assert rep.shard_padded_height(cfg, shards) == jrep.shard_padded_height(jcfg, shards)
        for index in range(shards):
            shard = rep.TileShard(shards, index)
            row0 = rep.shard_tile_rows(cfg, shard)[0]
            want = jrep.shard_valid_h(jcfg, jrep.TileShard("tile", shards), row0)
            got = rep.shard_valid_h(cfg, shard, row0)
            assert (got is None) == (want is None) and (got is None or got == int(want))
    with pytest.raises(ValueError):
        rep.shard_rows_per(FrameConfig(H=32, W=48, num_points=8, max_num_points=8,
                                       iterations=1), 3)


# -- spawned ranks -------------------------------------------------------------

W, N = 48, 64


def _np_tree(x):
    """A JAX state as nested dicts of numpy arrays (the PRNG key dropped)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "key"}
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _jcfg(cfg: dict) -> JConfig:
    return JConfig(**{**cfg, "backend": "binned"})


def _jax_state(jcfg, seed, it=0):
    """A gsvc_tpu TrainState with its rgb_w spread (distinct prune ranks)."""
    state = jrep.init_train_state(jax.random.PRNGKey(seed), jcfg)
    p = state.params
    rgb_w = np.random.default_rng(seed + 10).uniform(0.2, 1.5, (jcfg.max_num_points, 1))
    return dataclasses.replace(state, it=jnp.int32(it), params=SplatParams(
        xyz=p.xyz, cholesky=p.cholesky + 0.5, features_dc=p.features_dc,
        rgb_w=jnp.asarray(rgb_w, jnp.float32)))


def _revive_arrays(key, n):
    """gsvc_tpu's `_revive` draws of the step whose state holds `key`."""
    _key, sub = jax.random.split(key)
    k1, k2, k3 = jax.random.split(sub, 3)
    return (np.asarray(jax.random.uniform(k1, (n, 2), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.uniform(k2, (n, 3))),
            np.asarray(jax.random.uniform(k3, (n, 3))))


def _gt(h, seed):
    return np.random.default_rng(seed).uniform(0, 1, (h, W, 3)).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(jrep.make_train_step(jcfg))


STEP_JOBS = {
    # name: (cfg, start it, steps, seed, backend)
    "step_h64": (dict(H=64), 0, 1, 0, "torch"),
    "step_h88": (dict(H=88), 0, 1, 1, "cuda"),
    "step_h88_image_loss": (dict(H=88), 0, 1, 2, "torch"),
    "removal_3997": (dict(H=64, isremoval=True, removal_rate=0.2), 3997, 4, 3, "cuda"),
    "adaptive_0": (dict(H=64, isdensity=True, densification_interval=2, num_points=48,
                        removal_rate=0.2), 0, 4, 4, "torch"),
    "adaptive_998": (dict(H=88, isdensity=True, densification_interval=2,
                          removal_rate=0.2), 998, 4, 5, "cuda"),
}
FIT_JOBS = {"fit_h64": (64, "cuda", 6), "fit_h88": (88, "torch", 7)}


def _step_job(name):
    cfg, start, steps, seed, backend = STEP_JOBS[name]
    cfg = {"W": W, "num_points": N, "max_num_points": N, "iterations": 10**4, **cfg}
    jstate = _jax_state(_jcfg(cfg), seed, start)
    draws = ranks.Draws(_revive_arrays(jstate.key, N)) if cfg.get("isdensity") else None
    return {"kind": "steps", "cfg": {**cfg, "backend": backend}, "jstate": jstate,
            "state": _np_tree(jstate), "gt": _gt(cfg["H"], seed + 20), "steps": steps,
            "draws": draws}


def _fit_job(name):
    h, backend, seed = FIT_JOBS[name]
    cfg = dict(H=h, W=W, num_points=48, max_num_points=48, iterations=6, isremoval=True,
               densification_interval=3)
    jstate = _jax_state(_jcfg(cfg), seed)
    return {"kind": "fit", "cfg": {**cfg, "backend": backend}, "jstate": jstate,
            "state": _np_tree(jstate), "gt": _gt(h, seed + 20)}


def _qat_job():
    h, n = 88, 48
    rng = np.random.default_rng(5)
    gmodel = {"_xyz": rng.normal(0, 0.5, (n, 2)).astype(np.float32),
              "_cholesky": rng.uniform(0, 1, (n, 3)).astype(np.float32),
              "_features_dc": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    cfg = dict(H=h, W=W, num_points=n, max_num_points=n, iterations=8)
    jstate = jcomp.init_compress_state(jax.random.key(9), gmodel)
    # the k-means rows of the first step: gsvc_tpu's key split of that step
    keys = jax.random.split(jax.random.split(jstate.key)[1], 2)
    perms = [np.asarray(jax.random.permutation(k, n)) for k in keys]
    return {"kind": "qat", "cfg": {**cfg, "backend": "cuda"}, "jstate": jstate,
            "state": _np_tree(jstate), "gt": rng.uniform(0, 1, (h, W, 3)).astype(np.float32),
            "perms": perms}


def _frames_job():
    cfg = dict(H=64, W=W, num_points=N, max_num_points=N, iterations=10**4)
    jstates = [_jax_state(_jcfg(cfg), 30 + f) for f in range(4)]
    return {"kind": "frames", "n_frame": 2, "n_tile": 2, "cfg": {**cfg, "backend": "cuda"},
            "jstates": jstates, "states": [_np_tree(s) for s in jstates],
            "gt": np.stack([_gt(64, 40 + f) for f in range(4)])}


def _run(world, jobs):
    """launch() the jobs (without the parent's own JAX states) on `world`
    ranks; (jobs, results by rank, seconds)."""
    sent = [{k: v for k, v in job.items() if k not in ("jstate", "jstates")}
            for job in jobs.values()]
    t0 = time.perf_counter()
    out = launch(ranks.run_jobs, world, (sent,), timeout=600)
    return jobs, [dict(zip(jobs, r)) for r in out], time.perf_counter() - t0


@pytest.fixture(scope="module")
def two_ranks():
    jobs = {name: _step_job(name) for name in STEP_JOBS}
    jobs.update({name: _fit_job(name) for name in FIT_JOBS})
    jobs["qat_h88"] = _qat_job()
    jobs["replicate"] = {"kind": "replicate"}
    return _run(2, jobs)


@pytest.fixture(scope="module")
def four_ranks():
    jobs = {"fit_h88": _fit_job("fit_h88"), "frames": _frames_job()}
    return _run(4, jobs)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("suite,name", [("two_ranks", n) for n in (
    *STEP_JOBS, *FIT_JOBS, "qat_h88")] + [("four_ranks", "fit_h88"), ("four_ranks", "frames")])
def test_ranks_are_bitwise_equal(suite, name, request):
    _jobs, results, _secs = request.getfixturevalue(suite)
    # the ranks of one tile group: all of them, or a frame index's two
    groups = [(0, 1), (2, 3)] if name == "frames" else [tuple(range(len(results)))]
    for group in groups:
        first = dict(_leaves(results[group[0]][name]))
        for r in group[1:]:
            got = dict(_leaves(results[r][name]))
            assert got.keys() == first.keys()
            for k, v in first.items():
                if k != "/mesh":  # the rank's own (frame, tile) index
                    assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k


def _close_states(got, state, atol, what):
    """A rank's state (numpy tree) against a port or gsvc_tpu TrainState at
    gsvc_tpu's sharding tolerances."""
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        want = getattr(state.params, name)
        want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        np.testing.assert_allclose(got["params"][name], want, rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")
    np.testing.assert_array_equal(got["alive"], np.asarray(state.alive), err_msg=what)
    np.testing.assert_allclose(got["loss"], np.asarray(state.loss), rtol=1e-4, atol=1e-6,
                               err_msg=what)
    np.testing.assert_allclose(got["psnr"], np.asarray(state.psnr), rtol=1e-4, err_msg=what)
    assert got["it"] == int(state.it), what


@pytest.mark.parametrize("name", list(STEP_JOBS))
def test_sharded_steps_match_unsharded_and_jax(two_ranks, name):
    jobs, results, _secs = two_ranks
    job = jobs[name]
    cfg = FrameConfig(**job["cfg"])
    steps = job["steps"]
    jstate, state = job["jstate"], train_state_from_numpy(job["state"])
    step = rep.make_train_step(cfg, draws=job["draws"])
    gt = torch.from_numpy(job["gt"])
    rows = rep._rows_target_for(gt, cfg)
    for _ in range(steps):
        jstate = _jax_step(_jcfg({**job["cfg"]}))(jstate, jnp.asarray(job["gt"]))
        state = step(state, gt, rows)
    got = results[0][name]["state"]
    atol = 5e-4 if cfg.isdensity or cfg.isremoval else 2e-4
    _close_states(got, state, atol, "port")
    _close_states(got, jstate, atol, "gsvc_tpu")
    assert got["lr_frozen"] == state.lr_frozen and got["grace"] == state.grace
    assert got["opt"]["step"] == state.opt.step == int(jstate.opt.step)
    if name == "adaptive_0":  # the revive at it == 1 fired alike
        assert int(got["alive"].sum()) > job["cfg"]["num_points"]
    if name in ("removal_3997", "adaptive_998"):  # crossed the control threshold
        assert got["lr_frozen"] and got["opt"]["step"] < steps


@pytest.mark.parametrize("name", list(STEP_JOBS))
def test_sharded_gradients_match_unsharded_and_jax(two_ranks, name):
    """The all-reduced loss and gradients of a sharded step's first
    iteration, read before Adan (whose near scale invariance would hide a
    gradient counted once a rank), against the unsharded port's and
    gsvc_tpu's on one device."""
    jobs, results, _secs = two_ranks
    job = jobs[name]
    cfg, jcfg = FrameConfig(**job["cfg"]), _jcfg(job["cfg"])
    got = results[0][name]["first"]
    gt = torch.from_numpy(job["gt"])
    loss, sq, grads = rep._loss_and_grads(train_state_from_numpy(job["state"]), gt, cfg, 0.0,
                                          rep._rows_target_for(gt, cfg))
    jstate = job["jstate"]

    def jloss(tr):
        return jrep._loss_and_psnr(jrep._from_trainable(tr), jstate.alive,
                                   jnp.asarray(job["gt"]), jcfg, 0.0)[0]

    jgrads = jax.jit(jax.grad(jloss))(jrep._trainable(jstate.params))
    np.testing.assert_allclose(got["loss"], loss.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got["sq"], sq.numpy(), rtol=1e-4)
    assert got["grads"].keys() == grads.keys() == jgrads.keys()
    for k, g in got["grads"].items():
        for what, want in (("port", grads[k].numpy()), ("gsvc_tpu", np.asarray(jgrads[k]))):
            np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-6, err_msg=f"{what} {k}")


@pytest.mark.parametrize("suite,name", [("two_ranks", "fit_h64"), ("two_ranks", "fit_h88"),
                                        ("four_ranks", "fit_h88")])
def test_fit_frame_sharded_matches_fit_frame(suite, name, request):
    jobs, results, _secs = request.getfixturevalue(suite)
    job = jobs[name]
    cfg = FrameConfig(**job["cfg"])
    jres = jrep.fit_frame(job["jstate"], jnp.asarray(job["gt"]), _jcfg(job["cfg"]))
    res = rep.fit_frame(train_state_from_numpy(job["state"]), torch.from_numpy(job["gt"]), cfg)
    got = results[0][name]
    assert got["image"].shape == (cfg.H, cfg.W, 3)
    for what, ref in (("port", res), ("gsvc_tpu", jres)):
        _close_states(got["state"], ref.state, 2e-3, what)
        np.testing.assert_allclose(got["image"], np.asarray(ref.image), rtol=0, atol=5e-3,
                                   err_msg=what)


def test_fit_compress_sharded_matches_fit_compress(two_ranks):
    jobs, results, _secs = two_ranks
    job = jobs["qat_h88"]
    cfg, jcfg = FrameConfig(**job["cfg"]), _jcfg(job["cfg"])
    got = results[0]["qat_h88"]
    draws = ranks.KMeansDraws(job["perms"])
    gt = torch.from_numpy(job["gt"])
    # the raw gradients at the first step (the VQ term counted once)
    _r, _v, grads, _vq = comp._loss_and_grads(
        compress_state_from_numpy(job["state"]), gt, cfg, rep._rows_target_for(gt, cfg), draws)
    jstate = job["jstate"]
    sub = jax.random.split(jstate.key)[1]

    def jloss(tr):
        img, vq_loss, _c, _v = jcomp.forward_quantize(
            jcomp.CompressParams(**tr), jstate.vq, jstate.p_xyz, jstate.p_cholesky,
            jstate.p_features_dc, sub, jcfg, training=True)
        return jnp.mean((img - jnp.asarray(job["gt"])) ** 2) + vq_loss

    jgrads = jax.jit(jax.grad(jloss))(jcomp._p2d(jstate.params))
    for k, g in got["grads"].items():
        for what, want in (("port", grads[k].numpy()), ("gsvc_tpu", np.asarray(jgrads[k]))):
            np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-6, err_msg=f"{what} {k}")
    ref = comp.fit_compress(compress_state_from_numpy(job["state"]), gt, cfg, draws=draws)
    jref = jcomp.fit_compress(jstate, jnp.asarray(job["gt"]), jcfg)
    drift = 2.5 * cfg.lr * cfg.iterations
    for what, state in (("port", ref), ("gsvc_tpu", jref)):
        np.testing.assert_allclose(got["state"]["loss"], np.asarray(state.loss), rtol=5e-3,
                                   err_msg=what)
        for f in ("xyz", "cholesky", "features_dc", "q_scale", "q_beta"):
            np.testing.assert_allclose(got["state"]["params"][f],
                                       np.asarray(getattr(state.params, f)), rtol=0,
                                       atol=drift, err_msg=f"{what} {f}")
        np.testing.assert_allclose(got["state"]["vq"]["embed"], np.asarray(state.vq.embed),
                                   rtol=0, atol=drift, err_msg=what)
    assert got["state"]["it"] == ref.it == cfg.iterations


def test_frame_axis_steps_each_block(four_ranks):
    jobs, results, _secs = four_ranks
    job = jobs["frames"]
    cfg = FrameConfig(**job["cfg"])
    step = rep.make_train_step(cfg)
    meshes = [r["frames"]["mesh"] for r in results]
    assert meshes == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in results:
        assert r["frames"]["frames"] == ([0, 1] if r["frames"]["mesh"][0] == 0 else [2, 3])
    for r in (results[0], results[2]):
        for f, got in zip(r["frames"]["frames"], r["frames"]["states"]):
            gt = torch.from_numpy(job["gt"][f])
            state = step(train_state_from_numpy(job["states"][f]), gt,
                         rep._rows_target_for(gt, cfg))
            jstate = _jax_step(_jcfg(job["cfg"]))(job["jstates"][f], jnp.asarray(job["gt"][f]))
            _close_states(got, state, 2e-4, f"port frame {f}")
            _close_states(got, jstate, 2e-4, f"gsvc_tpu frame {f}")


def test_replicate_to_mesh_broadcasts_rank_0(two_ranks):
    _jobs, results, _secs = two_ranks
    for r in results:
        np.testing.assert_array_equal(r["replicate"]["a"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(r["replicate"]["b"][0], np.arange(4))


def test_sharded_fit_refuses_graphs():
    cfg = FrameConfig(H=32, W=W, num_points=8, max_num_points=8, iterations=2)
    state = rep.init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="eagerly"):
        rep.fit_frame_partial(state, torch.zeros((32, W, 3)), 2, cfg, graph=True,
                              shard=rep.TileShard(2, 0))
    with pytest.raises(ValueError, match="pointwise"):
        rep._loss_and_psnr(state.params, state.alive, torch.zeros((16, W, 3)),
                           dataclasses.replace(cfg, loss_type="Fusion2"), 0.0,
                           shard=rep.TileShard(2, 0))


def test_a_failing_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        launch(ranks.fail_on_rank, 2, (1,), timeout=120)
    assert time.perf_counter() - t0 < 60  # the waiting rank was ended, not awaited


def test_a_launch_outlasts_its_collective_timeout():
    """A launch has no deadline of its own (a CLI's fit runs for hours):
    ranks that work longer than the collective timeout between two
    collectives finish."""
    # ones summed over 2 ranks twice
    assert launch(ranks.sleep_between_collectives, 2, (9.0,), collective_timeout=8) == [4.0, 4.0]


def test_shard_cli_ab_needs_a_card(monkeypatch, tmp_path, capsys):
    from gsvc_tpu_torch.scripts import shard_cli_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert shard_cli_ab.main([str(tmp_path), str(tmp_path)]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def _cli_runs(yuv, tmp_path, runs):
    """The represent and compress CLIs at --tile_shards 1 and 2; runs[shards]
    is the checkpoint directory of each."""
    for shards in (1, 2):
        ckpt = tmp_path / f"shards{shards}"
        common = ["-d", str(yuv), "--data_name", "synth", "--width", "48", "--height", "32",
                  "--image_length", "3", "--num_points", "40", "--backend", "cuda",
                  "--checkpoint_dir", str(ckpt), "--device", "cpu", "--tile_shards",
                  str(shards)]
        assert drv.main(common + ["--iterations", "30", "--kdetect_points", "30",
                                  "--kdetect_iterations", "10", "--is_rm", "--is_ad",
                                  "--savdir_m", "models"]) == 0
        npz = ckpt / "models/synth/GaussianVideo_30_40/gmodels_state_dict.npz"
        assert cdrv.main(common + ["--iterations", "20", "--model_path", str(npz),
                                   "--k_frames_dir", str(ckpt), "--savdir_m", "cmodels"]) == 0
        runs[shards] = ckpt


def test_tile_shards_2_through_the_clis(tmp_path, capsys):
    """The represent and compress CLIs at --tile_shards 2 (two spawned CPU
    ranks) against --tile_shards 1 on a 3-frame 48x32 clip, then the
    decoder on the sharded streams."""
    yuv = _write_yuv(tmp_path / "synth.yuv", _frames(2, 2)[:3])
    runs = {}
    _cli_runs(yuv, tmp_path, runs)
    out = capsys.readouterr().out
    assert out.count("--tile_shards 2: 2 ranks on the CPU (gloo); rank 0 writes") == 2
    one, two = runs[1], runs[2]
    assert _files(one) == _files(two)  # the same files, each written by rank 0 alone
    for name in ("result/synth/K_frames.txt",
                 "result/synth/GaussianVideo_30_40/num_gaussian_points.txt"):
        assert (one / name).read_text() == (two / name).read_text(), name
    for run in ("GaussianVideo_30_40", "GaussianVideo_20_40"):
        a, b = ((r / "result/synth" / run / "train.txt").read_text() for r in (one, two))
        assert len(a.splitlines()) == len(b.splitlines()) == 4  # 3 frames + the average
        pa, pb = _psnrs(a), _psnrs(b)
        assert set(pa) == set(pb) == {1, 2, 3}
        for f in pa:
            assert abs(pa[f] - pb[f]) < 0.1, (run, f, pa[f], pb[f])
    dec_out = tmp_path / "decoded"
    bits = two / "cmodels/synth/GaussianVideo_20_40/bitstream"
    assert decode.main([
        "--bitstream", str(bits), "--height", "32", "--width", "48", "--model_path",
        str(two / "models/synth/GaussianVideo_30_40/gmodels_state_dict.npz"), "--k_frames",
        str(two / "result/synth/K_frames.txt"), "-d", str(yuv), "--out", str(dec_out),
        "--device", "cpu", "--backend", "cuda"]) == 0
    enc = _psnrs((two / "result/synth/GaussianVideo_20_40/train.txt").read_text())
    dec = _psnrs((dec_out / "decode.txt").read_text())
    assert set(dec) == {1, 2, 3} and all(abs(dec[f] - enc[f]) < 0.1 for f in enc)


def test_validate_sharding_twin_matches_on_ragged_spans(capsys):
    from gsvc_tpu_torch.scripts import validate_1080p_sharding as val

    assert val.main(["--device", "cpu", "--height", "72", "--width", "64",
                     "--shards", "2,4", "--timeout", "300"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("--tile_shards")]
    assert [ln.split()[1] for ln in lines] == ["2", "4"]
    assert all(ln.endswith(" MATCH") for ln in lines), out

"""PyTorch port parity: the compress stage against gsvc_tpu.

The same numpy inputs go through both packages. gsvc_tpu runs its
`binned` backend; the port runs "torch" (autograd through the plain
renderer, image loss) and "cuda", whose kernel wrappers take their plain
versions on CPU tensors (rows loss, K6 and the K3 reduction). The k-means
rows come from JAX's `permutation(split(key, Q)[q], n)[:K]`, injected into
the port.

Tolerances: quantizer values and codes exact; quantizer gradients,
including at the clip bounds, rtol 1e-5; the residual VQ's indices and
`initted` exact, its codebooks, EMA statistics and commitment loss rtol
1e-5 (f32 sums in another order); 4 QAT steps: loss and PSNR rtol 1e-4,
parameters atol 1e-5, the best-snapshot choice exact; the port's chunked
fit equals its full fit bitwise; the bit accounting dict equal; the
bitstream bytes identical.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.compress import bitstream as jbs
from gsvc_tpu.compress import quantizers as jq
from gsvc_tpu.config import FrameConfig as JConfig
from gsvc_tpu.models import compress as jcomp
from gsvc_tpu_torch.compress import bitstream, quantizers as q
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import compress_state_from_numpy
from gsvc_tpu_torch.models import compress as comp
from gsvc_tpu_torch.models.represent import TileShard

H, W, N = 32, 48, 60
BASE = dict(H=H, W=W, num_points=N, max_num_points=N, iterations=4, lr=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_fake_quantize_half_matches_jax():
    x = np.random.default_rng(0).normal(0, 3, (40, 2)).astype(np.float32)
    x[0] = [1e-5, 65519.0]
    want, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jq.fake_quantize_half(v) * 3.0))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = q.fake_quantize_half(xt)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jq.fake_quantize_half(jnp.asarray(x))))
    (g,) = torch.autograd.grad(torch.sum(got * 3.0), xt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jgrad))


def _quant_inputs():
    """Cholesky-like values with some exactly on the clip bounds: scale is
    a power of two, so (x - beta) / scale lands on 0 and 63 exactly."""
    rng = np.random.default_rng(1)
    scale = np.array([0.25, 1 / 63, 0.05], np.float32)
    beta = np.array([0.5, 1 / 63, -0.2], np.float32)
    x = rng.uniform(-0.5, 3.5, (64, 3)).astype(np.float32)
    x[0, 0] = 0.5  # code 0: the lower bound
    x[1, 0] = 0.5 + 63 * 0.25  # code 63: the upper bound
    x[2, 0] = 0.5 + 10.5 * 0.25  # a half: rounds to even
    x[3, 0] = 0.5 + 11.5 * 0.25
    return x, scale, beta


def test_uniform_quantize_matches_jax_at_the_bounds():
    x, scale, beta = _quant_inputs()
    wgt = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(x_, s, b):
        deq, _ = jq.uniform_quantize(x_, jq.UniformQuantParams(s, b), 6)
        return jnp.sum(deq * wgt + deq**2)

    jdeq, jcodes = jq.uniform_quantize(
        jnp.asarray(x), jq.UniformQuantParams(jnp.asarray(scale), jnp.asarray(beta)), 6)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, beta)))
    leaves = [_t(a).requires_grad_() for a in (x, scale, beta)]
    deq, codes = q.uniform_quantize(leaves[0], q.UniformQuantParams(*leaves[1:]), 6)
    np.testing.assert_array_equal(deq.detach().numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert codes.dtype == torch.int32
    assert codes[0, 0] == 0 and codes[1, 0] == 63 and codes[2, 0] == 10 and codes[3, 0] == 12
    grads = torch.autograd.grad(torch.sum(deq * _t(wgt) + deq**2), leaves)
    for name, g, jg in zip(("x", "scale", "beta"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # at a bound jnp.clip splits the gradient: half reaches x
    assert np.asarray(jgrads[0])[0, 0] != 0.0
    init = q.uniform_quantizer_init(3, 6)
    jinit = jq.uniform_quantizer_init(3, 6)
    np.testing.assert_array_equal(init.scale.numpy(), np.asarray(jinit.scale))
    np.testing.assert_array_equal(init.beta.numpy(), np.asarray(jinit.beta))


def _jax_kmeans_idx(key, nq):
    """gsvc_tpu's k-means rows: permutation(split(key, nq)[stage], n)[:k]."""
    keys = jax.random.split(key, nq)

    def draws(stage, n, k):
        return np.asarray(jax.random.permutation(keys[stage], n)[:k])

    return draws


def _vq_close(vq, jvq):
    assert vq.initted == bool(jvq.initted)
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(vq, name).numpy(),
                                   np.asarray(getattr(jvq, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_residual_vq_matches_jax_in_training_and_eval():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(c, 0.07, (70, 3)) for c in (0.1, 0.4, 0.8)])
    x = x.astype(np.float32)
    jstep = jax.jit(lambda x, s, k: jq.residual_vq_forward(x, s, k, True))
    jeval = jax.jit(lambda x, s: jq.residual_vq_forward(x, s, jax.random.key(0), False))
    jstate = jq.residual_vq_init(2, 8, 3)
    state = q.residual_vq_init(2, 8, 3)
    key = jax.random.key(5)
    for i in range(3):  # k-means, then two EMA updates
        k = jax.random.fold_in(key, i)
        xs = x + np.float32(0.01 * i)
        xt = _t(xs).requires_grad_()
        jout = jstep(jnp.asarray(xs), jstate, k)
        out = q.residual_vq_forward(xt, state, True, draws=_jax_kmeans_idx(k, 2))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jout[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(out[2].detach()), float(jout[2]), rtol=1e-5)
        _vq_close(out[3], jout[3])
        # gradients: straight through the quantized output, plus the
        # commitment loss's, against jax.grad of the same objective
        (g,) = torch.autograd.grad(torch.sum(out[0] ** 2) + out[2], xt)
        jg = jax.grad(lambda v: jnp.sum(jq.residual_vq_forward(v, jstate, k, True)[0] ** 2)
                      + jq.residual_vq_forward(v, jstate, k, True)[2])(jnp.asarray(xs))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
        state, jstate = out[3], jout[3]
    idx, jidx = q.residual_vq_forward(_t(x), state, False)[1], jeval(jnp.asarray(x), jstate)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.shape == (x.shape[0], 2) and int(idx.max()) < 8
    recon = q.residual_vq_decompress(state, idx.numpy())
    np.testing.assert_allclose(recon, jq.residual_vq_decompress(jstate, np.asarray(jidx)),
                               rtol=1e-5, atol=1e-6)


def test_vq_ties_pick_the_first_code():
    # each row is equidistant from codes 1 and 2 (and, for the last, 0-3)
    embed = np.zeros((1, 4, 3), np.float32)
    embed[0, :, 0] = [0.0, 1.0, 3.0, 5.0]
    x = np.array([[2.0, 0, 0], [4.0, 0, 0], [0.5, 0, 0], [2.0, 1.0, 0]], np.float32)
    jvq = jq.VQState(jnp.asarray(embed), jnp.zeros((1, 4)), jnp.zeros((1, 4, 3)),
                     jnp.bool_(True))
    vq = q.VQState(_t(embed), torch.zeros((1, 4)), torch.zeros((1, 4, 3)), True)
    jidx = np.asarray(jq.residual_vq_forward(jnp.asarray(x), jvq, jax.random.key(0),
                                             False)[1])
    idx = q.residual_vq_forward(_t(x), vq, False)[1].numpy()
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(idx[:, 0], [1, 2, 0, 1])


def _gmodels(seed, delta):
    rng = np.random.default_rng(seed)
    g = {
        "_xyz": np.arctanh(rng.uniform(-0.85, 0.85, (N, 2))).astype(np.float32),
        "_cholesky": rng.uniform(0, 1.5, (N, 3)).astype(np.float32),
        "_features_dc": rng.uniform(0, 1, (N, 3)).astype(np.float32),
    }
    if not delta:
        return g, None
    cur = {k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32) for k, v in g.items()}
    return cur, g


def _gt(seed=9):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rng = np.random.default_rng(seed)
    return np.clip(np.stack([xx / W, yy / H, 0.5 + 0 * xx], -1)
                   + rng.normal(0, 0.05, (H, W, 3)), 0, 1).astype(np.float32)


@lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(jcomp.make_train_step_quantize(jcfg))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_train_steps_match_jax(delta, backend):
    jcfg = JConfig(**BASE, backend="binned")
    cfg = FrameConfig(**BASE, backend=backend)
    gmodel, p_gmodel = _gmodels(4, delta)
    jstate = jcomp.init_compress_state(jax.random.key(2), gmodel, p_gmodel)
    state = compress_state_from_numpy(jstate)
    assert state.it == 0 and not state.vq.initted
    gt = _gt()
    keys = {}

    def draws(stage, n, k):
        return keys["draws"](stage, n, k)

    step = comp.make_train_step_quantize(cfg, draws=draws)
    from gsvc_tpu_torch.models.represent import _rows_target_for

    rows = _rows_target_for(torch.from_numpy(gt), cfg)
    assert (rows is not None) == (backend == "cuda")
    improved, jimproved = [], []
    for _ in range(4):
        keys["draws"] = _jax_kmeans_idx(jax.random.split(jstate.key)[1], 2)
        best0, jbest0 = state.best_psnr.clone(), jstate.best_psnr
        jstate = _jax_step(jcfg)(jstate, jnp.asarray(gt))
        state = step(state, torch.from_numpy(gt), rows)
        improved.append(bool(state.psnr > best0))
        jimproved.append(bool(jstate.psnr > jbest0))
        assert state.it == int(jstate.it) and state.opt.step == int(jstate.opt.step)
        np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-4)
        np.testing.assert_allclose(float(state.psnr), float(jstate.psnr), rtol=1e-4)
    assert improved == jimproved and improved[0]
    for which in ("params", "best_params"):
        for f in dataclasses.fields(comp.CompressParams):
            np.testing.assert_allclose(
                getattr(getattr(state, which), f.name).numpy(),
                np.asarray(getattr(getattr(jstate, which), f.name)),
                rtol=0, atol=1e-5, err_msg=f"{which}.{f.name}")
    np.testing.assert_allclose(float(state.best_psnr), float(jstate.best_psnr), rtol=1e-4)
    _vq_close(state.vq, jstate.vq)
    _vq_close(state.best_vq, jstate.best_vq)
    # the delta buffers ride along unchanged
    np.testing.assert_array_equal(state.p_cholesky.numpy(), np.asarray(jstate.p_cholesky))


def test_fit_compress_chunked_equals_full_bitwise():
    cfg = FrameConfig(**{**BASE, "iterations": 7}, backend="cuda")
    gmodel, _ = _gmodels(5, False)
    gt = torch.from_numpy(_gt(3))
    full = comp.fit_compress(comp.init_compress_state(gmodel), gt, cfg,
                             draws=torch.Generator().manual_seed(0))
    chunked = comp.fit_compress_chunked(comp.init_compress_state(gmodel), gt, cfg, 3,
                                        draws=torch.Generator().manual_seed(0))
    assert full.it == chunked.it == 7
    for f in dataclasses.fields(comp.CompressParams):
        assert torch.equal(getattr(full.params, f.name), getattr(chunked.params, f.name))
    for name in ("embed", "cluster_size", "embed_avg"):
        assert torch.equal(getattr(full.vq, name), getattr(chunked.vq, name))
    assert torch.equal(full.best_psnr, chunked.best_psnr)
    # the reload: the fit returns its best snapshot
    assert full.params is full.best_params and full.vq is full.best_vq


@lru_cache(maxsize=None)
def _fitted_jax_state(delta):
    """A JAX compress state after a short fit (codebooks initialised)."""
    jcfg = JConfig(**{**BASE, "iterations": 6}, backend="binned")
    gmodel, p_gmodel = _gmodels(6, delta)
    jstate = jcomp.init_compress_state(jax.random.key(1), gmodel, p_gmodel)
    return jcomp.fit_compress(jstate, jnp.asarray(_gt(4)), jcfg), jcfg


@pytest.mark.parametrize("delta", [False, True])
def test_measure_bits_and_encode_frame_match_jax(delta):
    jstate, jcfg = _fitted_jax_state(delta)
    state = compress_state_from_numpy(jstate)
    cfg = FrameConfig(**{**BASE, "iterations": 6}, backend="torch")
    jbits, jimg = jcomp.measure_bits(jstate, jcfg)
    bits, img = comp.measure_bits(state, cfg)
    assert bits == jbits
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=1e-5)
    blob = bitstream.encode_frame(state, cfg, "P" if delta else "K")
    assert blob == jbs.encode_frame(jstate, jcfg)
    assert bitstream.frame_type(blob) == ("P" if delta else "K")
    assert int(comp.compress_overflow(state, cfg)) == int(jcomp.compress_overflow(jstate, jcfg))
    with pytest.raises(ValueError):
        bitstream.encode_frame(state, cfg, "B")


def test_delta_mode_refuses_a_splat_count_mismatch():
    gmodel, p_gmodel = _gmodels(8, True)
    short = {k: v[:-5] for k, v in p_gmodel.items()}
    with pytest.raises(ValueError, match="previous frame 55"):
        comp.init_compress_state(gmodel, short)


def test_sharding_arguments_are_refused():
    """`shard` and `tile_rows` are taken (the tile-sharded trainer,
    tests/test_torch_sharded.py runs them on ranks); gsvc_tpu's error
    stays: more shards than the frame's tile rows raise ValueError."""
    cfg = FrameConfig(**BASE)  # H = 32: two tile rows
    state = comp.init_compress_state(_gmodels(7, False)[0])
    args = (state.params, state.vq, state.p_xyz, state.p_cholesky, state.p_features_dc, cfg,
            False)
    span = comp.forward_quantize(*args, tile_rows=(1, 1))[0]
    assert span.shape == (16, W, 3)
    np.testing.assert_allclose(span.numpy(), comp.forward_quantize(*args)[0][16:].numpy(),
                               rtol=0, atol=1e-6)
    assert callable(comp.make_train_step_quantize(cfg, shard=TileShard(2, 1)))
    too_many = comp.make_train_step_quantize(cfg, shard=TileShard(3, 0))
    with pytest.raises(ValueError, match="3 tile shards > 2 tile rows"):
        too_many(state, torch.from_numpy(_gt())[:16])

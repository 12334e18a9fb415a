"""PyTorch port parity: bitstream, decoder CLI, render_frame and metrics.

Streams are written by gsvc_tpu (`init_compress_state` + `encode_frame`,
no fit) and decoded by both packages. Tolerances: codes, cholesky and
colours exact; means within 1 ulp of the correctly rounded tanh (ATen's)
and within 4 ulp of gsvc_tpu's, whose XLA tanh is itself up to 4 ulp from
the correctly rounded value; renders atol 1e-5; decoded.rgb within 1 uint8
level (a render difference of 1e-5 can round across a level boundary);
metrics atol 1e-5.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsvc_tpu.decode as jdecode
from gsvc_tpu.compress import bitstream as jbs
from gsvc_tpu.compress.quantizers import (
    UniformQuantParams,
    residual_vq_forward,
    uniform_quantize,
)
from gsvc_tpu.config import FrameConfig as JFrameConfig
from gsvc_tpu.core import SplatParams
from gsvc_tpu.drivers.compress import load_gmodels as jload_gmodels
from gsvc_tpu.models import represent as jrep
from gsvc_tpu.models.compress import init_compress_state
from gsvc_tpu.utils import metrics as jmetrics
from gsvc_tpu_torch import decode
from gsvc_tpu_torch.compress import bitstream
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import from_numpy
from gsvc_tpu_torch.drivers.compress import load_gmodels
from gsvc_tpu_torch.io.yuv import process_yuv_video
from gsvc_tpu_torch.models import represent
from gsvc_tpu_torch.utils import metrics
from gsvc_tpu_torch.utils.profiling import device_loop_time

H, W, N = 32, 48, 64
ATOL = 1e-5


def _gmodel(seed):
    rng = np.random.default_rng(seed)
    return {
        "_xyz": rng.normal(0, 0.5, (N, 2)).astype(np.float32),
        "_cholesky": rng.uniform(0, 1, (N, 3)).astype(np.float32),
        "_features_dc": rng.uniform(0, 1, (N, 3)).astype(np.float32),
    }


def _state(delta):
    """An unfitted compress state with a random Q=2, K=8 codebook."""
    gmodel = _gmodel(0)
    p_gmodel = None
    if delta:
        rng = np.random.default_rng(1)
        p_gmodel = {k: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
                    for k, v in gmodel.items()}
        gmodel, p_gmodel = p_gmodel, gmodel  # p = the previous frame
    state = init_compress_state(jax.random.key(0), gmodel, p_gmodel)
    embed = np.random.default_rng(2).uniform(-0.3, 0.6, (2, 8, 3)).astype(np.float32)
    state = dataclasses.replace(
        state, vq=dataclasses.replace(state.vq, embed=jnp.asarray(embed)))
    return state, p_gmodel


def _side(state, delta):
    if not delta:
        return {}
    return dict(p_xyz=np.asarray(state.p_xyz), p_cholesky=np.asarray(state.p_cholesky),
                p_features_dc=np.asarray(state.p_features_dc))


def _cfg(cls, **kw):
    return cls(H=H, W=W, num_points=N, max_num_points=N, iterations=1, **kw)


@pytest.mark.parametrize("delta", [False, True])
def test_decode_frame_matches_jax(delta):
    state, _ = _state(delta)
    blob = jbs.encode_frame(state, _cfg(JFrameConfig))
    assert bitstream.frame_type(blob) == jbs.frame_type(blob) == ("P" if delta else "K")
    kw = _side(state, delta)
    jm, jc, jcol = jbs.decode_frame(blob, **kw)
    tm, tc, tcol = bitstream.decode_frame(blob, **kw)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tcol, jcol)
    raw = np.frombuffer(blob, np.float16, count=2 * N, offset=20).reshape(N, 2)
    side = kw.get("p_xyz", np.zeros((N, 2), np.float32))
    exact = np.tanh((raw.astype(np.float32) + side).astype(np.float64))
    np.testing.assert_array_max_ulp(tm, exact.astype(np.float32), maxulp=1)
    np.testing.assert_array_max_ulp(tm, jm, maxulp=4)
    # and the rendered frames agree
    jimg = jbs.render_decoded(jm, jc, jcol, _cfg(JFrameConfig, backend="binned"))
    timg = bitstream.render_decoded(tm, tc, tcol, _cfg(FrameConfig))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=ATOL)


@pytest.mark.parametrize("delta", [False, True])
def test_pack_frame_bytes_match_encode_frame(delta):
    state, _ = _state(delta)
    p = state.params
    _deq, codes = uniform_quantize(p.cholesky, UniformQuantParams(p.q_scale, p.q_beta),
                                   bitstream.CHOL_BITS)
    _q, idx, _l, _s = residual_vq_forward(p.features_dc, state.vq,
                                          jax.random.key(0), False)
    blob = bitstream.pack_frame(
        np.asarray(p.xyz, np.float32).astype(np.float16), np.asarray(p.q_scale),
        np.asarray(p.q_beta), np.asarray(codes), np.asarray(state.vq.embed),
        np.asarray(idx), "P" if delta else "K",
    )
    assert blob == jbs.encode_frame(state, _cfg(JFrameConfig))
    with pytest.raises(ValueError):
        bitstream.pack_frame(np.zeros((1, 2)), np.ones(3), np.ones(3),
                             np.zeros((1, 3)), np.zeros((1, 2, 3)),
                             np.zeros((1, 1)), "B")


def test_wide_frame_packs_decodes_and_renders_as_jax():
    """One K-frame of 70,000 splats (a 17-bit gauss field in the port's
    binning; gsvc_tpu bins by its pair sort): pack_frame's bytes are
    encode_frame's, the decoded codes and colours equal, and the decoded
    render within ATOL of gsvc_tpu's. The colours are small, so that the
    capped sums of 256 lanes a tile stay below the clip at 1."""
    n = 70000
    rng = np.random.default_rng(6)
    gmodel = {"_xyz": rng.normal(0, 0.5, (n, 2)).astype(np.float32),
              "_cholesky": rng.uniform(0, 1, (n, 3)).astype(np.float32),
              "_features_dc": rng.uniform(0, 0.05, (n, 3)).astype(np.float32)}
    state = init_compress_state(jax.random.key(0), gmodel, None)
    embed = np.random.default_rng(7).uniform(0, 0.05, (2, 8, 3)).astype(np.float32)
    state = dataclasses.replace(
        state, vq=dataclasses.replace(state.vq, embed=jnp.asarray(embed)))
    kw = dict(H=H, W=W, num_points=n, max_num_points=n, iterations=1,
              max_intersects=6 * n)  # 6 tiles: no splat can overflow it
    blob = jbs.encode_frame(state, JFrameConfig(**kw))
    p = state.params
    _deq, codes = uniform_quantize(p.cholesky, UniformQuantParams(p.q_scale, p.q_beta),
                                   bitstream.CHOL_BITS)
    _q, idx, _l, _s = residual_vq_forward(p.features_dc, state.vq, jax.random.key(0),
                                          False)
    assert blob == bitstream.pack_frame(
        np.asarray(p.xyz, np.float32).astype(np.float16), np.asarray(p.q_scale),
        np.asarray(p.q_beta), np.asarray(codes), np.asarray(state.vq.embed),
        np.asarray(idx), "K")
    jm, jc, jcol = jbs.decode_frame(blob)
    tm, tc, tcol = bitstream.decode_frame(blob)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_array_max_ulp(tm, jm, maxulp=4)
    jimg = np.asarray(jbs.render_decoded(jm, jc, jcol, JFrameConfig(**kw, backend="binned")))
    timg = bitstream.render_decoded(tm, tc, tcol, FrameConfig(**kw)).numpy()
    assert 0.05 < jimg.max() < 1.0  # unclipped
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=ATOL)


def test_render_frame_matches_jax_on_a_checkpoint():
    gmodel = _gmodel(3)
    alive = np.random.default_rng(4).uniform(size=N) > 0.1
    jp = SplatParams(xyz=jnp.asarray(gmodel["_xyz"]),
                     cholesky=jnp.asarray(gmodel["_cholesky"]),
                     features_dc=jnp.asarray(gmodel["_features_dc"]),
                     rgb_w=jnp.ones((N, 1), jnp.float32))
    jcfg = _cfg(JFrameConfig, backend="binned")
    frame = from_numpy(gmodel)
    talive = torch.from_numpy(alive)
    want = np.asarray(jax.jit(jrep.render_frame, static_argnums=2)(
        jp, jnp.asarray(alive), jcfg))
    img = represent.render_frame(frame, talive, _cfg(FrameConfig))
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=ATOL)
    chw = represent.render_frame(frame, talive, _cfg(FrameConfig), layout="chw")
    np.testing.assert_allclose(chw.numpy().transpose(1, 2, 0), want, rtol=0, atol=ATOL)
    pos = represent.render_frame_pos(frame, talive, _cfg(FrameConfig))
    jpos = np.asarray(jax.jit(jrep.render_frame_pos, static_argnums=2)(
        jp, jnp.asarray(alive), jcfg))
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=ATOL)


def _write_yuv(path, frames):
    rng = np.random.default_rng(5)
    yuv = rng.integers(16, 236, (frames, H * 3 // 2, W)).astype(np.uint8)
    yuv.tofile(path)


def test_decode_clis_agree(tmp_path):
    """K-frame 1 and P-frame 2 through both decoders; the port on the CPU."""
    bs = tmp_path / "bitstream"
    bs.mkdir()
    k_state, _ = _state(False)
    p_state, prev = _state(True)
    (bs / "frame_1.gsvc").write_bytes(jbs.encode_frame(k_state, _cfg(JFrameConfig)))
    (bs / "frame_2.gsvc").write_bytes(jbs.encode_frame(p_state, _cfg(JFrameConfig)))
    ckpt = tmp_path / "gmodels.npz"
    np.savez(ckpt, **{f"frame_1/{k}": v for k, v in prev.items()})
    yuv = tmp_path / "video.yuv"
    _write_yuv(yuv, 2)
    common = ["--bitstream", str(bs), "--height", str(H), "--width", str(W),
              "--model_path", str(ckpt)]
    assert jdecode.main(common + ["--out", str(tmp_path / "jax"), "--no_png"]) == 0
    assert decode.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu",
                                 "--dataset", str(yuv)]) == 0
    jrgb = np.fromfile(tmp_path / "jax" / "decoded.rgb", np.uint8)
    trgb = np.fromfile(tmp_path / "port" / "decoded.rgb", np.uint8)
    assert trgb.size == jrgb.size == 2 * H * W * 3
    assert np.abs(trgb.astype(int) - jrgb.astype(int)).max() <= 1
    assert (tmp_path / "port" / "frame_2.png").is_file()
    report = (tmp_path / "port" / "decode.txt").read_text()
    assert report.count("PSNR:") == 2 and "MS-SSIM:" in report

    for k, v in jload_gmodels(str(ckpt)).items():
        for name, arr in v.items():
            np.testing.assert_array_equal(load_gmodels(str(ckpt))[k][name], arr)


def test_decode_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    bs = tmp_path / "bitstream"
    bs.mkdir()
    state, _ = _state(False)
    (bs / "frame_1.gsvc").write_bytes(jbs.encode_frame(state, _cfg(JFrameConfig)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.main(["--bitstream", str(bs), "--height", str(H), "--width", str(W),
                     "--device", "cuda"])
    with pytest.raises(RuntimeError):
        device_loop_time(lambda x: x, torch.zeros(1))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsvc_tpu_torch\n"
        "for m in pkgutil.walk_packages(gsvc_tpu_torch.__path__, 'gsvc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gsvc_tpu')]\n"
        "assert not bad, bad\n"
        "harnesses = [m for m in sys.modules if m.startswith('gsvc_tpu_torch.scripts.')]\n"
        "assert len(harnesses) >= 7, harnesses  # the six harnesses and common\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (2, 3, 64, 72)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert abs(float(metrics.psnr(ta, tb)) - float(jmetrics.psnr(ja, jb))) < 1e-4
    for name in ("ssim", "ms_ssim"):
        for avg in (True, False):
            got = getattr(metrics, name)(ta, tb, size_average=avg).numpy()
            want = np.asarray(getattr(jmetrics, name)(ja, jb, size_average=avg))
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)


def test_yuv_reader_levels(tmp_path):
    yuv = np.zeros((H * 3 // 2, W), np.uint8)
    yuv[:H // 2] = 16  # black (video range)
    yuv[H // 2:H] = 235  # white
    yuv[H:] = 128  # neutral chroma
    path = tmp_path / "v.yuv"
    np.concatenate([yuv, yuv]).tofile(path)
    frames = process_yuv_video(str(path), W, H)
    assert len(frames) == 2 and frames[0].shape == (H, W, 3)
    assert (frames[0][:H // 2] == 0).all() and (frames[0][H // 2:] >= 254).all()
    assert len(process_yuv_video(str(path), W, H, limit=1)) == 1

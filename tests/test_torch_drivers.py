"""PyTorch port parity: the represent / compress drivers and the model
loops they run, against gsvc_tpu, at 48x32 with ~40 splats.

gsvc_tpu runs its `binned` backend; the port runs "torch" or "cuda" (the
kernel wrappers' plain versions on CPU tensors). Random init draws are
injected into the port from JAX's keys (seed * 100003 + frame).

Tolerances: schedules, compaction, checkpoint dicts, the K-frame list and
log lines exact; loss_list.txt rtol 1e-3 (differences of two pre-train
losses, normalised); chained fit_frame_partial bitwise equal to
fit_frame, stopping at JAX's iteration; fit_frame_trace images atol 1e-5;
decoded PSNR within 0.1 dB of the encoder's (the JAX package's guard,
tests/test_driver_e2e.py); cross-package decodes atol 1e-5.
"""

import argparse
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.compress import bitstream as jbs
from gsvc_tpu.config import FrameConfig as JConfig
from gsvc_tpu.drivers import compress as jcdrv
from gsvc_tpu.drivers import represent as jdrv
from gsvc_tpu.models import represent as jrep
from gsvc_tpu.parallel import multihost as jmh
from gsvc_tpu.utils.logwriter import LogWriter as JLogWriter
from gsvc_tpu_torch import decode
from gsvc_tpu_torch.compress import bitstream
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import from_numpy, train_state_from_numpy
from gsvc_tpu_torch.drivers import compress as cdrv
from gsvc_tpu_torch.drivers import represent as drv
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.parallel import multihost as mh
from gsvc_tpu_torch.utils.logwriter import LogWriter

H, W = 32, 48


def _frames(n_scenes=2, per_scene=2):
    """uint8 RGB frames: a few blobs per scene, then the same scene with
    the blobs moved a few pixels (a cut between scenes)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for s in range(n_scenes):
        rng = np.random.default_rng(100 + s)
        blobs = [(rng.uniform(6, W - 6), rng.uniform(6, H - 6), rng.uniform(3, 8),
                  rng.uniform(0.3, 1.0, 3)) for _ in range(4)]
        for f in range(per_scene):
            img = np.zeros((H, W, 3), np.float32)
            for cx, cy, sd, col in blobs:
                g = np.exp(-(((xx - cx - 2 * f) ** 2 + (yy - cy - f) ** 2) / (2 * sd * sd)))
                img += g[..., None] * col
            frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def _write_yuv(path, frames):
    """I420 with the forward BT.601 transform of tests/test_driver_e2e.py."""
    with open(path, "wb") as fo:
        for rgb in frames:
            r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
            y = np.clip(16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256, 0, 255)
            u = np.clip(128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256, 0, 255)
            v = np.clip(128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256, 0, 255)
            for plane in (y, u[::2, ::2], v[::2, ::2]):
                fo.write(plane.astype(np.uint8).tobytes())
    return path


def _jax_init_uniforms(seed, frame_num, cap):
    """gsvc_tpu's init draws of frame `frame_num` (SimpleTrainer2d's key,
    then init_train_state's and init_splats' splits)."""
    k_init = jax.random.split(jax.random.key(seed * 100003 + frame_num))[0]
    k1, k2, k3 = jax.random.split(k_init, 3)
    return (np.asarray(jax.random.uniform(k1, (cap, 2), minval=-1.0, maxval=1.0)),
            np.asarray(jax.random.uniform(k2, (cap, 3))),
            np.asarray(jax.random.uniform(k3, (cap, 3))))


def test_logwriter_lines_match_jax(tmp_path):
    lines = ["Frame_1: 32x48, PSNR:30.1234, MS-SSIM:0.9876", "Average: x"]
    for i, cls in enumerate((LogWriter, JLogWriter)):
        lw = cls(tmp_path / str(i), suffix=".host0")
        for ln in lines:
            lw.write(ln)
    got = (tmp_path / "0" / "train.host0.txt").read_text()
    assert got == (tmp_path / "1" / "train.host0.txt").read_text()
    assert got == "\n".join(lines) + "\n"
    assert LogWriter(tmp_path / "t", train=False).file_path.endswith("test.txt")


@pytest.mark.parametrize("k_frames,n,hosts", [
    ([1], 7, 2), ([1, 4, 9], 12, 2), ([3, 1, 3, 6], 8, 3), ([1, 2, 3, 4], 4, 4),
    ([1, 10], 6, 1), ([2, 5], 9, 5),
])
def test_schedules_match_jax(k_frames, n, hosts):
    assert mh.gop_spans(k_frames, n) == jmh.gop_spans(k_frames, n)
    assert mh.assign_gops(k_frames, n, hosts) == jmh.assign_gops(k_frames, n, hosts)
    assert mh.assign_frames(n, hosts) == jmh.assign_frames(n, hosts)


def _jax_state(jcfg, seed, chol_shift=0.5):
    state = jrep.init_train_state(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    p = state.params
    return dataclasses.replace(state, params=dataclasses.replace(
        p, cholesky=p.cholesky + chol_shift,
        rgb_w=jnp.asarray(rng.uniform(0.2, 1.5, p.rgb_w.shape), jnp.float32)))


def test_compact_alive_and_gmodel_match_jax():
    jcfg = JConfig(H=H, W=W, num_points=40, max_num_points=50, iterations=1)
    jstate = _jax_state(jcfg, 3)
    alive = np.random.default_rng(4).uniform(size=50) < 0.7
    jp, jcount = jdrv.compact_alive(jstate.params, jnp.asarray(alive))
    params = from_numpy(jstate.params)
    p, count = drv.compact_alive(params, torch.from_numpy(alive))
    assert count == jcount == int(alive.sum())
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        np.testing.assert_array_equal(getattr(p, name).detach().numpy(),
                                      np.asarray(getattr(jp, name)))
    g, jg = (drv.gmodel_from_state(params, torch.from_numpy(alive)),
             jdrv.gmodel_from_state(jstate.params, jnp.asarray(alive)))
    assert sorted(g) == sorted(jg) == ["_cholesky", "_features_dc", "_xyz"]
    for k in g:
        assert g[k].shape[0] == count
        np.testing.assert_array_equal(g[k], jg[k])
    warm = drv._warm_params(g, 50)
    jwarm = jdrv._warm_params(jg, 50)
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        np.testing.assert_array_equal(getattr(warm, name).detach().numpy(),
                                      np.asarray(getattr(jwarm, name)))


def _kd_args(backend, **kw):
    return argparse.Namespace(kdetect_points=40, kdetect_iterations=30, removal_rate=0.1,
                              seed=1, backend=backend, lr=3e-2,
                              densification_interval=100, budget_factor=0, **kw)


def test_detect_k_frames_matches_jax(tmp_path):
    frames = _frames()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jk = jdrv.detect_k_frames(frames, _kd_args("binned"), jdir, "L2")
    k = drv.detect_k_frames(frames, _kd_args("cuda", device="cpu"), tdir, "L2",
                            uniforms=lambda fn: _jax_init_uniforms(1, fn, 40))
    assert k == jk == [1, 3]  # the cut is a K-frame, the moved scenes are not
    assert (tdir / "K_frames.txt").read_text() == (jdir / "K_frames.txt").read_text()

    def losses(d):
        return [float(m.group(2)) for m in re.finditer(
            r"^Frame (\d+): (\S+)$", (d / "loss_list.txt").read_text(), re.M)]

    assert len(losses(tdir)) == len(frames)
    np.testing.assert_allclose(losses(tdir), losses(jdir), rtol=1e-3, atol=1e-6)
    # the cache short-circuits
    assert drv.detect_k_frames(frames, None, tdir, "L2") == k


def _fit_cfgs(**kw):
    base = dict(H=H, W=W, num_points=40, max_num_points=48, iterations=30)
    base.update(kw)
    return JConfig(**base, backend="binned"), FrameConfig(**base, backend="cuda")


def _gt(seed):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def test_fit_frame_partial_chains_bitwise():
    _jcfg, cfg = _fit_cfgs(isremoval=True, densification_interval=4, iterations=19,
                           lr=1e-2)
    gt = torch.from_numpy(_gt(1))

    def fresh():
        return rep.init_train_state(cfg, generator=torch.Generator().manual_seed(2))

    full = rep.fit_frame(fresh(), gt, cfg)
    s = fresh()
    for lim in (7, 14, 21):
        s = rep.fit_frame_partial(s, gt, lim, cfg)
    assert s.it == full.state.it == 19
    for name in ("xyz", "cholesky", "features_dc", "rgb_w"):
        assert torch.equal(getattr(s.params, name), getattr(full.state.params, name))
    assert torch.equal(s.alive, full.state.alive) and torch.equal(s.loss, full.state.loss)


def test_fit_frame_partial_stops_where_jax_stops():
    # the lr at 0 plateaus at once: with a patience of 3 gsvc_tpu's
    # while_loop stops at it == 4, inside the second slice. (Not on every
    # scene: the min_delta of 1e-9 is below an ulp of the loss, and XLA may
    # recompute the loss inside the comparison's fusion an ulp lower, which
    # counts as an improvement; ROADMAP Queue 3.)
    jcfg, cfg = _fit_cfgs(lr=0.0, early_stop_patience=3)
    jstate = _jax_state(jcfg, 5, chol_shift=0.0)
    gt = _gt(2)
    s = train_state_from_numpy(jstate)
    full = rep.fit_frame(train_state_from_numpy(jstate), torch.from_numpy(gt), cfg)
    for lim in (3, 6, 9):
        jstate = jrep.fit_frame_partial(jstate, jnp.asarray(gt), lim, jcfg)
        s = rep.fit_frame_partial(s, torch.from_numpy(gt), lim, cfg)
        assert s.it == int(jstate.it) and bool(s.stop) == bool(jstate.stop)
    assert s.it == full.state.it == 4 and bool(s.stop)
    assert torch.equal(s.loss, full.state.loss)


def test_fit_frame_trace_matches_jax():
    jcfg, cfg = _fit_cfgs(isremoval=True, densification_interval=2, iterations=5,
                          lr=1e-2)
    jstate = _jax_state(jcfg, 6)
    gt = _gt(3)
    jfinal, jimgs = jrep.fit_frame_trace(jstate, jnp.asarray(gt), jcfg, trace_every=2)
    final, imgs = rep.fit_frame_trace(train_state_from_numpy(jstate),
                                      torch.from_numpy(gt), cfg, trace_every=2)
    assert imgs.shape == tuple(jimgs.shape) == (2, H, W, 3)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), rtol=0, atol=1e-5)
    assert final.it == int(jfinal.it) == 5
    np.testing.assert_array_equal(final.alive.numpy(), np.asarray(jfinal.alive))
    # the first traced image is the render after one update, before the second
    once = rep.make_train_step(cfg)(train_state_from_numpy(jstate), torch.from_numpy(gt),
                                    rep._rows_target_for(torch.from_numpy(gt), cfg))
    np.testing.assert_array_equal(
        imgs[0].numpy(), rep.render_frame(once.params, once.alive, cfg).numpy())


@pytest.mark.parametrize("h,valid_h", [(32, 20), (48, 33), (32, 0)])
def test_make_rows_target_valid_h_matches_jax(h, valid_h):
    gt = np.random.default_rng(h).uniform(size=(h, W, 3)).astype(np.float32)
    jcfg, cfg = _fit_cfgs()
    jrows, jmask = jrep.make_rows_target(jnp.asarray(gt), jcfg, valid_h=valid_h)
    rows, mask = rep.make_rows_target(torch.from_numpy(gt), cfg,
                                      valid_h=torch.tensor(valid_h))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(mask.sum()) == 3 * W * min(valid_h, h)


# -- the CLIs ---------------------------------------------------------------

REP_LINE = (r"Frame_\d+: 32x48, PSNR:\d+\.\d{4}, MS-SSIM:-?\d+\.\d{4}, "
            r"Training:\d+\.\d{4}s, Eval:\d+\.\d{8}s, FPS:\d+\.\d{4}, Loss:\d+\.\d{4}")
REP_AVG = (r"Average: 32x48, PSNR:\d+\.\d{4}, MS-SSIM:-?\d+\.\d{4}, Training:\d+\.\d{4}s, "
           r"Eval:\d+\.\d{8}s, FPS:\d+\.\d{4}, Size:\d+\.\d{4}, Gaussian_number:\d+\.\d{4}")
CMP_LINE = (r"Frame_\d+: 32x48, PSNR:\d+\.\d{4}, MS-SSIM:-?\d+\.\d{4}, bpp:\d+\.\d{4}, "
            r"Training:\d+\.\d{4}s, Eval:\d+\.\d{8}s, FPS:\d+\.\d{4}")
CMP_AVG = (r"Average: 32x48, PSNR:\d+\.\d{4}, MS-SSIM:-?\d+\.\d{4}, Bpp:\d+\.\d{4}, "
           r"Training:\d+\.\d{4}s, Eval:\d+\.\d{8}s, FPS:\d+\.\d{4}")


def _psnrs(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"Frame_(\d+):.*?PSNR:([\d.]+)", text)}


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_a_fit_over_its_budget_is_fitted_again_with_a_larger_one(capsys):
    """The RD ladder's 10k point (ROADMAP Queue 3): a represent fit that
    overflows its intersection budget (gsvc_tpu warns and keeps it) is
    fitted again from the start with twice the intersections it reached,
    in buckets of 8192; a fit within its budget is fitted once."""
    gt = _frames(1, 1)[0]
    args = _kd_args("cuda", device="cpu")
    made = []

    def make(max_intersects):
        made.append(max_intersects)
        return drv.SimpleTrainer2d(gt, 1, num_points=40, max_num_points=40, iterations=30,
                                   args=args, isremoval=True, backend="cuda",
                                   max_intersects=max_intersects)

    over = make(16)
    over.train()
    assert int(over.state.max_overflow) > 0
    made.clear()
    trainer, result, max_intersects = drv.train_within_budget(make, 16)
    assert made == [16, 8192] and max_intersects == 8192
    assert int(trainer.state.max_overflow) == 0 and rep.intersection_budget(trainer.cfg) == 8192
    assert "overflowed its intersection budget 16 by" in capsys.readouterr().err
    fresh = make(8192).train()  # the second fit is a fresh one with that budget
    assert result[0] == fresh[0] and result[-1] == fresh[-1]
    for k in result[5]:
        np.testing.assert_array_equal(result[5][k], fresh[5][k])
    made.clear()
    _trainer, _result, max_intersects = drv.train_within_budget(make, None)
    assert made == [None] and max_intersects is None
    assert "overflow" not in capsys.readouterr().err


def test_represent_compress_decode_clis(tmp_path):
    """The port's three CLIs on a synthetic 3-frame YUV: the artifacts and
    train.txt lines of gsvc_tpu's test_represent_then_compress_e2e."""
    yuv = _write_yuv(tmp_path / "synth.yuv", _frames(2, 2)[:3])
    ckpt = tmp_path / "ckpt"
    common = ["-d", str(yuv), "--data_name", "synth", "--width", "48", "--height", "32",
              "--image_length", "3", "--num_points", "40", "--backend", "cuda",
              "--checkpoint_dir", str(ckpt), "--savdir", "result", "--device", "cpu"]
    assert drv.main(common + ["--iterations", "30", "--kdetect_points", "30",
                              "--kdetect_iterations", "10", "--is_rm", "--is_ad",
                              "--savdir_m", "models"]) == 0
    npz = ckpt / "models" / "synth" / "GaussianVideo_30_40" / "gmodels_state_dict.npz"
    assert cdrv.main(common + ["--iterations", "20", "--model_path", str(npz),
                               "--k_frames_dir", str(ckpt), "--savdir_m", "cmodels",
                               "--fit_chunk", "8"]) == 0
    video = "video/video.mp4" + ("" if drv_has_cv2() else ".npz")
    assert _files(ckpt) == sorted([
        "cmodels/synth/GaussianVideo_20_40/bitstream/frame_1.gsvc",
        "cmodels/synth/GaussianVideo_20_40/bitstream/frame_2.gsvc",
        "cmodels/synth/GaussianVideo_20_40/bitstream/frame_3.gsvc",
        "cmodels/synth/GaussianVideo_20_40/gmodels_state_dict.npz",
        "models/synth/GaussianVideo_30_40/gmodels_state_dict.npz",
        "result/synth/GaussianVideo_20_40/train.txt",
        f"result/synth/GaussianVideo_20_40/{video}",
        "result/synth/GaussianVideo_30_40/num_gaussian_points.txt",
        "result/synth/GaussianVideo_30_40/train.txt",
        f"result/synth/GaussianVideo_30_40/{video}",
        "result/synth/K_frames.txt",
        "result/synth/loss_list.txt",
    ])
    k_frames = [int(x) for x in (ckpt / "result/synth/K_frames.txt").read_text().split()]
    assert k_frames[0] == 1
    with np.load(npz) as z:
        assert sorted(z.files) == sorted(f"frame_{f}/{k}" for f in (1, 2, 3)
                                         for k in ("_xyz", "_cholesky", "_features_dc"))
    # gsvc_tpu's compress stage loads the port's checkpoint as its own
    jg, g = jcdrv.load_gmodels(str(npz)), cdrv.load_gmodels(str(npz))
    assert sorted(jg) == sorted(g) == ["frame_1", "frame_2", "frame_3"]
    for f in g:
        for k in g[f]:
            np.testing.assert_array_equal(g[f][k], jg[f][k])
    rtext = (ckpt / "result/synth/GaussianVideo_30_40/train.txt").read_text().splitlines()
    assert all(re.fullmatch(REP_LINE, ln) for ln in rtext[:3]) and len(rtext) == 4
    assert re.fullmatch(REP_AVG, rtext[3])
    ctext = (ckpt / "result/synth/GaussianVideo_20_40/train.txt").read_text()
    clines = ctext.splitlines()
    assert all(re.fullmatch(CMP_LINE, ln) for ln in clines[:3]) and len(clines) == 4
    assert re.fullmatch(CMP_AVG, clines[3])
    assert re.fullmatch(r"(frame_\d+: \d+\n){3}", (
        ckpt / "result/synth/GaussianVideo_30_40/num_gaussian_points.txt").read_text())

    bs = ckpt / "cmodels/synth/GaussianVideo_20_40/bitstream"
    for f in (1, 2, 3):
        want = "K" if f in k_frames else "P"
        assert bitstream.frame_type((bs / f"frame_{f}.gsvc").read_bytes()) == want
    dec_out = tmp_path / "decoded"
    assert decode.main([
        "--bitstream", str(bs), "--height", "32", "--width", "48", "--model_path",
        str(npz), "--k_frames", str(ckpt / "result/synth/K_frames.txt"), "-d", str(yuv),
        "--out", str(dec_out), "--device", "cpu", "--backend", "cuda"]) == 0
    assert (dec_out / "decoded.rgb").stat().st_size == 3 * 32 * 48 * 3
    report = (dec_out / "decode.txt").read_text()
    enc, dec = _psnrs(ctext), _psnrs(report)
    assert set(enc) == set(dec) == {1, 2, 3}
    for f in enc:
        assert abs(dec[f] - enc[f]) < 0.1, (f, dec[f], enc[f])
    # the multi-chip modes are refused, never run on one device
    for main in (drv.main, cdrv.main):
        for extra in (["--tile_shards", "2"], ["--hosts", "2"]):
            with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
                main(common + ["--model_path", str(npz)] + extra)


def drv_has_cv2():
    from gsvc_tpu_torch.io import video

    return video._HAS_CV2


def test_compress_cli_reads_jax_checkpoint_and_jax_decodes_its_streams(tmp_path):
    """Cross-load: the port's compress driver on a representation npz that
    gsvc_tpu wrote, and gsvc_tpu's decoder on the port's streams."""
    frames = _frames(1, 3)
    yuv = _write_yuv(tmp_path / "clip.yuv", frames)
    jcfg = JConfig(H=H, W=W, num_points=40, max_num_points=40, iterations=1)
    state = {}
    for f in (1, 2, 3):  # frames 2 and 3 move frame 1's splats a little
        js = _jax_state(jcfg, 1)
        g = jdrv.gmodel_from_state(js.params, js.alive)
        g = {k: (v + np.float32(0.01 * (f - 1))).astype(np.float32) for k, v in g.items()}
        state.update({f"frame_{f}/{k}": v for k, v in g.items()})
    npz = tmp_path / "jax_gmodels.npz"
    np.savez(npz, **state)
    kdir = tmp_path / "k" / "result" / "clip"
    kdir.mkdir(parents=True)
    (kdir / "K_frames.txt").write_text("1\n3\n")
    assert cdrv.main(["-d", str(yuv), "--data_name", "clip", "--width", "48", "--height",
                      "32", "--image_length", "3", "--num_points", "40", "--iterations",
                      "6", "--model_path", str(npz), "--k_frames_dir", str(tmp_path / "k"),
                      "--checkpoint_dir", str(tmp_path / "q"), "--backend", "torch",
                      "--device", "cpu"]) == 0
    bs = tmp_path / "q" / "models" / "clip" / "GaussianVideo_6_40" / "bitstream"
    cfg = FrameConfig(H=H, W=W, num_points=40, max_num_points=40, iterations=1,
                      backend="torch")
    for f, is_k in ((1, True), (2, False), (3, True)):
        blob = (bs / f"frame_{f}.gsvc").read_bytes()
        assert jbs.frame_type(blob) == ("K" if is_k else "P")
        side = () if is_k else tuple(state[f"frame_{f - 1}/{k}"]
                                     for k in ("_xyz", "_cholesky", "_features_dc"))
        jdec = jbs.decode_frame(blob, *side)
        dec = bitstream.decode_frame(blob, *side)
        jimg = np.asarray(jbs.render_decoded(*jdec, dataclasses.replace(
            jcfg, backend="binned")))
        img = bitstream.render_decoded(*dec, cfg).numpy()
        assert img.std() > 0.01
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5)

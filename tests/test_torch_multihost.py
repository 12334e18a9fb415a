"""PyTorch port parity: multi-host GOP parallelism (`parallel/multihost.py`
and `--hosts N` in both CLIs) against gsvc_tpu and against the port's own
single-host run.

- the barrier's file markers: a port host and a gsvc_tpu host meet on one
  directory (threads), with and without a run nonce, directional waits,
  stale markers and the timeout;
- the artifact merges of both packages on the same shard files;
- the represent CLI as two host processes (one intra-op thread each,
  `scripts.measure_multihost_scaling.run_hosts`), once with
  GSVC_COORDINATOR (torch.distributed barriers) and once with --hosts 2
  --host_id h (file markers), and the compress CLI as two hosts run one
  after the other, against --hosts 1 at 64x48, 4 frames, K-frames pinned
  to 1 and 3 (`artifact_differences`);
- a fit under two budgets that both hold it, and the represent driver's
  per-GOP budget;
- the refusal of --hosts > 1 with --tile_shards > 1.

Tolerance: none; every comparison is exact (the merged text files byte for
byte, npz arrays bitwise, train.txt Frame_ lines up to their timing fields).
"""

import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from gsvc_tpu.parallel import multihost as jmh
from gsvc_tpu_torch import decode
from gsvc_tpu_torch.drivers import compress as cdrv
from gsvc_tpu_torch.drivers import represent as drv
from gsvc_tpu_torch.models import represent as rep
from gsvc_tpu_torch.parallel import multihost as mh
from gsvc_tpu_torch.scripts import measure_multihost_scaling as mhs
from gsvc_tpu_torch.scripts.encoder_drift import train_lines
from torch_threads import one_thread  # noqa: F401

H, W, FRAMES, POINTS, ITERS, QAT_ITERS = 48, 64, 4, 48, 24, 12
RUN, QRUN = f"GaussianVideo_{ITERS}_{POINTS}", f"GaussianVideo_{QAT_ITERS}_{POINTS}"



# -- the barrier ----------------------------------------------------------


def _hosts_meet(tmp_path, hosts, **kw):
    """Run barrier("t") of each (package, host_id, wait_for) in `hosts` in
    its own thread; returns the exceptions they raised."""
    errors = []

    def run(package, host_id, wait_for):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                package.barrier("t", tmp_path, 2, host_id, wait_for=wait_for, **kw)
        except Exception as e:  # reported by the test
            errors.append(e)

    threads = [threading.Thread(target=run, args=h) for h in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return errors


@pytest.mark.parametrize("nonce", ["run7", ""])
@pytest.mark.parametrize("port_host", [0, 1])
def test_a_port_host_and_a_jax_host_meet_on_one_directory(tmp_path, monkeypatch, nonce,
                                                          port_host):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    if nonce:
        monkeypatch.setenv("GSVC_RUN_NONCE", nonce)
    else:
        monkeypatch.delenv("GSVC_RUN_NONCE", raising=False)
    hosts = [(mh if h == port_host else jmh, h, None) for h in (0, 1)]
    assert _hosts_meet(tmp_path, hosts, timeout_s=20) == []
    stem = f".barrier_t.{nonce}" if nonce else ".barrier_t"
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{stem}.host0", f"{stem}.host1"]


@pytest.mark.parametrize("worker", ["port", "jax"])
def test_directional_barrier_lets_hosts_run_one_after_another(tmp_path, monkeypatch, worker):
    """A worker signals and returns at once (wait_for=[]); host 0, run after
    it, finds its marker."""
    monkeypatch.setenv("GSVC_RUN_NONCE", "seq")
    first, last = (mh, jmh) if worker == "port" else (jmh, mh)
    first.barrier("compressed", tmp_path, 2, 1, timeout_s=1, wait_for=[])
    last.barrier("compressed", tmp_path, 2, 0, timeout_s=1, wait_for=range(2))


def test_barrier_times_out_naming_the_missing_marker(tmp_path, monkeypatch):
    monkeypatch.setenv("GSVC_RUN_NONCE", "lonely")
    for package in (mh, jmh):
        with pytest.raises(TimeoutError, match=r"barrier t: missing .*\.barrier_t\.lonely\.host1"):
            package.barrier("t", tmp_path, 2, 0, timeout_s=1)


def test_without_a_nonce_the_barrier_warns_as_gsvc_tpu(tmp_path, monkeypatch):
    monkeypatch.delenv("GSVC_RUN_NONCE", raising=False)
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    with pytest.warns(UserWarning, match="without GSVC_RUN_NONCE/SLURM_JOB_ID"):
        mh.barrier("t", tmp_path, 2, 1, timeout_s=1, wait_for=[])
    monkeypatch.setenv("SLURM_JOB_ID", "99")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mh.barrier("t", tmp_path, 2, 1, timeout_s=1, wait_for=[])
    assert (tmp_path / ".barrier_t.99.host1").exists()


def test_clear_stale_markers_removes_only_its_own_as_gsvc_tpu(tmp_path):
    names = [".barrier_kdetect.host0", ".barrier_kdetect.host1", ".barrier_trained.7.host0",
             ".barrier_trained.7.host1", ".barrier_x.host10", "train.host0.txt"]
    left = {}
    for package in (mh, jmh):
        d = tmp_path / package.__name__
        d.mkdir()
        for n in names:
            (d / n).write_text("ok")
        package.clear_stale_markers(d, 0)
        left[package] = sorted(p.name for p in d.iterdir())
    assert left[mh] == left[jmh] == [".barrier_kdetect.host1", ".barrier_trained.7.host1",
                                     ".barrier_x.host10", "train.host0.txt"]
    mh.clear_stale_markers(tmp_path / "absent", 0)  # no directory: nothing to do


def test_initialize_without_a_coordinator_or_with_one_process_does_nothing(monkeypatch):
    monkeypatch.delenv("GSVC_COORDINATOR", raising=False)
    monkeypatch.setenv("GSVC_NUM_PROCS", "2")
    assert mh.initialize() is False
    assert mh.initialize("127.0.0.1:1", num_processes=1) is False
    assert not torch.distributed.is_initialized()


# -- the merges -----------------------------------------------------------


def _shards(root: Path, kind: str, frames_by_host, rng):
    model_dir, out_dir = root / "models", root / "result"
    model_dir.mkdir(parents=True)
    out_dir.mkdir(parents=True)
    for h, frames in enumerate(frames_by_host):
        if frames is None:  # a host that wrote nothing
            continue
        arrays, lines, counts = {}, [], []
        for f in frames:
            n = int(rng.integers(3, 9))
            for k in ("_xyz", "_cholesky", "_features_dc"):
                arrays[f"frame_{f}/{k}"] = rng.standard_normal((n, 3)).astype(np.float32)
            m = rng.random(6) * [40, 1, 2, 10, 1e-3, 900]
            if kind == "represent":
                lines.append(f"Frame_{f}: {H}x{W}, PSNR:{m[0]:.4f}, MS-SSIM:{m[1]:.4f}, "
                             f"Training:{m[3]:.4f}s, Eval:{m[4]:.8f}s, FPS:{m[5]:.4f}, "
                             f"Loss:{m[1] / 7:.4f}")
                counts.append(f"frame_{f}: {n}")
            else:
                lines.append(f"Frame_{f}: {H}x{W}, PSNR:{m[0]:.4f}, MS-SSIM:{m[1]:.4f}, "
                             f"bpp:{m[2]:.4f}, Training:{m[3]:.4f}s, Eval:{m[4]:.8f}s, "
                             f"FPS:{m[5]:.4f}")
        np.savez(model_dir / f"gmodels_state_dict.host{h}.npz", **arrays)
        if lines:
            (out_dir / f"train.host{h}.txt").write_text("\n".join(lines[::-1]) + "\n")
        if kind == "represent":
            (out_dir / f"num_gaussian_points.host{h}.txt").write_text(
                "".join(c + "\n" for c in counts[::-1]))
    return model_dir, out_dir


@pytest.mark.parametrize("kind,frames_by_host", [
    ("represent", [[1, 2, 7], [3, 4, 5, 6]]),
    ("represent", [[1, 2], [10, 11, 3], []]),
    ("compress", [[1, 2, 3], [4, 5, 6]]),
    ("compress", [[1, 2], [3, 4], None]),
])
def test_merges_write_gsvc_tpus_bytes(tmp_path, kind, frames_by_host):
    merged = {}
    for name, package in (("port", mh), ("jax", jmh)):
        model_dir, out_dir = _shards(tmp_path / name, kind, frames_by_host,
                                     np.random.default_rng(5))
        merge = (package.merge_host_artifacts if kind == "represent"
                 else package.merge_compress_artifacts)
        merge(model_dir, out_dir, len(frames_by_host), H, W)
        files = ["train.txt"] + (["num_gaussian_points.txt"] if kind == "represent" else [])
        merged[name] = ({f: (out_dir / f).read_bytes() for f in files},
                        np.load(model_dir / "gmodels_state_dict.npz"))
    (port_txt, port_npz), (jax_txt, jax_npz) = merged["port"], merged["jax"]
    assert port_txt == jax_txt
    assert b"Average: 48x64" in port_txt["train.txt"]
    assert port_npz.files == jax_npz.files  # in (frame, key) order
    for k in jax_npz.files:
        np.testing.assert_array_equal(port_npz[k], jax_npz[k], err_msg=k)


# -- the CLIs: --hosts 2 against --hosts 1 ----------------------------------


def _write_yuv(path):
    """gsvc_tpu's tests/test_multihost.py clip: a gradient and three moving
    blobs a frame, as I420."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    with open(path, "wb") as fo:
        for f in range(FRAMES):
            img = np.stack([xx / W * 0.8, yy / H * 0.8, 0 * xx + 0.4], -1)
            for _ in range(3):
                cx, cy = rng.uniform(5, W - 5) + 3 * f, rng.uniform(5, H - 5)
                s, col = rng.uniform(3, 8), rng.uniform(0.3, 1.0, 3)
                img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))[..., None] * col
            r, g, b = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(2, 0, 1).astype(
                np.float32)
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = -0.169 * r - 0.331 * g + 0.5 * b + 128
            v = 0.5 * r - 0.419 * g - 0.081 * b + 128
            for plane in (y, u[::2, ::2], v[::2, ::2]):
                fo.write(np.clip(plane, 0, 255).astype(np.uint8).tobytes())
    return path


def _pin_k_frames(ckpt: Path):
    kdir = ckpt / "result" / "mh"
    kdir.mkdir(parents=True)
    (kdir / "K_frames.txt").write_text("1\n3\n")  # two GOPs: [1, 2], [3, 4]


def _rep_argv(yuv, ckpt):
    return ["-d", str(yuv), "--data_name", "mh", "--width", str(W), "--height", str(H),
            "--image_length", str(FRAMES), "--num_points", str(POINTS), "--iterations",
            str(ITERS), "--kdetect_points", "24", "--kdetect_iterations", "5",
            "--backend", "torch", "--checkpoint_dir", str(ckpt), "--device", "cpu"]


def _cmp_argv(yuv, ckpt, dst):
    return ["-d", str(yuv), "--data_name", "mh", "--width", str(W), "--height", str(H),
            "--image_length", str(FRAMES), "--num_points", str(POINTS), "--iterations",
            str(QAT_ITERS), "--backend", "torch", "--model_path",
            str(ckpt / "models" / "mh" / RUN / "gmodels_state_dict.npz"),
            "--k_frames_dir", str(ckpt), "--checkpoint_dir", str(dst), "--device", "cpu"]


@pytest.fixture(scope="module")
def single_host(tmp_path_factory):
    """The clip, and its represent and compress runs at --hosts 1."""
    root = tmp_path_factory.mktemp("single")
    yuv = _write_yuv(root / "mh.yuv")
    _pin_k_frames(root / "ck")
    assert drv.main(_rep_argv(yuv, root / "ck")) == 0
    assert cdrv.main(_cmp_argv(yuv, root / "ck", root / "cq")) == 0
    return yuv, root


@pytest.mark.parametrize("barriers", ["torch.distributed", "file markers"])
def test_two_represent_hosts_match_one_bitwise(single_host, tmp_path, barriers):
    yuv, single = single_host
    ck = tmp_path / "ck"
    _pin_k_frames(ck)
    _secs, _launches, outs = mhs.run_hosts(
        "represent", _rep_argv(yuv, ck), 2, tmp_path / "logs", timeout=240,
        one_thread=True, markers=barriers == "file markers")
    assert "host 0/2: GOPs [1]" in outs[0] and "host 1/2: GOPs [3]" in outs[1]
    assert "multi-host artifacts merged" in outs[0]

    assert mhs.artifact_differences(single / "ck", ck) == []
    out_dir = ck / "result" / "mh" / RUN
    lines = train_lines(out_dir / "train.txt")
    assert sorted(lines) == list(range(1, FRAMES + 1))
    assert all("Loss" in ln for ln in lines.values())
    with np.load(ck / "models" / "mh" / RUN / "gmodels_state_dict.npz") as z:
        assert len(z.files) == 3 * FRAMES
    markers = sorted(p.name for p in out_dir.glob(".barrier_*"))
    if barriers == "torch.distributed":
        assert markers == []
    else:
        nonce = markers[0].split(".")[2]
        assert markers == [f".barrier_{t}.{nonce}.host{h}" for t in ("kdetect", "trained")
                           for h in (0, 1)]
    assert not (out_dir / "video").exists()  # no video on several hosts


def test_two_compress_hosts_match_one_bitwise(single_host, tmp_path, monkeypatch):
    yuv, single = single_host
    monkeypatch.setenv("GSVC_RUN_NONCE", "cmp")
    argv = _cmp_argv(yuv, single / "ck", tmp_path / "cq")
    assert cdrv.main(argv + ["--hosts", "2", "--host_id", "1"]) == 0  # signals, exits
    qmodels = tmp_path / "cq" / "models" / "mh" / QRUN
    assert sorted(p.name for p in (qmodels / "bitstream").iterdir()) == [
        "frame_3.gsvc", "frame_4.gsvc"]
    assert cdrv.main(argv + ["--hosts", "2", "--host_id", "0"]) == 0  # waits, merges
    # every frame_N.gsvc byte for byte, the npz bitwise, the Frame_ lines
    assert mhs.artifact_differences(single / "cq", tmp_path / "cq") == []
    assert len(list((qmodels / "bitstream").iterdir())) == FRAMES

    dec = tmp_path / "decoded"
    assert decode.main([
        "--bitstream", str(qmodels / "bitstream"), "--height", str(H), "--width", str(W),
        "--model_path", str(single / "ck" / "models" / "mh" / RUN / "gmodels_state_dict.npz"),
        "--k_frames", str(single / "ck" / "result" / "mh" / "K_frames.txt"), "-d", str(yuv),
        "--out", str(dec), "--device", "cpu", "--backend", "torch", "--no_png"]) == 0
    enc = train_lines(tmp_path / "cq" / "result" / "mh" / QRUN / "train.txt")
    got = train_lines(dec / "decode.txt")
    assert sorted(got) == sorted(enc) == list(range(1, FRAMES + 1))
    for f in enc:
        assert abs(got[f]["PSNR"] - enc[f]["PSNR"]) < 0.1, (f, got[f], enc[f])


# -- the intersection budget ----------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_a_fit_within_two_budgets_is_the_same_fit(backend):
    """The budget sets the length of the binned arrays (the sort, the
    padding keys, K3's scan); a fit that both budgets hold fits the same
    bits with either. This covers only the plain path, which runs here:
    there K3 is a float64 cumsum whose sums do not depend on the padded
    length. K3's kernel does depend on it; `chip_smoke.py` phase 11 holds
    a fit at two budgets on the card, and the represent CLI's split
    against one host where every K-frame overflows."""
    gt = np.asarray(np.random.default_rng(3).integers(0, 256, (H, W, 3)), np.uint8)
    args = drv.parse_args(["-d", "x", "--lr", "0.03", "--device", "cpu"])
    results = []
    for budget in (None, 4 * 8192):
        tr = drv.SimpleTrainer2d(gt, 1, num_points=POINTS, max_num_points=POINTS,
                                 iterations=30, args=args, isremoval=True, backend=backend,
                                 max_intersects=budget)
        tr.state = rep.fit_frame_partial(tr.state, tr.gt, 30, tr.cfg, draws=tr.draws)
        st = tr.state
        results.append((rep.intersection_budget(tr.cfg), int(st.max_overflow), tr.test()[0],
                        int(st.alive.sum()), float(st.loss),
                        drv.gmodel_from_state(st.params, st.alive)))
    (budget_a, over_a, *a, gmodel_a), (budget_b, over_b, *b, gmodel_b) = results
    assert budget_a < budget_b and over_a == over_b == 0
    assert a == b  # PSNR, splats, loss
    assert gmodel_a.keys() == gmodel_b.keys()
    for k in gmodel_a:
        np.testing.assert_array_equal(gmodel_a[k], gmodel_b[k], err_msg=k)


def test_each_gop_starts_from_the_default_budget(single_host, tmp_path, monkeypatch):
    """A budget raised by a refit is kept for the later frames of its GOP
    and dropped at the next K-frame, so that a GOP fits the same bits on
    whichever host runs it (K3's sums depend on the scan's length on the
    card)."""
    yuv, _single = single_host
    seen = {}

    def fake_refit(make_trainer, max_intersects=None, ispos=False):
        trainer = make_trainer(max_intersects)
        seen[trainer.frame_num] = max_intersects
        raised = 8192 if trainer.frame_num in (1, 3) else max_intersects
        return trainer, trainer.train(ispos), raised

    monkeypatch.setattr(drv, "train_within_budget", fake_refit)
    _pin_k_frames(tmp_path / "ck")
    assert drv.main(_rep_argv(yuv, tmp_path / "ck") + ["--iterations", "2"]) == 0
    assert seen == {1: None, 2: 8192, 3: None, 4: 8192}


# -- refusals -------------------------------------------------------------


@pytest.mark.parametrize("how", ["flag", "env"])
@pytest.mark.parametrize("main", [drv.main, cdrv.main], ids=["represent", "compress"])
def test_hosts_with_tile_shards_raise(tmp_path, monkeypatch, main, how):
    monkeypatch.delenv("GSVC_COORDINATOR", raising=False)
    argv = ["-d", "x.yuv", "--model_path", "x.npz", "--tile_shards", "2", "--device", "cpu",
            "--checkpoint_dir", str(tmp_path)]
    if how == "flag":
        argv += ["--hosts", "2"]
    else:
        monkeypatch.setenv("GSVC_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="--hosts 2 with --tile_shards 2"):
        main(argv)
    assert not torch.distributed.is_initialized()
    assert not any(tmp_path.iterdir())


def test_single_host_run_leaves_no_shards(single_host):
    _yuv, single = single_host
    names = sorted(str(p.relative_to(single)) for p in single.rglob("*") if p.is_file())
    assert not [n for n in names if ".host" in n or ".barrier" in n]
    assert "ck/result/mh/" + RUN + "/train.txt" in names

"""The port's RD point (gsvc_tpu_torch/scripts/run_rd_point.py) against
the JAX package's script (scripts/run_rd_point.py), on the CPU.

Tolerances: the synthetic clip's bytes exact; each frame's decoded PSNR
within 0.1 dB of the compress stage's (the JAX package's guard,
tests/test_driver_e2e.py); a --skip-represent rerun's compress stage
bitwise the first run's (same checkpoint, same seeds, the CPU).
"""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest

from gsvc_tpu_torch.scripts import run_rd_point as rd

REPO = Path(__file__).resolve().parents[1]
H, W, FRAMES, N, ITERS, COMP_ITERS = 32, 48, 3, 40, 30, 20
FIELDS = {
    "num_points", "splats_kept", "k_frames", "bpp", "psnr", "ms_ssim", "frame_bpp",
    "frame_psnr", "frame_ms_ssim", "decoded_psnr", "decoded_ms_ssim",
    "frame_decoded_psnr", "frame_decoded_ms_ssim", "max_decode_gap_db", "represent_psnr",
    "represent_s_per_frame", "qat_s_per_frame", "represent_eval_fps", "qat_eval_fps",
    "decode_fps", "decode_stages", "peak_gib", "held_gib", "cli_seconds", "card",
}


def _jax_script():
    """scripts/run_rd_point.py as a module (it imports only numpy at the top)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_rd_point", REPO / "scripts" / "run_rd_point.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("width,height,frames", [(400, 300, 2), (448, 320, 3),
                                                 (400, 300, 8)])
def test_make_clip_writes_the_jax_scripts_bytes(tmp_path, width, height, frames):
    """The same clip byte for byte (8 frames: a pan margin over 64 px)."""
    ours = rd.make_clip(tmp_path / "port.yuv", W=width, H=height, F=frames)
    theirs = _jax_script().make_clip(tmp_path / "jax.yuv", W=width, H=height, F=frames)
    data = ours.read_bytes()
    assert len(data) == frames * width * height * 3 // 2
    assert data == theirs.read_bytes()


def _small_point(*args, **kwargs):
    """`run_point` at 48x32 on the CPU with a small K-frame detection: what
    the CLI's `main` runs at 1080p on the card."""
    return _run_point(*args, **kwargs, width=W, height=H, device="cpu", kdetect=(30, 10))


_run_point = rd.run_point


def _main(workdir: Path, *extra) -> tuple:
    """The CLI's `main` on the small point: (exit code, stdout lines)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(rd, "run_point", _small_point)
        rc = rd.main(["--frames", str(FRAMES), "--num-points", str(N), "--iterations",
                      str(ITERS), "--comp-iterations", str(COMP_ITERS), "--workdir",
                      str(workdir), *extra])
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def point(tmp_path_factory):
    """One RD point end to end through the CLI's `main`: (workdir, exit
    code, the JSON line parsed)."""
    wd = tmp_path_factory.mktemp("rd_point")
    rc, lines = _main(wd)
    return wd, rc, json.loads(lines[-1])


def _psnrs(path: Path) -> dict:
    return {int(f): float(p) for f, p in
            re.findall(r"Frame_(\d+): .*?PSNR:([\d.]+)", path.read_text())}


def test_rd_point_decodes_every_frame_within_0p1_db(point):
    """The JAX script's artifacts under the workdir; each frame decoded from
    its bytes within 0.1 dB of the compress stage's PSNR."""
    wd, rc, rec = point
    assert rc == 0
    ck = wd / "ck"
    assert (wd / "synth1080p.yuv").stat().st_size == FRAMES * H * W * 3 // 2
    assert (ck / "models/synth1080/GaussianVideo_30_40/gmodels_state_dict.npz").is_file()
    bitstream = ck / "models/synth1080/GaussianVideo_20_40/bitstream"
    assert sorted(p.name for p in bitstream.iterdir()) == [
        f"frame_{f}.gsvc" for f in range(1, FRAMES + 1)]
    enc = _psnrs(ck / "result/synth1080/GaussianVideo_20_40/train.txt")
    dec = _psnrs(wd / "decoded_40/decode.txt")
    assert sorted(enc) == sorted(dec) == list(range(1, FRAMES + 1))
    for f in enc:
        assert abs(dec[f] - enc[f]) < 0.1, (f, dec[f], enc[f])
    assert rec["frame_psnr"] == [enc[f] for f in sorted(enc)]
    assert rec["frame_decoded_psnr"] == [dec[f] for f in sorted(dec)]
    assert rec["max_decode_gap_db"] < rd.DECODE_TOL_DB


def test_rd_point_json_line_carries_the_point(point):
    wd, _rc, rec = point
    assert FIELDS <= set(rec)
    assert rec["num_points"] == N and rec["frames"] == FRAMES
    assert (rec["width"], rec["height"]) == (W, H)
    assert rec["k_frames"][0] == 1
    counts = (wd / "ck/result/synth1080/GaussianVideo_30_40/num_gaussian_points.txt")
    assert rec["splats_kept"] == [int(ln.split(":")[1])
                                  for ln in counts.read_text().splitlines()]
    assert len(rec["splats_kept"]) == len(rec["frame_bpp"]) == FRAMES
    for key in ("frame_bpp", "frame_psnr", "frame_ms_ssim", "frame_decoded_psnr",
                "frame_decoded_ms_ssim", "frame_represent_psnr"):
        assert len(rec[key]) == FRAMES and all(np.isfinite(rec[key])), key
    assert rec["bpp"] == pytest.approx(np.mean(rec["frame_bpp"]))
    assert rec["psnr"] == pytest.approx(np.mean(rec["frame_psnr"]))
    assert min(rec["frame_bpp"]) > 0 and rec["decode_fps"] > 0
    assert rec["represent_s_per_frame"] > 0 and rec["qat_s_per_frame"] > 0
    assert rec["represent_eval_fps"] > 0 and rec["qat_eval_fps"] > 0
    assert rec["decode_stages"]["frames"] == FRAMES
    assert set(rec["cli_seconds"]) == set(rec["peak_gib"]) == set(rec["held_gib"]) == {
        "represent", "compress", "decode"}
    # measured on a card only: none of them is a CPU number
    assert set(rec["peak_gib"].values()) == {None} and rec["card"] is None
    assert all(v == [None, None] for v in rec["held_gib"].values())
    assert rec["device"] == "cpu"


def test_skip_represent_reuses_the_checkpoint(point):
    """--skip-represent runs compress and decode on the checkpoint the
    first run wrote, which stays as it was; the coded frames are the first
    run's."""
    wd, _rc, first = point
    npz = wd / "ck/models/synth1080/GaussianVideo_30_40/gmodels_state_dict.npz"
    rep_log = wd / "ck/result/synth1080/GaussianVideo_30_40/train.txt"
    bitstream = wd / "ck/models/synth1080/GaussianVideo_20_40/bitstream"
    before = (npz.read_bytes(), rep_log.read_text(),
              [p.read_bytes() for p in sorted(bitstream.iterdir())])
    rc, lines = _main(wd, "--skip-represent")
    again = json.loads(lines[-1])
    assert rc == 0
    assert not any(ln.startswith("represent done") for ln in lines)
    assert set(again["cli_seconds"]) == {"compress", "decode"}
    assert (npz.read_bytes(), rep_log.read_text()) == before[:2]
    assert [p.read_bytes() for p in sorted(bitstream.iterdir())] == before[2]
    assert again["frame_represent_psnr"] == first["frame_represent_psnr"]
    assert again["frame_bpp"] == first["frame_bpp"]
    assert again["frame_decoded_psnr"] == first["frame_decoded_psnr"]

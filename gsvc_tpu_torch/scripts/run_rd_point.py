"""Record an end-to-end RD point on a synthetic 1080p sequence through the
port's three CLIs (the PyTorch port of scripts/run_rd_point.py).

Generates the synthetic-textured clip (multi-octave value-noise background,
four moving textured objects, a global pan of 8 px a frame; `make_clip`
writes the same bytes as the JAX script's), then runs the pipeline as a
user would:

  represent:  python -m gsvc_tpu_torch.drivers.represent --is_rm --is_ad
  compress:   python -m gsvc_tpu_torch.drivers.compress on its checkpoint
  decode:     python -m gsvc_tpu_torch.decode --no_png, from the bytes alone

each by its `main`, with the JAX script's arguments and paths under the
workdir. It prints the three logs as the JAX script does, then one JSON
line of the point: splats kept and K-frames, mean and per-frame bpp, PSNR
and MS-SSIM (compress train.txt), decoded PSNR and MS-SSIM (decode.txt),
represent PSNR, represent and QAT seconds a frame (train.txt), the
drivers' eval fps, the decoder's frames/s and `decode.STAGES`, each CLI's
peak device memory and the memory it found and left allocated, and the
card's nvidia-smi line.

    python -m gsvc_tpu_torch.scripts.run_rd_point --frames 10 \
        --num-points 10000 --iterations 20000 --comp-iterations 6000

Runs at 1920x1080 on the card. A CLI that fails raises; the exit code is 1
when a frame decodes 0.1 dB or more from its encoder PSNR (the JAX
package's guard, tests/test_driver_e2e.py). `run_point` is the same run at
any frame size, on any device and K-detection size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch import decode as decode_cli
from gsvc_tpu_torch.drivers import compress as compress_driver
from gsvc_tpu_torch.drivers import represent as represent_driver
from gsvc_tpu_torch.scripts.common import card_line
from gsvc_tpu_torch.scripts.encoder_drift import train_lines

DATA_NAME = "synth1080"
DECODE_TOL_DB = 0.1


def _value_noise(rng, H, W, octaves=5, base=8):
    """Multi-octave value noise in [0,1], [H, W]."""
    acc = np.zeros((H, W), np.float32)
    amp, tot = 1.0, 0.0
    for o in range(octaves):
        gh, gw = base * (2 ** o) + 1, base * (2 ** o) * 2 + 1
        grid = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        yy = np.linspace(0, gh - 1, H)
        xx = np.linspace(0, gw - 1, W)
        y0 = np.floor(yy).astype(int)
        x0 = np.floor(xx).astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        v = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        acc += amp * v
        tot += amp
        amp *= 0.55
    return acc / tot


def make_clip(path: Path, W=1920, H=1080, F=5, seed=7):
    """F I420 frames of H x W into `path`: the value-noise background
    panned 8 px a frame, four textured discs moving over it."""
    rng = np.random.default_rng(seed)
    # pan margin must cover the full pan travel (8 px/frame)
    margin = max(64, 8 * F + 8)
    bg = np.stack(
        [_value_noise(rng, H, W + margin) for _ in range(3)], axis=-1
    )
    bg = 0.25 + 0.6 * bg
    tex = [_value_noise(rng, 256, 256, octaves=4, base=4) for _ in range(4)]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # object centres 200 / 150 px inside the frame, as the JAX script places
    # them (it needs W >= 400 and H >= 300); a quarter of a smaller side
    mx, my = (200 if W >= 400 else W // 4), (150 if H >= 300 else H // 4)
    objs = []
    for k in range(4):
        objs.append(dict(
            cx=rng.uniform(mx, W - mx), cy=rng.uniform(my, H - my),
            r=rng.uniform(60, 160),
            vx=rng.uniform(-25, 25), vy=rng.uniform(-12, 12),
            col=rng.uniform(0.4, 1.0, 3), tex=tex[k],
        ))
    with open(path, "wb") as fo:
        for f in range(F):
            pan = 8 * f
            img = bg[:, pan:pan + W, :].copy()
            for o in objs:
                cx, cy = o["cx"] + o["vx"] * f, o["cy"] + o["vy"] * f
                d2 = (xx - cx) ** 2 + (yy - cy) ** 2
                m = np.clip(1.2 - np.sqrt(d2) / o["r"], 0, 1)[..., None]
                ty = np.clip(((yy - cy) / o["r"] * 96 + 128), 0, 255).astype(int)
                tx = np.clip(((xx - cx) / o["r"] * 96 + 128), 0, 255).astype(int)
                t = o["tex"][ty, tx][..., None]
                img = img * (1 - m) + m * (o["col"] * (0.5 + 0.5 * t))
            rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = -0.169 * r - 0.331 * g + 0.5 * b + 128
            v = 0.5 * r - 0.419 * g - 0.081 * b + 128
            fo.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(u[::2, ::2], 0, 255).astype(np.uint8).tobytes())
            fo.write(np.clip(v[::2, ::2], 0, 255).astype(np.uint8).tobytes())
    return path


def _run_cli(name: str, main, argv, device: torch.device) -> dict:
    """One CLI's `main(argv)`: raises unless it returns 0; its wall seconds
    and, on a card, its peak device memory and the memory allocated as it
    started and as it returned, in GiB (None elsewhere)."""
    cuda = device.type == "cuda"

    def allocated():
        return torch.cuda.memory_allocated(device) / 2**30 if cuda else None

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    start = allocated()
    t0 = time.perf_counter()
    rc = main(argv)
    if cuda:
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name} returned {rc}")
    print(f"{name} done in {secs:.0f}s", flush=True)
    return {"seconds": secs,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
            "held_gib": [start, allocated()]}


def _mean(frames: dict, key: str) -> float:
    return float(np.mean([v[key] for v in frames.values()]))


def run_point(workdir: Path, frames: int, num_points: int, iterations: int,
              comp_iterations: int, skip_represent: bool = False, width: int = 1920,
              height: int = 1080, device: str = "cuda",
              kdetect: Optional[Tuple[int, int]] = None) -> dict:
    """One RD point in `workdir`: the clip (made once), represent (unless
    skip_represent, which reuses the checkpoint), compress and decode;
    returns the point's record (the JSON line). `kdetect` is (points,
    iterations) of the K-frame detection, None for the drivers' defaults."""
    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device)
    clip = wd / "synth1080p.yuv"
    if not clip.exists():
        print("generating clip...", flush=True)
        make_clip(clip, W=width, H=height, F=frames)

    ck = wd / "ck"
    common = [
        "-d", str(clip), "--data_name", DATA_NAME,
        "--width", str(width), "--height", str(height),
        "--image_length", str(frames),
        "--num_points", str(num_points),
        "--checkpoint_dir", str(ck),
        "--loss_type", "L2", "--device", device,
    ]
    clis = {}
    if not skip_represent:
        extra = [] if kdetect is None else [
            "--kdetect_points", str(kdetect[0]), "--kdetect_iterations", str(kdetect[1])]
        clis["represent"] = _run_cli("represent", represent_driver.main, common + [
            "--iterations", str(iterations), "--is_rm", "--is_ad",
            "--fit_chunk", "2500"] + extra, dev)

    run = f"GaussianVideo_{iterations}_{num_points}"
    model_path = ck / "models" / DATA_NAME / run / "gmodels_state_dict.npz"
    clis["compress"] = _run_cli("compress", compress_driver.main, common + [
        "--iterations", str(comp_iterations),
        "--model_path", str(model_path),
        "--k_frames_dir", str(ck),
        "--fit_chunk", "2000",
    ], dev)

    result = ck / "result" / DATA_NAME
    rep_log = result / run / "train.txt"
    crun = f"GaussianVideo_{comp_iterations}_{num_points}"
    comp_log = result / crun / "train.txt"
    print("=== representation train.txt ===")
    print(rep_log.read_text())
    print("=== compression train.txt ===")
    print(comp_log.read_text())

    # decode purely from the written bitstream and score against the clip:
    # the RD curve on decoded bytes, not on the encoder's own render
    dec_dir = wd / f"decoded_{num_points}"
    k_file = result / "K_frames.txt"
    clis["decode"] = _run_cli("decode", decode_cli.main, [
        "--bitstream", str(ck / "models" / DATA_NAME / crun / "bitstream"),
        "--height", str(height), "--width", str(width),
        "--model_path", str(model_path),
        "--k_frames", str(k_file),
        "-d", str(clip), "--out", str(dec_dir), "--no_png", "--device", device,
    ], dev)
    stages = dict(decode_cli.STAGES)
    print("=== decode.txt (from-bitstream reconstruction) ===")
    print((dec_dir / "decode.txt").read_text())

    rep, enc = train_lines(rep_log), train_lines(comp_log)
    dec = train_lines(dec_dir / "decode.txt")
    if not sorted(rep) == sorted(enc) == sorted(dec) == list(range(1, frames + 1)):
        raise RuntimeError(f"frames logged: represent {sorted(rep)}, compress "
                           f"{sorted(enc)}, decode {sorted(dec)}")
    kept = [int(ln.split(":")[1]) for ln in
            (result / run / "num_gaussian_points.txt").read_text().splitlines()]

    def per_frame(log: dict, key: str) -> list:
        return [log[f][key] for f in sorted(log)]

    return {
        "num_points": num_points, "frames": frames, "width": width, "height": height,
        "iterations": iterations, "comp_iterations": comp_iterations,
        "splats_kept": kept,
        "k_frames": [int(x) for x in k_file.read_text().split()],
        "bpp": _mean(enc, "bpp"), "psnr": _mean(enc, "PSNR"),
        "ms_ssim": _mean(enc, "MS-SSIM"),
        "frame_bpp": per_frame(enc, "bpp"), "frame_psnr": per_frame(enc, "PSNR"),
        "frame_ms_ssim": per_frame(enc, "MS-SSIM"),
        "decoded_psnr": _mean(dec, "PSNR"), "decoded_ms_ssim": _mean(dec, "MS-SSIM"),
        "frame_decoded_psnr": per_frame(dec, "PSNR"),
        "frame_decoded_ms_ssim": per_frame(dec, "MS-SSIM"),
        "max_decode_gap_db": max(abs(dec[f]["PSNR"] - enc[f]["PSNR"]) for f in enc),
        "represent_psnr": _mean(rep, "PSNR"),
        "frame_represent_psnr": per_frame(rep, "PSNR"),
        "represent_s_per_frame": _mean(rep, "Training"),
        "qat_s_per_frame": _mean(enc, "Training"),
        "represent_eval_fps": _mean(rep, "FPS"), "qat_eval_fps": _mean(enc, "FPS"),
        "decode_fps": frames / clis["decode"]["seconds"], "decode_stages": stages,
        "cli_seconds": {k: v["seconds"] for k, v in clis.items()},
        "peak_gib": {k: v["peak_gib"] for k, v in clis.items()},
        "held_gib": {k: v["held_gib"] for k, v in clis.items()},
        "device": str(dev), "card": card_line() if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--num-points", type=int, default=10000)
    ap.add_argument("--iterations", type=int, default=10000)
    ap.add_argument("--comp-iterations", type=int, default=6000)
    ap.add_argument("--workdir", type=str, default="rd_run")
    ap.add_argument("--skip-represent", action="store_true")
    args = ap.parse_args(argv)

    point = run_point(Path(args.workdir), args.frames, args.num_points, args.iterations,
                      args.comp_iterations, skip_represent=args.skip_represent)
    print(json.dumps(point))
    if point["max_decode_gap_db"] >= DECODE_TOL_DB:
        print(f"run_rd_point: a frame decodes {point['max_decode_gap_db']:.4f} dB from "
              f"its encoder PSNR (tolerance {DECODE_TOL_DB} dB)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How far the coded frames of `chip_smoke.py`'s phase 6 move when only the
order of K3's sums changes: the 4-frame 1080p/10k clip through the
represent, compress and decode CLIs, with K3 as its kernel or as its plain
version (float64 sums), from one seed of the CLIs.

    python -m gsvc_tpu_torch.scripts.encoder_drift [--seed 1] [--k3 kernel] [--eager]

Prints each frame's represent and QAT PSNR, its bpp and the sha256 of its
coded `frame_N.gsvc` (two encodes that agree to the bit agree there), and
the kernels' launches summed over the three CLIs, then one JSON line of
them. `--eager` runs every fit step and render eagerly
(`utils.graphs.eager`): the eager encoder whose launches and hashes phase 6
holds its graphs to (`ENCODER_LAUNCHES`, `ENCODER_SHA256`). Run as a file with another tree's package first on
PYTHONPATH, it encodes with that tree's kernels (its imports are the
encoder's CLIs, `fill_cuda`'s two K3 functions, `scripts.common`'s scene
and `utils.graphs`' `eager` and `launch_counts`). Card only: exits 1 without one.

Also the clip and the CLI arguments that `chip_smoke.py` phase 6 runs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

# the represent fits run to the splat-control threshold (4000 with --is_rm),
# where K- and P-frames reach the same splat count, which the compress
# stage's delta model needs
ENC_ITERS, KDETECT_ITERS, QAT_ITERS = 4000, 100, 300
H, W, N = 1080, 1920, 10000


def rgb_to_i420(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> one I420 frame: the inverse of the BT.601
    video-range matrix with three-decimal coefficients (the reader,
    `io.yuv.yuv420_to_rgb`, uses OpenCV's 20-bit fixed-point ones, which
    differ in the third decimal), chroma averaged over 2x2."""
    m = np.array([[1.164, 0.0, 1.596], [1.164, -0.392, -0.813], [1.164, 2.017, 0.0]])
    ycc = rgb.astype(np.float64) @ np.linalg.inv(m).T + np.array([16.0, 128.0, 128.0])
    h, w = rgb.shape[:2]
    chroma = ycc[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    planes = (ycc[..., 0], chroma[..., 0], chroma[..., 1])
    return b"".join(np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes()
                    for p in planes)


def write_yuv(clip, path: Path) -> None:
    path.write_bytes(b"".join(
        rgb_to_i420((img.cpu().numpy() * 255.0).round().astype(np.uint8)) for img in clip))


def train_lines(path) -> dict:
    """{frame: {field: value}} of a driver's train.txt Frame_N lines."""
    out = {}
    for ln in Path(path).read_text().splitlines():
        m = re.match(r"Frame_(\d+): \d+x\d+, (.*)$", ln)
        if m:
            out[int(m.group(1))] = {
                k: float(v) for k, v in re.findall(r"([\w-]+):(-?[\d.]+)s?", m.group(2))}
    return out


def render_scene(means, L, colors, opacity, H: int, W: int, tb) -> torch.Tensor:
    """[H, W, 3] render of a scene through K1, K2 and K4, clipped to [0, 1]."""
    from gsvc_tpu_torch.ops import rasterize_cuda
    from gsvc_tpu_torch.ops.binning import bin_gaussians
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d

    with torch.no_grad():
        xys, _d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
        budget = (int(nth.sum()) * 21 // 20 // 8192 + 1) * 8192
        binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, kernels=True)
        img = rasterize_cuda.forward_image(binned, xys, conics, colors, opacity,
                                           H, W, tb, 16, 16, 256)
        return torch.clamp(img, 0.0, 1.0)


def encoder_clip(sc) -> list:
    """Four frames: the bench scene `sc`'s render through K4, the same moved
    by (3, 2) pixels, then a cut to the bench scene of seed 1 and its move."""
    from gsvc_tpu_torch.ops import rasterize_cuda
    from gsvc_tpu_torch.scripts.common import bench_scene

    H, W, tb = sc.H, sc.W, sc.tb
    shift = torch.tensor([3 * 2.0 / W, 2 * 2.0 / H], device=sc.means.device)
    means_b, L_b, colors_b, opacity_b = bench_scene(sc.n, sc.means.device, seed=1)
    with torch.no_grad():
        first = torch.clamp(rasterize_cuda.forward_image(*sc.rargs), 0.0, 1.0)
    return [first,
            render_scene(sc.means + shift, sc.L, sc.colors, sc.opacity, H, W, tb),
            render_scene(means_b, L_b, colors_b, opacity_b, H, W, tb),
            render_scene(means_b + shift, L_b, colors_b, opacity_b, H, W, tb)]


class Run:
    """The represent and compress CLIs' arguments for `n_frames` frames of
    H x W in `yuv` with `n` splats, and where they write, under `tmp`."""

    def __init__(self, yuv: Path, tmp: Path, H: int, W: int, n: int, n_frames: int,
                 seed: int = 1, device: str = "cuda"):
        self.ck, self.cq = tmp / "ck", tmp / "cq"
        common = ["-d", str(yuv), "--data_name", "smoke", "--width", str(W), "--height",
                  str(H), "--image_length", str(n_frames), "--num_points", str(n),
                  "--seed", str(seed), "--device", device]
        rep_dir = f"GaussianVideo_{ENC_ITERS}_{n}"
        qat_dir = f"GaussianVideo_{QAT_ITERS}_{n}"
        self.npz = self.ck / "models" / "smoke" / rep_dir / "gmodels_state_dict.npz"
        self.k_frames = self.ck / "result" / "smoke" / "K_frames.txt"
        self.bitstream = self.cq / "models" / "smoke" / qat_dir / "bitstream"
        self.rep_log = self.ck / "result" / "smoke" / rep_dir / "train.txt"
        self.qat_log = self.cq / "result" / "smoke" / qat_dir / "train.txt"
        self.counts = self.ck / "result" / "smoke" / rep_dir / "num_gaussian_points.txt"
        self.represent = common + [
            "--iterations", str(ENC_ITERS), "--kdetect_iterations", str(KDETECT_ITERS),
            "--is_rm", "--is_ad", "--checkpoint_dir", str(self.ck)]
        self.compress = common + [
            "--iterations", str(QAT_ITERS), "--model_path", str(self.npz),
            "--k_frames_dir", str(self.ck), "--checkpoint_dir", str(self.cq)]
        self.decoded = tmp / "decoded"
        self.decode = [
            "--bitstream", str(self.bitstream), "--height", str(H), "--width", str(W),
            "--model_path", str(self.npz), "--k_frames", str(self.k_frames), "-d",
            str(yuv), "--no_png", "--out", str(self.decoded), "--device", device]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--seed", type=int, default=1,
                    help="the CLIs' --seed (chip_smoke.py runs their default, 1)")
    ap.add_argument("--k3", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="every fit step and render eager (utils.graphs.eager)")
    args = ap.parse_args(argv)

    import contextlib

    from gsvc_tpu_torch import decode as decode_cli
    from gsvc_tpu_torch.drivers import compress as compress_cli
    from gsvc_tpu_torch.drivers import represent as represent_cli
    from gsvc_tpu_torch.ops import fill_cuda
    from gsvc_tpu_torch.scripts import common
    from gsvc_tpu_torch.utils import graphs

    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(N, H, W, dev)
    clip = encoder_clip(sc)
    if args.k3 == "plain":  # every caller reaches K3 through the module
        fill_cuda.segmented_cumsum = fill_cuda.segmented_cumsum_torch
    with tempfile.TemporaryDirectory() as tmp:
        yuv = Path(tmp) / "clip.yuv"
        write_yuv(clip, yuv)
        run = Run(yuv, Path(tmp), H, W, N, len(clip), seed=args.seed, device=args.device)
        before = graphs.launch_counts()
        for name, cli, cli_argv in (("represent", represent_cli.main, run.represent),
                                    ("compress", compress_cli.main, run.compress),
                                    ("decode", decode_cli.main, run.decode)):
            with graphs.eager() if args.eager else contextlib.nullcontext():
                rc = cli(cli_argv)
            if rc != 0:
                print(f"encoder_drift: {name} returned {rc}", file=sys.stderr)
                return 1
        launches = {k: v - before.get(k, 0) for k, v in graphs.launch_counts().items()}
        rep, enc = train_lines(run.rep_log), train_lines(run.qat_log)
        k_frames = [int(x) for x in run.k_frames.read_text().split()]
        sha = {f: hashlib.sha256((run.bitstream / f"frame_{f}.gsvc").read_bytes())
               .hexdigest()[:16] for f in enc}
    frames = {f: {"type": "K" if f in k_frames else "P", "represent_psnr": rep[f]["PSNR"],
                  "qat_psnr": enc[f]["PSNR"], "bpp": enc[f]["bpp"], "gsvc_sha256": sha[f]}
              for f in sorted(enc)}
    how = f"seed {args.seed} K3 {args.k3}" + (" eager" if args.eager else "")
    for f, r in frames.items():
        print(f"encoder_drift [{common.card_line()}] {how} frame {f} "
              f"{r['type']}: represent PSNR {r['represent_psnr']:.4f} dB, QAT PSNR "
              f"{r['qat_psnr']:.4f} dB, bpp {r['bpp']:.4f}, gsvc sha256 {r['gsvc_sha256']}")
    print(f"encoder_drift {how}: launches over the three CLIs {launches}")
    print(json.dumps({"seed": args.seed, "k3": args.k3, "eager": args.eager,
                      "frames": frames, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

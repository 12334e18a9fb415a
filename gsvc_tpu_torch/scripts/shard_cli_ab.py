"""Time the represent CLI at --tile_shards N in two checkouts on one card,
run in the order A, B, B, A, so that a drift of the shared host shows as
a drift and not as a difference.

The clip is phase 6's (`encoder_drift.encoder_clip`, made on the card at
1920x1080 and --num_points splats), or with `--clip rd` the RD ladder's
(`run_rd_point.make_clip`), cut to --frames frames; each run fits them
with --iterations its a frame (`--is_rm`), its K-frames detected or, with
--k_frames, pinned. Each checkout builds its kernels before the first run.
Prints the card's `nvidia-smi` name and power limit, then one JSON line a
run: the checkout, its wall seconds, its Training seconds and PSNR a frame
(train.txt) and the fits it dropped for overflowing their intersection
budget (stderr: frame, budget, overflow, seconds). Exits non-zero without
a card or when a run fails.

    python -m gsvc_tpu_torch.scripts.shard_cli_ab PARENT_DIR CHANGE_DIR
        [--tile_shards 2] [--clip encoder|rd] [--k_frames 1,3]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

H, W = 1080, 1920
# the kernel and host libraries of a checkout (gsvc_tpu_torch/_build.py)
BUILD = ("from gsvc_tpu_torch import _build; "
         "_build.build_all([p.stem for d in ('csrc', 'native') for e in ('cu', 'cpp') "
         "for p in sorted((_build.PKG_DIR / d).glob('*.' + e))])")
# (older drivers print no seconds)
_OVERFLOW = re.compile(r"frame (\d+): the fit overflowed its intersection budget (\d+) by "
                       r"(\d+) intersections[^;]*?(?: in ([\d.]+) s)?;")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a", type=Path, help="the first checkout (the parent)")
    p.add_argument("b", type=Path, help="the second checkout (the change)")
    p.add_argument("--tile_shards", type=int, default=2)
    p.add_argument("--clip", choices=("encoder", "rd"), default="encoder")
    p.add_argument("--k_frames", default="", help="pinned K-frames, e.g. 1,3")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--num_points", type=int, default=10000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_cli_ab: no CUDA device", file=sys.stderr)
        return 1
    from gsvc_tpu_torch.scripts.common import scene
    from gsvc_tpu_torch.scripts.encoder_drift import encoder_clip, train_lines, write_yuv
    from gsvc_tpu_torch.scripts.run_rd_point import make_clip

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for tree in dict.fromkeys((args.a, args.b)):
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree.resolve(), check=True)
    with tempfile.TemporaryDirectory(prefix="shard_cli_ab_") as tmp:
        tmp = Path(tmp)
        yuv = tmp / "clip.yuv"
        if args.clip == "rd":
            make_clip(yuv, W, H, args.frames)
        else:
            clip = encoder_clip(scene(args.num_points, H, W, torch.device("cuda")))
            write_yuv(clip[:args.frames], yuv)
            del clip
            torch.cuda.empty_cache()
        for i, tree in enumerate((args.a, args.b, args.b, args.a)):
            ck = tmp / f"run{i}"
            if args.k_frames:
                (ck / "result" / "ab").mkdir(parents=True)
                (ck / "result" / "ab" / "K_frames.txt").write_text(
                    "".join(f"{int(k)}\n" for k in args.k_frames.split(",")))
            cmd = [sys.executable, "-m", "gsvc_tpu_torch.drivers.represent", "-d", str(yuv),
                   "--data_name", "ab", "--width", str(W), "--height", str(H),
                   "--image_length", str(args.frames), "--num_points", str(args.num_points),
                   "--tile_shards", str(args.tile_shards), "--device", "cuda",
                   "--iterations", str(args.iterations), "--kdetect_iterations", "100",
                   "--is_rm", "--checkpoint_dir", str(ck)]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=tree.resolve(), capture_output=True, text=True)
            wall = time.perf_counter() - t0
            if run.returncode:
                print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
                return 1
            lines = train_lines(ck / "result" / "ab" /
                                f"GaussianVideo_{args.iterations}_{args.num_points}" /
                                "train.txt")
            frames = range(1, args.frames + 1)
            print(json.dumps({"tree": str(tree), "wall_s": wall,
                              "training_s": [lines[f]["Training"] for f in frames],
                              "psnr": [lines[f]["PSNR"] for f in frames],
                              "dropped_fits": [
                                  [int(f), int(b), int(o), float(s) if s else None]
                                  for f, b, o, s in _OVERFLOW.findall(run.stderr)]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

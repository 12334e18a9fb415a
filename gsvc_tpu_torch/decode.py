"""Decoder CLI: reconstruct frames from a `bitstream/` directory on the GPU.

    python -m gsvc_tpu_torch.decode --bitstream <dir> --height H --width W \
        [--model_path <representation npz>] [--k_frames <K_frames.txt>] \
        [--dataset video.yuv] [--out <dir>] [--backend auto] [--device cuda]

The PyTorch port of `python -m gsvc_tpu.decode`, with the same flags and
outputs: `frame_N.png` per frame, `decoded.rgb` (raw RGB24 stream) and
`decode.txt` (per-frame PSNR / MS-SSIM against `--dataset` when given).
P-frames need `--model_path` (the representation checkpoint the compress
stage read) for their previous-frame side information; K-frames decode
standalone. `--device cuda` (the default) runs on the card and fails when
there is none.

On the card each frame's splats go from pinned host memory into the inputs
of the render's CUDA graph (`compress.bitstream.decoded_renderer`, one
capture a splat count), the graph replays, and the frame is converted to
uint8 on the device (`to_uint8`, bitwise numpy's conversion) before its
6 MB at 1080p come back. `STAGES` holds the last run's seconds by stage.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the last `main` run's seconds by stage, summed over its frames: a view of
# its spans (`utils.profiling.RECORDER`; `timed`, so read where the
# recorder is off too).
# The rANS decode ("entropy", `decode.entropy`) and the rest of
# decode_frame ("unpack", `decode.unpack`) on the host clock; the copy of
# the splats to the device ("h2d", `decode.h2d`), the render ("render";
# "capture" for the eager first render of a graph and its capture: a
# `decode.render` span, attribute capture) and the uint8 conversion with
# its copy back ("d2h", `decode.d2h`), each on the device's clock where it
# is a card (the spans' CUDA events, the host's elsewhere); the raw and PNG
# writes ("write", `decode.write`) on the host clock; and "frames"
STAGES: dict = {}


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """A [0, 1] float32 image as uint8 levels on its device: float32
    multiply, round half to even, as numpy's
    `(np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)`."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).round().to(torch.uint8)


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC frame decoder (PyTorch/CUDA)")
    p.add_argument("--bitstream", type=str, required=True,
                   help="directory of frame_N.gsvc streams")
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="representation checkpoint npz (P-frame side info)")
    p.add_argument("--k_frames", type=str, default=None,
                   help="K_frames.txt (default: frame 1 is the only K-frame)")
    p.add_argument("-d", "--dataset", type=str, default=None,
                   help="original YUV420 for PSNR/MS-SSIM scoring")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default: <bitstream>/../decoded)")
    p.add_argument("--backend", type=str, default="auto",
                   help="rasterizer backend: auto | cuda | torch | dense")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--no_png", action="store_true",
                   help="skip per-frame PNGs (write only decoded.rgb)")
    return p.parse_args(argv)


def _find_frames(bs_dir: Path):
    pat = re.compile(r"frame_(\d+)\.gsvc$")
    frames = []
    for f in bs_dir.iterdir():
        m = pat.match(f.name)
        if m:
            frames.append((int(m.group(1)), f))
    if not frames:
        raise SystemExit(f"no frame_N.gsvc streams in {bs_dir}")
    return sorted(frames)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from gsvc_tpu_torch.compress.bitstream import (
        decode_frame,
        decoded_renderer,
        frame_type,
    )
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.drivers.common import load_gmodels, resolve_device
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d
    from gsvc_tpu_torch.utils.profiling import RECORDER

    device = resolve_device(args.device)

    bs_dir = Path(args.bitstream)
    frames = _find_frames(bs_dir)
    out_dir = Path(args.out) if args.out else bs_dir.parent / "decoded"
    out_dir.mkdir(parents=True, exist_ok=True)

    k_frames = {1}
    if args.k_frames:
        k_frames = {int(x) for x in Path(args.k_frames).read_text().split()}

    gmodels = None
    if args.model_path:
        gmodels = load_gmodels(args.model_path)

    p_frames = [n for n, _ in frames if n not in k_frames]
    if p_frames and gmodels is None:
        raise SystemExit(
            f"frames {p_frames[:5]}... are P-frames (not in the K-frame "
            "schedule) and need --model_path for their previous-frame "
            "side-information buffers"
        )

    gt_frames = None
    if args.dataset:
        from gsvc_tpu_torch.io.yuv import process_yuv_video

        gt_frames = process_yuv_video(
            args.dataset, args.width, args.height, limit=frames[-1][0]
        )

    png = not args.no_png
    if png:
        from PIL import Image

    lines = []
    psnrs, msims = [], []
    t_start = time.time()
    STAGES.clear()

    # Pass 1: decode every frame's params, then size ONE intersection
    # budget from the measured maximum (a too-small budget drops whole
    # splats: the JAX decoder's 1fcb84c fix).
    decoded = []
    for frame_num, path in frames:
        blob = path.read_bytes()
        schedule_k = frame_num in k_frames
        ftype = frame_type(blob)
        if ftype is not None and ftype != ("K" if schedule_k else "P"):
            raise SystemExit(
                f"frame {frame_num}: bitstream says type {ftype} but the "
                f"K-frame schedule says {'K' if schedule_k else 'P'} — "
                "wrong or stale --k_frames?"
            )
        is_k = schedule_k if ftype is None else (ftype == "K")
        if is_k or gmodels is None:
            side = (None, None, None)
        else:
            pg = gmodels[f"frame_{frame_num - 1}"]
            side = (pg["_xyz"], pg["_cholesky"], pg["_features_dc"])
        decoded.append((frame_num, len(blob)) + decode_frame(blob, *side, times=STAGES))

    tb = ((args.width + 15) // 16, (args.height + 15) // 16, 1)
    with torch.no_grad():
        n_isect = max(
            int(project_gaussians_2d(
                torch.as_tensor(m, device=device), torch.as_tensor(ch, device=device),
                args.height, args.width, tb,
            )[4].sum())
            for _, _, m, ch, _ in decoded
        )
    budget = int(np.ceil(n_isect * 1.1 / 8192)) * 8192

    host8 = torch.empty((args.height, args.width, 3), dtype=torch.uint8,
                        pin_memory=device.type == "cuda")
    with open(out_dir / "decoded.rgb", "wb") as raw:
        for frame_num, nbytes, means, chol, colors in decoded:
            cfg = FrameConfig(
                H=args.height, W=args.width, num_points=means.shape[0],
                max_num_points=means.shape[0], iterations=1,
                backend=args.backend, max_intersects=budget,
            )
            render = decoded_renderer(means.shape[0], cfg, device)
            with RECORDER("decode.h2d", device=device, timed=True) as h2d:
                render.load(means, chol, colors)
            stage = "capture" if render.capturing else "render"
            with RECORDER("decode.render", device=device, timed=True,
                          capture=render.capturing) as rendered:
                img_t = render()  # a graph's output: read before the next frame's
            with RECORDER("decode.d2h", device=device, timed=True) as d2h:
                host8.copy_(to_uint8(img_t), non_blocking=True)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            with RECORDER("decode.write", timed=True) as write:
                img8 = host8.numpy()
                raw.write(img8)  # host8 itself, no copy
                if png:
                    Image.fromarray(img8).save(out_dir / f"frame_{frame_num}.png")
            RECORDER.resolve()  # the frame's events have completed
            for key, span in (("h2d", h2d), (stage, rendered), ("d2h", d2h),
                              ("write", write)):
                STAGES[key] = STAGES.get(key, 0.0) + span.seconds

            line = (
                f"Frame_{frame_num}: {args.height}x{args.width}, "
                f"n={means.shape[0]}, bytes={nbytes}"
            )
            if gt_frames is not None and frame_num <= len(gt_frames):
                from gsvc_tpu_torch.utils.metrics import ms_ssim, psnr

                gt = torch.as_tensor(
                    gt_frames[frame_num - 1].astype(np.float32) / 255.0,
                    device=device,
                )
                ps = float(psnr(img_t, gt))
                psnrs.append(ps)
                line += f", PSNR:{ps:.4f}"
                if min(args.height, args.width) >= 11:  # the SSIM window
                    mss = float(ms_ssim(
                        img_t.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]
                    ))
                    msims.append(mss)
                    line += f", MS-SSIM:{mss:.4f}"
            print(line)
            lines.append(line)

    STAGES["frames"] = len(frames)
    summary = (
        f"Decoded {len(frames)} frames in {time.time() - t_start:.2f}s "
        f"-> {out_dir}"
    )
    if psnrs:
        summary += f"; avg PSNR {np.mean(psnrs):.4f}"
    if msims:
        summary += f", avg MS-SSIM {np.mean(msims):.4f}"
    print(summary)
    lines.append(summary)
    (out_dir / "decode.txt").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

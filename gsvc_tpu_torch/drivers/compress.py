"""Compression-stage training driver (PyTorch port of
gsvc_tpu/drivers/compress.py, the reference `train_video_Compress.py`).

    python -m gsvc_tpu_torch.drivers.compress -d video.yuv --width 1920 \
        --height 1080 --model_path <gmodels_state_dict.npz> \
        --k_frames_dir <represent checkpoint_dir> --iterations 30000 \
        [--device cuda]

Loads the representation checkpoint, fine-tunes each frame with
quantization in the loop (the frame model for K-frames, the delta model
for P-frames), measures bpp with rANS coding, writes train.txt, the
quantized checkpoint and the decodable `bitstream/frame_N.gsvc` streams.
Same flags and artifacts as the JAX driver, plus `--device` (default
cuda; raises when there is no card).

A P-frame's side information is the previous frame's REPRESENTATION
checkpoint, not its compressed version (train_video_Compress.py:51-72):
the decoder's P-frame path reads the same checkpoint.

`--tile_shards N` > 1 runs the CLI as N spawned ranks of one gloo group
(`drivers.common.launch_ranks`): each runs this driver on the same frames,
its QAT fits split by tile rows (`parallel.sharded.fit_compress_sharded`,
eager steps); rank 0 alone writes the logs, the checkpoint, the
bitstream and the video.

`--hosts N` > 1 (or GSVC_NUM_PROCS, `drivers.common.hosts_of`) runs this
host's block of frames (`parallel.multihost.assign_frames`): it writes
their `bitstream/frame_N.gsvc` into the shared directory and `.host{h}`
shards of the checkpoint and train.txt, then signals the `compressed`
barrier and exits; host 0 waits there for every host and merges the
shards into the single-host files (no video). The hosts may run one after
another, host 0 last.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gsvc_tpu_torch.compress.bitstream import encode_frame
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.drivers.common import (
    SINGLE_HOST,
    Hosts,
    frame_generator,
    hosts_of,
    launch_ranks,
    load_gmodels,
    resolve_device,
)
from gsvc_tpu_torch.io import generate_video, process_yuv_video
from gsvc_tpu_torch.models.compress import (
    compress_overflow,
    fit_compress_chunked,
    forward_quantize,
    init_compress_state,
    measure_bits,
)
from gsvc_tpu_torch.models.represent import uses_kernels
from gsvc_tpu_torch.ops.binning import default_max_intersects
from gsvc_tpu_torch.parallel import multihost
from gsvc_tpu_torch.parallel.launch import rank_device
from gsvc_tpu_torch.parallel.sharded import fit_compress_sharded, tile_mesh
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.logwriter import LogWriter
from gsvc_tpu_torch.utils.metrics import ms_ssim
from gsvc_tpu_torch.utils.profiling import _sync


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC compression training "
                                            "(PyTorch/CUDA)")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--data_name", type=str, default="video")
    p.add_argument("--model_name", type=str, default="GaussianVideo")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--savdir", type=str, default="result")
    p.add_argument("--savdir_m", type=str, default="models")
    p.add_argument("--fps", type=int, default=120)
    p.add_argument("--image_length", type=int, default=50)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--num_points", type=int, default=4000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--save_everyimgs", action="store_true")
    p.add_argument("--removal_rate", type=float, default=0.1)
    p.add_argument("--is_rm", action="store_true")
    p.add_argument("--backend", type=str, default="auto",
                   help="rasterizer backend: auto | cuda | torch | dense")
    # intersection-budget headroom (x num_points): QAT inflates splat
    # footprints (6-bit covariances + delta offsets), so the compress stage
    # takes twice the representation stage's default of 16
    p.add_argument("--budget_factor", type=int, default=32)
    # N > 1: N ranks (spawned processes, gloo), each QAT fit's tile rows
    # split over them (parallel/sharded.py); rank 0 writes
    p.add_argument("--tile_shards", type=int, default=0)
    # fit each frame in slices of at most N iterations (the same trajectory,
    # models.compress.fit_compress_chunked)
    p.add_argument("--fit_chunk", type=int, default=0)
    # multi-host frame parallelism: compress frames are independent (a
    # P-frame's side information is the representation checkpoint), so hosts
    # take contiguous frame blocks and host 0 merges (parallel/multihost.py)
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=-1)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints_quant")
    p.add_argument("--k_frames_dir", type=str, default="./checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda)")
    return p.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    with hosts_of(args) as hosts:
        device = resolve_device(args.device)
        if args.tile_shards > 1:
            return launch_ranks(_rank_main, args, list(argv))
        return _run(args, device, hosts=hosts)


def _rank_main(rank: int, world_size: int, argv) -> dict:
    """Rank `rank` of a --tile_shards run: this CLI on its device,
    writing only on rank 0. Returns the rank's kernel launch counts."""
    args = parse_args(argv)
    _run(args, rank_device(rank, args.device), writer=rank == 0)
    return graphs.launch_counts()


def _run(args, device: torch.device, writer: bool = True,
         hosts: Hosts = SINGLE_HOST) -> int:
    """The CLI's work after its arguments; a rank of a --tile_shards run
    that is not the `writer` writes nothing. A host of a multi-host run
    (`hosts`) codes its frames and writes its shards; host 0 merges them."""
    mesh = tile_mesh(args.tile_shards) if args.tile_shards > 1 else None
    base = Path(args.checkpoint_dir)
    run_name = f"{args.model_name}_{args.iterations}_{args.num_points}"
    out_dir = base / args.savdir / args.data_name / run_name
    model_dir = base / args.savdir_m / args.data_name / run_name
    bs_dir = model_dir / "bitstream"
    if writer:
        for d in (out_dir, bs_dir):
            d.mkdir(parents=True, exist_ok=True)
    if hosts.multi:
        multihost.clear_stale_markers(out_dir, hosts.host_id)
    log = LogWriter(out_dir, suffix=hosts.suffix).write if writer else (lambda text: None)

    video_frames = process_yuv_video(
        args.dataset, args.width, args.height, limit=args.image_length
    )
    image_length = min(args.image_length, len(video_frames))
    gmodels = load_gmodels(args.model_path)

    kfile = Path(args.k_frames_dir) / args.savdir / args.data_name / "K_frames.txt"
    k_frames = [int(x) for x in kfile.read_text().split()] if kfile.exists() else [1]
    frames = list(range(1, image_length + 1))
    if hosts.multi:
        frames = multihost.assign_frames(image_length, hosts.n)[hosts.host_id]
        print(f"host {hosts.host_id}/{hosts.n}: frames {frames}")

    psnrs, msims, bpps, t_train, t_eval, fpses = [], [], [], [], [], []
    out_state = {}
    img_list = []
    for frame_num in frames:
        i = frame_num - 1
        gt = torch.as_tensor(video_frames[i].astype(np.float32) / 255.0, device=device)
        H, W = gt.shape[0], gt.shape[1]
        gmodel = gmodels[f"frame_{frame_num}"]
        is_k = frame_num in k_frames
        p_gmodel = None if is_k else gmodels[f"frame_{i}"]
        n_pts = gmodel["_xyz"].shape[0]
        tb = ((W + 15) // 16, (H + 15) // 16)
        cfg = FrameConfig(
            H=H, W=W, num_points=n_pts, max_num_points=n_pts,
            iterations=args.iterations, lr=args.lr,
            loss_type=args.loss_type, backend=args.backend,
            max_intersects=default_max_intersects(
                n_pts, tb[0] * tb[1], factor=args.budget_factor),
        )
        draws = frame_generator(args.seed, frame_num)
        state = init_compress_state(gmodel, p_gmodel, device)
        t0 = time.time()
        if mesh is not None:  # every step eager; --fit_chunk unused, as gsvc_tpu
            state = fit_compress_sharded(state, gt, cfg, mesh, draws=draws)
        else:
            # slices of --fit_chunk iterations (one slice by default)
            state = fit_compress_chunked(state, gt, cfg, args.fit_chunk or args.iterations,
                                         draws=draws)
        _sync(state.params.xyz)
        train_time = time.time() - t0
        overflow = int(compress_overflow(state, cfg))
        if overflow > 0 and writer:
            print(
                f"WARNING: frame {frame_num}: intersection budget overflow "
                f"— {overflow} intersections (whole splats) dropped from "
                "the render; raise max_intersects",
                file=sys.stderr,
            )

        bits, img = measure_bits(state, cfg)
        # the frame's bitstream: the bytes the bpp accounting counts,
        # decodable standalone by python -m gsvc_tpu_torch.decode
        if writer:
            (bs_dir / f"frame_{frame_num}.gsvc").write_bytes(
                encode_frame(state, cfg, "K" if is_k else "P"))
        mse = float(torch.mean((img - gt) ** 2))
        psnr = 10 * math.log10(1.0 / mse)
        mss = float(ms_ssim(img.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]))
        # eval fps loop (train_video_Compress.py:104-109): the quantized
        # forward; on the kernel path in the planar [3, H, W] layout (K5).
        # On a card the first render is eager and captures a CUDA graph that
        # the 100 timed ones replay (gsvc_tpu jits it once)
        layout = "chw" if uses_kernels(cfg, device) else "image"

        def forward():
            return forward_quantize(
                state.params, state.vq, state.p_xyz, state.p_cholesky,
                state.p_features_dc, cfg, training=False, layout=layout)[0]

        with graphs.render_graph(forward, (), device) as render:
            out = render()
            _sync(out)
            t0 = time.time()
            for _ in range(100):
                out = render()
            _sync(out)
            eval_time = (time.time() - t0) / 100

        img_list.append((img * 255).cpu().numpy().astype(np.uint8))
        psnrs.append(psnr)
        msims.append(mss)
        bpps.append(bits["bpp"])
        t_train.append(train_time)
        t_eval.append(eval_time)
        fpses.append(1.0 / eval_time)
        for k in ("xyz", "cholesky", "features_dc"):
            out_state[f"frame_{frame_num}/_{k}"] = (
                getattr(state.params, k).detach().cpu().numpy())
        log(
            "Frame_{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, bpp:{:.4f}, "
            "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}".format(
                frame_num, H, W, psnr, mss, bits["bpp"], train_time,
                eval_time, 1.0 / eval_time,
            )
        )

    if not writer:
        return 0
    np.savez(model_dir / f"gmodels_state_dict{hosts.suffix}.npz", **out_state)
    if hosts.multi:
        # workers signal and exit; host 0 waits for everyone, then merges
        multihost.barrier("compressed", out_dir, hosts.n, hosts.host_id,
                          wait_for=range(hosts.n) if hosts.host_id == 0 else [])
        if hosts.host_id == 0:
            multihost.merge_compress_artifacts(model_dir, out_dir, hosts.n, args.height,
                                               args.width)
            print("multi-host compress artifacts merged")
        return 0
    log(
        "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Bpp:{:.4f}, "
        "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}".format(
            args.height, args.width, float(np.mean(psnrs)),
            float(np.mean(msims)), float(np.mean(bpps)),
            float(np.mean(t_train)), float(np.mean(t_eval)),
            float(np.mean(fpses)),
        )
    )
    generate_video(out_dir, img_list, args.fps, origin=True)
    return 0


def cli():
    """console_scripts entry point."""
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

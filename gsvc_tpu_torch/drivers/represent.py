"""Video representation training driver (PyTorch port of
gsvc_tpu/drivers/represent.py, the reference `train_video_Represent.py`).

    python -m gsvc_tpu_torch.drivers.represent -d video.yuv --width 1920 \
        --height 1080 --num_points 10000 --iterations 30000 --is_rm --is_ad \
        [--device cuda]

Same flags and artifacts as the JAX driver (train.txt, K_frames.txt,
loss_list.txt, num_gaussian_points.txt, the per-frame splat checkpoint
`gmodels_state_dict.npz`, the output video), plus `--device` (default
cuda; raises when there is no card). Per frame:

  - K-frame detection from warm-start-advantage outliers
    (train_video_Represent.py:312-356), cached in K_frames.txt;
  - K-frames: fresh init + removal control (--is_rm);
  - P-frames: warm start from the previous frame's converged splats +
    adaptive control (--is_ad) (train_video_Represent.py:358-366);
  - a fit that overflows its intersection budget (the JAX driver warns and
    keeps it) is fitted again with a larger budget, kept for the frames
    after it (`train_within_budget`).

The checkpoint keys are `frame_{n}/_xyz|_cholesky|_features_dc` with the
colours premultiplied by rgb_W (train_video_Represent.py:109-113), so
either package's compress stage reads either package's checkpoint.

Random draws: frame n's splat init and its revive draws come from one
`torch.Generator` seeded with seed * 100003 + n, the integer the JAX
driver keys its PRNG with (the streams differ; tests inject the JAX
package's numbers through `uniforms` / `draws`).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import GaussianFrame
from gsvc_tpu_torch.drivers.common import (
    check_single_host,
    frame_generator,
    resolve_device,
)
from gsvc_tpu_torch.io import generate_video, process_yuv_video
from gsvc_tpu_torch.models.represent import (
    fit_frame_partial,
    init_train_state,
    intersection_budget,
    pre_train_frame,
    render_frame,
    render_frame_pos,
    uses_kernels,
)
from gsvc_tpu_torch.ops.binning import default_max_intersects
from gsvc_tpu_torch.parallel.multihost import NOT_PORTED, gop_spans
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.control import detect_outliers_mean_diff
from gsvc_tpu_torch.utils.logwriter import LogWriter
from gsvc_tpu_torch.utils.metrics import ms_ssim
from gsvc_tpu_torch.utils.profiling import _sync


def compact_alive(params: GaussianFrame, alive: torch.Tensor):
    """Move alive slots to the front (stable), mirroring the reference's
    boolean-mask reallocation order. Returns (params, alive_count)."""
    order = torch.argsort((~alive).to(torch.int8), stable=True)
    count = int(alive.sum())
    with torch.no_grad():
        compacted = GaussianFrame(params.xyz[order], params.cholesky[order],
                                  params.features_dc[order], params.rgb_w[order])
    return compacted, count


def gmodel_from_state(params: GaussianFrame, alive: torch.Tensor) -> dict:
    """The saved per-frame model dict (train_video_Represent.py:109-113):
    xyz / cholesky raw, features premultiplied by rgb_W; alive slots only,
    as numpy arrays."""
    compacted, count = compact_alive(params, alive)

    def host(t):
        return t.detach()[:count].cpu().numpy()

    return {
        "_xyz": host(compacted.xyz),
        "_cholesky": host(compacted.cholesky),
        "_features_dc": host(compacted.features_dc * compacted.rgb_w),
    }


def _warm_params(gmodel: dict, capacity: int, device="cpu") -> GaussianFrame:
    count = min(gmodel["_xyz"].shape[0], capacity)

    def pad(a):
        a = np.asarray(a, np.float32)[:count]
        return torch.as_tensor(np.pad(a, ((0, capacity - count), (0, 0))),
                               device=device)

    return GaussianFrame(
        pad(gmodel["_xyz"]), pad(gmodel["_cholesky"]), pad(gmodel["_features_dc"]),
        torch.ones((capacity, 1), dtype=torch.float32, device=device),
    )


class SimpleTrainer2d:
    """Per-frame trainer facade mirroring the reference class
    (train_video_Represent.py:17-202).

    `uniforms` (the init draws, see `init_splats`) and `draws` (the revive
    draws, see `make_train_step`) override the frame's generator."""

    def __init__(
        self,
        image: np.ndarray,
        frame_num: int,
        loss_type: str = "L2",
        num_points: int = 2000,
        max_num_points: int = 2000,
        iterations: int = 30000,
        args=None,
        Trained_Model=None,
        isdensity: bool = False,
        isremoval: bool = True,
        removal_rate: float = 0.25,
        seed: int = 1,
        backend: str = "auto",
        tile_shards: int = 0,
        fit_chunk: int = 0,
        device=None,
        uniforms=None,
        draws=None,
        max_intersects: Optional[int] = None,
    ):
        if tile_shards and tile_shards > 1:
            raise NotImplementedError(f"--tile_shards {tile_shards} {NOT_PORTED}")
        if device is None:
            device = getattr(args, "device", "cuda") if args is not None else "cuda"
        self.device = resolve_device(device) if isinstance(device, str) else device
        self.fit_chunk = fit_chunk or (
            getattr(args, "fit_chunk", 0) if args is not None else 0
        )
        self.gt = torch.as_tensor(image.astype(np.float32) / 255.0,
                                  device=self.device)  # [H, W, 3]
        self.H, self.W = image.shape[0], image.shape[1]
        self.frame_num = frame_num
        self.cfg = FrameConfig(
            H=self.H,
            W=self.W,
            num_points=num_points,
            max_num_points=max_num_points,
            iterations=iterations,
            lr=args.lr if args else 1e-3,
            loss_type=loss_type,
            densification_interval=(
                args.densification_interval if args else 100
            ),
            removal_rate=removal_rate,
            isdensity=isdensity,
            isremoval=isremoval,
            backend=backend,
        )
        if max_intersects is None and args is not None and getattr(args, "budget_factor", 0):
            tbb = self.cfg.tile_bounds
            max_intersects = default_max_intersects(
                max_num_points, tbb[0] * tbb[1], factor=args.budget_factor)
        self.cfg = dataclasses.replace(self.cfg, max_intersects=max_intersects)
        gen = frame_generator(seed, frame_num)
        self.draws = gen if draws is None else draws
        if Trained_Model is not None:
            warm = _warm_params(Trained_Model, max_num_points, self.device)
            count = min(Trained_Model["_xyz"].shape[0], max_num_points)
            self.state = init_train_state(
                self.cfg, warm=warm, warm_count=count, uniforms=uniforms,
                generator=gen, device=self.device)
        else:
            self.state = init_train_state(self.cfg, uniforms=uniforms,
                                          generator=gen, device=self.device)

    def train(self, ispos: bool = False):
        t0 = time.time()
        # slices of --fit_chunk iterations (one slice by default); chained
        # slices are one fit_frame, early stop included
        chunk = max(self.fit_chunk or self.cfg.iterations, 1)
        for hi in range(chunk, self.cfg.iterations + chunk, chunk):
            self.state = fit_frame_partial(self.state, self.gt, hi, self.cfg,
                                           draws=self.draws)
        _sync(self.state.params.xyz)
        train_time = time.time() - t0
        state = self.state
        num_points = int(state.alive.sum())
        psnr, msssim, combined_img, img = self.test(ispos)
        # render-only timing loop (train_video_Represent.py:101-106); on the
        # kernel path it times the planar [3, H, W] forward (K5), the
        # reference model's own forward layout. On a card the first render
        # is eager and captures a CUDA graph that the 100 timed ones replay
        # (gsvc_tpu compiles the render once, drivers/represent.py:206-208)
        fps_layout = "chw" if uses_kernels(self.cfg, self.device) else "image"
        with graphs.render_graph(
                lambda: render_frame(state.params, state.alive, self.cfg, layout=fps_layout),
                (), self.device) as render:
            out = render()
            _sync(out)
            t0 = time.time()
            for _ in range(100):
                out = render()
            _sync(out)
            eval_time = (time.time() - t0) / 100
        gmodel = gmodel_from_state(state.params, state.alive)
        return (
            psnr, msssim, train_time, eval_time, 1.0 / eval_time,
            gmodel, combined_img, img, num_points, float(state.loss),
        )

    def pre_train(self, lambda_value: float = 0.7):
        res = pre_train_frame(self.state, self.gt, self.cfg, lambda_value)
        self.state = res.state
        gmodel = gmodel_from_state(res.state.params, res.state.alive)
        return gmodel, float(res.state.loss)

    def test(self, ispos: bool = False):
        """PSNR / MS-SSIM + the rendered frame; with ispos also the combined
        (position map | render) image (train_video_Represent.py:135-202)."""
        img = render_frame(self.state.params, self.state.alive, self.cfg)
        mse = float(torch.mean((img - self.gt) ** 2))
        psnr = 10 * math.log10(1.0 / mse)
        mss = float(ms_ssim(img.permute(2, 0, 1)[None], self.gt.permute(2, 0, 1)[None]))
        img_u8 = (torch.clamp(img, 0, 1) * 255).cpu().numpy().astype(np.uint8)
        if not ispos:
            return psnr, mss, img_u8, img_u8
        pos = render_frame_pos(self.state.params, self.state.alive, self.cfg)
        pos_u8 = (torch.clamp(pos, 0, 1) * 255).cpu().numpy().astype(np.uint8)
        combined = np.concatenate([pos_u8, img_u8], axis=1)
        return psnr, mss, combined, img_u8


def train_within_budget(make_trainer, max_intersects: Optional[int] = None,
                        ispos: bool = False):
    """Fit a frame with `make_trainer(max_intersects)` and, while its fit
    reports a budget overflow (whole splats dropped from its render and
    gradients, which also ends it early through a noisy loss), fit it again
    from the start with the budget raised to twice the intersections it
    reached, in buckets of 8192. Returns (the trainer, its `train()`, the
    budget of that fit)."""
    while True:
        trainer = make_trainer(max_intersects)
        result = trainer.train(ispos)
        overflow = int(trainer.state.max_overflow)
        if overflow == 0:
            return trainer, result, max_intersects
        was = intersection_budget(trainer.cfg)
        max_intersects = -(-2 * (was + overflow) // 8192) * 8192
        print(f"frame {trainer.frame_num}: the fit overflowed its intersection budget "
              f"{was} by {overflow} intersections (whole splats dropped from render and "
              f"gradients); fitting it again with {max_intersects}", file=sys.stderr)


def _save_png(path, img_u8: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(str(path), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
    except Exception:  # cv2 missing
        np.save(str(path) + ".npy", img_u8)


def detect_k_frames(video_frames, args, out_dir: Path, loss_type: str,
                    uniforms=None) -> list:
    """K-frame detection (train_video_Represent.py:312-356), cached in
    K_frames.txt. `uniforms(frame_num)` overrides the init draws of the
    frame's two pre-train trainers."""
    kfile = out_dir / "K_frames.txt"
    if kfile.exists():
        return [int(line.strip()) for line in kfile.read_text().splitlines()]
    loss_list = []
    gmodel = None
    n = len(video_frames)
    kd_points = getattr(args, "kdetect_points", 5000)
    kd_iters = getattr(args, "kdetect_iterations", 500)
    for i in range(n):
        frame_num = i + 1
        common = dict(
            loss_type=loss_type, num_points=kd_points, max_num_points=kd_points,
            args=args, isdensity=False, isremoval=False,
            removal_rate=args.removal_rate, seed=args.seed, backend=args.backend,
            uniforms=None if uniforms is None else uniforms(frame_num),
        )
        k_tr = SimpleTrainer2d(video_frames[i], frame_num, iterations=kd_iters,
                               **common)
        if frame_num == 1:
            gmodel, _ = k_tr.pre_train()
            loss_list.append(0.0)
        else:
            p_tr = SimpleTrainer2d(video_frames[i], frame_num,
                                   iterations=max(kd_iters // 5, 1),
                                   Trained_Model=gmodel, **common)
            gmodel, loss_k = k_tr.pre_train()
            _, loss_p = p_tr.pre_train()
            loss_list.append(loss_p - loss_k)
    vals = np.asarray(loss_list, np.float64)
    if len(vals) > 1:
        lo, hi = vals[1:].min(), vals[1:].max()
        norm = [vals[0]] + list((vals[1:] - lo) / max(hi - lo, 1e-12))
    else:
        norm = list(vals)
    with open(out_dir / "loss_list.txt", "w") as f:
        for idx, v in enumerate(norm, start=1):
            f.write(f"Frame {idx}: {v}\n")
    outliers = detect_outliers_mean_diff(norm)
    k_frames = sorted(set([1] + [int(x + 1) for x in outliers]))
    with open(kfile, "w") as f:
        for fr in k_frames:
            f.write(f"{fr}\n")
    return k_frames


def parse_args(argv):
    p = argparse.ArgumentParser(description="GSVC representation training "
                                            "(PyTorch/CUDA)")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--data_name", type=str, default="video")
    p.add_argument("--model_name", type=str, default="GaussianVideo")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--savdir", type=str, default="result")
    p.add_argument("--savdir_m", type=str, default="models")
    p.add_argument("--fps", type=int, default=120)
    p.add_argument("--image_length", type=int, default=50)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--num_points", type=int, default=10000)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--removal_rate", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--save_everyimgs", action="store_true")
    p.add_argument("--is_pos", action="store_true")
    p.add_argument("--is_ad", action="store_true")
    p.add_argument("--is_rm", action="store_true")
    p.add_argument("--backend", type=str, default="auto",
                   help="rasterizer backend: auto | cuda | torch | dense")
    # intersection-budget headroom (x num_points); 0 = the library default
    p.add_argument("--budget_factor", type=int, default=0)
    # split each frame's fit into slices of at most N iterations (0 = one);
    # the same trajectory (models.represent.fit_frame_partial)
    p.add_argument("--fit_chunk", type=int, default=0)
    # multi-chip tile sharding: not ported (raises for N > 1)
    p.add_argument("--tile_shards", type=int, default=0)
    # K-frame detection pre-train size (the reference hardcodes 5000 splats
    # and 500 + 100 iterations, train_video_Represent.py:322-330)
    p.add_argument("--kdetect_points", type=int, default=5000)
    p.add_argument("--kdetect_iterations", type=int, default=500)
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    # multi-host GOP parallelism: not ported (raises for --hosts > 1)
    p.add_argument("--hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=-1)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda)")
    return p.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    check_single_host(args)
    resolve_device(args.device)

    base = Path(args.checkpoint_dir)
    run_name = f"{args.model_name}_{args.iterations}_{args.num_points}"
    out_dir = base / args.savdir / args.data_name / run_name
    out_dir.mkdir(parents=True, exist_ok=True)
    model_dir = base / args.savdir_m / args.data_name / run_name
    model_dir.mkdir(parents=True, exist_ok=True)
    logwriter = LogWriter(out_dir)

    video_frames = process_yuv_video(
        args.dataset, args.width, args.height, limit=args.image_length
    )
    image_length = min(args.image_length, len(video_frames))
    video_frames = video_frames[:image_length]

    k_dir = base / args.savdir / args.data_name
    k_dir.mkdir(parents=True, exist_ok=True)
    k_frames = detect_k_frames(video_frames, args, k_dir, args.loss_type)
    print("K-frames:", k_frames)

    psnrs, ms_ssims, t_train, t_eval, fpses = [], [], [], [], []
    gnum_by_frame = {}
    gmodels_state = {}
    img_list = []
    combined_img_list = []
    img_dir = out_dir / "img"
    # raised where a fit overflows it, kept for the frames after it
    max_intersects = None
    for gop in gop_spans(k_frames, image_length):
        gmodel = None
        num_gaussian_points = args.num_points
        for frame_num in gop:
            i = frame_num - 1
            common = dict(loss_type=args.loss_type, max_num_points=args.num_points,
                          iterations=args.iterations, args=args,
                          removal_rate=args.removal_rate, seed=args.seed,
                          backend=args.backend)
            if frame_num in k_frames:
                frame = dict(num_points=args.num_points, Trained_Model=None,
                             isdensity=False, isremoval=args.is_rm)
            else:
                frame = dict(num_points=num_gaussian_points, Trained_Model=gmodel,
                             isdensity=args.is_ad, isremoval=False)
            trainer, result, max_intersects = train_within_budget(
                lambda mi: SimpleTrainer2d(video_frames[i], frame_num, **frame, **common,
                                           max_intersects=mi),
                max_intersects, args.is_pos)
            (
                psnr, msssim, train_time, eval_time, eval_fps,
                gmodel, combined_img, img, num_gaussian_points, loss,
            ) = result
            img_list.append(img)
            if args.is_pos:
                combined_img_list.append(combined_img)
            # PNG dumps (train_video_Represent.py:146-160): every frame with
            # --save_everyimgs, frame 1 and every 100th with --save_imgs
            if args.save_everyimgs or (
                args.save_imgs and (i == 0 or (i + 1) % 100 == 0)
            ):
                img_dir.mkdir(parents=True, exist_ok=True)
                _save_png(img_dir / f"{frame_num}_fitting.png", img)
                if args.is_pos:
                    _save_png(img_dir / f"{frame_num}_fitting_combined_pos.png",
                              combined_img)
            psnrs.append(psnr)
            ms_ssims.append(msssim)
            t_train.append(train_time)
            t_eval.append(eval_time)
            fpses.append(eval_fps)
            gnum_by_frame[frame_num] = num_gaussian_points
            for k, v in gmodel.items():
                gmodels_state[f"frame_{frame_num}/{k}"] = v
            logwriter.write(
                "Frame_{}: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}, "
                "Loss:{:.4f}".format(
                    frame_num, trainer.H, trainer.W, psnr, msssim,
                    train_time, eval_time, eval_fps, loss,
                )
            )

    ckpt = model_dir / "gmodels_state_dict.npz"
    np.savez(ckpt, **gmodels_state)
    with open(out_dir / "num_gaussian_points.txt", "w") as f:
        for fr in sorted(gnum_by_frame):
            f.write(f"frame_{fr}: {gnum_by_frame[fr]}\n")

    file_size = ckpt.stat().st_size
    logwriter.write(
        "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Training:{:.4f}s, "
        "Eval:{:.8f}s, FPS:{:.4f}, Size:{:.4f}, Gaussian_number:{:.4f}".format(
            args.height, args.width, float(np.mean(psnrs)),
            float(np.mean(ms_ssims)), float(np.mean(t_train)),
            float(np.mean(t_eval)), float(np.mean(fpses)),
            file_size / (1024 * 1024),
            float(np.mean(list(gnum_by_frame.values()))),
        )
    )
    generate_video(out_dir, img_list, args.fps, origin=True)
    if args.is_pos:
        generate_video(out_dir, combined_img_list, args.fps, origin=False)
    return 0


def cli():
    """console_scripts entry point."""
    return main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

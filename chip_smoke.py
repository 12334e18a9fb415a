#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gsvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path and its training step once at 1920x1080
with 10k splats, the paper's operating point, and fails (non-zero exit) at
the first fault:

0. device: a CUDA card, its name and power limit from nvidia-smi;
1. build: the kernels of gsvc_tpu_torch/csrc, one nvcc per source, and the
   native rANS and I420 code of gsvc_tpu_torch/native, one g++ each, all in
   parallel (each build's seconds); ptxas's register and shared-memory use
   of every kernel, K3's
   cluster size, and the inner-loop instruction mix of K4/K5 and K6 a
   (pixel, lane) pair from the built libraries' SASS (`utils.sass`; "not
   measured" without cuobjdump);
2. kernels: K1 (fill_decode_keys), K2 (rank_cap_decode), K4 (forward,
   [H,W,3] and the tile-row "rows" store), K5 (forward, [3,H,W]), K6
   (backward into the expansion slots) and K3 (segmented cumsum) on the
   bench scene (bench.py's scene, seed 0, unit opacity), each against its
   plain PyTorch version on the card: keys, ids and K2's tile edges
   exactly, renders within max-abs 1e-4, the rows store exactly
   image_to_rows of the image store; K1 and K2 also on wide keys (WIDE_N
   splats, a 17-bit gauss field, `fill_cuda.key_layout`) at 1920x1080
   (int32 keys) and 3840x2160 (int64), exactly, K2 at the cap of 256 and
   at WIDE_CAP (runs past it: capped lanes, the 17-bit sentinel), with
   `bin_gaussians`' kernel path equal to its plain one there,
   K6 / K3 and the autograd function's per-splat gradients (against
   autograd through the plain renderer) within 1e-4 of the largest entry;
   K3 also at the full budget with sparse flags, whose segments run over
   several CTAs' spans; two launches of K2 (also on both wide scenes), K5,
   K4 rows, K6 (rows) and K3 (both cases) bitwise equal;
3. serving slice: a stream of DECODE_FRAMES K-frames of the scene written
   with `pack_frame` (`scripts.decode_rate`), decoded by `python -m
   gsvc_tpu_torch.decode --no_png` (its `main`), its renders replays of one
   captured CUDA graph, then rendered once more as the planar eval render
   (`render_frame`, layout "chw"); the same CLI runs with every render
   eager before it and after a second graph run (whose capture is cached).
   decoded.rgb must be within 1 uint8 level of the plain path's render,
   the graph runs' bytes equal to the eager runs', the graph captured once
   and replayed for every later frame with K1, K2 and K4 `image` inside,
   the native rANS decode equal to the numpy one, and the eval render
   within 1e-4. Prints the decoder's frames/s and ms a frame by stage for
   each run, and the rANS decode of a frame natively and in numpy;
4. training slice: `fit_frame` with removal control (the K-frame mode) from
   `init_splats` toward the bench scene's render, its plain steps as
   CUDA-graph replays (the default), then the same fit with graph=False:
   PSNR must rise, the two fits must be bitwise identical (parameters,
   mask, moments, counters, loss, best loss, patience, image), the graph
   must have replayed, and no binning budget may overflow; then a few
   adaptive-control steps (the P-frame mode), which revive splats, a
   pre-train and a QAT fit, each with graphs and with graph=False, bitwise
   equal;
5. times: each kernel beside its plain version (K1 and K2 also on both
   wide scenes, and `torch.sort` of the keys at each layout), the eval render
   (projection + binning + render + clip, "chw") in frames per second (a
   chained device loop, and 100 calls eager and as replays of its CUDA
   graph, whose frame must equal the eager one bitwise), and
   a plain train step in ms, eagerly and as a graph replay (represent with
   the rows loss and with the image loss, QAT), against the all-PyTorch
   path's eager step, all with CUDA events;
6. the encoder: a 4-frame 1080p I420 clip (the bench scene, the same moved
   by a few pixels, then a cut to another seed's scene and its move),
   through `python -m gsvc_tpu_torch.drivers.represent` (10k splats,
   --is_rm --is_ad, K-frame detection), `drivers.compress` (QAT, rANS,
   `frame_N.gsvc`) and `decode`, each by its `main`, the fits and the
   renders on CUDA graphs. It fails unless every CLI returns 0, K_frames.txt starts with 1
   and leaves a P-frame, every fit beats its starting render's PSNR, no
   budget overflow is reported, the bitstream trailers match K_frames.txt,
   each decoded PSNR is within 0.1 dB of the compress stage's, the fits
   replayed graphs, and the launch counts of K1-K6 over the three CLIs are
   the eager encoder's (`ENCODER_LAUNCHES`); it prints per-frame fit
   seconds, QAT ms a step, eval fps and bpp, each CLI's fit and render
   graph captures,
   capture seconds, replays and peak device memory, and each coded frame's
   sha256 beside the eager encoder's (`ENCODER_SHA256`, equal or not);
7. the profiling path (`gsvc_tpu_torch.scripts`): the harnesses' kernels
   against their plain versions (P1's K4 variants within max-abs 1e-4 and
   within 1e-4 of the plain render's largest entry, which must not be 0,
   P5's job-based backward C and D and K6's two pixel splits F and G
   within 1e-4 of K6's slots, F, which is K6's kernel, bitwise equal to
   K6, P6's transposes exactly), timed, then the
   six harnesses' mains (P3, P2, P4, P1, P6, P5) at 1080p/10k with a few
   repetitions a stage;
8. a reduced RD point (`scripts.run_rd_point.run_point`, the RD ladder's
   point): RD_FRAMES frames of its synthetic 1080p clip (a pan of 8 px a
   frame) at RD_N splats, the represent (4000 its a frame, the removal
   threshold, where P-frames keep the K-frame's count, as phase 6; K-frame
   detection at the driver's defaults), compress (300 its) and decode
   CLIs. It fails unless every frame decodes within 0.1 dB of its encoder
   PSNR, the stream holds a P-frame, no CLI reports a budget overflow and
   K1-K6 all launched; it prints
   seconds a frame, the decoder's frames/s and each CLI's peak memory;
9. wide RD points: phase 8's point at WIDE_N splats and RD_WIDE_FRAMES
   frames at 1920x1080 (int32 wide keys) and at 3840x2160 (int64), each
   with phase 8's checks, failing unless every frame kept at least 65,536
   splats (so the fits, the decoder and their K1 / K2 ran on wide keys);
   each prints the key layout, the eval fps, seconds a frame and each
   CLI's peak memory;
10. the tile-sharded trainer (`parallel/sharded.py`), its ranks spawned by
   `parallel.launch` (gloo), SHARD_RANKS of them sharing the card:
   (a) K4 rows / image, K5 and K6 at every tile-row span of 2, 3 and 4
   shards of the bench scene (68 tile rows; the last spans partial or
   wholly past the grid): bitwise the same rows of the full-grid launch
   (K6: the slots of a full-grid K6 whose gradient is zero outside the
   span, so every other slot is 0), zero past the image, within 1e-4 of
   their plain versions, two launches bitwise equal, the per-splat
   gradients summed over the spans within 1e-4 of the whole grid's; K4
   rows and image, K5 and K6 timed at the first span of 2 shards; (b)
   phase 4's removal-control fit through `fit_frame_sharded` and 5
   adaptive-control steps through `make_sharded_train_step`, (c) a
   SHARD_QAT_ITERS QAT fit through `fit_compress_sharded`: the ranks'
   final states bitwise equal, PSNR within PSNR_TOL_DB of the
   single-process fit with graph=False, no overflow; prints the sharded
   step ms (eager) beside the single process's eager step and the step's
   all_reduce alone; (d) SHARD_CLI_FRAMES frames of phase 6's clip through
   the represent (SHARD_CLI_ITERS its, --is_rm), compress and decode CLIs
   at --tile_shards 2 (the ranks the CLI's main() spawns, launched here
   with a deadline so that each returns its launch counts) and at 1
   (main()): every CLI returns 0, the sharded CLIs
   write the unsharded ones' files (rank 0 alone writes), each decoded
   PSNR within 0.1 dB of its compress PSNR and the sharded and unsharded
   PSNR a frame within 0.1 dB; prints bpp, PSNR and seconds a frame;
11. multi-host GOP parallelism (`parallel/multihost.py`, `--hosts N`): the
   intersection budget first: K3 over the same lanes padded to longer rows
   (measured: its sums move with the length, which is why each GOP starts
   from the default budget), and phase 4's fit at two budgets that both
   hold it (checked: bitwise equal); then the represent CLI on phase 6's
   clip at --budget_factor MH_OVER_FACTOR, MH_OVER_ITERS its, as one host
   process and as MH_HOSTS (checked: both runs drop the same fits for
   overflowing their budget, and each GOP's first dropped fit overflowed
   the starting budget, so the single host started GOP 2 from it again
   after GOP 1 had raised it; the split bitwise the single host's); then
   phase 6's
   clip with its K-frames pinned to 1 and 3 (two GOPs), --is_rm --is_ad at
   MH_ITERS its (where K- and P-frames keep the count the delta compress
   needs), through the represent CLI as one host process and as MH_HOSTS
   host processes sharing the card, their barriers a torch.distributed
   gloo group (GSVC_COORDINATOR on 127.0.0.1; `scripts.
   measure_multihost_scaling.run_hosts`), then the compress CLI (QAT_ITERS)
   at --hosts 1 and at --hosts MH_HOSTS with file markers, worker first
   (each host its main()), then the decoder on the merged streams. It fails
   unless every host returns 0, each claimed a GOP, the merged checkpoints,
   num_gaussian_points.txt, the timing-stripped Frame_ lines and every
   frame_N.gsvc equal the single host's bitwise (`artifact_differences`),
   every frame decodes within 0.0001 dB of the encoder's PSNR and each host
   process launched K1-K6; prints the wall time of each run;
12. the 3D pipeline (`scene3d`: N gaussians in a camera's frustum covering
   W x H, SH degree PIPE_DEGREE, a background and the alpha output):
   project_gaussians -> spherical_harmonics -> rasterize_gaussians_alpha
   (depth-ordered uncapped binning through K1 / K2, A1) -> an L2 loss ->
   A2 and K3 -> gradients in means3d, scales, quats, the SH coefficients and
   opacity; K1, K2, A1, A2 and K3 must launch and every gradient be finite.
   A1 is held to the plain version (gsvc_tpu's scan, chunk ALPHA_CHUNK) at
   C = 3, at C = 5, on a dense variant (3x the footprints at opacity 1,
   where pixels break and tiles hold ~170 lanes) and on a wide one (6x the
   footprints at 1/20 the opacity, where thousands of tiles hold more than
   256 lanes, A1's and A2's staged batch, and must): max-abs RENDER_TOL on
   every pixel but those whose T_final lies within NEAR_BREAK x 1e-4 of
   the break on either side (a log-sum against a product can flip the
   break there; counted and printed with their errors). A2's slots and
   v_background are held to its plain version (`alpha_backward_torch`) on
   the same full-size inputs, the scene and both variants, within GRAD_TOL
   of the largest entry; and A2 through K3 to autograd through the scan at
   PIPE_SMALL (the scene and its dense variant, GRAD_TOL of the largest
   entry), the whole pipeline's gradients to the plain backend's there;
   two launches of A1 and of A2 bitwise equal; `project_gaussians_2d_scale_rot` at 1080p/10k through the eval
   render (K1, K2, K5) within RENDER_TOL of the plain render. Times A1 and
   A2 beside their plain (dense per-tile) versions and their bounds
   (`utils.work.alpha_work` on this run's evaluated pairs).

Around each of phases 3 and 4, around each CLI of phase 6, around the
mains of phase 7, around each point of phases 8 and 9, around each of
phase 10's fits and CLIs (in each rank), around each host of phase 11
and around phase 12's path and its scale + rotation render,
every launch counter is zeroed just before and read just after (a host
process starts at 0); each kernel of that path must have launched. The
kernels' JSON reports phase 6's counts for K1-K6, those of phase 9's
point on the same grid for K1 and K2 on wide keys (1080p: int32, 4K UHD:
int64), phase 7's for the harnesses' kernels, phase 10b's (rank 0) for K4 rows / image and K6 at the
2-shard span and phase 12's path for A1 and A2, and each kernel's bound (`utils.work`,
`utils.profiling.roofline_ms`) and library call (null where no single
PyTorch call computes the same function; for K2, the `searchsorted` of its
tile edges).

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile

runs phases 0 and 1, then profiles the represent and QAT train steps, run
eagerly and as graph replays (`profile_steps`: host and device ms a step,
launches, device idle share, the top device and host ops) and exits
without the smoke's checks.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H, W, N = 1080, 1920, 10000
RENDER_TOL = 1e-4
GRAD_TOL = 1e-4  # max-abs error over the largest entry of the plain result
TRAIN_ITERS = 300
STEP_REPS = 40  # phase 5: timed steps, eager and replayed
PROFILE_ITERS = 10  # phase 7: timed repetitions of each harness stage
DECODE_FRAMES = 16  # phase 3's stream
RD_N, RD_FRAMES = 20000, 3  # phase 8's RD point
# phase 10: the tile-sharded trainer's ranks (gloo, sharing the card), the
# shard counts of its span checks, its QAT fit's and its CLIs' cut
SHARD_RANKS, SPAN_SHARDS = 2, (2, 3, 4)
SHARD_QAT_ITERS, SHARD_CLI_FRAMES, SHARD_CLI_ITERS = 300, 2, 1000
PSNR_TOL_DB = 0.05  # a sharded fit against the single-process one
# phase 11: the hosts sharing the card, and the represent its of its clip
MH_HOSTS, MH_ITERS = 2, 4000
# and its represent run that overflows its starting budget in each GOP
# (max(2 N, 4 tiles) = 32,768 at 1080p/10k: in 500 its the K-frames stay
# under it, the --is_ad P-frames pass it)
MH_OVER_FACTOR, MH_OVER_ITERS = 2, 500
# phases 2, 5 and 9: splats past 65,535, whose keys have a 17-bit gauss
# field (int32 at 1080p, int64 at 4K UHD), phase 9's frames at each grid,
# and the small cap phase 2 also holds K2 to on those keys
WIDE_N, WIDE_GRIDS, RD_WIDE_FRAMES = 100000, ((1080, 1920), (2160, 3840)), 2
WIDE_CAP = 4
# phase 6's kernel launches and coded frames as the eager encoder made them
# (`python -m gsvc_tpu_torch.scripts.encoder_drift --eager`: every fit step
# and render eager, the same CLIs and seed): the graphs must launch the same
# kernels; the bytes are compared and printed
ENCODER_LAUNCHES = {"fill_decode_keys": 18487, "rank_cap_decode": 18487,
                    "forward_rows": 17660, "backward_slots": 17660,
                    "segmented_cumsum": 17660, "forward_chw": 808, "forward_image": 19}
ENCODER_SHA256 = ("8e76cbd280e9cef0", "40c8b44f5d5a4e3d", "afe1be16eebdc54a",
                  "0ac06a4d66f84cbc")
# phase 12: the 3D pipeline's SH degree, the cut size (H, W, N) of A2's check
# against plain autograd, the plain scan's chunk on the card ([64, H*W]
# intermediates) and how near 1e-4 a pixel's T_final lies when its break
# decision is within rounding (relative)
PIPE_DEGREE, PIPE_SMALL, ALPHA_CHUNK, NEAR_BREAK = 3, (272, 480, 2000), 64, 1e-3
LIBS = ("fill", "segsum", "rasterize_fwd", "rasterize_bwd", "profile_kernel_parts",
        "profile_bwd_variants", "probe_transpose", "rasterize_alpha")
NATIVE = ("rans", "yuv")  # host C++ (gsvc_tpu_torch/native), built with g++


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def errors(got, want):
    """(max-abs error, max-abs error over the largest entry of want)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def same_fit(torch, a, b) -> bool:
    """Whether two represent or QAT states are bitwise equal: their host
    counters and every tensor they hold (parameters, mask, moments, loss,
    best loss or PSNR, patience, snapshots)."""
    from gsvc_tpu_torch.utils.profiling import tensors

    host = ("it", "lr_frozen", "grace")
    if [getattr(a, k, None) for k in host] != [getattr(b, k, None) for k in host] \
            or (a.opt.step, a.opt.fresh) != (b.opt.step, b.opt.fresh):
        return False
    def held(s):  # a represent state's splats are a module's parameters
        params = s.params.parameters() if isinstance(s.params, torch.nn.Module) else ()
        return [*params, *tensors(s)]

    ta, tb = held(a), held(b)
    return len(ta) == len(tb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def plain_step_ms(torch, dev, plan, state, reps: int):
    """(eager ms, replay ms) of a plain step of `plan` (`utils.graphs.FitPlan`),
    whose first step is `state`'s next: that step and one more eagerly, then
    CUDA events around `reps` eager steps, then around `reps` replays of the
    step's graph after its warm-up and capture."""
    from gsvc_tpu_torch.utils import graphs

    box = [plan.step(plan.step(state))]

    def timed(fn) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def eager():
        box[0] = plan.step(box[0])

    eager_ms = timed(eager)
    with graphs.StepGraph(dev) as run:
        def replay():
            s = box[0]
            box[0] = run(lambda: plan.step(s), lambda: plan.after_plain(s))

        for _ in range(graphs.WARMUP + 1):
            replay()
        replay_ms = timed(replay)
    return eager_ms, replay_ms


def encoder_phase(torch, smi, counters, clip, tmp: Path) -> dict:
    """Phase 6: the 4-frame clip through `drivers.represent`,
    `drivers.compress` and `decode` (each CLI's `main`, with the arguments
    of `scripts.encoder_drift.Run`), checked; returns the launch counts
    summed over the three CLIs."""
    import contextlib
    import hashlib
    import io

    from gsvc_tpu_torch import decode as decode_cli
    from gsvc_tpu_torch.compress.bitstream import frame_type
    from gsvc_tpu_torch.drivers import compress as compress_cli
    from gsvc_tpu_torch.drivers import represent as represent_cli
    from gsvc_tpu_torch.io import process_yuv_video
    from gsvc_tpu_torch.models.represent import render_frame
    from gsvc_tpu_torch.utils.graphs import RenderGraph, StepGraph
    from gsvc_tpu_torch.scripts.encoder_drift import (
        ENC_ITERS,
        QAT_ITERS,
        Run,
        train_lines,
        write_yuv,
    )

    yuv = tmp / "clip.yuv"
    write_yuv(clip, yuv)
    n_frames = len(clip)
    run = Run(yuv, tmp, H, W, N, n_frames)
    clis = [
        ("represent", represent_cli.main, run.represent,
         ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
          "segmented_cumsum", "forward_chw")),
        ("compress", compress_cli.main, run.compress,
         ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
          "segmented_cumsum", "forward_chw")),
        ("decode", decode_cli.main, run.decode,
         ("fill_decode_keys", "rank_cap_decode", "forward_image")),
    ]
    total = {c.__name__: 0 for c in counters}
    graph = StepGraph
    for name, main, argv, needed in clis:
        err = io.StringIO()
        for c in counters:
            c.launches = 0
        graph.captures, graph.replays, graph.capture_seconds = 0, 0, 0.0
        RenderGraph.captures, RenderGraph.replays, RenderGraph.capture_seconds = 0, 0, 0.0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches = {c.__name__: c.launches for c in counters}
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"{name} returned {rc}")
        if "overflow" in err.getvalue():  # a compress WARNING or a represent refit
            fail(f"{name} reported an intersection budget overflow")
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched by {name}: {missing}; launches {launches}")
        if name != "decode" and graph.replays == 0:
            fail(f"{name}: no fit replayed a CUDA graph")
        if RenderGraph.replays == 0:
            fail(f"{name}: no render replayed a CUDA graph")
        for k, v in launches.items():
            total[k] += v
        print(f"phase 6 {name}: {secs:.2f} s; fits: {graph.captures} graph captures in "
              f"{graph.capture_seconds:.3f} s, {graph.replays} replays; renders: "
              f"{RenderGraph.captures} captures in {RenderGraph.capture_seconds:.3f} s, "
              f"{RenderGraph.replays} replays; peak device memory {peak_gb:.2f} GiB; "
              f"launches {launches}")
    if total != ENCODER_LAUNCHES:
        fail(f"phase 6 launches {total}, the eager encoder's {ENCODER_LAUNCHES}")

    k_frames = [int(x) for x in run.k_frames.read_text().split()]
    if k_frames[0] != 1 or len(k_frames) >= n_frames:
        fail(f"K_frames.txt {k_frames}: want frame 1 first and a P-frame")
    for f in range(1, n_frames + 1):
        want = "K" if f in k_frames else "P"
        got = frame_type((run.bitstream / f"frame_{f}.gsvc").read_bytes())
        if got != want:
            fail(f"frame {f}: bitstream trailer {got}, K_frames.txt says {want}")
    rep, enc = train_lines(run.rep_log), train_lines(run.qat_log)
    dec = train_lines(tmp / "decoded" / "decode.txt")
    if not (sorted(rep) == sorted(enc) == sorted(dec) == list(range(1, n_frames + 1))):
        fail(f"frames logged: represent {sorted(rep)}, compress {sorted(enc)}, "
             f"decode {sorted(dec)}")

    # each frame's fit must beat the render it started from: the trainer the
    # driver built (same seed; a P-frame warm-starts from the checkpoint)
    args = represent_cli.parse_args(run.represent)
    frames = process_yuv_video(str(yuv), W, H)
    gmodels = compress_cli.load_gmodels(str(run.npz))
    counts = {int(a.split("_")[1]): int(b) for a, b in (
        ln.split(":") for ln in run.counts.read_text().splitlines())}
    init_psnr = {}
    for f in range(1, n_frames + 1):
        is_k = f in k_frames
        tr = represent_cli.SimpleTrainer2d(
            frames[f - 1], f, num_points=N if is_k else counts[f - 1],
            max_num_points=N, iterations=ENC_ITERS, args=args,
            Trained_Model=None if is_k else gmodels[f"frame_{f - 1}"],
            isdensity=not is_k, isremoval=is_k, removal_rate=args.removal_rate,
            seed=args.seed)
        img = render_frame(tr.state.params, tr.state.alive, tr.cfg)
        init_psnr[f] = float(10.0 * torch.log10(1.0 / torch.mean((img - tr.gt) ** 2)))
        if not rep[f]["PSNR"] > init_psnr[f]:
            fail(f"frame {f}: fitted PSNR {rep[f]['PSNR']} <= initial {init_psnr[f]:.4f}")
        if abs(dec[f]["PSNR"] - enc[f]["PSNR"]) >= 0.1:
            fail(f"frame {f}: decoded PSNR {dec[f]['PSNR']} vs encoder {enc[f]['PSNR']}")
    sha = [hashlib.sha256((run.bitstream / f"frame_{f}.gsvc").read_bytes()).hexdigest()[:16]
           for f in range(1, n_frames + 1)]
    print(f"phase 6 encoder [{smi}]: {W}x{H}, {N} splats, {n_frames} frames, K-frames "
          f"{k_frames}; splats kept {counts}; launches of K1-K6 the eager encoder's; coded "
          f"frames' sha256 {sha}: " + ("the eager encoder's" if tuple(sha) == ENCODER_SHA256
                                       else f"differ from the eager encoder's {ENCODER_SHA256}"))
    for f in range(1, n_frames + 1):
        print(f"phase 6 frame {f} [{smi}]: {'K' if f in k_frames else 'P'}; represent "
              f"{ENC_ITERS} its {rep[f]['Training']:.2f} s, PSNR {init_psnr[f]:.3f} -> "
              f"{rep[f]['PSNR']:.4f} dB, eval {rep[f]['FPS']:.1f} fps; QAT {QAT_ITERS} its "
              f"{enc[f]['Training']:.2f} s = {1e3 * enc[f]['Training'] / QAT_ITERS:.2f} "
              f"ms/step, PSNR {enc[f]['PSNR']:.4f} dB, bpp {enc[f]['bpp']:.4f}, eval "
              f"{enc[f]['FPS']:.1f} fps; decoded PSNR {dec[f]['PSNR']:.4f} dB")
    return total


def rd_point_phase(torch, smi, counters, tmp: Path, phase: int, n: int, frames: int,
                   min_kept: int = 0, width: int = W, height: int = H) -> dict:
    """Phases 8 and 9: a reduced RD point of `n` splats and `frames` frames
    of width x height through `run_rd_point.run_point` (its three CLIs),
    checked: every frame decoded within the point's tolerance of its
    encoder PSNR, a P-frame in the stream, no budget overflow reported,
    K1-K6 launched, every frame keeping at least `min_kept` splats. Returns
    the point's launches."""
    import contextlib
    import io

    from gsvc_tpu_torch.ops.fill_cuda import key_layout
    from gsvc_tpu_torch.scripts import run_rd_point as rd
    from gsvc_tpu_torch.scripts.encoder_drift import ENC_ITERS, QAT_ITERS

    err = io.StringIO()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        point = rd.run_point(tmp, frames, n, ENC_ITERS, QAT_ITERS, width=width,
                             height=height)
    secs = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if "overflow" in err.getvalue():  # a compress WARNING or a represent refit
        fail(f"the RD point of phase {phase} reported an intersection budget overflow")
    launches = {c.__name__: c.launches for c in counters}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched by the RD point of phase {phase}: {missing}; "
             f"launches {launches}")
    if point["max_decode_gap_db"] >= rd.DECODE_TOL_DB:
        fail(f"RD point of phase {phase}: decoded PSNR {point['frame_decoded_psnr']} vs "
             f"encoder {point['frame_psnr']} (tol {rd.DECODE_TOL_DB} dB)")
    if len(point["k_frames"]) >= frames:
        fail(f"RD point of phase {phase}: K-frames {point['k_frames']}, no P-frame")
    if len(point["splats_kept"]) != frames or min(point["splats_kept"]) < min_kept:
        fail(f"RD point of phase {phase}: splats kept {point['splats_kept']}, want "
             f"{frames} frames of at least {min_kept}")
    layout = key_layout(((width + 15) // 16) * ((height + 15) // 16), n)
    print(f"phase {phase} RD point [{smi}]: {width}x{height}, {n} splats (keys: a "
          f"{layout.gauss_bits}-bit gauss field, {str(layout.dtype)[6:]}), {frames} "
          f"frames, {ENC_ITERS} + {QAT_ITERS} its, K-frames {point['k_frames']}, splats kept "
          f"{point['splats_kept']}: bpp {point['frame_bpp']}, PSNR {point['frame_psnr']}, "
          f"decoded {point['frame_decoded_psnr']} (max gap {point['max_decode_gap_db']:.4f} "
          f"dB); represent {point['represent_s_per_frame']:.2f} s a frame, QAT "
          f"{point['qat_s_per_frame']:.2f} s a frame; eval fps represent "
          f"{point['represent_eval_fps']:.1f}, QAT {point['qat_eval_fps']:.1f}; decoder "
          f"{point['decode_fps']:.2f} frames/s; peak GiB {point['peak_gib']}, allocated "
          f"at start and end {point['held_gib']}; CLI seconds "
          f"{point['cli_seconds']}; {secs:.2f} s in all; launches {launches}")
    return launches


def timed_row(smi, phase, name, src, replaces, counter, err, kern, plain, work,
              library=None) -> dict:
    """A kernel's entry of the kernels JSON: kern() and plain() timed alone
    (CUDA events behind a spin kernel), library() where one PyTorch call
    computes the same function, and the bound of `work` (bytes, ops).
    `launches` holds the counter's name until the path's run fills it."""
    from gsvc_tpu_torch.utils.profiling import event_ms, roofline_ms

    ms = event_ms(kern, 50)
    plain_ms = event_ms(plain, 3)
    library_ms = event_ms(library, 50) if library is not None else None
    bound_ms, bound_by = roofline_ms(*work)
    print(f"phase {phase} time [{smi}]: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f} %), library "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counter, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def profiling_phase(torch, dev, smi, sc, v_rows, counters) -> list:
    """Phase 7: the new kernels of the profiling harnesses against their
    plain versions at 1080p/10k, timed; then the six harnesses' mains with
    every launch counter zeroed just before and read just after. P1's
    variants must be within max-abs RENDER_TOL and within RENDER_TOL of the
    plain render's largest entry, which must not be 0 (no_acc's output is
    ~1e-5, so max-abs alone would pass a kernel that writes zeros). P5's C,
    D, F and G must be within GRAD_TOL of K6's slots, A exactly and B, E
    within GRAD_TOL of their plain versions; P6's transposes exact. Returns
    the new kernels' JSON entries."""
    from gsvc_tpu_torch.ops import rasterize_cuda
    from gsvc_tpu_torch.scripts import probe_transpose as p6
    from gsvc_tpu_torch.scripts import profile_bwd_chain as p4
    from gsvc_tpu_torch.scripts import profile_bwd_variants as p5
    from gsvc_tpu_torch.scripts import profile_fwd_chain as p2
    from gsvc_tpu_torch.scripts import profile_kernel_parts as p1
    from gsvc_tpu_torch.scripts import profile_micro_ops as p3
    from gsvc_tpu_torch.utils import work

    rargs, geom = sc.rargs, (sc.H, sc.W, sc.tb)
    kernels = []
    with torch.no_grad():
        valid = {v: work.gated_pairs(sc, v) for v in p1.VARIANTS}
        for v, wrapper in p1.FORWARD_PARTS.items():
            got, want = wrapper(*rargs), p1.render_parts_torch(v, *rargs)
            err, rel = errors(got, want)
            largest = float(want.abs().max())
            if not (torch.isfinite(got).all() and largest > 0.0 and err <= RENDER_TOL
                    and rel <= RENDER_TOL):
                fail(f"P1 {v}: max-abs {err}, rel {rel} (tol {RENDER_TOL} each) against "
                     f"its plain version, whose largest entry is {largest}")
            print(f"phase 7 P1 {v}: max-abs {err:.3g}, rel {rel:.3g} against its plain "
                  f"version (largest entry {largest:.4g}; tol {RENDER_TOL} each)")
            kernels.append(timed_row(
                smi, 7, f"P1 forward_parts {v}", "gsvc_tpu_torch/csrc/profile_kernel_parts.cu",
                "scripts/profile_kernel_parts.py:52", wrapper.__name__, err,
                lambda w=wrapper: w(*rargs), lambda v=v: p1.render_parts_torch(v, *rargs),
                work.parts_work(v, sc, valid[v])))
        jobs = p5.build_jobs(sc.binned)
        bargs = (*rargs[:5], v_rows, *geom)
        k6 = rasterize_cuda.backward_slots(*bargs, 16, 16, 256, "rows")
        for v, wrapper in p5.BACKWARD_JOBS.items():
            got = wrapper(*bargs, jobs)
            plain = p5.backward_jobs_torch(v, *bargs, jobs)
            err, rel = errors(got, k6 if v in p5.K6_FUNCTION else plain)
            ok = torch.equal(got, plain) if v == "A" else rel <= GRAD_TOL
            if v == "F" and not torch.equal(got, k6):
                fail("P5 F, K6's own kernel and split, differs from K6")
            if not (torch.isfinite(got).all() and ok):
                fail(f"P5 {v}: max-abs {err}, rel {rel} against "
                     + ("K6's slots" if v in p5.K6_FUNCTION else "its plain version"))
            kernels.append(timed_row(
                smi, 7, f"P5 backward_jobs {v}", "gsvc_tpu_torch/csrc/profile_bwd_variants.cu",
                "scripts/profile_bwd_variants.py:109", wrapper.__name__, err,
                lambda w=wrapper: w(*bargs, jobs),
                lambda v=v: p5.backward_jobs_torch(v, *bargs, jobs),
                work.jobs_work(v, sc, jobs.tile.shape[0], valid["full"])))
        for name, x in p6.probe_inputs(sc, dev).items():
            if not torch.equal(p6.transpose_last2(x), p6.transpose_last2_torch(x)):
                fail(f"P6 transpose {name} differs from x.transpose(-1, -2)")
            kernels.append(timed_row(
                smi, 7, f"P6 transpose {name}", "gsvc_tpu_torch/csrc/probe_transpose.cu",
                "scripts/probe_mxu_transpose.py:" + ("79" if x.dim() == 3 else "32"),
                "transpose_last2", 0.0, lambda x=x: p6.transpose_last2(x),
                lambda x=x: p6.transpose_last2_torch(x), (8 * x.numel(), 0),
                library=lambda x=x: p6.transpose_last2_torch(x)))
        k4_rows = rasterize_cuda.forward_rows(*rargs)
        planar = p6.rows_to_chw(k4_rows, *geom)
        if not (torch.equal(planar, p6.rows_to_chw_torch(k4_rows, *geom))
                and torch.equal(planar, rasterize_cuda.forward_chw(*rargs))):
            fail("P6 rows_to_chw differs from its plain version or from K5")
        kernels.append(timed_row(
            smi, 7, "P6 rows_to_chw", "gsvc_tpu_torch/csrc/probe_transpose.cu",
            "scripts/probe_mxu_transpose.py:71", "rows_to_chw", 0.0,
            lambda: p6.rows_to_chw(k4_rows, *geom),
            lambda: p6.rows_to_chw_torch(k4_rows, *geom),
            (work.rows_bytes(sc) + 12 * sc.H * sc.W, 0)))

    new = [*p1.FORWARD_PARTS.values(), *p5.BACKWARD_JOBS.values(), p6.transpose_last2,
           p6.rows_to_chw]
    every = list(counters) + new
    for c in every:
        c.launches = 0
    t0 = time.perf_counter()
    for mod in (p3, p2, p4, p1, p6, p5):
        rc = mod.main(["--iters", str(PROFILE_ITERS)])
        if rc != 0:
            fail(f"{mod.__name__} returned {rc}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in every}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched on the profiling path: {missing}; launches {launches}")
    for k in kernels:
        k["launches"] = launches[k["launches"]]
    print(f"phase 7 profiling path: the six harnesses in {secs:.2f} s; launches {launches}")
    return kernels


def profile_steps(np, torch, dev, smi) -> None:
    """`--profile`: where a train step's time goes at 1080p/10k, for the
    represent step (removal control, rows L2, from `init_splats`) and the
    QAT step (K-frame mode, the bench scene as its checkpoint, the compress
    CLI's budget), each fitting the bench scene's render, as the fits
    run them: eagerly (graph=False) and as replays of the step's CUDA graph.

    Per step: host enqueue and synced ms over 50 chained steps on the host
    clock, then torch.profiler over 20 more (`utils.profiling.profile_device`:
    device busy sums device-side events only). Device idle = 1 - busy /
    synced step."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import CHOLESKY_BOUND
    from gsvc_tpu_torch.models import compress
    from gsvc_tpu_torch.models.represent import fit_plan, init_train_state
    from gsvc_tpu_torch.ops.binning import default_max_intersects
    from gsvc_tpu_torch.scripts.common import bench_scene
    from gsvc_tpu_torch.scripts.encoder_drift import render_scene
    from gsvc_tpu_torch.utils import graphs
    from gsvc_tpu_torch.utils.profiling import device_events, launches, profile_device

    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    means, L, colors, opacity = bench_scene(N, dev)
    gt = render_scene(means, L, colors, opacity, H, W, tb)
    # control every 1000th step: the 130-odd steps below are step 1 and plain steps
    rcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=10**6,
                       isremoval=True, densification_interval=1000)
    qcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=999,
                       max_intersects=default_max_intersects(N, tb[0] * tb[1], factor=32))
    gmodel = {"_xyz": np.arctanh(means.cpu().numpy()),
              "_cholesky": L.cpu().numpy() - np.float32(CHOLESKY_BOUND),
              "_features_dc": colors.cpu().numpy()}

    def represent():
        state = init_train_state(rcfg, generator=torch.Generator().manual_seed(0), device=dev)
        return fit_plan(state, gt, 999, rcfg), state

    def qat():  # step 1 runs k-means
        state = compress.init_compress_state(gmodel, None, dev)
        return compress.qat_plan(state, gt, qcfg, torch.Generator().manual_seed(0)), state

    for name, make in (("represent step (removal control, rows L2)", represent),
                       ("QAT step (K-frame)", qat)):
        for how in ("eager", "graph"):
            plan, state = make()
            state = plan.step(state)
            with graphs.StepGraph(dev) if how == "graph" else graphs.Eager() as run:
                box = [state]

                def once(plan=plan, run=run, box=box):
                    s = box[0]
                    box[0] = run(lambda: plan.step(s), lambda: plan.after_plain(s))

                for _ in range(graphs.WARMUP + 1):
                    once()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    once()
                enqueue_ms = (time.perf_counter() - t0) / 50 * 1e3
                torch.cuda.synchronize()
                synced_ms = (time.perf_counter() - t0) / 50 * 1e3
                busy_ms, events = profile_device(once, 20)
            device = device_events(events)
            print(f"profile [{smi}]: {name}, {how}: host enqueue {enqueue_ms:.4f} ms, synced "
                  f"{synced_ms:.4f} ms a step; device busy {busy_ms:.4f} ms over "
                  f"{sum(e.count for e in device) / 20:.1f} device events and "
                  f"{launches(events) / 20:.1f} kernel launches a step; device idle "
                  f"{100 * (1 - busy_ms / synced_ms):.1f} %")
            for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
                print(f"profile   device {e.key[:64]:64s} {e.self_device_time_total / 20:9.1f} "
                      f"us x{e.count / 20:.1f} a step")
            for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]:
                print(f"profile   host {e.key[:64]:64s} {e.self_cpu_time_total / 20:9.1f} "
                      f"us x{e.count / 20:.1f} a step")


def _digest(torch, state) -> str:
    """sha256 of a represent or QAT state: its host counters and every
    tensor it holds (bitwise equality across ranks)."""
    import hashlib

    from gsvc_tpu_torch.utils.profiling import tensors

    h = hashlib.sha256(repr([getattr(state, k, None) for k in ("it", "lr_frozen", "grace")]
                            + [state.opt.step, sorted(state.opt.fresh.items())]).encode())
    params = state.params.parameters() if isinstance(state.params, torch.nn.Module) else ()
    for t in (*params, *tensors(state)):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def sharded_rank(rank: int, world_size: int, device: str = "cuda", size=(H, W, N),
                 iters=(TRAIN_ITERS, SHARD_QAT_ITERS)) -> dict:
    """Phase 10b and 10c in one rank (`parallel.launch`; every rank on
    cuda:0): the removal-control fit of phase 4 through
    `fit_frame_sharded`, the all_reduce of its step alone, 5 adaptive-control
    steps through `make_sharded_train_step`, then a SHARD_QAT_ITERS QAT fit
    through `fit_compress_sharded`, each with the launch counters zeroed
    just before and read just after. Returns digests, PSNRs, seconds and
    launches. (`device`, `size` (H, W, N) and `iters` shrink it to a
    rehearsal on the CPU.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import CHOLESKY_BOUND
    from gsvc_tpu_torch.models import compress
    from gsvc_tpu_torch.models.represent import init_train_state, render_frame
    from gsvc_tpu_torch.ops import rasterize_cuda
    from gsvc_tpu_torch.parallel import sharded
    from gsvc_tpu_torch.parallel.launch import rank_device
    from gsvc_tpu_torch.scripts.common import scene
    from gsvc_tpu_torch.utils import graphs

    H, W, N = size
    train_iters, qat_iters = iters
    dev = rank_device(rank, device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    sc = scene(N, H, W, dev)
    with torch.no_grad():
        gt = torch.clamp(rasterize_cuda.forward_image(*sc.rargs), 0.0, 1.0)
    mesh = sharded.tile_mesh(world_size)

    def psnr_of(img) -> float:
        return float(10.0 * torch.log10(1.0 / torch.mean((img - gt) ** 2)))

    def zero() -> None:
        for c in graphs.kernel_counters():
            c.launches = 0

    out = {}
    kcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=train_iters,
                       isremoval=True)
    state = init_train_state(kcfg, generator=torch.Generator().manual_seed(0), device=dev)
    psnr0 = psnr_of(render_frame(state.params, state.alive, kcfg))
    zero()
    sync()
    t0 = time.perf_counter()
    res = sharded.fit_frame_sharded(state, gt, kcfg, mesh,
                                    draws=torch.Generator(device=dev).manual_seed(1))
    sync()
    out["fit"] = {"seconds": time.perf_counter() - t0, "launches": graphs.launch_counts(),
                  "digest": _digest(torch, res.state), "psnr0": psnr0,
                  "psnr": psnr_of(res.image), "it": res.state.it,
                  "overflow": int(res.state.max_overflow),
                  "image": bool(res.image.shape == (H, W, 3)
                                and torch.isfinite(res.image).all())}
    # the step's all_reduce alone: loss, squared error and the 9 N gradients
    flat = torch.randn(2 + 9 * N, device=dev, generator=torch.Generator(dev).manual_seed(2))
    for _ in range(5):
        dist.all_reduce(flat)
    sync()
    t0 = time.perf_counter()
    for _ in range(50):
        dist.all_reduce(flat)
    sync()
    out["all_reduce_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    dcfg = FrameConfig(H=H, W=W, num_points=N * 9 // 10, max_num_points=N, iterations=5,
                       isdensity=True)
    step = sharded.make_sharded_train_step(mesh, dcfg,
                                           draws=torch.Generator(device=dev).manual_seed(4))
    states = [init_train_state(dcfg, generator=torch.Generator().manual_seed(3), device=dev)]
    zero()
    for _ in range(dcfg.iterations):
        states = step(states, gt[None])
    out["adaptive"] = {"digest": _digest(torch, states[0]),
                       "alive": int(states[0].alive.sum()),
                       "launches": graphs.launch_counts()}
    qcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=qat_iters)
    gmodel = {"_xyz": np.arctanh(sc.means.cpu().numpy()),
              "_cholesky": sc.L.cpu().numpy() - np.asarray(CHOLESKY_BOUND, np.float32),
              "_features_dc": sc.colors.cpu().numpy()}
    qstate = compress.init_compress_state(gmodel, None, dev)
    zero()
    sync()
    t0 = time.perf_counter()
    qstate = sharded.fit_compress_sharded(qstate, gt, qcfg, mesh,
                                          draws=torch.Generator().manual_seed(0))
    sync()
    out["qat"] = {"seconds": time.perf_counter() - t0, "launches": graphs.launch_counts(),
                  "digest": _digest(torch, qstate), "best_psnr": float(qstate.best_psnr),
                  "overflow": int(compress.compress_overflow(qstate, qcfg))}
    return out


def span_phase(torch, smi, sc, v_rows) -> list:
    """Phase 10a: K4 (rows, image), K5 and K6 at every span of SPAN_SHARDS
    shards of the bench scene's 68 tile rows: each equal to the same rows
    of the full-grid launch bitwise (K6's slots: those of a full-grid
    launch whose gradient is zero outside the span, so every other slot is
    0), within RENDER_TOL / GRAD_TOL of its plain version at the span, two
    launches bitwise equal; the per-splat gradients summed over a shard
    count's spans within GRAD_TOL of the full grid's. Then K4 rows and
    image, K5 and K6 timed at the first span of 2 shards. Returns the
    kernels JSON rows of K4 rows, K4 image and K6 at that span (launches:
    the counter's name)."""
    from gsvc_tpu_torch.ops import rasterize_cuda as rc
    from gsvc_tpu_torch.ops.rasterize_binned import span_height
    from gsvc_tpu_torch.utils import work

    tb_x, tb_y = sc.tb[0], sc.tb[1]
    r_out = rc.round8(3 * tb_x)
    rargs, geom = sc.rargs, (sc.H, sc.W, sc.tb, 16, 16, 256)
    bargs = (sc.binned, sc.xys, sc.conics, sc.colors, sc.opacity)
    gss = sc.binned.gauss_slot_start
    full = {"rows": rc.forward_rows(*rargs), "image": rc.forward_image(*rargs),
            "chw": rc.forward_chw(*rargs)}
    whole = rc.reduce_slot_grads(rc.backward_slots(*bargs, v_rows, *geom, layout="rows"), gss)
    extra = max(s * -(-tb_y // s) for s in SPAN_SHARDS) - tb_y  # span rows past the grid
    v_pad = torch.cat([v_rows, v_rows.new_zeros((extra * r_out, v_rows.shape[1]))])
    worst = {"fwd": 0.0, "k6": 0.0, "sum": 0.0}
    t0 = time.perf_counter()
    for shards in SPAN_SHARDS:
        rows_per = -(-tb_y // shards)
        summed = [torch.zeros_like(g) for g in whole]
        for i in range(shards):
            span = (i * rows_per, rows_per)
            row0, inside = span[0], max(0, min(rows_per, tb_y - span[0]))
            valid = max(0, min(span_height(span, tb_y, sc.H), sc.H - 16 * row0))
            rows = rc.forward_rows(*rargs, tile_rows=span)
            image = rc.forward_image(*rargs, tile_rows=span)
            chw = rc.forward_chw(*rargs, tile_rows=span)
            px = slice(16 * row0, 16 * row0 + valid)
            if not (torch.equal(rows[:inside * r_out],
                                full["rows"][row0 * r_out:(row0 + inside) * r_out])
                    and not rows[inside * r_out:].any()
                    and torch.equal(image[:valid], full["image"][px])
                    and not image[valid:].any()
                    and torch.equal(chw[:, :valid], full["chw"][:, px])
                    and not chw[:, valid:].any()):
                fail(f"K4 / K5 at the span {span} of {shards} shards differ from the same "
                     "rows of the full-grid launch")
            for layout, got in (("rows", rows), ("image", image), ("chw", chw)):
                plain = rc.rasterize_forward_torch(*rargs, layout=layout, tile_rows=span)
                err = errors(got, plain)[0]
                worst["fwd"] = max(worst["fwd"], err)
                if not (torch.isfinite(got).all() and err <= RENDER_TOL):
                    fail(f"{layout} at the span {span}: max-abs {err} against its plain "
                         "version")
            v_span = v_pad[row0 * r_out:(row0 + rows_per) * r_out]
            slots = rc.backward_slots(*bargs, v_span, *geom, layout="rows", tile_rows=span)
            v_masked = torch.zeros_like(v_rows)
            v_masked[row0 * r_out:(row0 + inside) * r_out] = \
                v_rows[row0 * r_out:(row0 + inside) * r_out]
            if not torch.equal(slots, rc.backward_slots(*bargs, v_masked, *geom,
                                                        layout="rows")):
                fail(f"K6 at the span {span} of {shards} shards differs from the full-grid "
                     "K6 of the span's gradient")
            rel = errors(slots, rc.rasterize_backward_torch(*bargs, v_span, *geom,
                                                            layout="rows", tile_rows=span))[1]
            worst["k6"] = max(worst["k6"], rel)
            if not (torch.isfinite(slots).all() and rel <= GRAD_TOL):
                fail(f"K6 at the span {span}: rel {rel} against its plain version")
            for name, launch in (
                    ("K4 rows", lambda: rc.forward_rows(*rargs, tile_rows=span)),
                    ("K5", lambda: rc.forward_chw(*rargs, tile_rows=span)),
                    ("K6", lambda: rc.backward_slots(*bargs, v_span, *geom, layout="rows",
                                                     tile_rows=span))):
                if not torch.equal(launch(), launch()):
                    fail(f"{name} at the span {span}: two launches differ")
            for acc, g in zip(summed, rc.reduce_slot_grads(slots, gss)):
                acc += g
        for name, got, want in zip(("xys", "conics", "colors", "opacity"), summed, whole):
            rel = errors(got, want)[1]
            worst["sum"] = max(worst["sum"], rel)
            if rel > GRAD_TOL:
                fail(f"per-splat {name} gradients summed over {shards} spans: rel {rel}")
    print(f"phase 10a spans: K4 rows / image, K5 and K6 at every span of {SPAN_SHARDS} "
          f"shards ({tb_y} tile rows) bitwise the full-grid launch's rows, zero past the "
          f"image and the grid, two launches bitwise equal; max-abs against the plain "
          f"versions {worst['fwd']:.3g} (tol {RENDER_TOL}), K6 rel {worst['k6']:.3g}, "
          f"per-splat grads summed over the spans rel {worst['sum']:.3g} (tol {GRAD_TOL}); "
          f"{time.perf_counter() - t0:.2f} s")
    span = (0, -(-tb_y // 2))
    swork = work.span_work(sc, work.gated_pairs(sc, tile_rows=span), span)
    v_span = v_rows[:span[1] * r_out]
    rows = []
    for name, counter, kern, plain in (
            ("K4 forward rows", "forward_rows",
             lambda: rc.forward_rows(*rargs, tile_rows=span),
             lambda: rc.rasterize_forward_torch(*rargs, layout="rows", tile_rows=span)),
            ("K4 forward image", "forward_image",
             lambda: rc.forward_image(*rargs, tile_rows=span),
             lambda: rc.rasterize_forward_torch(*rargs, layout="image", tile_rows=span)),
            ("K5 forward chw", "forward_chw",
             lambda: rc.forward_chw(*rargs, tile_rows=span),
             lambda: rc.rasterize_forward_torch(*rargs, layout="chw", tile_rows=span)),
            ("K6 backward", "backward_slots",
             lambda: rc.backward_slots(*bargs, v_span, *geom, layout="rows", tile_rows=span),
             lambda: rc.rasterize_backward_torch(*bargs, v_span, *geom, layout="rows",
                                                 tile_rows=span))):
        src = "gsvc_tpu_torch/csrc/" + ("rasterize_bwd.cu" if name.startswith("K6")
                                        else "rasterize_fwd.cu")
        line = {"K4": "428", "K5": "523", "K6": "676"}[name[:2]]
        row = timed_row(smi, 10, f"{name}, 2-shard span {span}", src,
                        f"gsvc_tpu/ops/rasterize_pallas.py:{line}", counter,
                        worst["k6" if name.startswith("K6") else "fwd"], kern, plain,
                        swork[name])
        if not name.startswith("K5"):  # K5 renders no span on the sharded fits
            rows.append(row)
    return rows


def sharded_phase(torch, smi, counters, fit_psnr, eager_s, qat_psnr, qat_eager_s) -> dict:
    """Phases 10b and 10c: `sharded_rank` on SHARD_RANKS ranks sharing the
    card, checked: the ranks' final states bitwise equal, PSNR rises and
    within PSNR_TOL_DB of the single-process fit with graph=False
    (`fit_psnr`, `qat_psnr`), no overflow, K4 rows, K6 and K3 launched on
    every rank. Prints the sharded step ms (eager) beside the single
    process's eager step (`eager_s`, `qat_eager_s`). Returns rank 0's
    launches of 10b."""
    from gsvc_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    results = launch(sharded_rank, SHARD_RANKS, timeout=900)
    secs = time.perf_counter() - t0
    need = ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
            "segmented_cumsum")
    for part in ("fit", "adaptive", "qat"):
        if len({r[part]["digest"] for r in results}) != 1:
            fail(f"phase 10 {part}: the ranks' final states differ")
        for rank, r in enumerate(results):
            missing = [k for k in need if r[part]["launches"][k] <= 0]
            if missing:
                fail(f"phase 10 {part}: rank {rank} launched none of {missing}")
    fit, adaptive, qat = results[0]["fit"], results[0]["adaptive"], results[0]["qat"]
    if not (fit["image"] and fit["it"] == TRAIN_ITERS and fit["psnr"] > fit["psnr0"]
            and abs(fit["psnr"] - fit_psnr) < PSNR_TOL_DB and fit["overflow"] == 0):
        fail(f"phase 10b sharded fit: it {fit['it']}, PSNR {fit['psnr0']:.3f} -> "
             f"{fit['psnr']:.4f} dB against the single process's {fit_psnr:.4f} (tol "
             f"{PSNR_TOL_DB}), overflow {fit['overflow']}")
    if adaptive["alive"] != N:
        fail(f"phase 10b adaptive control: {adaptive['alive']} alive after the revive")
    if not (abs(qat["best_psnr"] - qat_psnr) < PSNR_TOL_DB and qat["overflow"] == 0):
        fail(f"phase 10c sharded QAT: best PSNR {qat['best_psnr']:.4f} against "
             f"{qat_psnr:.4f} (tol {PSNR_TOL_DB}), overflow {qat['overflow']}")
    print(f"phase 10b sharded fit [{smi}]: {SHARD_RANKS} ranks on one card, fit_frame_sharded "
          f"{TRAIN_ITERS} its (removal control, rows L2): ranks bitwise equal; PSNR "
          f"{fit['psnr0']:.3f} -> {fit['psnr']:.4f} dB, single process {fit_psnr:.4f}; "
          f"step ms eager: sharded {1e3 * fit['seconds'] / TRAIN_ITERS:.3f}, single process "
          f"{1e3 * eager_s / TRAIN_ITERS:.3f}; the step's all_reduce ({2 + 9 * N} floats, "
          f"gloo) {results[0]['all_reduce_ms']:.4f} ms, rank 1 "
          f"{results[1]['all_reduce_ms']:.4f}; 5 adaptive-control steps revived to "
          f"{adaptive['alive']}, ranks bitwise equal; launches rank 0 {fit['launches']}, "
          f"rank 1 {results[1]['fit']['launches']}")
    print(f"phase 10c sharded QAT [{smi}]: fit_compress_sharded {SHARD_QAT_ITERS} its: ranks "
          f"bitwise equal; best PSNR {qat['best_psnr']:.4f} dB, single process "
          f"{qat_psnr:.4f}; step ms eager: sharded "
          f"{1e3 * qat['seconds'] / SHARD_QAT_ITERS:.3f}, single process "
          f"{1e3 * qat_eager_s / SHARD_QAT_ITERS:.3f}; launches rank 0 {qat['launches']}; "
          f"phase 10b + 10c {secs:.2f} s with the ranks' start")
    return fit["launches"]


def sharded_cli_phase(torch, smi, counters, clip, tmp: Path, device: str = "cuda") -> None:
    """Phase 10d: SHARD_CLI_FRAMES frames of phase 6's clip through the
    represent (SHARD_CLI_ITERS its, --is_rm: P-frames keep the K-frame's
    count for the delta compress), compress (SHARD_QAT_ITERS) and decode
    CLIs at --tile_shards SHARD_RANKS and at 1. Fails unless every CLI
    returns 0, the sharded run wrote the files the unsharded one did (each
    once: rank 0), every rank launched K1-K6's training kernels, each
    decoded PSNR is within 0.1 dB of its compress PSNR and the sharded and
    unsharded PSNR a frame within 0.1 dB; prints bpp, PSNR and seconds a
    frame of both."""
    from gsvc_tpu_torch import decode as decode_cli
    from gsvc_tpu_torch.drivers import compress as compress_cli
    from gsvc_tpu_torch.drivers import represent as represent_cli
    from gsvc_tpu_torch.parallel.launch import launch
    from gsvc_tpu_torch.scripts.encoder_drift import train_lines, write_yuv

    yuv = tmp / "clip.yuv"
    write_yuv(clip[:SHARD_CLI_FRAMES], yuv)
    need = ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
            "segmented_cumsum") if device == "cuda" else ()  # the CPU launches none
    logs = {}
    for shards in (SHARD_RANKS, 1):
        ck, cq = tmp / f"ck{shards}", tmp / f"cq{shards}"
        common = ["-d", str(yuv), "--data_name", "smoke", "--width", str(W), "--height",
                  str(H), "--image_length", str(SHARD_CLI_FRAMES), "--num_points", str(N),
                  "--tile_shards", str(shards), "--device", device]
        rep_dir = f"GaussianVideo_{SHARD_CLI_ITERS}_{N}"
        npz = ck / "models" / "smoke" / rep_dir / "gmodels_state_dict.npz"
        qat_dir = cq / "result" / "smoke" / f"GaussianVideo_{SHARD_QAT_ITERS}_{N}"
        t0 = time.perf_counter()
        # --tile_shards > 1: the ranks main() would spawn, launched here with
        # a deadline, each returning its launch counts (a fresh checkpoint
        # directory: no K-frame cache for the represent CLI to hand them)
        for name, cli, argv, rank_args in (
                ("represent", represent_cli, common + [
                    "--iterations", str(SHARD_CLI_ITERS), "--kdetect_iterations", "100",
                    "--is_rm", "--checkpoint_dir", str(ck)], (None,)),
                ("compress", compress_cli, common + [
                    "--iterations", str(SHARD_QAT_ITERS), "--model_path", str(npz),
                    "--k_frames_dir", str(ck), "--checkpoint_dir", str(cq)], ())):
            for c in counters:
                c.launches = 0
            if shards > 1:
                per_rank = launch(cli._rank_main, shards, (argv, *rank_args), timeout=600)
            else:
                rc = cli.main(argv)
                if rc != 0:
                    fail(f"phase 10d {name} --tile_shards 1 returned {rc}")
                per_rank = [{c.__name__: c.launches for c in counters}]
            for rank, launches in enumerate(per_rank):
                missing = [k for k in need if launches[k] <= 0]
                if missing:
                    fail(f"phase 10d {name} --tile_shards {shards}: rank {rank} launched "
                         f"none of {missing}")
        secs = time.perf_counter() - t0
        qat_models = cq / "models" / "smoke" / f"GaussianVideo_{SHARD_QAT_ITERS}_{N}"
        rc = decode_cli.main([
            "--bitstream", str(qat_models / "bitstream"), "--height", str(H), "--width",
            str(W), "--model_path", str(npz), "--k_frames",
            str(ck / "result" / "smoke" / "K_frames.txt"), "-d", str(yuv), "--no_png",
            "--out", str(tmp / f"dec{shards}"), "--device", device])
        if rc != 0:
            fail(f"phase 10d decode of the --tile_shards {shards} streams returned {rc}")
        logs[shards] = (train_lines(ck / "result" / "smoke" / rep_dir / "train.txt"),
                        train_lines(qat_dir / "train.txt"),
                        train_lines(tmp / f"dec{shards}" / "decode.txt"), secs,
                        sorted(str(p.relative_to(d)) for d in (ck, cq)
                               for p in d.rglob("*") if p.is_file()))
    (rep_s, enc_s, dec_s, secs_s, files_s), (rep_1, enc_1, dec_1, secs_1, files_1) = (
        logs[SHARD_RANKS], logs[1])
    if files_s != files_1:
        fail(f"phase 10d: the sharded CLIs wrote {files_s}, the unsharded {files_1}")
    frames = list(range(1, SHARD_CLI_FRAMES + 1))
    for f in frames:
        for what, enc, dec in (("sharded", enc_s, dec_s), ("unsharded", enc_1, dec_1)):
            if abs(dec[f]["PSNR"] - enc[f]["PSNR"]) >= 0.1:
                fail(f"phase 10d {what} frame {f}: decoded PSNR {dec[f]['PSNR']} vs "
                     f"encoder {enc[f]['PSNR']}")
        for what, a, b in (("represent", rep_s, rep_1), ("QAT", enc_s, enc_1)):
            if abs(a[f]["PSNR"] - b[f]["PSNR"]) >= 0.1:
                fail(f"phase 10d frame {f}: {what} PSNR sharded {a[f]['PSNR']} vs "
                     f"unsharded {b[f]['PSNR']}")
    for shards, (rep, enc, dec, secs, _files) in logs.items():
        print(f"phase 10d CLIs [{smi}] --tile_shards {shards}: {SHARD_CLI_FRAMES} frames, "
              f"{SHARD_CLI_ITERS} + {SHARD_QAT_ITERS} its, represent + compress "
              f"{secs:.2f} s; " + "; ".join(
                  f"frame {f}: represent PSNR {rep[f]['PSNR']:.4f} dB in "
                  f"{rep[f]['Training']:.2f} s, QAT PSNR {enc[f]['PSNR']:.4f} in "
                  f"{enc[f]['Training']:.2f} s, bpp {enc[f]['bpp']:.4f}, decoded "
                  f"{dec[f]['PSNR']:.4f}" for f in frames))


def multihost_phase(torch, smi, counters, clip, gt, tmp: Path) -> None:
    """Phase 11: the budget's effect on K3 (measured) and on a fit, then
    phase 6's clip through the represent CLI on one host and on MH_HOSTS
    host processes, first with K-frames that overflow their budget, the
    compress CLI on one and on MH_HOSTS hosts run one after the other, and
    the decoder on the merged streams; checked as the module docstring
    says."""
    import os

    from gsvc_tpu_torch import decode as decode_cli
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.drivers import compress as compress_cli
    from gsvc_tpu_torch.models.represent import fit_frame, init_train_state, intersection_budget
    from gsvc_tpu_torch.ops import fill_cuda
    from gsvc_tpu_torch.ops.binning import default_max_intersects
    from gsvc_tpu_torch.scripts import measure_multihost_scaling as mhs
    from gsvc_tpu_torch.scripts.encoder_drift import QAT_ITERS, train_lines, write_yuv

    dev = gt.device
    need = ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
            "segmented_cumsum", "forward_chw") if dev.type == "cuda" else ()  # CPU: none
    # the budget sets the length of K3's scan: the same lanes (segments of up
    # to 700) padded to longer rows, and a fit whose budgets both hold it
    s1 = 163840
    vals = torch.randn((9, s1), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    lens = torch.randint(1, 700, (s1,), generator=torch.Generator().manual_seed(1))
    flags = torch.zeros(s1, dtype=torch.int32, device=dev)
    starts = torch.cumsum(lens, 0)
    flags[starts[starts < s1].to(dev)] = 1
    flags[0] = 1
    ref = fill_cuda.segmented_cumsum(vals, flags)
    k3 = []
    for s2 in (s1 + 8192, 2 * s1):
        out = fill_cuda.segmented_cumsum(
            torch.nn.functional.pad(vals, (0, s2 - s1)),
            torch.nn.functional.pad(flags, (0, s2 - s1), value=1))[:, :s1]
        k3.append(f"{s2}: {int((out != ref).sum())} of {vals.numel()} lanes differ "
                  f"(max abs {float((out - ref).abs().max()):.3g})")
    cfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=TRAIN_ITERS,
                      isremoval=True)
    fits = []
    for budget in (None, 2 * intersection_budget(cfg)):
        c = dataclasses.replace(cfg, max_intersects=budget)
        fits.append(fit_frame(init_train_state(c, generator=torch.Generator().manual_seed(0),
                                               device=dev), gt, c,
                              draws=torch.Generator(device=dev).manual_seed(1)))
    print(f"phase 11 budget [{smi}]: K3 over {s1} lanes padded to " + "; ".join(k3)
          + f"; fit_frame {TRAIN_ITERS} its at budgets {intersection_budget(cfg)} and "
          f"{2 * intersection_budget(cfg)} (overflow {int(fits[0].state.max_overflow)}, "
          f"{int(fits[1].state.max_overflow)})")
    if not (same_fit(torch, fits[0].state, fits[1].state)
            and torch.equal(fits[0].image, fits[1].image)):
        fail("phase 11: a fit at two budgets that both hold it differs")

    yuv = tmp / "clip.yuv"
    write_yuv(clip, yuv)
    n_frames = len(clip)

    def represent(h: int, ck: Path, iterations: int, extra=()):
        """The represent CLI on h host processes; (wall s, launches, outputs)."""
        mhs.pin_k_frames(ck)
        try:
            return mhs.run_hosts(
                "represent", mhs.represent_argv(yuv, ck, W, H, N, n_frames, iterations,
                                                dev.type) + list(extra),
                h, tmp / "logs", timeout=300, one_thread=dev.type == "cpu")
        except RuntimeError as e:
            fail(f"phase 11 represent on {h} host(s): {e}")

    # each GOP drops a fit that overflowed the starting budget: host 1 starts
    # GOP 2 from it, and so must the single host, after GOP 1 raised it
    start = default_max_intersects(N, ((W + 15) // 16) * ((H + 15) // 16),
                                   factor=MH_OVER_FACTOR)
    over_re = re.compile(r"frame (\d+): the fit overflowed its intersection budget (\d+) "
                         r"by (\d+) intersections .* in ([\d.]+) s")
    over, secs, launches = {}, {}, {}
    for h in (1, MH_HOSTS):
        ov = tmp / f"over{h}"
        secs[f"over {h}"], launches[f"over {h}"], outs = represent(
            h, ov, MH_OVER_ITERS, ["--budget_factor", str(MH_OVER_FACTOR)])
        over[h] = sorted((int(f), int(b), int(o), float(t))
                         for out in outs for f, b, o, t in over_re.findall(out))
        first = {}  # each GOP's first dropped fit's budget, by its K-frame
        for f, b, _o, _t in over[h]:
            first.setdefault(max(k for k in mhs.K_FRAMES if k <= f), b)
        if first != {k: start for k in mhs.K_FRAMES}:
            fail(f"phase 11 overflow case on {h} host(s): each GOP's first dropped fit must "
                 f"have overflowed the starting budget {start}; dropped (frame, budget, "
                 f"overflow, s): {over[h]}")
    if [o[:3] for o in over[1]] != [o[:3] for o in over[MH_HOSTS]]:
        fail(f"phase 11 overflow case: one host dropped {over[1]}, {MH_HOSTS} dropped "
             f"{over[MH_HOSTS]}")
    diffs = mhs.artifact_differences(tmp / "over1", tmp / f"over{MH_HOSTS}")
    if diffs:
        fail(f"phase 11 overflow case: {MH_HOSTS} hosts differ from one: {diffs}")
    print(f"phase 11 overflow [{smi}]: --budget_factor {MH_OVER_FACTOR} (budget {start}), "
          f"{MH_OVER_ITERS} its, K-frames {list(mhs.K_FRAMES)}: one host process "
          f"{secs['over 1']:.3f} s, {MH_HOSTS} {secs[f'over {MH_HOSTS}']:.3f} s, bitwise equal; "
          "fits dropped (frame, budget, overflow, s): one host "
          f"{over[1]}, {MH_HOSTS} hosts {over[MH_HOSTS]}")

    ck = {h: tmp / f"ck{h}" for h in (1, MH_HOSTS)}
    cq = {h: tmp / f"cq{h}" for h in (1, MH_HOSTS)}
    for h in (1, MH_HOSTS):
        secs[h], launches[h], outs = represent(h, ck[h], MH_ITERS)
    gops = [re.search(r"host \d+/\d+: GOPs (\[.*\])", out) for out in outs]
    if [g and g.group(1) for g in gops] != [str([k]) for k in mhs.K_FRAMES]:
        fail(f"phase 11: the hosts claimed GOPs {[g and g.group(1) for g in gops]}")
    rep_dir = f"GaussianVideo_{MH_ITERS}_{N}"
    npz = {h: ck[h] / "models" / mhs.DATA / rep_dir / "gmodels_state_dict.npz"
           for h in ck}
    host_ids = {1: [None], MH_HOSTS: list(range(MH_HOSTS - 1, -1, -1))}  # worker first
    nonce = os.environ.get("GSVC_RUN_NONCE")
    os.environ["GSVC_RUN_NONCE"] = f"smoke{os.getpid()}"
    try:
        for h in (1, MH_HOSTS):
            argv = ["-d", str(yuv), "--data_name", mhs.DATA, "--width", str(W), "--height",
                    str(H), "--image_length", str(n_frames), "--num_points", str(N),
                    "--iterations", str(QAT_ITERS), "--model_path", str(npz[h]),
                    "--k_frames_dir", str(ck[h]), "--checkpoint_dir", str(cq[h]),
                    "--device", dev.type]
            t0 = time.perf_counter()
            for host in host_ids[h]:
                for c in counters:
                    c.launches = 0
                rc = compress_cli.main(argv + ([] if host is None else
                                               ["--hosts", str(h), "--host_id", str(host)]))
                if rc != 0:
                    fail(f"phase 11 compress host {host} of {h} returned {rc}")
                launches.setdefault(f"compress {h}", []).append(
                    {c.__name__: c.launches for c in counters})
            secs[f"compress {h}"] = time.perf_counter() - t0
    finally:
        if nonce is None:
            del os.environ["GSVC_RUN_NONCE"]
        else:
            os.environ["GSVC_RUN_NONCE"] = nonce
    for run, per_host in launches.items():
        for host, counts in enumerate(per_host):
            missing = [k for k in need if counts[k] <= 0]
            if missing:
                fail(f"phase 11 {run}: host process {host} launched none of {missing}")
    for what, one, many in (("represent", ck[1], ck[MH_HOSTS]),
                            ("compress", cq[1], cq[MH_HOSTS])):
        diffs = mhs.artifact_differences(one, many)
        if diffs:
            fail(f"phase 11 {what}: {MH_HOSTS} hosts differ from one: {diffs}")
    qat_dir = f"GaussianVideo_{QAT_ITERS}_{N}"
    models = cq[MH_HOSTS] / "models" / mhs.DATA / qat_dir
    rc = decode_cli.main([
        "--bitstream", str(models / "bitstream"), "--height", str(H), "--width", str(W),
        "--model_path", str(npz[MH_HOSTS]), "--k_frames",
        str(ck[MH_HOSTS] / "result" / mhs.DATA / "K_frames.txt"), "-d", str(yuv), "--no_png",
        "--out", str(tmp / "decoded"), "--device", dev.type])
    if rc != 0:
        fail(f"phase 11 decode of the merged streams returned {rc}")
    enc = train_lines(cq[MH_HOSTS] / "result" / mhs.DATA / qat_dir / "train.txt")
    dec = train_lines(tmp / "decoded" / "decode.txt")
    if sorted(dec) != list(range(1, n_frames + 1)) or any(
            abs(dec[f]["PSNR"] - enc[f]["PSNR"]) > 1e-4 + 1e-9 for f in dec):
        fail(f"phase 11: decoded PSNR {[dec[f]['PSNR'] for f in sorted(dec)]} against the "
             f"encoder's {[enc[f]['PSNR'] for f in sorted(enc)]}")
    rep_log = train_lines(ck[MH_HOSTS] / "result" / mhs.DATA / rep_dir / "train.txt")
    print(f"phase 11 multi-host [{smi}]: {W}x{H}, {N} splats, {n_frames} frames, K-frames "
          f"{list(mhs.K_FRAMES)}, --is_rm --is_ad {MH_ITERS} + {QAT_ITERS} its; represent: "
          f"one host process {secs[1]:.3f} s, {MH_HOSTS} host processes sharing the card "
          f"{secs[MH_HOSTS]:.3f} s (wall, process starts included; GOPs "
          f"{[g.group(1) for g in gops]}); compress: one host {secs['compress 1']:.3f} s, "
          f"{MH_HOSTS} hosts one after another {secs[f'compress {MH_HOSTS}']:.3f} s; merged "
          f"artifacts bitwise the single host's; PSNR a frame represent "
          f"{[rep_log[f]['PSNR'] for f in sorted(rep_log)]}, QAT "
          f"{[enc[f]['PSNR'] for f in sorted(enc)]}, bpp {[enc[f]['bpp'] for f in sorted(enc)]}, "
          f"decoded equal to 4 decimals; launches {launches}")


def scene3d(torch, n: int, h: int, w: int, dev, seed: int = 0) -> dict:
    """Phase 12's scene from the smoke's seed: n gaussians uniform in the
    view frustum of an identity camera at depths 2-10, fx = fy = 1000 w /
    1920 (the splats cover w x h), world scales 0.005-0.04 (times
    sqrt(1920 / w): a cut frame keeps splats of a few pixels), SH degree
    PIPE_DEGREE, a background and an L2 target."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    f = 1000.0 * w / 1920
    z = 2.0 + 8.0 * u(n)
    means = torch.stack([(u(n) * w - w / 2) / f * z, (u(n) * h - h / 2) / f * z, z], -1)
    k = (PIPE_DEGREE + 1) ** 2
    coeffs = torch.cat([2.0 * u(n, 1, 3), 0.1 * torch.randn((n, k - 1, 3), generator=gen,
                                                             device=dev)], 1)
    return {"means": means, "scales": (0.005 + 0.035 * u(n, 3)) * (1920 / w) ** 0.5,
            "quats": torch.randn((n, 4), generator=gen, device=dev), "coeffs": coeffs,
            "opacity": 0.3 + 0.7 * u(n, 1), "bg": u(3), "target": u(h, w, 3),
            "view": torch.eye(4, device=dev), "campos": torch.zeros(3, device=dev),
            "cam": (f, f, w / 2, h / 2, h, w, ((w + 15) // 16, (h + 15) // 16, 1))}


def pipeline3d(torch, s: dict, backend: str = "auto"):
    """project_gaussians -> spherical_harmonics (view directions from the
    camera) -> rasterize_gaussians_alpha (background, alpha) -> an L2 loss
    -> gradients in means3d, scales, quats, the SH coefficients and opacity:
    (loss, gradients, the compositor's inputs and outputs)."""
    from gsvc_tpu_torch.ops import project_gaussians, rasterize_gaussians_alpha
    from gsvc_tpu_torch.ops import spherical_harmonics

    fx, fy, cx, cy, h, w, tb = s["cam"]
    with torch.enable_grad():
        leaves = [s[k].clone().requires_grad_() for k in
                  ("means", "scales", "quats", "coeffs", "opacity")]
        xys, depths, radii, conics, nth, _cov3d = project_gaussians(
            leaves[0], leaves[1], 1.0, leaves[2], s["view"], fx, fy, cx, cy, h, w, tb)
        colors = spherical_harmonics(PIPE_DEGREE, leaves[0] - s["campos"], leaves[3])
        img, alpha = rasterize_gaussians_alpha(
            xys, depths, radii, conics, nth, colors, leaves[4], h, w, background=s["bg"],
            return_alpha=True, chunk=ALPHA_CHUNK, backend=backend)
        loss = torch.mean((img - s["target"]) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    outs = [t.detach() for t in (xys, depths, radii, conics, colors, img, alpha)]
    return loss.detach(), grads, outs


def pipeline3d_phase(torch, dev, smi, counters) -> list:
    """Phase 12: the 3D pipeline at 1080p/10k on the card (see the module
    docstring); returns A1's and A2's rows of the kernels JSON."""
    from gsvc_tpu_torch.ops import rasterize_alpha
    from gsvc_tpu_torch.ops import rasterize_alpha_cuda as rac
    from gsvc_tpu_torch.ops.binning import budget_overflow, default_max_intersects
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d_scale_rot
    from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum
    from gsvc_tpu_torch.utils import work

    t_phase = time.perf_counter()
    sc = scene3d(torch, N, H, W, dev)
    tb = sc["cam"][-1]
    every = tuple(counters) + (rac.alpha_forward, rac.alpha_backward_slots)
    needed = ("fill_decode_keys", "rank_cap_decode", "alpha_forward", "alpha_backward_slots",
              "segmented_cumsum")
    pipeline3d(torch, sc)  # a warm-up run: its kernels' first calls
    torch.cuda.synchronize()
    for c in every:
        c.launches = 0
    t0 = time.perf_counter()
    loss, grads, outs = pipeline3d(torch, sc)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in every}
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        fail(f"phase 12: the 3D pipeline launched none of {missing}; launches {launches}")
    names = ("means3d", "scales", "quats", "SH coefficients", "opacity")
    for name, g in zip(names, grads):
        if not torch.isfinite(g).all():
            fail(f"phase 12: the gradient in {name} is not finite")
    xys, depths, radii, conics, colors, img, alpha = outs

    with torch.no_grad():
        # A1 against the plain version (gsvc_tpu's scan, op for op), apart
        # from pixels whose break decision lies within rounding
        db = rac.bin_depth_ordered(xys, depths, radii, tb)
        o = db.order
        opac = sc["opacity"]
        splats = [xys[o].contiguous(), conics[o].contiguous(), colors[o].contiguous(),
                  opac[o].contiguous(), sc["bg"]]
        a1 = rac.alpha_forward(db.binned, *splats, H, W, tb, True)
        if not (torch.equal(a1[0], img) and torch.equal(a1[1], alpha)):
            fail("phase 12: A1 on the main path's inputs differs from the main path's render")

        def against_scan(got, cols, bg, op, rad=radii, con=conics):
            out_p, T_p = rasterize_alpha.composite_torch(xys, depths, rad, con, cols, op, H,
                                                         W, chunk=ALPHA_CHUNK)
            img_p = (out_p + T_p[:, None] * bg).reshape(H, W, -1)
            T_p = T_p.reshape(H, W)
            err = torch.maximum((got[0] - img_p).abs().amax(-1), (got[2] - T_p).abs())
            eps = rasterize_alpha.T_EPS
            near = (((got[2] - eps).abs() <= NEAR_BREAK * eps)
                    | ((T_p - eps).abs() <= NEAR_BREAK * eps))
            if not torch.isfinite(got[0]).all():
                fail("phase 12: A1's image is not finite")
            return (float(torch.where(near, 0.0, err).max()), int(near.sum()),
                    int((near & (err > RENDER_TOL)).sum()), float(torch.where(near, err, 0.0).max()),
                    float(cols.abs().max()) + float(bg.abs().max()))

        a1_check = {"C=3": against_scan(a1, colors, sc["bg"], opac)}
        gen = torch.Generator(device=dev).manual_seed(12)
        colors5 = torch.rand((N, 5), generator=gen, device=dev)
        bg5 = torch.rand(5, generator=gen, device=dev)
        a1_5 = rac.alpha_forward(db.binned, splats[0], splats[1], colors5[o].contiguous(),
                                 splats[3], bg5, H, W, tb, True)
        a1_check["C=5"] = against_scan(a1_5, colors5, bg5, opac)
        # dense: 3x the footprints at opacity 1 (alpha clamps at 0.999 near the
        # centres; most pixels break, tiles hold hundreds of lanes)
        ones, rad3, con3 = torch.ones_like(opac), radii * 3, conics / 9.0
        db3 = rac.bin_depth_ordered(xys, depths, rad3, tb)
        o3 = db3.order
        dense = [xys[o3].contiguous(), con3[o3].contiguous(), colors[o3].contiguous(),
                 ones[o3].contiguous(), sc["bg"]]
        a1_3 = rac.alpha_forward(db3.binned, *dense, H, W, tb, True)
        a1_check["C=3, dense"] = against_scan(a1_3, colors, sc["bg"], ones, rad3, con3)
        broke = (rac.pair_counts(db3.binned, dense[0], dense[1], dense[3], H, W, tb)[0],
                 256 * db3.total, int(db3.binned.tile_counts.max()))
        # wide: 6x the footprints at 1/20 the opacity (tiles hold up to ~450
        # lanes, past A1's and A2's staged batch of 256; few pixels break)
        faint, rad6, con6 = opac * 0.05, radii * 6, conics / 36.0
        db6 = rac.bin_depth_ordered(xys, depths, rad6, tb)
        wide_counts = db6.binned.tile_counts
        if int(wide_counts.max()) <= 256:
            fail(f"phase 12: the wide variant's longest tile list is {int(wide_counts.max())} "
                 "lanes, not past 256")
        o6 = db6.order
        wide = [xys[o6].contiguous(), con6[o6].contiguous(), colors[o6].contiguous(),
                faint[o6].contiguous(), sc["bg"]]
        a1_6 = rac.alpha_forward(db6.binned, *wide, H, W, tb, True)
        a1_check["C=3, wide"] = against_scan(a1_6, colors, sc["bg"], faint, rad6, con6)
        wide_tiles = (int(wide_counts.max()), int((wide_counts > 256).sum()), db6.total)
        for key, (far, near, flips, flip_err, _scale) in a1_check.items():
            if far > RENDER_TOL:
                fail(f"phase 12: A1 ({key}) differs from the plain scan by {far} > {RENDER_TOL} "
                     "at a pixel whose break decision is not within rounding")
        a1_err = max(v[0] for v in a1_check.values())
        v_img = torch.randn((H, W, 3), generator=gen, device=dev)
        v_alpha = torch.randn((H, W), generator=gen, device=dev)
        # A2 against its plain version on the same full-size inputs
        a2_full = {}
        for key, (dbv, spl, fwd) in {"C=3": (db, splats, a1), "C=3, dense": (db3, dense, a1_3),
                                     "C=3, wide": (db6, wide, a1_6)}.items():
            got = rac.alpha_backward_slots(dbv.binned, *spl, fwd[2], fwd[3], v_img, v_alpha,
                                           H, W, tb)
            want = rac.alpha_backward_torch(dbv.binned, *spl, fwd[2], v_img, v_alpha, H, W, tb)
            for name, a, b in zip(("slots", "v_background"), got, want):
                a2_full[f"{name} ({key})"] = err = errors(a, b)
                if not (torch.isfinite(a).all() and err[1] <= GRAD_TOL):
                    fail(f"phase 12: A2's {name} ({key}) at {W}x{H}/{N}: max-abs {err[0]}, "
                         f"rel {err[1]} > {GRAD_TOL} against its plain version")
            if key == "C=3":
                a2 = got
            del got, want
        # the kernels JSON's error: A2 on the main path's inputs (the variants'
        # slots are larger, their errors printed beside them)
        a2_err = max(a2_full["slots (C=3)"][0], a2_full["v_background (C=3)"][0])
        twice = {
            "A1": lambda: torch.cat([t.reshape(-1).float() for t in rac.alpha_forward(
                db.binned, *splats, H, W, tb, True)]),
            "A2": lambda: torch.cat([t.reshape(-1) for t in rac.alpha_backward_slots(
                db.binned, *splats, a1[2], a1[3], v_img, v_alpha, H, W, tb)]),
        }
        for name, launch in twice.items():
            if not torch.equal(launch(), launch()):
                fail(f"phase 12: two launches of {name} on the same inputs differ")
        if not all(torch.isfinite(t).all() for t in a2):
            fail("phase 12: A2's gradients are not finite")

    # A2 against plain autograd through the scan at a cut size: the
    # compositor's own gradients, then the whole pipeline's
    ph, pw, pn = PIPE_SMALL
    small = scene3d(torch, pn, ph, pw, dev, seed=1)
    _l, _g, souts = pipeline3d(torch, small)
    sx, sd, sr, scon, scol = souts[:5]
    sgen = torch.Generator(device=dev).manual_seed(13)
    sv_img = torch.randn((ph, pw, 3), generator=sgen, device=dev)
    sv_alpha = torch.randn((ph, pw), generator=sgen, device=dev)
    a2_errs = {}
    dense_small = (", dense", sr * 3, scon / 9.0, torch.ones_like(small["opacity"]))
    for tag, srad, scon_v, sop in (("", sr, scon, small["opacity"]), dense_small):
        comp = []
        with torch.enable_grad():
            for backend in ("auto", "torch"):
                leaves = [t.clone().requires_grad_() for t in (sx, scon_v, scol, sop,
                                                               small["bg"])]
                simg, salpha = rasterize_alpha.rasterize_gaussians_alpha(
                    leaves[0], sd, srad, leaves[1], None, leaves[2], leaves[3], ph, pw,
                    background=leaves[4], return_alpha=True, chunk=ALPHA_CHUNK,
                    backend=backend)
                comp.append(torch.autograd.grad(
                    torch.sum(simg * sv_img) + torch.sum(salpha * sv_alpha), leaves))
        for name, a, b in zip(("xys", "conics", "colors", "opacity", "background"), *comp):
            a2_errs[name + tag] = err = errors(a, b)
            if not (torch.isfinite(a).all() and err[1] <= GRAD_TOL):
                fail(f"phase 12: A2's gradient in {name}{tag}: max-abs {err[0]}, rel "
                     f"{err[1]} > {GRAD_TOL} against plain autograd")
    _l, g_plain, _o = pipeline3d(torch, small, backend="torch")
    _l, g_kern, _o = pipeline3d(torch, small)
    pipe_errs = {name: errors(a, b) for name, a, b in zip(names, g_kern, g_plain)}
    for name, (err, rel) in pipe_errs.items():
        if rel > GRAD_TOL:
            fail(f"phase 12: the pipeline's gradient in {name} at {pw}x{ph}/{pn}: max-abs "
                 f"{err}, rel {rel} > {GRAD_TOL} against the plain backend")

    # project_gaussians_2d_scale_rot at 1080p/10k through the eval render
    with torch.no_grad():
        means2d = torch.rand((N, 2), generator=gen, device=dev) * 2.0 - 1.0
        scales2d = 0.5 + 2.0 * torch.rand((N, 2), generator=gen, device=dev)
        rot = (torch.rand((N, 1), generator=gen, device=dev) * 2.0 - 1.0) * 3.14159265
        tb2 = ((W + 15) // 16, (H + 15) // 16, 1)
        proj = project_gaussians_2d_scale_rot(means2d, scales2d, rot, H, W, tb2)
        budget = default_max_intersects(N, tb2[0] * tb2[1])
        if int(budget_overflow(proj[4], budget)) != 0:
            fail("phase 12: the scale + rotation scene overflows its budget")
        cols, opac2 = colors5[:, :3].contiguous(), sc["opacity"]
        for c in every:
            c.launches = 0
        sr_img = rasterize_gaussians_sum(*proj, cols, opac2, H, W, backend="cuda", layout="chw",
                                         max_intersects=budget)
        sr_launches = {c.__name__: c.launches for c in every}
        sr_ref = rasterize_gaussians_sum(*proj, cols, opac2, H, W, backend="torch",
                                         layout="chw", max_intersects=budget)
        sr_err = float((sr_img - sr_ref).abs().max())
        if any(sr_launches[k] <= 0 for k in ("fill_decode_keys", "rank_cap_decode",
                                             "forward_chw")) or sr_err > RENDER_TOL:
            fail(f"phase 12: scale + rotation eval render: max-abs {sr_err}, launches "
                 f"{sr_launches}")

        pc = rac.pair_counts(db.binned, splats[0], splats[1], splats[3], H, W, tb)
        bounds = work.alpha_work(N, 3, db.total, tb[0] * tb[1], H, W, True, pc)
        src, replaces = "gsvc_tpu_torch/csrc/rasterize_alpha.cu", "gsvc_tpu/ops/rasterize_alpha.py:50"
        rows = [
            timed_row(smi, 12, "A1 alpha_forward", src, replaces, "alpha_forward", a1_err,
                      lambda: rac.alpha_forward(db.binned, *splats, H, W, tb, True),
                      lambda: rac.alpha_forward_torch(db.binned, *splats, H, W, tb, True),
                      bounds["A1 alpha_forward"]),
            timed_row(smi, 12, "A2 alpha_backward", src, replaces, "alpha_backward_slots",
                      a2_err,
                      lambda: rac.alpha_backward_slots(db.binned, *splats, a1[2], a1[3], v_img,
                                                       v_alpha, H, W, tb),
                      lambda: rac.alpha_backward_torch(db.binned, *splats, a1[2], v_img,
                                                       v_alpha, H, W, tb),
                      bounds["A2 alpha_backward"]),
        ]
    for r in rows:
        r["launches"] = launches[r["launches"]]
    counts = db.binned.tile_counts
    print(f"phase 12 3D pipeline [{smi}]: {W}x{H}, {N} gaussians, SH degree {PIPE_DEGREE}, "
          f"{db.total} intersections (longest tile list {int(counts.max())} lanes, "
          f"{int((counts > 256).sum())} tiles past 256); project -> SH -> A1 -> L2 -> A2 + K3 "
          f"in {path_s * 1e3:.1f} ms (loss {float(loss):.6f}), launches {launches}; pairs (A1 "
          f"evaluated, contributing, A2 evaluated) {pc}; dense: A1 evaluates {broke[0]} of "
          f"{broke[1]} pairs, the longest tile list {broke[2]} lanes; wide: the longest tile "
          f"list {wide_tiles[0]} lanes, {wide_tiles[1]} tiles past 256, {wide_tiles[2]} "
          "intersections")
    for key, (far, near, flips, flip_err, scale) in a1_check.items():
        print(f"phase 12 A1 {key}: max-abs {far:.3g} against the plain scan (chunk "
              f"{ALPHA_CHUNK}, tol {RENDER_TOL}) outside {near} pixels whose T_final lies "
              f"within {NEAR_BREAK:g} x 1e-4 of the break; {flips} of them differ by more "
              f"than {RENDER_TOL} (break flips), by at most {flip_err:.3g} (1e-4 x (max|c| + "
              f"max|bg|) = {1e-4 * scale:.3g})")
    print(f"phase 12 A2 at {W}x{H}/{N} against its plain version (max-abs, rel): " + ", ".join(
        f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in a2_full.items()) + f" (tol rel {GRAD_TOL})")
    print(f"phase 12 A2 at {pw}x{ph}/{pn} against plain autograd (max-abs, rel): " + ", ".join(
        f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in a2_errs.items())
          + "; the pipeline's gradients: " + ", ".join(
        f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in pipe_errs.items())
          + f" (tol rel {GRAD_TOL}); two launches of A1 and of A2 bitwise equal; scale + "
          f"rotation eval render max-abs {sr_err:.3g}, launches {sr_launches}; phase 12 "
          f"{time.perf_counter() - t_phase:.2f} s")
    return rows


def main() -> int:
    argv = sys.argv[1:]
    if argv not in ([], ["--profile"]):
        fail(f"usage: {Path(__file__).name} [--profile]; got {argv}")
    repo = Path(__file__).resolve().parent
    if not (repo / "gsvc_tpu_torch" / "__init__.py").is_file():
        fail(f"gsvc_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch

    # -- phase 0: device -------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi)
    print(f"phase 0 device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from gsvc_tpu_torch import _build
    from gsvc_tpu_torch.compress.bitstream import (
        decode_frame,
        decoded_renderer,
        render_decoded,
    )
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import CHOLESKY_BOUND, from_numpy
    from gsvc_tpu_torch.models import compress
    from gsvc_tpu_torch.models.represent import (
        fit_frame,
        fit_plan,
        fit_twins,
        init_train_state,
        make_train_step,
        pre_train_frame,
        render_frame,
    )
    from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
    from gsvc_tpu_torch.ops.binning import bin_gaussians, key_inputs
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d
    from gsvc_tpu_torch.ops.rasterize import image_to_rows, rasterize_gaussians_sum
    from gsvc_tpu_torch.scripts.common import scene
    from gsvc_tpu_torch.utils import graphs, sass, work
    from gsvc_tpu_torch.utils.graphs import RenderGraph, StepGraph
    from gsvc_tpu_torch.utils.profiling import device_loop_time, event_ms

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(LIBS + NATIVE)
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.2f} s; native (g++): " + ", ".join(
        f"{lib} " + (f"{_build.build_seconds[lib]:.2f} s" if lib in _build.build_seconds
                     else "built before") for lib in NATIVE))
    for lib in LIBS:
        for kernel, used in _build.resources(_build.build_log(lib)):
            print(f"phase 1 ptxas {lib} {sass.pretty(kernel)}: {used}")
    print(f"phase 1 K3 cluster: {fill_cuda.SEG_CLUSTER} CTAs a row")
    for lib in ("rasterize_fwd", "rasterize_bwd"):
        mixes = sass.library_mix(_build.library_path(lib))
        if mixes is None:
            print(f"phase 1 sass {lib}: not measured (no cuobjdump)")
        for kernel, mix in sorted((mixes or {}).items()):
            print(f"phase 1 sass {lib} {sass.describe(kernel, mix)}")
    if argv == ["--profile"]:
        profile_steps(np, torch, dev, smi)
        return 0

    # -- phase 2: kernels against their plain versions ----------------
    torch.set_grad_enabled(False)
    sc = scene(N, H, W, dev)  # the bench scene, projected and binned via K1, K2
    tb, means, L, colors, opacity = sc.tb, sc.means, sc.L, sc.colors, sc.opacity
    xys, radii, conics, nth, budget = sc.xys, sc.radii, sc.conics, sc.nth, sc.budget
    n_isect = int(nth.sum())
    ki = key_inputs(xys, radii, nth, tb, 16, 16, budget)
    keys = fill_cuda.fill_decode_keys(*ki.k1)
    keys_plain = fill_cuda.fill_decode_keys_torch(*ki.k1)
    errs = {"K1": float((keys - keys_plain).abs().max())}
    if not torch.equal(keys, keys_plain):
        fail(f"K1 keys differ at {int((keys != keys_plain).sum())} slots")
    skeys = torch.sort(keys).values
    k2 = fill_cuda.rank_cap_decode(skeys, 256, N, ki.num_tiles)
    k2_plain = fill_cuda.rank_cap_decode_torch(skeys, 256, N, ki.num_tiles)
    errs["K2"] = float(max((a - b).abs().max() for a, b in zip(k2, k2_plain)))
    for name, a, b in zip(("tile ids", "gauss ids", "tile edges"), k2, k2_plain):
        if not torch.equal(a, b):
            fail(f"K2 {name} differ from the plain version at {int((a != b).sum())} entries")
    tiles = k2[0]
    binned = sc.binned
    binned_p = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, kernels=False)
    for name in binned._fields:
        if not torch.equal(getattr(binned, name), getattr(binned_p, name)):
            fail(f"binning field {name} differs between kernel and plain path")
    if int(binned.overflow) != 0:
        fail(f"budget {budget} overflowed by {int(binned.overflow)}")
    rargs = sc.rargs
    for layout, wrapper in (("image", rasterize_cuda.forward_image),
                            ("chw", rasterize_cuda.forward_chw)):
        got = wrapper(*rargs)
        ref = rasterize_cuda.rasterize_forward_torch(*rargs, layout=layout)
        errs[layout] = float((got - ref).abs().max())
        if not (torch.isfinite(got).all() and errs[layout] <= RENDER_TOL):
            fail(f"forward {layout}: max-abs {errs[layout]} > {RENDER_TOL}")
    rows = rasterize_cuda.forward_rows(*rargs)
    rows_ref = image_to_rows(rasterize_cuda.forward_image(*rargs), H, W)
    errs["rows"] = float((rows - rows_ref).abs().max())
    if not torch.equal(rows, rows_ref):
        fail(f"forward rows differs from image_to_rows(K4 image): {errs['rows']}")
    print(f"phase 2 kernels: intersections {n_isect}, budget {budget}; K1 keys, K2 "
          f"ids and {ki.num_tiles + 1} tile edges exact; forward max-abs image "
          f"{errs['image']:.3g} chw {errs['chw']:.3g} (tol {RENDER_TOL}); rows exact")

    # K1 and K2 on wide keys: WIDE_N splats at 1080p (int32) and 4K UHD (int64)
    wide = {}
    for wh, ww in WIDE_GRIDS:
        wsc = scene(WIDE_N, wh, ww, dev)
        wki = key_inputs(wsc.xys, wsc.radii, wsc.nth, wsc.tb, 16, 16, wsc.budget)
        wlayout = fill_cuda.key_layout(wki.num_tiles, WIDE_N)
        tag = f"{ww}x{wh}/{WIDE_N}, {wlayout.gauss_bits}-bit, {str(wlayout.dtype)[6:]}"
        wkeys = fill_cuda.fill_decode_keys(*wki.k1)
        if wkeys.dtype != wlayout.dtype or not torch.equal(
                wkeys, fill_cuda.fill_decode_keys_torch(*wki.k1)):
            fail(f"K1 on wide keys ({tag}) differs from its plain version")
        wskeys = torch.sort(wkeys).values
        # the cap of 256 and WIDE_CAP, which every tile run longer than it
        # passes (K2's capped lanes and the 17-bit sentinel)
        for cap in (256, WIDE_CAP):
            got = fill_cuda.rank_cap_decode(wskeys, cap, WIDE_N, wki.num_tiles)
            want = fill_cuda.rank_cap_decode_torch(wskeys, cap, WIDE_N, wki.num_tiles)
            for name, a, b in zip(("tile ids", "gauss ids", "tile edges"), got, want):
                if not torch.equal(a, b):
                    fail(f"K2 on wide keys ({tag}, cap {cap}): {name} differ from the "
                         f"plain version at {int((a != b).sum())} entries")
            if not torch.equal(torch.cat(got), torch.cat(
                    fill_cuda.rank_cap_decode(wskeys, cap, WIDE_N, wki.num_tiles))):
                fail(f"K2 on wide keys ({tag}, cap {cap}): two launches on the same "
                     "inputs differ")
        capped = int((wsc.binned.tile_counts - WIDE_CAP).clamp(min=0).sum())
        if capped <= 0:
            fail(f"wide keys ({tag}): no tile run passes the cap of {WIDE_CAP}")
        wplain = bin_gaussians(wsc.xys, wsc.radii, wsc.nth, wsc.tb, 16, 16, wsc.budget,
                               kernels=False)
        for name in wsc.binned._fields:
            if not torch.equal(getattr(wsc.binned, name), getattr(wplain, name)):
                fail(f"binning field {name} on wide keys ({tag}) differs between the "
                     "kernel and the plain path")
        if int(wsc.binned.overflow) != 0:
            fail(f"wide keys ({tag}): budget {wsc.budget} overflowed")
        wide[tag] = ((wh, ww), wsc, wki, wkeys, wskeys, want[0])
        print(f"phase 2 kernels, wide keys ({tag}): intersections {int(wsc.nth.sum())}, "
              f"budget {wsc.budget}, tiles {wki.num_tiles}, the longest tile run "
              f"{int(wsc.binned.tile_counts.max())} lanes, {capped} lanes past a cap of "
              f"{WIDE_CAP}; K1 keys, K2 ids and tile edges exact at caps 256 and "
              f"{WIDE_CAP}, two K2 launches bitwise equal, bin_gaussians' kernel path = "
              "plain")

    # K6 in each layout and K3 on its slots, against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    v_img = torch.randn((H, W, 3), device=dev, generator=gen)
    v_by_layout = {"image": v_img, "chw": v_img.permute(2, 0, 1).contiguous(),
                   "rows": image_to_rows(v_img, H, W)}
    geom = (H, W, tb, 16, 16, 256)
    bargs = (binned, xys, conics, colors, opacity)
    slots_ref = rasterize_cuda.rasterize_backward_torch(*bargs, v_img, *geom)
    k6 = {}
    for layout, v in v_by_layout.items():
        slots = rasterize_cuda.backward_slots(*bargs, v, *geom, layout=layout)
        k6[layout] = errors(slots, slots_ref)
        if not (torch.isfinite(slots).all() and k6[layout][1] <= GRAD_TOL):
            fail(f"K6 {layout}: max-abs {k6[layout][0]}, rel {k6[layout][1]} "
                 f"> {GRAD_TOL}")
    errs["K6"] = max(e[0] for e in k6.values())
    twice = {"K2": lambda: torch.cat(fill_cuda.rank_cap_decode(skeys, 256, N,
                                                               ki.num_tiles)),
             "K5": lambda: rasterize_cuda.forward_chw(*rargs),
             "K4 rows": lambda: rasterize_cuda.forward_rows(*rargs),
             "K6 rows": lambda: rasterize_cuda.backward_slots(
                 *bargs, v_by_layout["rows"], *geom, layout="rows")}
    for name, launch in twice.items():
        if not torch.equal(launch(), launch()):
            fail(f"{name}: two launches on the same inputs differ")
    flags = rasterize_cuda.segment_flags(binned.gauss_slot_start, budget)
    slots_ref = slots_ref.contiguous()  # a slice of [9, S + 1]: K3 would copy it each call
    seg = fill_cuda.segmented_cumsum(slots_ref, flags)
    seg_ref = fill_cuda.segmented_cumsum_torch(slots_ref, flags)
    errs["K3"], k3_rel = errors(seg, seg_ref)
    if not (torch.isfinite(seg).all() and k3_rel <= GRAD_TOL):
        fail(f"K3: max-abs {errs['K3']}, rel {k3_rel} > {GRAD_TOL}")
    # K3 at the full budget with sparse flags: segments of thousands of
    # lanes, carried across several CTAs of the cluster
    sp_vals = torch.randn((9, budget), device=dev, generator=gen)
    sp_flags = (torch.rand(budget, device=dev, generator=gen) < 5e-5).to(torch.int32)
    sp_flags[0] = 0
    edges = torch.cat([torch.nonzero(sp_flags)[:, 0].cpu(), torch.tensor([budget])])
    steps = -(-budget // 128)  # K3's 128-lane steps, split among a cluster's CTAs
    span = -(-steps // fill_cuda.SEG_CLUSTER) * 128
    longest = int(torch.diff(edges, prepend=torch.tensor([0])).max())
    if longest <= 2 * span:
        fail(f"K3 sparse case: the longest segment, {longest} lanes, spans < 3 CTAs")
    sp_seg = fill_cuda.segmented_cumsum(sp_vals, sp_flags)
    k3_sparse = errors(sp_seg, fill_cuda.segmented_cumsum_torch(sp_vals, sp_flags))
    if not (torch.isfinite(sp_seg).all() and k3_sparse[1] <= GRAD_TOL):
        fail(f"K3 sparse: max-abs {k3_sparse[0]}, rel {k3_sparse[1]} > {GRAD_TOL}")
    for name, launch in (("K3", lambda: fill_cuda.segmented_cumsum(slots_ref, flags)),
                         ("K3 sparse", lambda: fill_cuda.segmented_cumsum(sp_vals, sp_flags))):
        if not torch.equal(launch(), launch()):
            fail(f"{name}: two launches on the same inputs differ")

    # per-splat gradients of the autograd function against autograd through
    # the plain renderer, on one loss
    wgt = torch.rand((H, W, 3), device=dev, generator=gen) + 0.5
    torch.cuda.reset_peak_memory_stats(dev)
    per_splat = []
    with torch.enable_grad():
        for kernels in (True, False):
            leaves = [t.clone().requires_grad_() for t in (xys, conics, colors, opacity)]
            render = (rasterize_cuda.rasterize_sum if kernels
                      else rasterize_cuda.rasterize_forward_torch)
            img = render(binned, *leaves, *geom)
            per_splat.append(torch.autograd.grad(
                torch.sum((img - 0.3) ** 2 * wgt), leaves))
    grad_errs = {}
    for name, a, b in zip(("xys", "conics", "colors", "opacity"), *per_splat):
        grad_errs[name] = errors(a, b)
        if not (torch.isfinite(a).all() and grad_errs[name][1] <= GRAD_TOL):
            fail(f"per-splat grad {name}: max-abs {grad_errs[name][0]}, rel "
                 f"{grad_errs[name][1]} > {GRAD_TOL}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print("phase 2 kernels: K6 (max-abs, rel) " + ", ".join(
        f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in k6.items())
        + f"; K3 ({errs['K3']:.3g}, {k3_rel:.3g}), K3 sparse ({k3_sparse[0]:.3g}, "
        f"{k3_sparse[1]:.3g}; {int(sp_flags.sum())} flags, longest segment {longest} "
        f"lanes, a CTA's span {span}); per-splat grads of the "
        "autograd function vs plain autograd " + ", ".join(
            f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in grad_errs.items())
        + f" (tol rel {GRAD_TOL}); two launches of K2, K5, K4 rows, K6 rows and K3 (both "
        f"cases) bitwise equal; keys {str(keys.dtype)[6:]}; peak {peak_gb:.1f} GiB")

    # -- phase 3: the slice, through the decoder CLI --------------------
    from gsvc_tpu_torch.scripts.decode_rate import (
        decode_run,
        describe,
        k_frame_blob,
        write_stream,
    )

    blob = k_frame_blob(sc)
    t_numpy, t_native = {}, {}  # the numpy plain codec once, for the record
    dec_plain = decode_frame(blob, native=False, times=t_numpy)
    dec = decode_frame(blob, times=t_native)
    dec_means, dec_chol, dec_colors = dec
    if not all(np.array_equal(a, b) for a, b in zip(dec, dec_plain)):
        fail("decode_frame with the native rANS differs from the numpy codec")
    n_dec = int(project_gaussians_2d(
        torch.as_tensor(dec_means, device=dev),
        torch.as_tensor(dec_chol, device=dev), H, W, tb)[4].sum())
    dec_budget = int(np.ceil(n_dec * 1.1 / 8192)) * 8192  # as decode.py sizes it
    frame = from_numpy({
        "_xyz": np.arctanh(dec_means),
        "_cholesky": dec_chol - np.asarray(CHOLESKY_BOUND, np.float32),
        "_features_dc": dec_colors}, dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)

    def frame_cfg(backend):
        return FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                           iterations=1, backend=backend,
                           max_intersects=dec_budget)

    counters = graphs.kernel_counters()
    serve_kernels = ("fill_decode_keys", "rank_cap_decode", "forward_image",
                     "forward_chw")
    train_kernels = ("fill_decode_keys", "rank_cap_decode", "forward_rows",
                     "backward_slots", "segmented_cumsum")
    with tempfile.TemporaryDirectory() as tmp:
        # the decoder's runs: eager, graph (the main path), graph (its capture
        # cached), eager
        bs, k_file = write_stream(blob, Path(tmp), DECODE_FRAMES)
        runs = [("eager", decode_run(bs, k_file, Path(tmp) / "0", H, W, eager=True))]
        for c in counters:
            c.launches = 0
        RenderGraph.captures, RenderGraph.replays = 0, 0
        t0 = time.perf_counter()
        runs.append(("graph", decode_run(bs, k_file, Path(tmp) / "1", H, W)))
        eval_img = render_frame(frame, alive, frame_cfg("auto"), layout="chw")
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        captures, replays = RenderGraph.captures, RenderGraph.replays
        runs += [("graph", decode_run(bs, k_file, Path(tmp) / "2", H, W)),
                 ("eager", decode_run(bs, k_file, Path(tmp) / "3", H, W, eager=True))]
        for name, run in runs:
            if run["rc"] != 0:
                fail(f"decode ({name} renders) returned {run['rc']}")
        missing = [k for k in serve_kernels if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched on the main path: {missing}")
        decoded = [np.fromfile(Path(tmp) / str(i) / "decoded.rgb", np.uint8)
                   for i in range(len(runs))]
        if decoded[1].size != DECODE_FRAMES * H * W * 3:
            fail(f"decoded.rgb holds {decoded[1].size} bytes, want "
                 f"{DECODE_FRAMES * H * W * 3}")
        if not all(np.array_equal(d, decoded[1]) for d in decoded):
            fail("the decoder's graph replays differ from its eager renders")
        if not (Path(tmp) / "1" / "decode.txt").is_file():
            fail("decode.txt missing")
    # the decoder's graph: the cache's entry for its splat count and budget
    replayed = dict((c.__name__, n) for c, n in
                    decoded_renderer(N, frame_cfg("auto"), dev).counts)
    inside = {"fill_decode_keys": 1, "rank_cap_decode": 1, "forward_image": 0}
    if (captures, replays) != (1, DECODE_FRAMES - 1) or any(
            replayed.get(k) != 1 for k in inside) or any(  # the eval render adds K1, K2
            launches[k] != DECODE_FRAMES + extra for k, extra in inside.items()):
        fail(f"decoder graphs: {captures} captures, {replays} replays, a replay's "
             f"launches {replayed}, the run's {launches}; want 1 capture, "
             f"{DECODE_FRAMES - 1} replays, each launching K1, K2 and K4 image once")
    ref = render_decoded(dec_means, dec_chol, dec_colors, frame_cfg("torch"), dev,
                         graph=False)
    ref8 = (ref.cpu().numpy() * 255.0).round().astype(np.int16)
    frames8 = decoded[1].reshape(DECODE_FRAMES, H, W, 3).astype(np.int16)
    level = int(np.abs(frames8 - ref8).max())
    if level > 1:
        fail(f"decoded.rgb is {level} levels from the plain render")
    eval_ref = render_frame(frame, alive, frame_cfg("torch"), layout="chw")
    eval_err = float((eval_img - eval_ref).abs().max())
    if not (torch.isfinite(eval_img).all() and eval_err <= RENDER_TOL):
        fail(f"eval render max-abs {eval_err} > {RENDER_TOL}")
    print(f"phase 3 serving slice: decode of {DECODE_FRAMES} frames + eval render "
          f"{slice_s:.2f} s; decoded.rgb within {level} level(s) of the plain render, "
          f"the graph runs' bytes equal to the eager runs'; {captures} capture, {replays} "
          f"replays, each launching {replayed}; native rANS = numpy; eval chw max-abs "
          f"{eval_err:.3g}; launches {launches}")
    for name, run in runs:
        print(f"phase 3 time [{smi}]: decoder, {name} renders, "
              + describe("1080p/10k --no_png", run, DECODE_FRAMES))
    print(f"phase 3 time [{smi}]: rANS decode of one frame's {5 * N} symbols "
          f"(host): native {1e3 * t_native['entropy']:.4f} ms, numpy "
          f"{1e3 * t_numpy['entropy']:.4f} ms")

    # -- phase 4: the training slice -------------------------------------
    torch.set_grad_enabled(True)
    gt = torch.clamp(rasterize_cuda.forward_image(*rargs), 0.0, 1.0)

    def psnr_of(img):
        return float(10.0 * torch.log10(1.0 / torch.mean((img - gt) ** 2)))

    def fit(cfg, seed=0, graph=None):
        state = init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                                 device=dev)
        psnr0 = psnr_of(render_frame(state.params, state.alive, cfg))
        res = fit_frame(state, gt, cfg, graph=graph,
                        draws=torch.Generator(device=dev).manual_seed(seed + 1))
        return psnr0, res

    def replayed(fn):
        """fn()'s result, failing unless it replayed a CUDA graph."""
        before = StepGraph.replays
        out = fn()
        if StepGraph.replays == before:
            fail("a fit with graphs replayed none")
        return out

    kcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                       iterations=TRAIN_ITERS, isremoval=True)
    for c in counters:
        c.launches = 0
    StepGraph.capture_seconds = 0.0
    t0 = time.perf_counter()
    psnr0, res = replayed(lambda: fit(kcfg))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    capture_s = StepGraph.capture_seconds
    train_launches = {c.__name__: c.launches for c in counters}
    missing = [k for k in train_kernels if train_launches[k] <= 0]
    if missing:
        fail(f"kernels not launched on the training path: {missing}")
    psnr1 = psnr_of(res.image)
    if not (res.image.shape == (H, W, 3) and torch.isfinite(res.image).all()):
        fail("fit_frame returned a non-finite or misshapen image")
    if res.state.it != TRAIN_ITERS or not psnr1 > psnr0:
        fail(f"fit: it {res.state.it}, PSNR {psnr0:.3f} -> {psnr1:.3f} dB")
    if int(res.state.max_overflow) != 0:
        fail(f"binning budget overflowed by {int(res.state.max_overflow)}")
    alive_k = int(res.state.alive.sum())
    t0 = time.perf_counter()
    _psnr0b, res_b = fit(kcfg, graph=False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if not (same_fit(torch, res.state, res_b.state) and torch.equal(res.image, res_b.image)):
        fail("the fit with graphs differs from the fit with graph=False")
    dcfg = FrameConfig(H=H, W=W, num_points=9000, max_num_points=N, iterations=5,
                       isdensity=True)
    _p, res_d = replayed(lambda: fit(dcfg, seed=3))
    alive_d = int(res_d.state.alive.sum())
    if alive_d != N or not torch.isfinite(res_d.image).all():
        fail(f"adaptive control: {alive_d} alive after the revive, want {N}")
    if not same_fit(torch, res_d.state, fit(dcfg, seed=3, graph=False)[1].state):
        fail("adaptive control: the fit with graphs differs from graph=False")
    # the K-frame detector's pre-train and a QAT fit on the scene as its checkpoint
    pcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=100)
    pre = [pre_train_frame(init_train_state(pcfg, generator=torch.Generator().manual_seed(4),
                                            device=dev), gt, pcfg, graph=g).state
           for g in (None, False)]
    qcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=60)
    gmodel = {"_xyz": np.arctanh(means.cpu().numpy()),
              "_cholesky": L.cpu().numpy() - np.asarray(CHOLESKY_BOUND, np.float32),
              "_features_dc": colors.cpu().numpy()}
    qat = [compress.fit_compress(compress.init_compress_state(gmodel, None, dev), gt, qcfg,
                                 reload_best=False, draws=torch.Generator().manual_seed(0),
                                 graph=g)
           for g in (None, False)]
    for name, (a, b) in (("pre-train", pre), ("QAT fit", qat)):
        if not same_fit(torch, a, b):
            fail(f"{name}: the fit with graphs differs from graph=False")
    # phase 10c's single-process QAT, graph=False
    t0 = time.perf_counter()
    qat_ref = compress.fit_compress(
        compress.init_compress_state(gmodel, None, dev), gt,
        dataclasses.replace(qcfg, iterations=SHARD_QAT_ITERS),
        draws=torch.Generator().manual_seed(0), graph=False)
    torch.cuda.synchronize()
    qat_ref_s = time.perf_counter() - t0
    print(f"phase 4 training slice: fit_frame {TRAIN_ITERS} its (removal "
          f"control) on graphs in {fit_s:.2f} s (capture {capture_s:.3f} s), with "
          f"graph=False in {eager_s:.2f} s: bitwise equal; PSNR {psnr0:.3f} -> "
          f"{psnr1:.3f} dB, {alive_k} alive, overflow 0; adaptive control revived to "
          f"{alive_d}, a pre-train of {pcfg.iterations} and a QAT fit of "
          f"{qcfg.iterations} its, each on graphs bitwise equal to graph=False; "
          f"launches {train_launches}")

    # -- phase 5: times --------------------------------------------------
    def eval_fps(backend: str, reps: int) -> float:
        def chained(m):
            x, d, r, c, k = project_gaussians_2d(m, L, H, W, tb)
            img = rasterize_gaussians_sum(
                x, d, r, c, k, colors, opacity, H, W, backend=backend,
                layout="chw", max_intersects=budget,
            )
            return m + torch.clamp(img, 0.0, 1.0).sum() * 0.0

        return 1.0 / device_loop_time(chained, means, reps=reps, outer=3)

    fps = {"torch": [], "cuda": []}
    with torch.no_grad():
        for backend in ("torch", "cuda", "cuda", "torch"):
            fps[backend].append(eval_fps(backend, 100 if backend == "cuda" else 10))

    def eval_render():
        x, d, r, c, k = project_gaussians_2d(means, L, H, W, tb)
        img = rasterize_gaussians_sum(x, d, r, c, k, colors, opacity, H, W, backend="cuda",
                                      layout="chw", max_intersects=budget)
        return torch.clamp(img, 0.0, 1.0)

    # the eval render as the represent driver's fps loop runs it: 100 calls
    # eagerly, and 100 replays of its graph after the eager first call
    call_fps = {"eager": [], "graph": []}
    for how in ("eager", "graph", "graph", "eager"):
        with graphs.render_graph(eval_render, (), dev, graph=how == "graph") as render:
            first = render()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(100):
                out = render()
            end.record()
            end.synchronize()
            call_fps[how].append(100e3 / start.elapsed_time(end))
            if how == "graph":
                inside = dict((c.__name__, n) for c, n in render.counts)
                if not torch.equal(out, first):
                    fail("the eval render's replay differs from its eager render")
                if any(inside.get(k) != 1 for k in ("fill_decode_keys", "rank_cap_decode",
                                                    "forward_chw")):
                    fail(f"the eval render's graph launches {inside}: want K1, K2, K5 once")
    timed = [
        ("K1 fill_decode_keys", "gsvc_tpu_torch/csrc/fill.cu",
         "gsvc_tpu/ops/fill_pallas.py:57", "fill_decode_keys", errs["K1"],
         lambda: fill_cuda.fill_decode_keys(*ki.k1),
         lambda: fill_cuda.fill_decode_keys_torch(*ki.k1)),
        ("K2 rank_cap_decode", "gsvc_tpu_torch/csrc/fill.cu",
         "gsvc_tpu/ops/fill_pallas.py:242", "rank_cap_decode", errs["K2"],
         lambda: fill_cuda.rank_cap_decode(skeys, 256, N, ki.num_tiles),
         lambda: fill_cuda.rank_cap_decode_torch(skeys, 256, N, ki.num_tiles)),
        ("K4 forward image", "gsvc_tpu_torch/csrc/rasterize_fwd.cu",
         "gsvc_tpu/ops/rasterize_pallas.py:428", "forward_image",
         errs["image"], lambda: rasterize_cuda.forward_image(*rargs),
         lambda: rasterize_cuda.rasterize_forward_torch(*rargs, layout="image")),
        ("K5 forward chw", "gsvc_tpu_torch/csrc/rasterize_fwd.cu",
         "gsvc_tpu/ops/rasterize_pallas.py:523", "forward_chw",
         errs["chw"], lambda: rasterize_cuda.forward_chw(*rargs),
         lambda: rasterize_cuda.rasterize_forward_torch(*rargs, layout="chw")),
    ]
    v_rows = v_by_layout["rows"]
    timed += [
        ("K4 forward rows", "gsvc_tpu_torch/csrc/rasterize_fwd.cu",
         "gsvc_tpu/ops/rasterize_pallas.py:428", "forward_rows",
         errs["rows"], lambda: rasterize_cuda.forward_rows(*rargs),
         lambda: rasterize_cuda.rasterize_forward_torch(*rargs, layout="rows")),
        ("K6 backward", "gsvc_tpu_torch/csrc/rasterize_bwd.cu",
         "gsvc_tpu/ops/rasterize_pallas.py:676", "backward_slots", errs["K6"],
         lambda: rasterize_cuda.backward_slots(*bargs, v_rows, *geom, layout="rows"),
         lambda: rasterize_cuda.rasterize_backward_torch(*bargs, v_rows, *geom,
                                                         layout="rows")),
        ("K3 segmented_cumsum", "gsvc_tpu_torch/csrc/segsum.cu",
         "gsvc_tpu/ops/fill_pallas.py:169", "segmented_cumsum", errs["K3"],
         lambda: fill_cuda.segmented_cumsum(slots_ref, flags),
         lambda: fill_cuda.segmented_cumsum_torch(slots_ref, flags)),
    ]
    bounds = work.kernel_work(sc, work.gated_pairs(sc), k3_rows=slots_ref.shape[0])
    tile_range = torch.arange(ki.num_tiles + 1, dtype=torch.int32, device=dev)
    library = {"K2 rank_cap_decode": lambda: torch.searchsorted(tiles, tile_range)}
    kernels = [timed_row(smi, 5, *row, bounds[row[0]], library.get(row[0]))
               for row in timed]
    # K1 and K2 on the wide scenes, (grid, row); their launches are phase
    # 9's point on the same grid
    wide_rows = []
    for tag, (grid, wsc, wki, _wkeys, wskeys, wtiles) in wide.items():
        wwork = work.key_work(wsc)
        wrange = torch.arange(wki.num_tiles + 1, dtype=torch.int32, device=dev)
        wide_rows += [(grid, row) for row in (
            timed_row(smi, 5, f"K1 fill_decode_keys, wide keys {tag}",
                      "gsvc_tpu_torch/csrc/fill.cu", "gsvc_tpu/ops/fill_pallas.py:57",
                      "fill_decode_keys", 0.0,
                      lambda wki=wki: fill_cuda.fill_decode_keys(*wki.k1),
                      lambda wki=wki: fill_cuda.fill_decode_keys_torch(*wki.k1),
                      wwork["K1 fill_decode_keys"]),
            timed_row(smi, 5, f"K2 rank_cap_decode, wide keys {tag}",
                      "gsvc_tpu_torch/csrc/fill.cu", "gsvc_tpu/ops/fill_pallas.py:242",
                      "rank_cap_decode", 0.0,
                      lambda k=wskeys, t=wki.num_tiles: fill_cuda.rank_cap_decode(
                          k, 256, WIDE_N, t),
                      lambda k=wskeys, t=wki.num_tiles: fill_cuda.rank_cap_decode_torch(
                          k, 256, WIDE_N, t),
                      wwork["K2 rank_cap_decode"],
                      lambda t=wtiles, r=wrange: torch.searchsorted(t, r)))]
    # the key sort at each layout: the bench scene's 16-bit keys, the wide
    # scenes' keys, and the 1080p wide keys as int64
    sort_keys = {f"{W}x{H}/{N}, 16-bit, {str(keys.dtype)[6:]}": keys}
    for tag, (_g, _wsc, _wki, wkeys, _s, _t) in wide.items():
        sort_keys[tag] = wkeys
        if wkeys.dtype == torch.int32:
            sort_keys[f"{tag} keys as int64"] = wkeys.to(torch.int64)
    print(f"phase 5 time [{smi}]: torch.sort of the keys, device ms (CUDA events over "
          "50 sorts behind a spin kernel): " + "; ".join(
              f"{name} [{k.numel()}] {event_ms(lambda k=k: torch.sort(k), 50):.4f}"
              for name, k in sort_keys.items()))
    print(f"phase 5 time [{smi}]: eval render 1080p/10k chw fps: kernel path "
          f"{fps['cuda']}, plain path {fps['torch']} (a chained device loop; order "
          f"plain, kernel, kernel, plain); 100 calls, CUDA events: eager "
          f"{call_fps['eager']}, graph replays {call_fps['graph']} (order eager, graph, "
          f"graph, eager; each replay bitwise the eager render, launching K1, K2, K5)")

    def represent_plan(backend: str, rows_loss: bool):
        """The plan of a removal-control fit's steps 1..99 (step 1 its only
        control step) and its state; the L2 loss in the rasterizer's
        tile-row layout or on the image."""
        cfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                          iterations=10**6, isremoval=True, backend=backend)
        state = init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                 device=dev)
        plan = fit_plan(state, gt, 99, cfg)
        if not rows_loss:
            step, twins = make_train_step(cfg), fit_twins(state, 99, cfg)
            plan = plan._replace(step=lambda s: step(s, gt, None, twins))
        return plan, state

    def qat_plan():
        state = compress.init_compress_state(gmodel, None, dev)
        return compress.qat_plan(state, gt, qcfg, torch.Generator().manual_seed(0)), state

    qcfg = dataclasses.replace(qcfg, iterations=99)
    step_ms = {"plain": [], "kernel rows loss": [], "kernel image loss": [], "QAT": []}
    for key in ("plain", "kernel rows loss", "kernel image loss", "QAT", "QAT",
                "kernel image loss", "kernel rows loss", "plain"):
        if key == "plain":  # the all-PyTorch path, eagerly: ~1 s a step
            plan, state = represent_plan("torch", False)
            state = plan.step(plan.step(state))
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                state = plan.step(state)
            end.record()
            end.synchronize()
            step_ms[key].append(start.elapsed_time(end) / 2)
        else:
            plan, state = (qat_plan() if key == "QAT"
                           else represent_plan("cuda", key.endswith("rows loss")))
            step_ms[key].append(plain_step_ms(torch, dev, plan, state, STEP_REPS))
    print(f"phase 5 time [{smi}]: train step 1080p/10k ms, (eager, graph replay) with "
          f"CUDA events over {STEP_REPS} steps each (plain: 2, eager only; represent: "
          f"removal control, L2; QAT: K-frame): "
          + "; ".join(f"{k} {v}" for k, v in step_ms.items())
          + " (order plain, rows, image, QAT, QAT, image, rows, plain)")

    # -- phase 6: the encoder, YUV -> .gsvc -> decoded frames --------------
    torch.set_grad_enabled(True)
    from gsvc_tpu_torch.scripts.encoder_drift import encoder_clip

    clip = encoder_clip(sc)  # the bench scene (gt), moved; a cut, moved
    with tempfile.TemporaryDirectory() as tmp:
        enc_launches = encoder_phase(torch, smi, counters, clip, Path(tmp))
    for k in kernels:
        k["launches"] = enc_launches[k["launches"]]

    # -- phase 7: the profiling path ------------------------------------
    kernels += profiling_phase(torch, dev, smi, sc, v_rows, counters)

    # -- phase 8: a reduced RD point ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        rd_point_phase(torch, smi, counters, Path(tmp), 8, RD_N, RD_FRAMES)

    # -- phase 9: wide RD points, every frame past 65,535 splats -----------
    wide_launches = {}
    for wh, ww in WIDE_GRIDS:
        with tempfile.TemporaryDirectory() as tmp:
            wide_launches[(wh, ww)] = rd_point_phase(
                torch, smi, counters, Path(tmp), 9, WIDE_N, RD_WIDE_FRAMES,
                min_kept=1 << 16, width=ww, height=wh)
    for grid, k in wide_rows:
        k["launches"] = wide_launches[grid][k["launches"]]
        kernels.append(k)

    # -- phase 10: the tile-sharded trainer, ranks sharing the card ---------
    with torch.no_grad():
        span_rows = span_phase(torch, smi, sc, v_rows)
    shard_launches = sharded_phase(torch, smi, counters, psnr1, eager_s,
                                   float(qat_ref.best_psnr), qat_ref_s)
    for k in span_rows:
        k["launches"] = shard_launches[k["launches"]]
        kernels.append(k)
    with tempfile.TemporaryDirectory() as tmp:
        sharded_cli_phase(torch, smi, counters, clip, Path(tmp))

    # -- phase 11: multi-host GOP parallelism, host processes sharing the card
    with tempfile.TemporaryDirectory() as tmp:
        multihost_phase(torch, smi, counters, clip, gt, Path(tmp))

    # -- phase 12: the 3D pipeline: projection, SH, A1, A2 ------------------
    kernels += pipeline3d_phase(torch, dev, smi, counters)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   image_to_rows of the image store,
   K6 / K3 and the autograd function's per-splat gradients (against
   autograd through the plain renderer) within 1e-4 of the largest entry;
   K3 also at the full budget with sparse flags, whose segments run over
   several CTAs' spans; two launches of K2, K5, K4 rows, K6 (rows) and K3
   (both cases) bitwise equal;
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
5. times: each kernel beside its plain version, the eval render
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
   seconds a frame, the decoder's frames/s and each CLI's peak memory.

Around each of phases 3 and 4, around each CLI of phase 6, around the
mains of phase 7 and around phase 8's point, every launch counter is zeroed
just before and read just after; each kernel of that path must have
launched. The kernels' JSON
reports phase 6's counts for K1-K6 and phase 7's for the harnesses'
kernels, and each kernel's bound (`utils.work`, `utils.profiling.roofline_ms`)
and library call (null where no single
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
# phase 6's kernel launches and coded frames as the eager encoder made them
# (`python -m gsvc_tpu_torch.scripts.encoder_drift --eager`: every fit step
# and render eager, the same CLIs and seed): the graphs must launch the same
# kernels; the bytes are compared and printed
ENCODER_LAUNCHES = {"fill_decode_keys": 18487, "rank_cap_decode": 18487,
                    "forward_rows": 17660, "backward_slots": 17660,
                    "segmented_cumsum": 17660, "forward_chw": 808, "forward_image": 19}
ENCODER_SHA256 = ("8e76cbd280e9cef0", "40c8b44f5d5a4e3d", "afe1be16eebdc54a",
                  "0ac06a4d66f84cbc")
LIBS = ("fill", "segsum", "rasterize_fwd", "rasterize_bwd", "profile_kernel_parts",
        "profile_bwd_variants", "probe_transpose")
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


def rd_point_phase(torch, smi, counters, tmp: Path) -> None:
    """Phase 8: a reduced RD point through `run_rd_point.run_point` (its
    three CLIs), checked: every frame decoded within the point's tolerance
    of its encoder PSNR, a P-frame in the stream, no budget overflow
    reported, K1-K6 launched."""
    import contextlib
    import io

    from gsvc_tpu_torch.scripts import run_rd_point as rd
    from gsvc_tpu_torch.scripts.encoder_drift import ENC_ITERS, QAT_ITERS

    err = io.StringIO()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        point = rd.run_point(tmp, RD_FRAMES, RD_N, ENC_ITERS, QAT_ITERS, width=W, height=H)
    secs = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if "overflow" in err.getvalue():  # a compress WARNING or a represent refit
        fail("the RD point reported an intersection budget overflow")
    launches = {c.__name__: c.launches for c in counters}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels not launched by the RD point: {missing}; launches {launches}")
    if point["max_decode_gap_db"] >= rd.DECODE_TOL_DB:
        fail(f"RD point: decoded PSNR {point['frame_decoded_psnr']} vs encoder "
             f"{point['frame_psnr']} (tol {rd.DECODE_TOL_DB} dB)")
    if len(point["k_frames"]) >= RD_FRAMES:
        fail(f"RD point: K-frames {point['k_frames']}, no P-frame in the stream")
    print(f"phase 8 RD point [{smi}]: {W}x{H}, {RD_N} splats, {RD_FRAMES} frames, "
          f"{ENC_ITERS} + {QAT_ITERS} its, K-frames {point['k_frames']}, splats kept "
          f"{point['splats_kept']}: bpp {point['frame_bpp']}, PSNR {point['frame_psnr']}, "
          f"decoded {point['frame_decoded_psnr']} (max gap {point['max_decode_gap_db']:.4f} "
          f"dB); represent {point['represent_s_per_frame']:.2f} s a frame, QAT "
          f"{point['qat_s_per_frame']:.2f} s a frame; decoder "
          f"{point['decode_fps']:.2f} frames/s; peak GiB {point['peak_gib']}, allocated "
          f"at start and end {point['held_gib']}; CLI seconds "
          f"{point['cli_seconds']}; {secs:.2f} s in all; launches {launches}")


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
    from gsvc_tpu_torch.utils.profiling import device_loop_time

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
        rd_point_phase(torch, smi, counters, Path(tmp))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

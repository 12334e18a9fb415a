#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gsvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path and its training step once at 1920x1080
with 10k splats, the paper's operating point, and fails (non-zero exit) at
the first fault:

0. device: a CUDA card, its name and power limit from nvidia-smi;
1. build: the kernels of gsvc_tpu_torch/csrc, one nvcc per source, in
   parallel;
2. kernels: K1 (fill_decode_keys), K2 (rank_cap_decode), K4 (forward,
   [H,W,3] and the tile-row "rows" store), K5 (forward, [3,H,W]), K6
   (backward into the expansion slots) and K3 (segmented cumsum) on the
   bench scene (bench.py's scene, seed 0, unit opacity), each against its
   plain PyTorch version on the card: keys and ids exactly, renders within
   max-abs 1e-4, the rows store exactly image_to_rows of the image store,
   K6 / K3 and the autograd function's per-splat gradients (against
   autograd through the plain renderer) within 1e-4 of the largest entry;
3. serving slice: a K-frame stream of the scene written with `pack_frame`,
   then decoded by `python -m gsvc_tpu_torch.decode` (its `main`) and
   rendered once more as the planar eval render (`render_frame`, layout
   "chw"). decoded.rgb must be within 1 uint8 level of the plain path's
   render, and the eval render within 1e-4;
4. training slice: `fit_frame` with removal control (the K-frame mode) from
   `init_splats` toward the bench scene's render, twice from one seed: PSNR
   must rise, the two runs must be bitwise identical, and no binning budget
   may overflow; then a few adaptive-control steps (the P-frame mode),
   which revive splats;
5. times: each kernel beside its plain version, the eval render
   (projection + binning + render + clip, "chw") in frames per second, and
   the train step in ms (kernel path with the rows loss and with the image
   loss, against the all-PyTorch path), all with CUDA events;
6. the encoder: a 4-frame 1080p I420 clip (the bench scene, the same moved
   by a few pixels, then a cut to another seed's scene and its move),
   through `python -m gsvc_tpu_torch.drivers.represent` (10k splats,
   --is_rm --is_ad, K-frame detection), `drivers.compress` (QAT, rANS,
   `frame_N.gsvc`) and `decode`, each by its `main`. It fails unless every
   CLI returns 0, K_frames.txt starts with 1 and leaves a P-frame, every
   fit beats its starting render's PSNR, no budget overflow is reported,
   the bitstream trailers match K_frames.txt, and each decoded PSNR is
   within 0.1 dB of the compress stage's; it prints per-frame fit seconds,
   QAT ms a step, eval fps and bpp;
7. the profiling path (`gsvc_tpu_torch.scripts`): the harnesses' kernels
   against their plain versions (P1's K4 variants within max-abs 1e-4 and
   within 1e-4 of the plain render's largest entry, which must not be 0,
   P5's job-based backward C and D within 1e-4 of K6's slots, P6's
   transposes exactly), timed, then the six harnesses' mains (P3, P2, P4,
   P1, P6, P5) at 1080p/10k with a few repetitions a stage.

Around each of phases 3 and 4, around each CLI of phase 6 and around the
mains of phase 7, every launch counter is zeroed just before and read just
after; each kernel of that path must have launched. The kernels' JSON
reports phase 6's counts for K1-K6 and phase 7's for the harnesses'
kernels, and each kernel's bound (`utils.work`, `utils.profiling.roofline_ms`)
and library call (null where no single
PyTorch call computes the same function).

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile

runs phases 0 and 1, then profiles the represent and QAT train steps
(`profile_steps`: host and device ms a step, launches, device idle share,
the top device and host ops) and exits without the smoke's checks.
"""

from __future__ import annotations

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
# phase 6: the represent fits run to the splat-control threshold (4000 with
# --is_rm), where K- and P-frames reach the same splat count, which the
# compress stage's delta model needs
ENC_ITERS, KDETECT_ITERS, QAT_ITERS = 4000, 100, 300
PROFILE_ITERS = 10  # phase 7: timed repetitions of each harness stage
LIBS = ("fill", "segsum", "rasterize_fwd", "rasterize_bwd", "profile_kernel_parts",
        "profile_bwd_variants", "probe_transpose")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def errors(got, want):
    """(max-abs error, max-abs error over the largest entry of want)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def rgb_to_i420(np, rgb):
    """uint8 [H, W, 3] -> one I420 frame: the exact inverse of the port's
    BT.601 `io.yuv.yuv420_to_rgb` matrix, chroma averaged over 2x2."""
    m = np.array([[1.164, 0.0, 1.596], [1.164, -0.392, -0.813], [1.164, 2.017, 0.0]])
    ycc = rgb.astype(np.float64) @ np.linalg.inv(m).T + np.array([16.0, 128.0, 128.0])
    h, w = rgb.shape[:2]
    chroma = ycc[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    planes = (ycc[..., 0], chroma[..., 0], chroma[..., 1])
    return b"".join(np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes()
                    for p in planes)


def train_lines(path):
    """{frame: {field: value}} of a driver's train.txt Frame_N lines."""
    import re

    out = {}
    for ln in Path(path).read_text().splitlines():
        m = re.match(r"Frame_(\d+): \d+x\d+, (.*)$", ln)
        if m:
            out[int(m.group(1))] = {
                k: float(v) for k, v in re.findall(r"([\w-]+):(-?[\d.]+)s?", m.group(2))}
    return out


def render_scene(torch, means, L, colors, opacity, tb):
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


def encoder_phase(np, torch, dev, smi, counters, clip, tmp: Path) -> dict:
    """Phase 6: the 4-frame clip through `drivers.represent`,
    `drivers.compress` and `decode` (each CLI's `main`), checked; returns
    the launch counts summed over the three CLIs."""
    import contextlib
    import io

    from gsvc_tpu_torch import decode as decode_cli
    from gsvc_tpu_torch.compress.bitstream import frame_type
    from gsvc_tpu_torch.drivers import compress as compress_cli
    from gsvc_tpu_torch.drivers import represent as represent_cli
    from gsvc_tpu_torch.io import process_yuv_video
    from gsvc_tpu_torch.models.represent import render_frame

    yuv = tmp / "clip.yuv"
    yuv.write_bytes(b"".join(
        rgb_to_i420(np, (img.cpu().numpy() * 255.0).round().astype(np.uint8))
        for img in clip))
    n_frames = len(clip)
    ck, cq = tmp / "ck", tmp / "cq"
    common = ["-d", str(yuv), "--data_name", "smoke", "--width", str(W), "--height",
              str(H), "--image_length", str(n_frames), "--num_points", str(N)]
    rep_argv = common + ["--iterations", str(ENC_ITERS), "--kdetect_iterations",
                         str(KDETECT_ITERS), "--is_rm", "--is_ad",
                         "--checkpoint_dir", str(ck)]
    run = f"GaussianVideo_{ENC_ITERS}_{N}"
    npz = ck / "models" / "smoke" / run / "gmodels_state_dict.npz"
    kfile = ck / "result" / "smoke" / "K_frames.txt"
    bs = cq / "models" / "smoke" / f"GaussianVideo_{QAT_ITERS}_{N}" / "bitstream"
    clis = [
        ("represent", represent_cli.main, rep_argv,
         ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
          "segmented_cumsum", "forward_chw")),
        ("compress", compress_cli.main, common + [
            "--iterations", str(QAT_ITERS), "--model_path", str(npz),
            "--k_frames_dir", str(ck), "--checkpoint_dir", str(cq)],
         ("fill_decode_keys", "rank_cap_decode", "forward_rows", "backward_slots",
          "segmented_cumsum", "forward_chw")),
        ("decode", decode_cli.main, [
            "--bitstream", str(bs), "--height", str(H), "--width", str(W),
            "--model_path", str(npz), "--k_frames", str(kfile), "-d", str(yuv),
            "--no_png", "--out", str(tmp / "decoded")],
         ("fill_decode_keys", "rank_cap_decode", "forward_image")),
    ]
    total = {c.__name__: 0 for c in counters}
    for name, main, argv, needed in clis:
        err = io.StringIO()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"{name} returned {rc}")
        if "WARNING" in err.getvalue():
            fail(f"{name} reported an intersection budget overflow")
        missing = [k for k in needed if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched by {name}: {missing}; launches {launches}")
        for k, v in launches.items():
            total[k] += v
        print(f"phase 6 {name}: {secs:.2f} s; launches {launches}")

    k_frames = [int(x) for x in kfile.read_text().split()]
    if k_frames[0] != 1 or len(k_frames) >= n_frames:
        fail(f"K_frames.txt {k_frames}: want frame 1 first and a P-frame")
    for f in range(1, n_frames + 1):
        want = "K" if f in k_frames else "P"
        got = frame_type((bs / f"frame_{f}.gsvc").read_bytes())
        if got != want:
            fail(f"frame {f}: bitstream trailer {got}, K_frames.txt says {want}")
    rep = train_lines(ck / "result" / "smoke" / run / "train.txt")
    enc = train_lines(cq / "result" / "smoke" / f"GaussianVideo_{QAT_ITERS}_{N}"
                      / "train.txt")
    dec = train_lines(tmp / "decoded" / "decode.txt")
    if not (sorted(rep) == sorted(enc) == sorted(dec) == list(range(1, n_frames + 1))):
        fail(f"frames logged: represent {sorted(rep)}, compress {sorted(enc)}, "
             f"decode {sorted(dec)}")

    # each frame's fit must beat the render it started from: the trainer the
    # driver built (same seed; a P-frame warm-starts from the checkpoint)
    args = represent_cli.parse_args(rep_argv)
    frames = process_yuv_video(str(yuv), W, H)
    gmodels = compress_cli.load_gmodels(str(npz))
    counts = {int(a.split("_")[1]): int(b) for a, b in (
        ln.split(":") for ln in (ck / "result" / "smoke" / run /
                                 "num_gaussian_points.txt").read_text().splitlines())}
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
    print(f"phase 6 encoder [{smi}]: {W}x{H}, {N} splats, {n_frames} frames, K-frames "
          f"{k_frames}; splats kept {counts}")
    for f in range(1, n_frames + 1):
        print(f"phase 6 frame {f} [{smi}]: {'K' if f in k_frames else 'P'}; represent "
              f"{ENC_ITERS} its {rep[f]['Training']:.2f} s, PSNR {init_psnr[f]:.3f} -> "
              f"{rep[f]['PSNR']:.4f} dB, eval {rep[f]['FPS']:.1f} fps; QAT {QAT_ITERS} its "
              f"{enc[f]['Training']:.2f} s = {1e3 * enc[f]['Training'] / QAT_ITERS:.2f} "
              f"ms/step, PSNR {enc[f]['PSNR']:.4f} dB, bpp {enc[f]['bpp']:.4f}, eval "
              f"{enc[f]['FPS']:.1f} fps; decoded PSNR {dec[f]['PSNR']:.4f} dB")
    return total


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
    ~1e-5, so max-abs alone would pass a kernel that writes zeros). P5's C
    and D must be within GRAD_TOL of K6's slots, A exactly and B, E within
    GRAD_TOL of their plain versions; P6's transposes exact. Returns the
    new kernels' JSON entries."""
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
            err, rel = errors(got, k6 if v in ("C", "D") else plain)
            ok = torch.equal(got, plain) if v == "A" else rel <= GRAD_TOL
            if not (torch.isfinite(got).all() and ok):
                fail(f"P5 {v}: max-abs {err}, rel {rel} against "
                     + ("K6's slots" if v in ("C", "D") else "its plain version"))
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
    driver's budget), each fitting the bench scene's render.

    Per step: host enqueue and synced ms over 50 chained steps on the host
    clock, then torch.profiler over 20 more (`utils.profiling.profile_device`:
    device busy sums device-side events only). Device idle = 1 - busy /
    synced step."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import CHOLESKY_BOUND
    from gsvc_tpu_torch.models import compress
    from gsvc_tpu_torch.models.represent import (
        init_train_state,
        make_rows_target,
        make_train_step,
    )
    from gsvc_tpu_torch.ops.binning import default_max_intersects
    from gsvc_tpu_torch.scripts.common import bench_scene
    from gsvc_tpu_torch.utils.profiling import device_events, launches, profile_device

    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    means, L, colors, opacity = bench_scene(N, dev)
    gt = render_scene(torch, means, L, colors, opacity, tb)
    rcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=10**6,
                       isremoval=True)
    qcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N, iterations=1,
                       max_intersects=default_max_intersects(N, tb[0] * tb[1], factor=32))
    gmodel = {"_xyz": np.arctanh(means.cpu().numpy()),
              "_cholesky": L.cpu().numpy() - np.float32(CHOLESKY_BOUND),
              "_features_dc": colors.cpu().numpy()}
    steps = (
        ("represent step (removal control, rows L2)", make_train_step(rcfg),
         init_train_state(rcfg, generator=torch.Generator().manual_seed(0), device=dev),
         make_rows_target(gt, rcfg)),
        ("QAT step (K-frame)",
         compress.make_train_step_quantize(qcfg, draws=torch.Generator().manual_seed(0)),
         compress.init_compress_state(gmodel, None, dev), make_rows_target(gt, qcfg)),
    )
    for name, step, state, target in steps:
        for _ in range(5):
            state = step(state, gt, target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            state = step(state, gt, target)
        enqueue_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        synced_ms = (time.perf_counter() - t0) / 50 * 1e3
        box = [state]

        def once(step=step, target=target):
            box[0] = step(box[0], gt, target)

        busy_ms, events = profile_device(once, 20)
        device = device_events(events)
        print(f"profile [{smi}]: {name}: host enqueue {enqueue_ms:.4f} ms, synced "
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
        pack_frame,
        render_decoded,
    )
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.core import CHOLESKY_BOUND, from_numpy
    from gsvc_tpu_torch.models.represent import (
        fit_frame,
        init_train_state,
        make_rows_target,
        make_train_step,
        render_frame,
    )
    from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
    from gsvc_tpu_torch.ops.binning import bin_gaussians, key_inputs
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d
    from gsvc_tpu_torch.ops.rasterize import image_to_rows, rasterize_gaussians_sum
    from gsvc_tpu_torch.scripts.common import bench_scene, scene
    from gsvc_tpu_torch.utils import work
    from gsvc_tpu_torch.utils.profiling import device_loop_time, event_ms

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(LIBS)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in LIBS
             for ln in _build.build_log(lib).splitlines() if "Used" in ln]
    print(f"phase 1 build: {build_s:.2f} s; " + " | ".join(ptxas))
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
    keys = fill_cuda.fill_decode_keys(*ki)
    keys_plain = fill_cuda.fill_decode_keys_torch(*ki)
    errs = {"K1": float((keys - keys_plain).abs().max())}
    if not torch.equal(keys, keys_plain):
        fail(f"K1 keys differ at {int((keys != keys_plain).sum())} slots")
    skeys = torch.sort(keys).values
    tiles, gauss = fill_cuda.rank_cap_decode(skeys, 256, N, ki.num_tiles)
    tiles_p, gauss_p = fill_cuda.rank_cap_decode_torch(skeys, 256, N)
    errs["K2"] = float(max((tiles - tiles_p).abs().max(),
                           (gauss - gauss_p).abs().max()))
    if not (torch.equal(tiles, tiles_p) and torch.equal(gauss, gauss_p)):
        fail("K2 tile / gauss ids differ from the plain version")
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
    print(f"phase 2 kernels: intersections {n_isect}, budget {budget}; K1, K2 "
          f"exact; forward max-abs image {errs['image']:.3g} chw "
          f"{errs['chw']:.3g} (tol {RENDER_TOL}); rows exact")

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
    flags = rasterize_cuda.segment_flags(binned.gauss_slot_start, budget)
    seg = fill_cuda.segmented_cumsum(slots_ref, flags)
    seg_ref = fill_cuda.segmented_cumsum_torch(slots_ref, flags)
    errs["K3"], k3_rel = errors(seg, seg_ref)
    if not (torch.isfinite(seg).all() and k3_rel <= GRAD_TOL):
        fail(f"K3: max-abs {errs['K3']}, rel {k3_rel} > {GRAD_TOL}")

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
        + f"; K3 ({errs['K3']:.3g}, {k3_rel:.3g}); per-splat grads of the "
        "autograd function vs plain autograd " + ", ".join(
            f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in grad_errs.items())
        + f" (tol rel {GRAD_TOL}); peak {peak_gb:.1f} GiB")

    # -- phase 3: the slice, through the decoder CLI --------------------
    from gsvc_tpu_torch import decode as decode_cli

    rng = np.random.default_rng(1)
    scale = np.array([5.5, 6.0, 5.5], np.float32) / 63.0
    beta = np.array([0.5, -3.0, 0.5], np.float32)
    raw_chol = L.cpu().numpy() - np.asarray(CHOLESKY_BOUND, np.float32)
    codes = np.clip(np.round((raw_chol - beta) / scale), 0, 63).astype(np.int32)
    embed = rng.uniform(0.0, 0.5, (2, 64, 3)).astype(np.float32)
    idx = rng.integers(0, 64, (N, 2)).astype(np.int32)
    xyz16 = np.arctanh(means.cpu().numpy()).astype(np.float16)
    blob = pack_frame(xyz16, scale, beta, codes, embed, idx, "K")
    dec_means, dec_chol, dec_colors = decode_frame(blob)
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

    counters = (fill_cuda.fill_decode_keys, fill_cuda.rank_cap_decode,
                rasterize_cuda.forward_image, rasterize_cuda.forward_chw,
                rasterize_cuda.forward_rows, rasterize_cuda.backward_slots,
                fill_cuda.segmented_cumsum)
    serve_kernels = ("fill_decode_keys", "rank_cap_decode", "forward_image",
                     "forward_chw")
    train_kernels = ("fill_decode_keys", "rank_cap_decode", "forward_rows",
                     "backward_slots", "segmented_cumsum")
    with tempfile.TemporaryDirectory() as tmp:
        bs = Path(tmp) / "bitstream"
        bs.mkdir()
        (bs / "frame_1.gsvc").write_bytes(blob)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = decode_cli.main(["--bitstream", str(bs), "--height", str(H),
                              "--width", str(W), "--no_png"])
        eval_img = render_frame(frame, alive, frame_cfg("auto"), layout="chw")
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if rc != 0:
            fail(f"decode returned {rc}")
        missing = [k for k in serve_kernels if launches[k] <= 0]
        if missing:
            fail(f"kernels not launched on the main path: {missing}")
        decoded = np.fromfile(Path(tmp) / "decoded" / "decoded.rgb", np.uint8)
        if decoded.size != H * W * 3:
            fail(f"decoded.rgb holds {decoded.size} bytes, want {H * W * 3}")
        if not (Path(tmp) / "decoded" / "decode.txt").is_file():
            fail("decode.txt missing")
    ref = render_decoded(dec_means, dec_chol, dec_colors, frame_cfg("torch"), dev)
    ref8 = (ref.cpu().numpy() * 255.0).round().astype(np.int16)
    level = int(np.abs(decoded.reshape(H, W, 3).astype(np.int16) - ref8).max())
    if level > 1:
        fail(f"decoded.rgb is {level} levels from the plain render")
    eval_ref = render_frame(frame, alive, frame_cfg("torch"), layout="chw")
    eval_err = float((eval_img - eval_ref).abs().max())
    if not (torch.isfinite(eval_img).all() and eval_err <= RENDER_TOL):
        fail(f"eval render max-abs {eval_err} > {RENDER_TOL}")
    print(f"phase 3 serving slice: decode + eval render {slice_s:.2f} s; decoded.rgb "
          f"within {level} level(s) of the plain render; eval chw max-abs "
          f"{eval_err:.3g}; launches {launches}")

    # -- phase 4: the training slice -------------------------------------
    torch.set_grad_enabled(True)
    gt = torch.clamp(rasterize_cuda.forward_image(*rargs), 0.0, 1.0)

    def psnr_of(img):
        return float(10.0 * torch.log10(1.0 / torch.mean((img - gt) ** 2)))

    def fit(cfg, seed=0):
        state = init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                                 device=dev)
        psnr0 = psnr_of(render_frame(state.params, state.alive, cfg))
        res = fit_frame(state, gt, cfg,
                        draws=torch.Generator(device=dev).manual_seed(seed + 1))
        return psnr0, res

    kcfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                       iterations=TRAIN_ITERS, isremoval=True)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    psnr0, res = fit(kcfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
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
    _psnr0b, res_b = fit(kcfg)
    same = all(torch.equal(getattr(res.state.params, k), getattr(res_b.state.params, k))
               for k in ("xyz", "cholesky", "features_dc", "rgb_w"))
    if not (same and torch.equal(res.image, res_b.image)
            and torch.equal(res.state.alive, res_b.state.alive)):
        fail("two fits from one seed differ")
    dcfg = FrameConfig(H=H, W=W, num_points=9000, max_num_points=N, iterations=5,
                       isdensity=True)
    _p, res_d = fit(dcfg, seed=3)
    alive_d = int(res_d.state.alive.sum())
    if alive_d != N or not torch.isfinite(res_d.image).all():
        fail(f"adaptive control: {alive_d} alive after the revive, want {N}")
    print(f"phase 4 training slice: fit_frame {TRAIN_ITERS} its (removal "
          f"control) in {fit_s:.2f} s, PSNR {psnr0:.3f} -> {psnr1:.3f} dB, "
          f"{alive_k} alive, overflow 0; a second fit is bitwise identical; "
          f"adaptive control revived to {alive_d}; launches {train_launches}")

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
    timed = [
        ("K1 fill_decode_keys", "gsvc_tpu_torch/csrc/fill.cu",
         "gsvc_tpu/ops/fill_pallas.py:57", "fill_decode_keys", errs["K1"],
         lambda: fill_cuda.fill_decode_keys(*ki),
         lambda: fill_cuda.fill_decode_keys_torch(*ki)),
        ("K2 rank_cap_decode", "gsvc_tpu_torch/csrc/fill.cu",
         "gsvc_tpu/ops/fill_pallas.py:242", "rank_cap_decode", errs["K2"],
         lambda: fill_cuda.rank_cap_decode(skeys, 256, N, ki.num_tiles),
         lambda: fill_cuda.rank_cap_decode_torch(skeys, 256, N)),
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
    kernels = [timed_row(smi, 5, *row, bounds[row[0]]) for row in timed]
    print(f"phase 5 time [{smi}]: eval render 1080p/10k chw fps: kernel path "
          f"{fps['cuda']}, plain path {fps['torch']} (order plain, kernel, "
          f"kernel, plain)")

    def train_step_ms(backend: str, rows_loss: bool, reps: int) -> float:
        """Mean ms of the removal-control train step, chained through its
        parameters, CUDA events around `reps` steps after two warm-ups."""
        cfg = FrameConfig(H=H, W=W, num_points=N, max_num_points=N,
                          iterations=10**6, isremoval=True, backend=backend)
        state = init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                 device=dev)
        step = make_train_step(cfg)
        target = make_rows_target(gt, cfg) if rows_loss else None
        for _ in range(2):
            state = step(state, gt, target)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state = step(state, gt, target)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    step_ms = {"plain": [], "kernel rows loss": [], "kernel image loss": []}
    for key in ("plain", "kernel rows loss", "kernel image loss",
                "kernel image loss", "kernel rows loss", "plain"):
        if key == "plain":
            step_ms[key].append(train_step_ms("torch", False, 3))
        else:
            step_ms[key].append(train_step_ms("cuda", key.endswith("rows loss"), 50))
    print(f"phase 5 time [{smi}]: train step 1080p/10k ms (removal control, "
          f"L2): " + "; ".join(f"{k} {v}" for k, v in step_ms.items())
          + " (order plain, rows, image, image, rows, plain)")

    # -- phase 6: the encoder, YUV -> .gsvc -> decoded frames --------------
    torch.set_grad_enabled(True)
    clip = [gt]  # frames 1-2: the bench scene, then moved by (3, 2) pixels
    shift = torch.tensor([3 * 2.0 / W, 2 * 2.0 / H], device=dev)
    clip.append(render_scene(torch, means + shift, L, colors, opacity, tb))
    means_b, L_b, colors_b, opacity_b = bench_scene(N, dev, seed=1)
    clip.append(render_scene(torch, means_b, L_b, colors_b, opacity_b, tb))  # a cut
    clip.append(render_scene(torch, means_b + shift, L_b, colors_b, opacity_b, tb))
    with tempfile.TemporaryDirectory() as tmp:
        enc_launches = encoder_phase(np, torch, dev, smi, counters, clip, Path(tmp))
    for k in kernels:
        k["launches"] = enc_launches[k["launches"]]

    # -- phase 7: the profiling path ------------------------------------
    kernels += profiling_phase(torch, dev, smi, sc, v_rows, counters)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

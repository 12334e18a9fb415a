#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gsvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at 1920x1080 with 10k splats, the
paper's operating point, and fails (non-zero exit) at the first fault:

0. device: a CUDA card, its name and power limit from nvidia-smi;
1. build: the kernels of gsvc_tpu_torch/csrc, compiled with nvcc;
2. kernels: K1 (fill_decode_keys), K2 (rank_cap_decode), K4 (forward,
   [H,W,3]) and K5 (forward, [3,H,W]) on the bench scene (bench.py's
   scene, seed 0, unit opacity), each against its plain PyTorch version
   on the card: keys and ids exactly, renders within max-abs 1e-4;
3. slice: a K-frame stream of the scene written with `pack_frame`, then
   decoded by `python -m gsvc_tpu_torch.decode` (its `main`) and rendered
   once more as the planar eval render (`render_frame`, layout "chw").
   Launch counters are zeroed just before and read just after; every
   kernel must have launched. decoded.rgb must be within 1 uint8 level of
   the plain path's render, and the eval render within 1e-4;
4. times: each kernel beside its plain version, and the eval render
   (projection + binning + render + clip, "chw") in frames per second on
   both paths, all with CUDA events on a chained loop.

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bench_scene(np, torch, dev):
    """bench.py's scene (seed 0): means, cholesky L, colours, opacity."""
    rng = np.random.default_rng(0)
    means = rng.uniform(-0.999, 0.999, (N, 2))
    L = np.stack(
        [rng.uniform(1.0, 6.0, N), rng.normal(0.0, 1.0, N),
         rng.uniform(1.0, 6.0, N)],
        axis=1,
    )
    colors = rng.uniform(0, 1, (N, 3))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return t(means), t(L), t(colors), torch.ones((N, 1), device=dev)


def event_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up.

    A spin kernel queued first keeps the card busy while the host enqueues
    the calls, so the events bracket device time rather than the host's
    launch rate (where enqueueing takes longer than the spin, as for the
    plain versions' thousands of launches, host time shows through).
    """
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of device cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
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
    from gsvc_tpu_torch.models.represent import render_frame
    from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
    from gsvc_tpu_torch.ops.binning import bin_gaussians, key_inputs
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d
    from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum
    from gsvc_tpu_torch.utils.profiling import device_loop_time

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    for lib in ("fill", "rasterize_fwd"):
        _build.load(lib)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in ("fill", "rasterize_fwd")
             for ln in _build.build_log(lib).splitlines() if "Used" in ln]
    print(f"phase 1 build: {build_s:.2f} s; " + " | ".join(ptxas))

    # -- phase 2: kernels against their plain versions ----------------
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    means, L, colors, opacity = bench_scene(np, torch, dev)
    torch.set_grad_enabled(False)
    xys, _d, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
    n_isect = int(nth.sum())
    budget = int(np.ceil(n_isect * 1.05 / 8192)) * 8192
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
    binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, kernels=True)
    binned_p = bin_gaussians(xys, radii, nth, tb, 16, 16, budget, kernels=False)
    for name in binned._fields:
        if not torch.equal(getattr(binned, name), getattr(binned_p, name)):
            fail(f"binning field {name} differs between kernel and plain path")
    if int(binned.overflow) != 0:
        fail(f"budget {budget} overflowed by {int(binned.overflow)}")
    rargs = (binned, xys, conics, colors, opacity, H, W, tb, 16, 16, 256)
    for layout, wrapper in (("image", rasterize_cuda.forward_image),
                            ("chw", rasterize_cuda.forward_chw)):
        got = wrapper(*rargs)
        ref = rasterize_cuda.rasterize_forward_torch(*rargs, layout=layout)
        errs[layout] = float((got - ref).abs().max())
        if not (torch.isfinite(got).all() and errs[layout] <= RENDER_TOL):
            fail(f"forward {layout}: max-abs {errs[layout]} > {RENDER_TOL}")
    print(f"phase 2 kernels: intersections {n_isect}, budget {budget}; K1, K2 "
          f"exact; forward max-abs image {errs['image']:.3g} chw "
          f"{errs['chw']:.3g} (tol {RENDER_TOL})")

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
                rasterize_cuda.forward_image, rasterize_cuda.forward_chw)
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
        missing = [k for k, v in launches.items() if v <= 0]
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
    print(f"phase 3 slice: decode + eval render {slice_s:.2f} s; decoded.rgb "
          f"within {level} level(s) of the plain render; eval chw max-abs "
          f"{eval_err:.3g}; launches {launches}")

    # -- phase 4: times --------------------------------------------------
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
    kernels = []
    for name, src, replaces, counter, err, kern, plain in timed:
        ms = event_ms(torch, kern, 50)
        plain_ms = event_ms(torch, plain, 5)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[counter],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        print(f"phase 4 time [{smi}]: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"phase 4 time [{smi}]: eval render 1080p/10k chw fps: kernel path "
          f"{fps['cuda']}, plain path {fps['torch']} (order plain, kernel, "
          f"kernel, plain)")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

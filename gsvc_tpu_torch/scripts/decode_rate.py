"""The decoder's rate at 1080p/10k: a stream of K-frames of the bench scene
through the decoder CLI (`gsvc_tpu_torch.decode.main`, `--no_png`), its
renders on CUDA graphs or all eager (`utils.graphs.eager`).

    python -m gsvc_tpu_torch.scripts.decode_rate [--frames 16]

Prints each run's frames per second (the CLI's wall time, start to end)
and, where the decoder keeps them (`decode.STAGES`), its ms a frame by
stage, then one JSON line of them; the runs go eager, graph, graph,
eager, and the second graph run finds its capture cached. Run as a file
with another tree's package first on PYTHONPATH, it times that tree's
decoder (a tree without render graphs: two runs, its renders eager).
Card only: exits 1 without one.

Also the stream that `chip_smoke.py` phase 3 decodes: `k_frame_blob` and
`write_stream`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H, W, N = 1080, 1920, 10000
ORDER = ("eager", "graph", "graph", "eager")  # the runs of a tree with render graphs


def k_frame_blob(sc) -> bytes:
    """A K-frame of the scene `sc` (`scripts.common.scene`): its means as
    float16, its cholesky coded to 6 bits, two random 64-entry codebooks
    and random stage indices (seed 1), written by `pack_frame`."""
    from gsvc_tpu_torch.compress.bitstream import pack_frame
    from gsvc_tpu_torch.core import CHOLESKY_BOUND

    rng = np.random.default_rng(1)
    scale = np.array([5.5, 6.0, 5.5], np.float32) / 63.0
    beta = np.array([0.5, -3.0, 0.5], np.float32)
    raw_chol = sc.L.cpu().numpy() - np.asarray(CHOLESKY_BOUND, np.float32)
    codes = np.clip(np.round((raw_chol - beta) / scale), 0, 63).astype(np.int32)
    embed = rng.uniform(0.0, 0.5, (2, 64, 3)).astype(np.float32)
    idx = rng.integers(0, 64, (sc.n, 2)).astype(np.int32)
    xyz16 = np.arctanh(sc.means.cpu().numpy()).astype(np.float16)
    return pack_frame(xyz16, scale, beta, codes, embed, idx, "K")


def write_stream(blob: bytes, directory: Path, frames: int):
    """`frames` copies of the K-frame `blob` as directory/bitstream/frame_1 ..
    frame_N.gsvc, and a K_frames.txt that lists them all; returns (the
    bitstream directory, K_frames.txt)."""
    bs = directory / "bitstream"
    bs.mkdir(parents=True, exist_ok=True)
    for f in range(1, frames + 1):
        (bs / f"frame_{f}.gsvc").write_bytes(blob)
    k_file = directory / "K_frames.txt"
    k_file.write_text("".join(f"{f}\n" for f in range(1, frames + 1)))
    return bs, k_file


def decode_run(bs: Path, k_file: Path, out: Path, height: int, width: int,
               eager: bool = False) -> dict:
    """One decoder CLI run (`--no_png`) into `out`: {"rc", "seconds",
    "stages", "capture_seconds"}: the stages `decode.STAGES` (seconds
    summed over the frames) and the host seconds of its render graphs'
    captures, or None where the tree has neither. eager=True runs it
    within `utils.graphs.eager()`."""
    from gsvc_tpu_torch import decode
    from gsvc_tpu_torch.utils import graphs

    render_graph = getattr(graphs, "RenderGraph", None)
    captured = render_graph.capture_seconds if render_graph else 0.0
    ctx = graphs.eager() if eager else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx:
        rc = decode.main(["--bitstream", str(bs), "--height", str(height), "--width",
                          str(width), "--k_frames", str(k_file), "--no_png",
                          "--out", str(out)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stages = getattr(decode, "STAGES", None)
    return {"rc": rc, "seconds": secs, "stages": None if stages is None else dict(stages),
            "capture_seconds": render_graph.capture_seconds - captured if render_graph
            else None}


def describe(name: str, run: dict, frames: int) -> str:
    """A run's line: frames/s, and ms a frame by stage where it has them
    (the render over the frames that replayed or rendered eagerly; the
    capture, the first frame's, alone)."""
    line = (f"{name}: {frames} frames in {run['seconds']:.4f} s = "
            f"{frames / run['seconds']:.2f} frames/s")
    stages = run["stages"]
    if stages:
        n = stages.get("frames", frames)
        parts = []
        for k, v in stages.items():
            if k == "capture":
                parts.append(f"capture {1e3 * v:.4f} (its frame; the capture's host time "
                             f"{1e3 * run['capture_seconds']:.4f})")
            elif k != "frames":
                per = n - 1 if k == "render" and "capture" in stages else n
                parts.append(f"{k} {1e3 * v / per:.4f}")
        line += "; ms a frame: " + ", ".join(parts)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gsvc_tpu_torch.scripts import common

    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    from gsvc_tpu_torch.utils import graphs

    sc = common.scene(N, H, W, dev)
    # eager, graph, graph, eager: the second graph run finds its capture cached
    order = ORDER if hasattr(graphs, "eager") else ("eager", "eager")
    result = []
    with tempfile.TemporaryDirectory() as tmp:
        bs, k_file = write_stream(k_frame_blob(sc), Path(tmp), args.frames)
        for i, name in enumerate(order):
            run = decode_run(bs, k_file, Path(tmp) / f"{i}", H, W,
                             eager=name == "eager" and order == ORDER)
            if run["rc"] != 0:
                print(f"decode_rate: the decoder returned {run['rc']}", file=sys.stderr)
                return 1
            print(f"decode_rate [{common.card_line()}] {describe(name, run, args.frames)}")
            result.append(dict(run, renders=name))
    print(json.dumps({"frames": args.frames, "runs": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

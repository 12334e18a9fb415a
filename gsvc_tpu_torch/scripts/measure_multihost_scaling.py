"""Multi-host GOP-parallel scaling of the represent CLI on one machine
(PyTorch port of scripts/measure_multihost_scaling.py).

    python -m gsvc_tpu_torch.scripts.measure_multihost_scaling [--device cuda]
        [--workdir mh_scaling] [--width 1920 --height 1080 --num-points 10000
        --iterations 4000]

The clip is `chip_smoke.py` phase 6's (`encoder_drift.encoder_clip`: the
bench scene, the same moved, a cut, its move) with its K-frames pinned to 1
and 3 (two GOPs), fitted with --is_rm --is_ad (4000 its, where K- and
P-frames keep the same splat count, which the delta compress needs): (a) by
one represent process, (b) by HOSTS represent processes started
together (two: the K-frames make two GOPs), their barriers a torch.distributed gloo group (GSVC_COORDINATOR
on 127.0.0.1), host 0 merging. Every process runs on `--device`: with
cuda, the machine's first card, which the hosts share (two processes on
one card, not two hosts). The merged artifacts must be bitwise the single
host's (exit 1 otherwise: `artifact_differences`). Prints each run's wall
time, process starts included, and each host's kernel launches, then one
JSON line; a run has TIMEOUT_S seconds. With --device cpu every process
runs one intra-op thread.

`run_hosts`, `artifact_differences` and `host_main` are also what
`chip_smoke.py` phase 11 runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DATA = "smoke"  # --data_name of the runs
K_FRAMES = (1, 3)
HOSTS = 2  # one a GOP
TIMEOUT_S = 1800.0  # a run of the clip on one or on HOSTS processes
# a host process: python -c HOST_CODE <cli> <launch counts json> <cli argv...>
HOST_CODE = ("from gsvc_tpu_torch.scripts.measure_multihost_scaling import host_main; "
             "host_main()")
_TIMING = re.compile(r", Training:[\d.]+s, Eval:[\d.]+s, FPS:[\d.]+")


def host_main() -> None:
    """One host process: runs `gsvc_tpu_torch.drivers.<cli>`'s main on the
    arguments after the first two, then writes the process's kernel launch
    counts (`utils.graphs.launch_counts`) as JSON to the second, and exits
    with the CLI's code."""
    from importlib import import_module

    from gsvc_tpu_torch.utils import graphs

    cli, counts, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    rc = import_module(f"gsvc_tpu_torch.drivers.{cli}").main(argv)
    Path(counts).write_text(json.dumps(graphs.launch_counts()))
    sys.exit(rc)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_hosts(cli: str, argv: List[str], hosts: int, work: Path,
              timeout: float = TIMEOUT_S, one_thread: bool = False,
              markers: bool = False) -> Tuple[float, List[dict], List[str]]:
    """`hosts` processes of the CLI started together, each on `argv`, their
    output in `work`. One host is a plain run; more meet in a
    GSVC_COORDINATOR group on 127.0.0.1, or with `markers` in gsvc_tpu's
    marker files (`--hosts N --host_id h` and one GSVC_RUN_NONCE). With
    `one_thread`, each runs on one intra-op thread (CPU runs: two processes'
    spinning thread pools slow both tenfold). Returns (wall seconds to the
    last exit, each host's kernel launches, each host's output). Raises
    RuntimeError, after killing the others, as soon as a host fails, or
    when the run outlasts `timeout`."""
    work.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GSVC_") and k != "SLURM_JOB_ID"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if one_thread:
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = free_port()
    if markers:
        env["GSVC_RUN_NONCE"] = str(port)
    elif hosts > 1:
        env.update(GSVC_COORDINATOR=f"127.0.0.1:{port}", GSVC_NUM_PROCS=str(hosts))
    procs, logs, counts = [], [], []
    t0 = time.perf_counter()
    try:
        for h in range(hosts):
            counts.append(work / f"{cli}.launches.host{h}.json")
            counts[h].unlink(missing_ok=True)
            logs.append(work / f"{cli}.host{h}.log")
            with open(logs[h], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", HOST_CODE, cli, str(counts[h])] + argv
                    + (["--hosts", str(hosts), "--host_id", str(h)] if markers else []),
                    env=env if markers or hosts == 1 else dict(env, GSVC_PROC_ID=str(h)),
                    stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"{cli} on {hosts} hosts: over {timeout:.0f} s")
            time.sleep(0.2)
        secs = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for h, p in enumerate(procs):
        if p.returncode != 0 or not counts[h].exists():
            raise RuntimeError(f"{cli} host {h}/{hosts} returned {p.returncode}:\n"
                               f"{outs[h][-4000:]}")
    return secs, [json.loads(c.read_text()) for c in counts], outs


def _files(root: Path) -> List[str]:
    """The artifact files under root, less what only one kind of run
    writes: the hosts' shards and barrier markers, and the video."""
    return sorted(
        str(p.relative_to(root)) for p in root.rglob("*")
        if p.is_file() and ".host" not in p.name and not p.name.startswith(".barrier_")
        and "video" not in p.relative_to(root).parts)


def artifact_differences(one: Path, many: Path) -> List[str]:
    """What differs between the artifacts of a single-host run under `one`
    and a merged multi-host run under `many`: the files present, each npz's
    keys and arrays (bitwise), each train.txt's Frame_ lines without their
    timing fields, every other file byte for byte (num_gaussian_points.txt,
    K_frames.txt, frame_N.gsvc). Empty when they are the same."""
    diffs = []
    names = _files(one)
    if names != _files(many):
        return [f"files: {names} against {_files(many)}"]
    for name in names:
        a, b = one / name, many / name
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                if sorted(za.files) != sorted(zb.files):
                    diffs.append(f"{name}: keys {za.files} against {zb.files}")
                else:
                    diffs += [f"{name}: {k}" for k in za.files
                              if not np.array_equal(za[k], zb[k])]
        elif name.endswith("train.txt"):
            la, lb = ([_TIMING.sub("", ln) for ln in p.read_text().splitlines()
                       if ln.startswith("Frame_")] for p in (a, b))
            if la != lb or not la:
                diffs.append(f"{name}: {la} against {lb}")
        elif a.read_bytes() != b.read_bytes():
            diffs.append(name)
    return diffs


def pin_k_frames(ckpt: Path) -> None:
    kdir = ckpt / "result" / DATA
    kdir.mkdir(parents=True, exist_ok=True)
    (kdir / "K_frames.txt").write_text("".join(f"{k}\n" for k in K_FRAMES))


def represent_argv(yuv: Path, ckpt: Path, width: int, height: int, n: int, frames: int,
                   iterations: int, device: str) -> List[str]:
    return ["-d", str(yuv), "--data_name", DATA, "--width", str(width), "--height",
            str(height), "--image_length", str(frames), "--num_points", str(n),
            "--iterations", str(iterations), "--is_rm", "--is_ad", "--checkpoint_dir",
            str(ckpt), "--device", device]


def write_clip(path: Path, width: int, height: int, n: int, device: str) -> int:
    """Phase 6's clip at width x height with n splats, as I420; returns its
    frame count."""
    import torch

    from gsvc_tpu_torch.scripts.common import scene
    from gsvc_tpu_torch.scripts.encoder_drift import encoder_clip, write_yuv

    clip = encoder_clip(scene(n, height, width, torch.device(device)))
    write_yuv(clip, path)
    return len(clip)


def measure(work: Path, width: int, height: int, n: int, iterations: int,
            device: str) -> dict:
    """The clip fitted by one host, then by HOSTS; raises RuntimeError
    unless the merged artifacts are bitwise the single host's."""
    hosts = HOSTS
    work.mkdir(parents=True, exist_ok=True)
    yuv = work / "clip.yuv"
    frames = write_clip(yuv, width, height, n, device)
    runs = {}
    for h in (1, hosts):
        ck = work / f"hosts{h}"
        pin_k_frames(ck)
        runs[h] = run_hosts("represent", represent_argv(yuv, ck, width, height, n, frames,
                                                        iterations, device),
                            h, work / "launches", one_thread=device == "cpu")
    diffs = artifact_differences(work / "hosts1", work / f"hosts{hosts}")
    if diffs:
        raise RuntimeError(f"{hosts} hosts against one: {diffs}")
    claimed = [re.search(r"host \d+/\d+: GOPs (\[.*\])", out) for out in runs[hosts][2]]
    return {"device": device, "width": width, "height": height, "num_points": n,
            "frames": frames, "k_frames": list(K_FRAMES), "iterations": iterations,
            "hosts": hosts, "gops": [m.group(1) if m else None for m in claimed],
            "t_1host_s": runs[1][0], f"t_{hosts}host_s": runs[hosts][0],
            "speedup": runs[1][0] / runs[hosts][0],
            "launches": {"1host": runs[1][1], f"{hosts}host": runs[hosts][1]},
            "artifacts": "bitwise equal"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None, help="default: a temporary directory")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--num-points", type=int, default=10000)
    ap.add_argument("--iterations", type=int, default=4000)
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("measure_multihost_scaling: no CUDA device (use --device cpu)",
                  file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
    else:
        smi = "the CPU"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(args.workdir or tmp)
        try:
            res = measure(work, args.width, args.height, args.num_points,
                          args.iterations, args.device)
        except RuntimeError as e:
            print(f"measure_multihost_scaling: FAIL: {e}", file=sys.stderr)
            return 1
    res["card"] = smi
    print(f"[{smi}] {args.width}x{args.height}, {args.num_points} splats, {res['frames']} "
          f"frames, {args.iterations} its, K-frames {list(K_FRAMES)}: one host "
          f"{res['t_1host_s']:.3f} s, {HOSTS} hosts {res[f't_{HOSTS}host_s']:.3f} s "
          f"(GOPs {res['gops']}); merged artifacts bitwise the single host's")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

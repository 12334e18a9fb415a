"""Multi-host GOP (K-frame chain) parallelism (PyTorch port of
gsvc_tpu/parallel/multihost.py).

Frames between two K-frames form a dependent chain (P-frames warm-start
from frame t-1), but the chains themselves (GOPs, [K_i, K_{i+1})) are
independent: each starts from a fresh init at its K-frame, and a frame's
random draws depend only on (seed, frame_num) (`drivers.common.
frame_generator`). N hosts therefore train disjoint GOP sets with no
communication during training, and host 0 merges their artifacts into the
single-host run's layout, bit for bit. The hosts meet only for the K-frame
list, the end-of-run barrier and the merge, through a shared filesystem.

- `initialize()`: a `torch.distributed` gloo group from the GSVC_* variables
  (GSVC_COORDINATOR, GSVC_NUM_PROCS, GSVC_PROC_ID), so that the barriers
  are collectives. The group carries no tensor of a fit, only rendezvous.
- `assign_gops()` / `assign_frames()`: the represent and compress schedules.
- `barrier()`: `dist.barrier()` when the group is up, else markers in a
  shared directory (the same marker names as gsvc_tpu's, so a port host and
  a gsvc_tpu host meet on one directory).
- `merge_host_artifacts()` / `merge_compress_artifacts()`: the per-host
  `.host{h}` shards into the single-host run's files, byte for byte those
  gsvc_tpu's merges write.

Launcher: gsvc_tpu_torch/scripts/sh_train_multihost.sh. Several ranks
fitting one frame are `parallel.sharded`, which a multi-host run refuses.
"""

from __future__ import annotations

import datetime
import os
import re
import time
import warnings
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

# How long a host waits in one collective barrier: the wait lasts as long as
# the slowest host's K-frame detection or its whole encode (hours for a
# default run), so it outlasts any encode rather than bounding one
BARRIER_TIMEOUT = datetime.timedelta(hours=48)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up a torch.distributed gloo group from the arguments or the
    GSVC_* variables (init_method tcp://GSVC_COORDINATOR, BARRIER_TIMEOUT).

    Returns True if the group was initialized (num_processes > 1 and a
    coordinator); False, with no side effects, otherwise.
    """
    coordinator = coordinator or os.environ.get("GSVC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("GSVC_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("GSVC_PROC_ID", "0"))
    if num_processes <= 1 or not coordinator:
        return False
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=BARRIER_TIMEOUT,
    )
    return True


def gop_spans(k_frames: Sequence[int], num_frames: int) -> List[List[int]]:
    """K-frame list (1-based, sorted, starts at 1) -> list of GOPs, each a
    list of consecutive 1-based frame numbers starting at its K-frame."""
    ks = sorted(set(int(k) for k in k_frames))
    if not ks or ks[0] != 1:
        ks = [1] + [k for k in ks if k != 1]
    spans = []
    for i, k in enumerate(ks):
        end = ks[i + 1] if i + 1 < len(ks) else num_frames + 1
        if k > num_frames:
            continue
        spans.append(list(range(k, min(end, num_frames + 1))))
    return spans


def assign_gops(
    k_frames: Sequence[int], num_frames: int, num_hosts: int
) -> List[List[List[int]]]:
    """Balanced deterministic GOP assignment: greedy longest-GOP-first onto
    the least-loaded host (ties by host index). Returns, per host, a list
    of GOPs (each a list of 1-based frame numbers) ordered by start frame.
    """
    spans = gop_spans(k_frames, num_frames)
    order = sorted(range(len(spans)), key=lambda i: (-len(spans[i]), spans[i][0]))
    load = [0] * num_hosts
    buckets: List[List[List[int]]] = [[] for _ in range(num_hosts)]
    for i in order:
        h = min(range(num_hosts), key=lambda j: (load[j], j))
        buckets[h].append(spans[i])
        load[h] += len(spans[i])
    for b in buckets:
        b.sort(key=lambda s: s[0])
    return buckets


def _run_nonce() -> str:
    """Shared per-run namespace for barrier markers: GSVC_RUN_NONCE (set by
    the launcher) or SLURM_JOB_ID (identical on every node of a job). Empty
    when neither exists: `clear_stale_markers` then guards against reuse of
    an out_dir across runs."""
    return os.environ.get("GSVC_RUN_NONCE") or os.environ.get("SLURM_JOB_ID", "")


def clear_stale_markers(out_dir: Path, host_id: int) -> None:
    """Delete this host's leftover barrier markers from earlier runs in the
    same out_dir. Each host deletes only its own, before its first barrier
    of the run, so a fast peer's fresh markers are never touched; without
    this a rerun would pass the marker rendezvous on stale files and host 0
    could merge partial shards."""
    if out_dir.is_dir():
        for p in out_dir.glob(f".barrier_*.host{host_id}"):
            try:
                p.unlink()
            except OSError:
                pass


def barrier(tag: str, out_dir: Path, num_hosts: int, host_id: int,
            timeout_s: float = 3600.0, wait_for=None) -> None:
    """Host rendezvous: signal this host's arrival, then wait for the hosts
    in `wait_for` (default: all). A full `dist.barrier()` when a
    torch.distributed group of more than one rank is up (`wait_for`
    ignored, as gsvc_tpu's collective barrier), else markers in out_dir,
    where a directional wait (workers signal and exit, host 0 waits for
    everyone before it merges) also lets the hosts run one after another in
    any order. Markers are namespaced by the run nonce (GSVC_RUN_NONCE /
    SLURM_JOB_ID), so a rerun in the same out_dir never meets an earlier
    run's files; each host also clears its stale markers at its start
    (`clear_stale_markers`). Raises TimeoutError after timeout_s seconds
    without every awaited marker."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    nonce = _run_nonce()
    if not nonce and num_hosts > 1:
        # without a shared nonce a previous run's markers look like a peer
        # that finished earlier in this run (hosts may run one after
        # another), so rerun protection is only clear_stale_markers'
        warnings.warn(
            "multihost file barrier without GSVC_RUN_NONCE/SLURM_JOB_ID: "
            "reusing an out_dir across runs can rendezvous on a previous "
            "run's markers if a peer launches late. Export a shared "
            "GSVC_RUN_NONCE (the launcher script does this under SLURM).",
            stacklevel=2,
        )
    stem = f".barrier_{tag}.{nonce}" if nonce else f".barrier_{tag}"
    (out_dir / f"{stem}.host{host_id}").write_text("ok")
    if wait_for is None:
        wait_for = range(num_hosts)
    deadline = time.time() + timeout_s
    want = [out_dir / f"{stem}.host{h}" for h in wait_for]
    while not all(p.exists() for p in want):
        if time.time() > deadline:
            missing = [str(p) for p in want if not p.exists()]
            raise TimeoutError(f"barrier {tag}: missing {missing}")
        time.sleep(0.2)


def assign_frames(num_frames: int, num_hosts: int) -> List[List[int]]:
    """Balanced contiguous frame split for the compress stage, whose frames
    are independent (a P-frame's side information comes from the
    representation checkpoint, train_video_Compress.py:51-72)."""
    base = num_frames // num_hosts
    extra = num_frames % num_hosts
    out, start = [], 1
    for h in range(num_hosts):
        cnt = base + (1 if h < extra else 0)
        out.append(list(range(start, start + cnt)))
        start += cnt
    return out


_FRAME_LINE = re.compile(r"^Frame_(\d+):")


def _merge_checkpoints(model_dir: Path, num_hosts: int, required: bool) -> None:
    """The hosts' gmodels_state_dict.host{h}.npz into gmodels_state_dict.npz,
    keys in (frame, key) order; a missing shard raises when `required`."""
    merged: Dict[str, np.ndarray] = {}
    for h in range(num_hosts):
        p = model_dir / f"gmodels_state_dict.host{h}.npz"
        if required or p.exists():
            with np.load(p) as z:
                for k in z.files:
                    merged[k] = z[k]

    def frame_no(key: str) -> int:
        return int(key.split("/")[0].split("_")[1])

    keys = sorted(merged, key=lambda k: (frame_no(k), k))
    np.savez(model_dir / "gmodels_state_dict.npz", **{k: merged[k] for k in keys})


def _frame_lines(out_dir: Path, num_hosts: int) -> List[str]:
    """The hosts' Frame_ lines of train.host{h}.txt in frame order."""
    lines: List[str] = []
    for h in range(num_hosts):
        p = out_dir / f"train.host{h}.txt"
        if p.exists():
            lines += [ln for ln in p.read_text().splitlines() if _FRAME_LINE.match(ln)]
    lines.sort(key=lambda ln: int(_FRAME_LINE.match(ln).group(1)))
    return lines


def _grab(lines: List[str], field: str) -> List[float]:
    vals = []
    for ln in lines:
        m = re.search(rf"{field}:([0-9.eE+-]+)", ln)
        if m:
            vals.append(float(m.group(1)))
    return vals


def _mean(vals: List[float]) -> float:
    return float(np.mean(vals)) if vals else 0.0


def merge_host_artifacts(
    model_dir: Path, out_dir: Path, num_hosts: int, H: int, W: int
) -> None:
    """Union the represent hosts' shards into the single-host artifact set.

    Inputs (written by drivers/represent.py when --hosts > 1):
      model_dir/gmodels_state_dict.host{h}.npz
      out_dir/train.host{h}.txt            (per-frame metric lines)
      out_dir/num_gaussian_points.host{h}.txt
    Outputs: gmodels_state_dict.npz, train.txt and num_gaussian_points.txt
    with the frames in order, and train.txt's recomputed Average line.
    """
    _merge_checkpoints(model_dir, num_hosts, required=True)
    lines = _frame_lines(out_dir, num_hosts)
    size_mb = (model_dir / "gmodels_state_dict.npz").stat().st_size / (1024 * 1024)
    gn = []
    for h in range(num_hosts):
        p = out_dir / f"num_gaussian_points.host{h}.txt"
        if p.exists():
            gn += [(int(ln.split(":")[0].split("_")[1]), int(ln.split(":")[1]))
                   for ln in p.read_text().splitlines() if ":" in ln]
    gn.sort()
    with open(out_dir / "train.txt", "w") as f:
        for ln in lines:
            f.write(ln + "\n")
        psnr = _grab(lines, "PSNR")
        if psnr:
            f.write(
                "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}, Size:{:.4f}, "
                "Gaussian_number:{:.4f}\n".format(
                    H, W, float(np.mean(psnr)), float(np.mean(_grab(lines, "MS-SSIM"))),
                    _mean(_grab(lines, "Training")), _mean(_grab(lines, "Eval")),
                    _mean(_grab(lines, "FPS")), size_mb, _mean([g for _, g in gn]),
                )
            )
    with open(out_dir / "num_gaussian_points.txt", "w") as f:
        for fr, g in gn:
            f.write(f"frame_{fr}: {g}\n")


def merge_compress_artifacts(
    model_dir: Path, out_dir: Path, num_hosts: int, H: int, W: int
) -> None:
    """Union the compress hosts' shards (the quantized checkpoint's
    gmodels_state_dict.host{h}.npz and the train.host{h}.txt lines; the
    frames' bitstreams are written unsharded) into the single-host layout,
    with the recomputed compress Average line."""
    _merge_checkpoints(model_dir, num_hosts, required=False)
    lines = _frame_lines(out_dir, num_hosts)
    with open(out_dir / "train.txt", "w") as f:
        for ln in lines:
            f.write(ln + "\n")
        psnr = _grab(lines, "PSNR")
        if psnr:
            f.write(
                "Average: {}x{}, PSNR:{:.4f}, MS-SSIM:{:.4f}, Bpp:{:.4f}, "
                "Training:{:.4f}s, Eval:{:.8f}s, FPS:{:.4f}\n".format(
                    H, W, float(np.mean(psnr)), float(np.mean(_grab(lines, "MS-SSIM"))),
                    _mean(_grab(lines, "bpp")), _mean(_grab(lines, "Training")),
                    _mean(_grab(lines, "Eval")), _mean(_grab(lines, "FPS")),
                )
            )

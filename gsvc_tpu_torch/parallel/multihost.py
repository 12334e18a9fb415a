"""GOP and frame scheduling (the pure-Python part of
gsvc_tpu/parallel/multihost.py).

Frames between two K-frames form a dependent chain (P-frames warm-start
from frame t-1), and the chains (GOPs, [K_i, K_{i+1})) are independent. The
single-host represent driver iterates GOPs through `gop_spans`;
`assign_gops` and `assign_frames` are the multi-host schedules of the JAX
package, kept equal to it. Running several hosts (the barrier and the
artifact merge) is not ported: the drivers refuse `--hosts > 1`.
"""

from __future__ import annotations

from typing import List, Sequence

NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 3: the sharded "
              "trainer, then multi-host)")


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

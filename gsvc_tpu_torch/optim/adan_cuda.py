"""Adan's update on the card: every leaf of a step in one launch of
csrc/adan.cu, in place.

gsvc_tpu has no kernel here: its `optim/adan.py` is plain jnp, which XLA
fuses into one update. The port's plain version, `optim.adan._update`,
runs one PyTorch op at a time, 31 kernels a leaf (125 a represent step of
4 leaves, ~155 a QAT step of 5), each ~1.6-1.8 us plus a gap on the H100,
for work whose bytes take 1.2 us at 1080p/10k. The kernel reads each
element's six values once and writes five (`utils.work.adan_work`), over
the leaves' concatenated range (`leaf_table`); the step's scalars, its
fresh flag and the clip factor stay on the device, so a CUDA graph of the
step replays every later step. Its arithmetic is `_update`'s on CUDA
tensors, op for op in the same order and each rounded once, so its
results are bitwise the plain version's there (the design note is in the
source).

`adan_update` checks its inputs (`check_inputs`) and raises on what the
kernel does not take; it runs only on CUDA tensors (`optim.adan.adan_step_`
keeps CPU tensors on the plain version). Each call is one launch, counted
as the recorder's `launches.adan_update` (`_build.launch`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.ops.rasterize_cuda import sm_count

MAX_LEAVES = 8  # csrc/adan.cu's kMaxLeaves
VEC = 4  # elements a unit (kPer): one float4 of each tensor
BLOCKS_PER_SM = 16  # the kernel's 128-thread blocks resident on an SM
# a leaf's tensors, in the order the kernel takes them
FIELDS = ("p", "g", "m", "n", "d", "npg")


def leaf_table(counts: Sequence[int]) -> Tuple[Tuple[int, ...], int]:
    """(each leaf's first unit, the units of all) for leaves of `counts`
    elements: a unit is VEC consecutive elements of one leaf (a leaf's last
    unit may hold fewer), a thread's share of the launch."""
    firsts, units = [], 0
    for c in counts:
        firsts.append(units)
        units += -(-int(c) // VEC)
    return tuple(firsts), units


def check_inputs(leaves, table, row, fresh, clip, device) -> None:
    """Raise ValueError unless the kernel takes these inputs on `device`:
    1..MAX_LEAVES leaves, each six contiguous float32 tensors (p, g, m, n, d,
    -g_prev) of one shape; table a contiguous float32 [R, 5]; row one int64;
    fresh one bool; clip None or one float32."""
    device = torch.device(device)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"adan_update: {len(leaves)} leaves, the kernel takes 1 to "
                         f"{MAX_LEAVES}")
    for i, leaf in enumerate(leaves):
        if len(leaf) != len(FIELDS):
            raise ValueError(f"adan_update: leaf {i} has {len(leaf)} tensors, want "
                             f"{len(FIELDS)} {FIELDS}")
        shape = leaf[0].shape
        for name, t in zip(FIELDS, leaf):
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() \
                    or t.shape != shape:
                raise ValueError(
                    f"adan_update: leaf {i}'s {name} must be contiguous float32 "
                    f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}{'' if t.is_contiguous() else ', not contiguous'}")
    scalars = (("table", table, torch.float32), ("row", row, torch.int64),
               ("fresh", fresh, torch.bool))
    if clip is not None:
        scalars += (("clip", clip, torch.float32),)
    for name, t, dtype in scalars:
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"adan_update: {name} must be {dtype} on {device}, got "
                             f"{t.dtype} on {t.device}")
        if name != "table" and t.numel() != 1:
            raise ValueError(f"adan_update: {name} must hold one value, got "
                             f"{tuple(t.shape)}")
    if table.dim() != 2 or table.shape[1] != 5 or not table.is_contiguous():
        raise ValueError(f"adan_update: table must be contiguous [R, 5], got "
                         f"{tuple(table.shape)}")


def adan_update(leaves, table: torch.Tensor, row: torch.Tensor, fresh: torch.Tensor,
                clip: Optional[torch.Tensor], betas: Tuple[float, float, float],
                eps: float, no_prox: bool) -> None:
    """One Adan update of every leaf in one launch, in place: leaves is
    [(p, g, m, n, d, -g_prev)] a leaf, their new values written into p, m,
    n, d and -g_prev; the step's scalars are row `row` of `table`
    (`optim.adan.adan_table` for a CUDA device), read on the device with
    the fresh flag and the clip factor (None: no clip)."""
    dev = leaves[0][0].device if leaves and leaves[0] else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"adan_update: the kernel runs on CUDA tensors, got {dev}")
    check_inputs(leaves, table, row, fresh, clip, dev)
    counts = [leaf[0].numel() for leaf in leaves]
    firsts, units = leaf_table(counts)
    b1, b2, b3 = betas
    n = len(leaves)
    ptrs = (ctypes.c_void_p * (len(FIELDS) * n))(*(t.data_ptr() for leaf in leaves
                                                  for t in leaf))
    consts = (ctypes.c_float * 7)(b1, 1.0 - b1, b2, 1.0 - b2, b3, 1.0 - b3, eps)
    _build.launch(
        _adan_lib(), "adan_update", dev, n, ptrs, (ctypes.c_longlong * n)(*counts),
        (ctypes.c_longlong * n)(*firsts), units, _build.ptr(table), table.shape[0],
        _build.ptr(row), _build.ptr(fresh), None if clip is None else _build.ptr(clip),
        consts, int(no_prox), BLOCKS_PER_SM * sm_count(dev),
    )


def _adan_lib() -> ctypes.CDLL:
    return _build.bind("adan", {
        "adan_update": (I32, [I32, VP, VP, VP, I64, VP, I64, VP, VP, VP, VP, I32, I32, VP])})

"""E1: the training loss in the tile-row layout in one pass (csrc/rows_loss.cu),
beside its plain PyTorch version and the autograd function the fits call.

gsvc_tpu has no kernel here: it leaves the chain from the rasterizer's
output to the loss (the background blend of `rasterize_gaussians_sum`, the
clip `_clip01`, the masked difference, its square and its sum) to XLA's
fusion. One PyTorch op at a time, that chain is 23 image-sized kernels in a
step (8 forward, 15 in autograd's backward), ~49 reads and writes of the
[rows, 256] float32 array (1.23 GB a step at 1080p). E1 reads K4's raw
rows, the target and the mask once and writes one gradient array `gd`
(dL/d(raw) for a unit loss gradient), with a float32 partial of the sums a
CTA, reduced in a fixed order; the backward is `grad * gd`, one multiply.
What bounds it is bytes, and its design moves each byte once.

Per element, in the chain's float32 operations (`rows_loss_torch`):
  x = raw * live + 1 * (1 - live), live = (kept total >= 1)
  out = clip01(x); diff = (out - gt) * mask
  gd = 2 diff mask c live (L2), sign(diff) mask c live (L1)
with c the clip's gradient, torch.maximum / torch.minimum's tie halves
included. For a 0/1 mask every factor past diff is a power of two or zero,
so the backward's `grad * gd` is bitwise autograd's gradient of the chain;
only the sums move, by their order.

`rows_loss` on a CPU tensor runs the plain version; on a CUDA tensor it
launches E1 or raises (`check_inputs`), and counts the launch as the
recorder's `launches.rows_loss` (`_build.launch`; a graph's replay adds
it as its capture saw it). E1 keeps one ticket a device for its last CTA:
its launches must not overlap on two streams.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.ops import rasterize
from gsvc_tpu_torch.ops.rasterize_cuda import sm_count

THREADS = 256  # csrc/rows_loss.cu's kThreads
CTAS_PER_SM = 8  # E1's CTAs an SM: a full SM of threads


def rows_loss_torch(raw: torch.Tensor, gt_rows: torch.Tensor, mask: torch.Tensor,
                    num_intersects: torch.Tensor,
                    l1: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of E1: (gd, loss, sq), loss the sum of |diff| (L1) or of
    diff^2, sq the sum of diff^2, gd dL/d(raw) for a unit loss gradient
    (the explicit formula, not autograd). The blend is
    `rasterize_gaussians_sum`'s on its default background, the clip
    `_clip01`'s, op for op."""
    x = rasterize.blend_background(raw, num_intersects, raw.new_ones((3,)), "rows")
    y = torch.maximum(x, x.new_zeros(()))
    diff = (torch.minimum(y, x.new_ones(())) - gt_rows) * mask
    sq = torch.sum(diff * diff)
    loss = torch.sum(torch.abs(diff)) if l1 else sq.clone()  # two tensors, as E1's
    g = (torch.sign(diff) if l1 else diff + diff) * mask
    g = torch.where(y == 1.0, g * 0.5, g).masked_fill_(y > 1.0, 0.0)  # minimum's
    g = torch.where(x == 0.0, g * 0.5, g).masked_fill_(x < 0.0, 0.0)  # maximum's
    return g * (num_intersects >= 1).to(raw.dtype), loss, sq


def check_inputs(raw, gt_rows, mask, num_intersects) -> None:
    """Raise ValueError unless E1 takes these: raw, gt_rows and mask
    contiguous float32 [rows, cols] on one device, cols a multiple of 4 and
    each 16-byte aligned; num_intersects one int32."""
    dev = raw.device
    shape = tuple(raw.shape)
    if len(shape) != 2 or shape[0] < 1 or shape[1] % 4 or shape[0] * shape[1] // 4 >= 1 << 30:
        raise ValueError(f"rows_loss: raw must be [rows, cols] with cols a multiple of 4, "
                         f"got {shape}")
    for name, t in (("raw", raw), ("gt_rows", gt_rows), ("mask", mask)):
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rows_loss: {name} must be contiguous 16-byte aligned float32 "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if num_intersects.dtype != torch.int32 or num_intersects.numel() != 1 \
            or num_intersects.device != dev:
        raise ValueError(f"rows_loss: num_intersects must be one int32 on {dev}, got "
                         f"{num_intersects.dtype} {tuple(num_intersects.shape)}")


def rows_loss(raw: torch.Tensor, gt_rows: torch.Tensor, mask: torch.Tensor,
              num_intersects: torch.Tensor,
              l1: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E1: (gd, loss, sq) of K4's raw rows against the rows target
    (`rows_loss_torch`'s values; the sums in E1's fixed order). On CPU
    tensors, the plain version."""
    if not raw.is_cuda:
        return rows_loss_torch(raw, gt_rows, mask, num_intersects, l1)
    check_inputs(raw, gt_rows, mask, num_intersects)
    dev = raw.device
    rows, cols = raw.shape
    grid = max(1, min(-(-rows * cols // (4 * THREADS)), CTAS_PER_SM * sm_count(dev)))
    gd = torch.empty_like(raw)
    partials = torch.empty((2 * grid,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    sq = torch.empty((), dtype=torch.float32, device=dev)
    _build.launch(_rows_loss_lib(), "rows_loss", dev, _build.ptr(raw), _build.ptr(gt_rows),
                  _build.ptr(mask), rows, cols, _build.ptr(num_intersects), _build.ptr(gd),
                  _build.ptr(partials), _build.ptr(loss), _build.ptr(sq), int(l1), grid)
    return gd, loss, sq


class RowsLoss(torch.autograd.Function):
    """(loss, sq) of `rows_loss`, differentiable w.r.t. raw: it saves gd
    alone, and its backward is grad * gd (sq is not differentiable)."""

    @staticmethod
    def forward(ctx, raw, gt_rows, mask, num_intersects, l1):
        gd, loss, sq = rows_loss(raw, gt_rows, mask, num_intersects, l1)
        ctx.save_for_backward(gd)
        ctx.mark_non_differentiable(sq)
        return loss, sq

    @staticmethod
    def backward(ctx, grad_loss, _grad_sq):
        (gd,) = ctx.saved_tensors
        return (grad_loss * gd if ctx.needs_input_grad[0] else None,
                None, None, None, None)


def _rows_loss_lib() -> ctypes.CDLL:
    return _build.bind("rows_loss", {
        "rows_loss": (I32, [VP, VP, VP, I64, I32, VP, VP, VP, VP, VP, I32, I32, VP])})

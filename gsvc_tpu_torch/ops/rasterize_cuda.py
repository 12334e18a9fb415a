"""Forward sum-rasterizer kernel K4/K5 (csrc/rasterize_fwd.cu), with its
plain PyTorch version.

Replaces `_forward_kernel` (layout "image", K4) and `_forward_kernel_chw`
(layout "chw", K5) of gsvc_tpu/ops/rasterize_pallas.py, launched from
`_forward_impl`. The TPU streams each tile row's lanes through VMEM and
evaluates sigma and the colour sum as MXU matmuls over a whole row of
tiles. On the card the reference CUDA design fits directly: one CTA per
16x16 tile, one thread per pixel, the tile's first min(count, cap) splats
gathered once into shared memory (9 floats each, 9 KB at cap 256; the
TPU's `_pack_lanes` gather folds into this load), then each thread sums
rgb * alpha over them in lane order, in f32 registers: deterministic, no
atomics. The store writes [H, W, 3] or [3, H, W] directly, masking pixels
past the image edge (1080 is 67.5 tile rows).

What bounds it: one expf and ~12 FLOPs per (pixel, lane) pair, about
2e7 pairs at 1080p/10k, so the SFU/FP32 pipes and the per-tile load
imbalance (a tile's CTA runs as long as its lane count) rather than
memory; the output is 25 MB. `expf`, not `__expf`: fast math belongs to
the later fast-colour mode.

`forward_image` (K4) and `forward_chw` (K5) are the two wrappers, each
with its own launch count. On a CPU tensor a wrapper runs the plain
version (ops/rasterize_binned); on a CUDA tensor it launches the kernel or
raises. No autograd yet: the backward kernel (K6) arrives with the
training slice, so the wrappers refuse inputs that require a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch.ops.binning import BinnedSplats
from gsvc_tpu_torch.ops.rasterize_binned import rasterize_binned

def rasterize_forward_torch(
    binned: BinnedSplats, xys, conics, colors, opacity,
    img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
    block_w: int = 16, block_h: int = 16, cap: int = 256,
    layout: str = "image",
) -> torch.Tensor:
    """Plain version of K4/K5: the binned renderer in the chosen layout."""
    img = rasterize_binned(
        binned, xys, conics, colors, opacity, img_height, img_width,
        tile_bounds, block_w, block_h, cap,
    )
    return img.permute(2, 0, 1).contiguous() if layout == "chw" else img


def forward_image(binned, xys, conics, colors, opacity, img_height,
                  img_width, tile_bounds, block_w=16, block_h=16, cap=256):
    """K4: the sum render as [H, W, 3]."""
    if not xys.is_cuda:
        return rasterize_forward_torch(
            binned, xys, conics, colors, opacity, img_height, img_width,
            tile_bounds, block_w, block_h, cap, "image",
        )
    out = _launch(binned, xys, conics, colors, opacity, img_height,
                  img_width, tile_bounds, block_w, block_h, cap, chw=False)
    forward_image.launches += 1
    return out


def forward_chw(binned, xys, conics, colors, opacity, img_height,
                img_width, tile_bounds, block_w=16, block_h=16, cap=256):
    """K5: the sum render as planar [3, H, W]."""
    if not xys.is_cuda:
        return rasterize_forward_torch(
            binned, xys, conics, colors, opacity, img_height, img_width,
            tile_bounds, block_w, block_h, cap, "chw",
        )
    out = _launch(binned, xys, conics, colors, opacity, img_height,
                  img_width, tile_bounds, block_w, block_h, cap, chw=True)
    forward_chw.launches += 1
    return out


forward_image.launches = 0
forward_chw.launches = 0


def _launch(binned, xys, conics, colors, opacity, img_height, img_width,
            tile_bounds, block_w, block_h, cap, chw: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (xys, conics, colors, opacity)
    ):
        raise NotImplementedError(
            "the CUDA rasterizer has no backward yet; call it under "
            "torch.no_grad()"
        )
    dev = xys.device
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    f32 = {"xys": (xys, (n, 2)), "conics": (conics, (n, 3)),
           "colors": (colors, (n, 3)), "opacity": (opacity.reshape(-1), (n,))}
    for name, (t, shape) in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"rasterize_forward: {name} must be float32 "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)}")
    i32 = (binned.tile_bin_start, binned.tile_counts, binned.sorted_gauss_ids)
    for t in i32:
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("rasterize_forward: binning arrays must be int32 "
                             f"on {dev}")
    if binned.tile_counts.shape[0] != tb_x * tb_y:
        raise ValueError("rasterize_forward: binning tile grid mismatch")
    if block_w * block_h > 1024 or 36 * cap > 48 * 1024:
        raise ValueError(f"rasterize_forward: block {block_w}x{block_h} / "
                         f"cap {cap} exceeds one CTA")
    args = [t.contiguous() for t in i32] + [
        t.contiguous() for t, _ in f32.values()
    ]
    shape = (3, img_height, img_width) if chw else (img_height, img_width, 3)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _raster_lib()
    with torch.cuda.device(dev):
        rc = lib.rasterize_forward(
            *(_build.ptr(t) for t in args), n, img_height, img_width,
            tb_x, tb_y, block_w, block_h, cap, int(chw),
            _build.ptr(out), _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "rasterize_forward")
    return out


def _raster_lib() -> ctypes.CDLL:
    lib = _build.load("rasterize_fwd")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_forward.restype = i32
        lib.rasterize_forward.argtypes = [vp] * 7 + [i32] * 9 + [vp, vp]
        lib._gsvc_bound = True
    return lib

"""Public sum-rasterization API (PyTorch port of gsvc_tpu/ops/rasterize.py).

Mirrors the reference `rasterize_gaussians_sum`
(gsplat/gsplat/rasterize_sum.py:14-86), with binning and rendering on the
device and no host sync.

Backends:
- "cuda": binning through the K1/K2 wrappers and the kernels' autograd
  function (ops/rasterize_cuda.py: forward K4/K5, backward K6 then the K3
  reduction); on CPU tensors the wrappers run their plain versions.
- "torch": the all-PyTorch path (plain binning + ops/rasterize_binned.py,
  differentiated by autograd), on either device.
- "dense": the O(N * pixels) oracle (ops/rasterize_dense.py), tests only.
- "auto": "cuda" for CUDA tensors, "torch" for CPU tensors.

`rasterize_gaussians_sum_clipped` is the render clipped to [0, 1], the
models' forward(): an eval render on the kernel path is one launch of K4 /
K5 whose store blends the background and clamps; every other render is
the chain, `_clip01` where it has an autograd node.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsvc_tpu_torch.ops import loss_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians, default_max_intersects
from gsvc_tpu_torch.ops.rasterize_cuda import blend_background

# Per-tile gaussian cap: the reference 3-channel kernel renders only the
# first BLOCK_SIZE=256 binned gaussians of a tile (forward.cu:613).
TILE_CAP = 256

BACKENDS = ("auto", "cuda", "torch", "dense")


def _grid(img_height: int, img_width: int, block_h: int, block_w: int):
    return (img_width + block_w - 1) // block_w, (img_height + block_h - 1) // block_h


def image_to_rows(img: torch.Tensor, img_height: int, img_width: int,
                  BLOCK_H: int = 16, BLOCK_W: int = 16) -> torch.Tensor:
    """Tile a [H, W, 3] image into the layout="rows" blocks (targets and
    masks of tile-space training losses); gsvc_tpu's `image_to_rows`."""
    tb_x, tb_y = _grid(img_height, img_width, BLOCK_H, BLOCK_W)
    return rasterize_cuda.image_to_rows(img, tb_x, tb_y, BLOCK_W, BLOCK_H)


def rows_to_image(rows: torch.Tensor, img_height: int, img_width: int,
                  BLOCK_H: int = 16, BLOCK_W: int = 16) -> torch.Tensor:
    """Inverse of the layout="rows" output: blocks -> [H, W, 3] image."""
    tb_x, tb_y = _grid(img_height, img_width, BLOCK_H, BLOCK_W)
    return rasterize_cuda.rows_to_image(rows, tb_x, tb_y, img_height,
                                        img_width, BLOCK_W, BLOCK_H)


def rasterize_gaussians_sum(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    BLOCK_H: int = 16,
    BLOCK_W: int = 16,
    background: Optional[torch.Tensor] = None,
    return_alpha: bool = False,
    backend: str = "auto",
    max_intersects: Optional[int] = None,
    tile_rows=None,
    layout: str = "image",
    fast_color: bool = False,
):
    """Accumulation rasterizer: [H, W, C] ("image"), [3, H, W] ("chw"), or
    ("rows", 3 channels) the [tb_y * round8(3*tb_x), BLOCK_H*BLOCK_W]
    tile-row blocks of `image_to_rows`, which pointwise losses consume
    without an untile transpose. Differentiable on every backend.

    `depths` is accepted for API parity and ignored (the sum render is
    order-independent). tile_rows=(row0, num_rows) renders only tile rows
    [row0, row0 + num_rows) of the grid, binned as the whole frame
    (gsvc_tpu's image sharding; "cuda" and "torch" backends): "rows" holds
    num_rows blocks, "image" / "chw" `rasterize_binned.span_height` pixel
    rows, zero past the image. Quirks kept for parity with gsvc_tpu:
    - with zero intersections the image is `background` everywhere
      (rasterize_sum.py:121-129), though the normal path never composites
      background (forward.cu:621-624);
    - `return_alpha` returns zeros (the sum kernel never updates
      transmittance).
    `fast_color` (gsvc_tpu's COLOR_BF16 mode, an argument here) renders
    through the fast-colour kernels and their gradient ("cuda"; their
    plain versions on "torch"): `ops/rasterize_cuda.py`. Off, every path
    is as it was, bit for bit.
    """
    del depths
    img, total = _render_sum(
        xys, radii, conics, num_tiles_hit, colors, opacity, img_height, img_width,
        BLOCK_H, BLOCK_W, return_alpha, backend, max_intersects, tile_rows, layout,
        fast_color)
    if background is None:
        background = torch.ones((colors.shape[-1],), dtype=colors.dtype, device=colors.device)
    img = blend_background(img, total, background, layout)
    if return_alpha:
        hw = img.shape[1:] if layout == "chw" else img.shape[:2]
        return img, torch.zeros(hw, dtype=img.dtype, device=img.device)
    return img


def rasterize_gaussians_sum_clipped(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    BLOCK_H: int = 16,
    BLOCK_W: int = 16,
    backend: str = "auto",
    max_intersects: Optional[int] = None,
    tile_rows=None,
    layout: str = "image",
    fast_color: bool = False,
) -> torch.Tensor:
    """`rasterize_gaussians_sum(...)` (the default background) clipped to
    [0, 1]: bitwise `torch.clamp` of it, and with an autograd node
    `_clip01` of it (jnp.clip's gradient). An eval render on the kernel
    path (3 channels, layout "image" or "chw", exact colour) is one launch
    of K4 / K5 whose store blends and clamps (`rasterize_cuda.CLIPPED`).
    Arguments as `rasterize_gaussians_sum`'s."""
    del depths
    img, total = _render_sum(
        xys, radii, conics, num_tiles_hit, colors, opacity, img_height, img_width,
        BLOCK_H, BLOCK_W, False, backend, max_intersects, tile_rows, layout, fast_color,
        clip=True)
    if total is None:  # K4 / K5 stored the final image
        return img
    img = blend_background(img, total, img.new_ones((colors.shape[-1],)), layout)
    return _clip01(img) if img.requires_grad else torch.clamp(img, 0.0, 1.0)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """clip to [0, 1] with jnp.clip's gradient (half at a tie)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def rasterize_rows_loss(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    gt_rows: torch.Tensor,
    mask: torch.Tensor,
    BLOCK_H: int = 16,
    BLOCK_W: int = 16,
    loss_type: str = "L2",
    backend: str = "auto",
    max_intersects: Optional[int] = None,
    tile_rows=None,
):
    """(loss, sq) of the layout="rows" render (the default background),
    clipped to [0, 1], against the tile-row target `gt_rows` under `mask`
    (`models.represent.make_rows_target`): loss the sum of squared ("L2")
    or absolute ("L1") masked differences, differentiable, sq the sum of
    squares. The render's background blend, the clip and the loss run in
    one pass of E1 (`ops/loss_cuda.py`; its plain version on CPU tensors),
    whose gradient is bitwise autograd's through `rasterize_gaussians_sum`,
    the clip and the sum. Arguments as `rasterize_gaussians_sum`'s."""
    del depths
    if loss_type not in ("L2", "L1"):
        raise ValueError(f"the rows loss is L2 or L1, got {loss_type!r}")
    raw, total = _render_sum(
        xys, radii, conics, num_tiles_hit, colors, opacity, img_height, img_width,
        BLOCK_H, BLOCK_W, False, backend, max_intersects, tile_rows, "rows", False)
    return loss_cuda.RowsLoss.apply(raw, gt_rows, mask, total.to(torch.int32),
                                    loss_type == "L1")


def _render_sum(xys, radii, conics, num_tiles_hit, colors, opacity, img_height, img_width,
                BLOCK_H, BLOCK_W, return_alpha, backend, max_intersects, tile_rows, layout,
                fast_color, clip=False):
    """(the render before its background blend, the kept intersections) of
    `rasterize_gaussians_sum`; with `clip`, an eval render that K4 / K5 can
    store clipped is (the final image, None)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if layout not in rasterize_cuda.LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    c_dim = colors.shape[-1]
    if layout == "rows" and c_dim != 3:
        raise ValueError("layout='rows' holds exactly 3 channels")
    if layout == "rows" and return_alpha:
        raise ValueError("return_alpha unsupported for layout='rows'")
    tile_bounds = (
        (img_width + BLOCK_W - 1) // BLOCK_W,
        (img_height + BLOCK_H - 1) // BLOCK_H,
        1,
    )
    if max_intersects is None:
        max_intersects = default_max_intersects(
            xys.shape[0], tile_bounds[0] * tile_bounds[1]
        )
    if backend == "auto":
        backend = "cuda" if xys.is_cuda else "torch"
    # The kernel packs exactly 3 colour channels; other counts take the
    # binned path, as the reference routes C != 3 to its N-d kernel
    # (rasterize_sum.py:147-150).
    if backend == "cuda" and c_dim != 3:
        backend = "torch"

    if backend == "dense":
        if tile_rows is not None:
            raise ValueError("tile_rows unsupported for the dense oracle")
        if fast_color:
            raise ValueError("fast_color unsupported for the dense oracle")
        from gsvc_tpu_torch.ops.rasterize_dense import rasterize_gaussians_sum_dense

        img = rasterize_gaussians_sum_dense(
            xys, radii, conics, colors, opacity,
            img_height, img_width, BLOCK_H, BLOCK_W, cap=TILE_CAP,
        )
        total = torch.sum(num_tiles_hit)
        if layout == "chw":
            img = img.permute(2, 0, 1)
        elif layout == "rows":
            img = image_to_rows(img, img_height, img_width, BLOCK_H, BLOCK_W)
    else:
        use_kernels = backend == "cuda"
        binned = bin_gaussians(
            xys, radii, num_tiles_hit, tile_bounds, BLOCK_W, BLOCK_H,
            max_intersects, cap=TILE_CAP, kernels=use_kernels,
        )
        total = binned.num_intersects
        args = (binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, BLOCK_W, BLOCK_H, TILE_CAP)
        if use_kernels and clip and layout in rasterize_cuda.CLIPPED and not fast_color \
                and not (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (xys, conics, colors, opacity))):
            # an eval render (no autograd node): the store blends and clamps
            return rasterize_cuda.CLIPPED[layout](*args, tile_rows), None
        if use_kernels:
            img = rasterize_cuda.rasterize_sum(*args, layout=layout, tile_rows=tile_rows,
                                               fast_color=fast_color)
        else:
            img = rasterize_cuda.rasterize_forward_torch(*args, layout=layout,
                                                         tile_rows=tile_rows,
                                                         fast_color=fast_color)
    return img, total

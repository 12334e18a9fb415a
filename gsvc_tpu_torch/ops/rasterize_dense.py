"""Dense O(N * pixels) sum-rasterizer: the port's own oracle.

PyTorch port of gsvc_tpu/ops/rasterize_dense.py, with the same reference
semantics (forward.cu:512-627): alpha = min(1, opac * exp(-sigma)),
sigma = 0.5*(c1*dx^2 + c3*dy^2) + c2*dx*dy with dx = x - px on integer
pixel coordinates, the sigma >= 0 and alpha >= 1/255 cutoffs, no
background, a splat touching only the tiles of its bbox, and the per-tile
cap on the first `cap` splats in gaussian order (forward.cu:613).
"""

from __future__ import annotations

from typing import Optional

import torch

from gsvc_tpu_torch.ops.projection import _tile_bbox

ALPHA_CUTOFF = 1.0 / 255.0


def _min1_forward_only(x: torch.Tensor) -> torch.Tensor:
    """Forward min(x, 1); backward identity (reference backward.cu:824),
    written as gsvc_tpu's `_min1_forward_only` so forward values match it
    bit for bit."""
    return x + (torch.clamp(x, max=1.0) - x).detach()


def rasterize_gaussians_sum_dense(
    xys: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    block_h: int = 16,
    block_w: int = 16,
    cap: Optional[int] = None,
) -> torch.Tensor:
    """Render [H, W, C] by evaluating every splat at every pixel (masked).

    Memory is O(H*W*N): for tests and small inputs only.
    """
    dev = xys.device
    tb_x = (img_width + block_w - 1) // block_w
    tb_y = (img_height + block_h - 1) // block_h
    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radii.to(xys.dtype), (tb_x, tb_y, 1), block_w, block_h
    )
    valid_g = radii > 0

    px = torch.arange(img_width, dtype=xys.dtype, device=dev)
    py = torch.arange(img_height, dtype=xys.dtype, device=dev)
    tile_x = (torch.arange(img_width, device=dev) // block_w)[None, :, None]
    tile_y = (torch.arange(img_height, device=dev) // block_h)[:, None, None]
    in_x = (tile_x >= tmin_x) & (tile_x < tmax_x)  # [1, W, N]
    in_y = (tile_y >= tmin_y) & (tile_y < tmax_y)  # [H, 1, N]
    member = in_x & in_y & valid_g

    if cap is not None:
        # rank of each gaussian in its tile's bin (gaussian order)
        tgx = torch.arange(tb_x, device=dev)[None, :, None]
        tgy = torch.arange(tb_y, device=dev)[:, None, None]
        t_in = (
            (tgx >= tmin_x) & (tgx < tmax_x)
            & (tgy >= tmin_y) & (tgy < tmax_y) & valid_g
        )  # [tb_y, tb_x, N]
        rank = torch.cumsum(t_in.to(torch.int32), dim=-1) - 1
        t_keep = t_in & (rank < cap)
        keep = t_keep.repeat_interleave(block_h, 0).repeat_interleave(block_w, 1)
        member = member & keep[:img_height, :img_width]

    dx = xys[:, 0][None, None, :] - px[None, :, None]
    dy = xys[:, 1][None, None, :] - py[:, None, None]
    c1 = conics[:, 0][None, None, :]
    c2 = conics[:, 1][None, None, :]
    c3 = conics[:, 2][None, None, :]
    sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy  # [H, W, N]
    alpha = _min1_forward_only(opacity.reshape(-1)[None, None, :] * torch.exp(-sigma))
    contrib = member & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
    w = torch.where(contrib, alpha, torch.zeros_like(alpha))
    return torch.einsum("hwn,nc->hwc", w, colors)

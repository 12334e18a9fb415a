"""Per-frame representation model: the render half of
gsvc_tpu/models/represent.py (`render_frame`, `render_frame_pos`).

The training loop (`make_train_step`, `fit_frame`) arrives with the
training slice.
"""

from __future__ import annotations

import torch

from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import CHOLESKY_BOUND, GaussianFrame
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum


@torch.no_grad()
def render_frame(
    params: GaussianFrame, alive: torch.Tensor, cfg: FrameConfig,
    rgb_w_trainable: bool = True, layout: str = "image",
) -> torch.Tensor:
    """model.forward(): render + clamp to [0, 1].

    Mirrors GaussianSplats_Represent.py:83-90 (opacity ones, colours
    premultiplied by rgb_W, clamp outside the rasterizer). layout="image"
    returns [H, W, 3], layout="chw" the planar [3, H, W].
    """
    colors = params.get_features if rgb_w_trainable else params.features_dc
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, params.get_cholesky_elements, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    opacity = torch.ones((params.capacity, 1), dtype=torch.float32,
                         device=xys.device)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, colors, opacity,
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects, layout=layout,
    )
    return torch.clamp(img, 0.0, 1.0)


@torch.no_grad()
def render_frame_pos(
    params: GaussianFrame, alive: torch.Tensor, cfg: FrameConfig
) -> torch.Tensor:
    """model.forward_pos(): every live splat with unit colour and a fixed
    cholesky of 1.0 (+ bound), [H, W, 3] (GaussianSplats_Represent.py:72-82)."""
    n = params.capacity
    dev = params.xyz.device
    cholesky = torch.full((n, 3), 1.0, dtype=torch.float32, device=dev) + torch.tensor(
        CHOLESKY_BOUND, dtype=torch.float32, device=dev
    )
    xys, depths, radii, conics, nth = project_gaussians_2d(
        params.get_xyz, cholesky, cfg.H, cfg.W,
        cfg.tile_bounds, cfg.block_w, cfg.block_h, alive=alive,
    )
    ones = torch.ones((n, 3), dtype=torch.float32, device=dev)
    img = rasterize_gaussians_sum(
        xys, depths, radii, conics, nth, ones, ones[:, :1],
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
    )
    return torch.clamp(img, 0.0, 1.0)

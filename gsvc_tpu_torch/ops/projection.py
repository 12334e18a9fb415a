"""2D Gaussian projection (PyTorch port of gsvc_tpu/ops/projection.py).

(NDC means, Cholesky L) -> pixel centres, conics, radii and tile counts,
with the reference semantics listed in the JAX module's docstring
(foward2d.cu:12, helpers.cuh:11-68). Elementwise over N splats: no kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def compute_cov2d_bounds(cov2d: torch.Tensor):
    """(N,3) upper-tri cov -> (conic (N,3), radius (N,), ok (N,) bool).

    det == 0 entries get conic 0 and radius 0 (helpers.cuh:45-68)."""
    a, b_, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b_ * b_
    ok = det != 0.0
    safe_det = torch.where(ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c * inv_det, -b_ * inv_det, a * inv_det], dim=-1)
    conic = torch.where(ok[:, None], conic, torch.zeros_like(conic))
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - det, min=0.1))
    vmax = half_tr + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(vmax, min=0.0)))
    radius = torch.where(ok, radius, torch.zeros_like(radius))
    return conic, radius, ok


def _tile_bbox(
    xys: torch.Tensor,
    radius: torch.Tensor,
    tile_bounds: Tuple[int, int, int],
    block_w: int,
    block_h: int,
):
    """Tile-space bbox (inclusive min, exclusive max), clamped to the grid."""
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    tcx = xys[:, 0] / block_w
    tcy = xys[:, 1] / block_h
    trx = radius / block_w
    try_ = radius / block_h

    def cell(v, hi):
        return torch.clamp(torch.floor(v).to(torch.int32), 0, hi)

    return (
        cell(tcx - trx, tb_x),
        cell(tcy - try_, tb_y),
        cell(tcx + trx + 1.0, tb_x),
        cell(tcy + try_ + 1.0, tb_y),
    )


def project_gaussians_2d(
    means2d: torch.Tensor,
    L_elements: torch.Tensor,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    block_w: int = 16,
    block_h: int = 16,
    alive: Optional[torch.Tensor] = None,
):
    """Project 2D splats to pixel space.

    Returns xys [N,2], depths [N] (zeros), radii [N] int32, conics [N,3],
    num_tiles_hit [N] int32. Dead splats (`alive` False) get radius 0 and
    no tiles.
    """
    n = means2d.shape[0]
    # 0.5*size*ndc + 0.5*size per axis, with host scalars (no host-to-device
    # copy, so the path stays capturable in a CUDA graph)
    hw, hh = 0.5 * img_width, 0.5 * img_height
    xys = torch.stack(
        [hw * means2d[:, 0] + hw, hh * means2d[:, 1] + hh], dim=-1
    )

    l11, l21, l22 = L_elements[:, 0], L_elements[:, 1], L_elements[:, 2]
    cov2d = torch.stack([l11 * l11, l11 * l21, l21 * l21 + l22 * l22], dim=-1)
    conics, radius_f, ok = compute_cov2d_bounds(cov2d)

    if alive is not None:
        ok = ok & alive
        radius_f = torch.where(alive, radius_f, torch.zeros_like(radius_f))

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    hit = ok & (tile_area > 0)
    num_tiles_hit = torch.where(hit, tile_area, 0).to(torch.int32)
    radii = torch.where(ok, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    depths = torch.zeros((n,), dtype=means2d.dtype, device=means2d.device)
    return xys, depths, radii, conics, num_tiles_hit

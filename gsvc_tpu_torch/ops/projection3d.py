"""3D Gaussian EWA projection (PyTorch port of gsvc_tpu/ops/projection3d.py).

The reference's `project_gaussians_forward_kernel` (forward.cu:12) and its
helpers `scale_rot_to_cov3d` (forward.cu:902), `project_cov3d_ewa`
(forward.cu:833) and `quat_to_rotmat` / `project_pix` / `clip_near_plane`
(helpers.cuh:106-233, :301). Elementwise and 3x3 matrix math over N
gaussians, with no kernel: gradients come from autograd through the same
formulas. Gaussians with view z <= clip_thresh, a zero covariance
determinant or an empty tile bbox get radius 0 and 0 tiles hit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gsvc_tpu_torch.ops.projection import _tile_bbox, compute_cov2d_bounds

# Screen-space dilation added to the projected covariance diagonal
# (forward.cu:871-873; the classic 0.3 px EWA blur).
COV2D_BLUR = 0.3


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3] rotation, normalised first
    (helpers.cuh:139-160)."""
    q = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y - w * z),
            2.0 * (x * z + w * y),
            2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z),
            2.0 * (y * z - w * x),
            2.0 * (x * z - w * y),
            2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def scale_rot_to_cov3d(
    scale: torch.Tensor, glob_scale: float, quat: torch.Tensor
) -> torch.Tensor:
    """(scale [N,3], global scalar, quat [N,4]) -> cov3d [N,3,3]:
    M M^T with M = R diag(glob_scale * scale) (forward.cu:902-920)."""
    M = quat_to_rotmat(quat) * (glob_scale * scale)[..., None, :]
    return M @ M.transpose(-1, -2)


def project_cov3d_ewa(
    mean3d: torch.Tensor,
    cov3d: torch.Tensor,
    viewmat: torch.Tensor,
    fx: float,
    fy: float,
    tan_fovx: float,
    tan_fovy: float,
) -> torch.Tensor:
    """EWA splatting: world-space cov3d -> screen-space cov2d [N,3] (upper
    triangle a, b, c), forward.cu:833-899: the view point clamped to
    1.3 tan_fov of the frustum, the Jacobian of the perspective map,
    T = J W, cov2d = T V T^T plus the 0.3 px blur on the diagonal."""
    W = viewmat[:3, :3]
    p = viewmat[:3, 3]
    t = mean3d @ W.T + p  # [N,3] view space
    tz = t[..., 2]
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[..., 1] / tz, -lim_y, lim_y) * tz
    rz = 1.0 / tz
    rz2 = rz * rz
    zeros = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([fx * rz, zeros, -fx * tx * rz2], dim=-1),
            torch.stack([zeros, fy * rz, -fy * ty * rz2], dim=-1),
        ],
        dim=-2,
    )  # [N,2,3]
    T = J @ W  # [N,2,3]
    cov2d = T @ cov3d @ T.transpose(-1, -2)  # [N,2,2]
    return torch.stack(
        [
            cov2d[..., 0, 0] + COV2D_BLUR,
            cov2d[..., 0, 1],
            cov2d[..., 1, 1] + COV2D_BLUR,
        ],
        dim=-1,
    )


def project_pix(
    fxy: Tuple[float, float], p_view: torch.Tensor, center: Tuple[float, float]
) -> torch.Tensor:
    """View-space point -> pixel centre (helpers.cuh:106-120): perspective
    divide, then the intrinsics with ndc2pix's half-pixel shift."""
    fx, fy = fxy
    cx, cy = center
    rz = 1.0 / p_view[..., 2]
    return torch.stack(
        [
            fx * p_view[..., 0] * rz + cx - 0.5,
            fy * p_view[..., 1] * rz + cy - 0.5,
        ],
        dim=-1,
    )


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    glob_scale: float,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    img_height: int,
    img_width: int,
    tile_bounds: Tuple[int, int, int],
    clip_thresh: float = 0.01,
    block_w: int = 16,
    block_h: int = 16,
):
    """Project 3D gaussians to screen space (gsplat's
    project_gaussians.py:12-76).

    Returns (xys [N,2], depths [N], radii [N] int32, conics [N,3],
    num_tiles_hit [N] int32, cov3d [N,3,3]), differentiable in means3d,
    scales and quats. Culled gaussians (view z <= clip_thresh) get a safe
    perspective divide, depth 0, radius 0 and no tiles.
    """
    W = viewmat[:3, :3]
    p = viewmat[:3, 3]
    p_view = means3d @ W.T + p
    in_front = p_view[..., 2] > clip_thresh
    # keep the perspective divide finite for culled points
    safe_z = torch.where(in_front, p_view[..., 2], torch.ones_like(p_view[..., 2]))
    safe_view = torch.cat([p_view[..., :2], safe_z[..., None]], dim=-1)

    cov3d = scale_rot_to_cov3d(scales, glob_scale, quats)
    tan_fovx = 0.5 * img_width / fx
    tan_fovy = 0.5 * img_height / fy
    cov2d = project_cov3d_ewa(means3d, cov3d, viewmat, fx, fy, tan_fovx, tan_fovy)
    conics, radius_f, ok = compute_cov2d_bounds(cov2d)
    ok = ok & in_front
    radius_f = torch.where(ok, radius_f, torch.zeros_like(radius_f))

    xys = project_pix((fx, fy), safe_view, (cx, cy))
    depths = torch.where(in_front, p_view[..., 2], torch.zeros_like(p_view[..., 2]))

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(
        xys, radius_f, tile_bounds, block_w, block_h
    )
    tile_area = (tmax_x - tmin_x) * (tmax_y - tmin_y)
    hit = ok & (tile_area > 0)
    num_tiles_hit = torch.where(hit, tile_area, 0).to(torch.int32)
    radii = torch.where(ok, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return xys, depths, radii, conics, num_tiles_hit, cov3d

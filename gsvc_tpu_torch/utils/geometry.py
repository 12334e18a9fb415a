"""Rotation / scaling / covariance helpers (PyTorch port of
gsvc_tpu/utils/geometry.py).

Quaternion and 2D rotation matrices, scaling-rotation factors, covariance
assembly and the lower-triangular factor of the Cholesky
parameterization (reference utils.py:44-131). Small batched
constructions on the inputs' device; no kernel.
"""

from __future__ import annotations

import torch


def strip_lowerdiag(L: torch.Tensor) -> torch.Tensor:
    """[N,3,3] -> [N,6] or [N,2,2] -> [N,3] upper-triangular packing
    (reference utils.py:44-59)."""
    if L.shape[1] == 3:
        return torch.stack(
            [L[:, 0, 0], L[:, 0, 1], L[:, 0, 2],
             L[:, 1, 1], L[:, 1, 2], L[:, 2, 2]],
            dim=1,
        )
    if L.shape[1] == 2:
        return torch.stack([L[:, 0, 0], L[:, 0, 1], L[:, 1, 1]], dim=1)
    raise ValueError(f"unsupported matrix size {L.shape[1]}")


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """Alias of strip_lowerdiag (reference utils.py:61-62)."""
    return strip_lowerdiag(sym)


def build_rotation(r: torch.Tensor) -> torch.Tensor:
    """[N,4] quaternions (w,x,y,z) -> [N,3,3] rotation matrices
    (reference utils.py:64-85)."""
    q = r / torch.linalg.norm(r, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=1),
        ],
        dim=1,
    )


def build_scaling_rotation(s: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s), [N,3,3] (reference utils.py:87-96)."""
    return build_rotation(r) * s[:, None, :]


def build_rotation_2d(r: torch.Tensor) -> torch.Tensor:
    """[N,1] angles -> [N,2,2] rotations (reference utils.py:98-106)."""
    t = r[:, 0]
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack(
        [torch.stack([c, -s], dim=1), torch.stack([s, c], dim=1)], dim=1
    )


def build_scaling_rotation_2d(s: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s), [N,2,2] (reference utils.py:109-115)."""
    return build_rotation_2d(r) * s[:, None, :]


def build_covariance_from_scaling_rotation_2d(
    scaling: torch.Tensor, scaling_modifier: float, rotation: torch.Tensor
) -> torch.Tensor:
    """Sigma = L L^T from per-axis scale + rotation (reference utils.py:117-123)."""
    L = build_scaling_rotation_2d(scaling_modifier * scaling, rotation)
    return L @ L.transpose(1, 2)


def build_triangular(r: torch.Tensor) -> torch.Tensor:
    """[N,3] (l11,l21,l22) -> [N,2,2] lower-triangular L
    (reference utils.py:125-130)."""
    zeros = torch.zeros_like(r[:, 0])
    return torch.stack(
        [
            torch.stack([r[:, 0], zeros], dim=1),
            torch.stack([r[:, 1], r[:, 2]], dim=1),
        ],
        dim=1,
    )


def build_covariance_from_cholesky(r: torch.Tensor) -> torch.Tensor:
    """Sigma = L L^T from packed Cholesky elements, [N,2,2]."""
    L = build_triangular(r)
    return L @ L.transpose(1, 2)

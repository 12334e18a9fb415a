"""Real spherical-harmonics colour evaluation, degrees 0-4 (PyTorch port of
gsvc_tpu/ops/sh.py).

The reference's SH kernels (sh.cuh:6-254) and their wrapper
`spherical_harmonics` (gsplat/sh.py:36): elementwise polynomials over N
points, with no kernel; the backward comes from autograd. The basis order
and constants are the 3DGS family's real-SH convention (m-major within
each degree).
"""

from __future__ import annotations

import torch

# Standard real spherical-harmonics normalization constants.
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    """Bases for SH up to `degree` inclusive: (degree+1)^2, degree <= 4
    (sh.cuh:34-44, gsplat/sh.py:10)."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    return (degree + 1) ** 2


def deg_from_sh(num_bases: int) -> int:
    """Inverse of num_sh_bases (gsplat/sh.py:23)."""
    for d in range(5):
        if (d + 1) ** 2 == num_bases:
            return d
    raise ValueError(f"Invalid number of SH bases: {num_bases}")


def eval_sh_bases(num_bases: int, dirs: torch.Tensor) -> torch.Tensor:
    """The first `num_bases` real SH bases at unit directions dirs [..., 3]
    -> [..., num_bases] (sh.cuh:6-31's tables)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if num_bases > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if num_bases > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
        if num_bases > 9:
            out += [
                _C3[0] * y * (3.0 * xx - yy),
                _C3[1] * xy * z,
                _C3[2] * y * (4.0 * zz - xx - yy),
                _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy),
                _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3.0 * yy),
            ]
        if num_bases > 16:
            out += [
                _C4[0] * xy * (xx - yy),
                _C4[1] * yz * (3.0 * xx - yy),
                _C4[2] * xy * (7.0 * zz - 1.0),
                _C4[3] * yz * (7.0 * zz - 3.0),
                _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                _C4[5] * xz * (7.0 * zz - 3.0),
                _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                _C4[7] * xz * (xx - 3.0 * yy),
                _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
            ]
    return torch.stack(out[:num_bases], dim=-1)


def spherical_harmonics(
    degrees_to_use: int, viewdirs: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """SH coefficients -> view-dependent colours (gsplat/sh.py:36).

    viewdirs [..., 3] (normalised here), coeffs [..., K, C] with K =
    num_sh_bases of the coefficients' degree; only the first
    num_sh_bases(degrees_to_use) bases contribute. Differentiable in both.
    """
    total_bases = coeffs.shape[-2]
    deg_from_sh(total_bases)  # validate
    n_use = num_sh_bases(degrees_to_use)
    if n_use > total_bases:
        raise ValueError(
            f"degrees_to_use={degrees_to_use} needs {n_use} bases, "
            f"coeffs has {total_bases}"
        )
    norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
    dirs = viewdirs / torch.clamp(norm, min=1e-12)
    bases = eval_sh_bases(n_use, dirs)  # [..., n_use]
    return torch.einsum("...k,...kc->...c", bases, coeffs[..., :n_use, :])

"""Core splat data model (PyTorch port of gsvc_tpu/core.py).

A frame's splats are one `nn.Module` holding the four per-splat parameters
of the reference model (GaussianSplats_Represent.py:28-38) at a fixed
capacity N, beside an `alive` mask as in the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# Added to the raw cholesky parameters before building the covariance
# (reference GaussianSplats_Represent.py:45).
CHOLESKY_BOUND = (0.5, 0.0, 0.5)


class GaussianFrame(nn.Module):
    """Per-frame splat parameters (the port of `SplatParams`).

    xyz [N,2] raw positions (tanh -> NDC), cholesky [N,3] raw (l11, l21,
    l22) (+ CHOLESKY_BOUND), features_dc [N,3] raw colours, rgb_w [N,1]
    per-splat weight; colours render premultiplied, features_dc * rgb_w.
    """

    def __init__(self, xyz, cholesky, features_dc, rgb_w):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.cholesky = nn.Parameter(cholesky)
        self.features_dc = nn.Parameter(features_dc)
        self.rgb_w = nn.Parameter(rgb_w)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_xyz(self) -> torch.Tensor:
        return torch.tanh(self.xyz)

    @property
    def get_cholesky_elements(self) -> torch.Tensor:
        bound = torch.tensor(
            CHOLESKY_BOUND, dtype=self.cholesky.dtype, device=self.cholesky.device
        )
        return self.cholesky + bound

    @property
    def get_features(self) -> torch.Tensor:
        return self.features_dc * self.rgb_w


def from_numpy(gmodel, device="cpu") -> GaussianFrame:
    """Carry a JAX frame's splats across as a `GaussianFrame`.

    `gmodel` is either the saved checkpoint dict {"_xyz", "_cholesky",
    "_features_dc"} (colours premultiplied, so rgb_w is 1), or the
    `SplatParams` fields as numpy arrays: a mapping or an object with
    xyz / cholesky / features_dc / rgb_w.
    """

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    if isinstance(gmodel, Mapping) and "_xyz" in gmodel:
        xyz = t(gmodel["_xyz"])
        return GaussianFrame(
            xyz, t(gmodel["_cholesky"]), t(gmodel["_features_dc"]),
            torch.ones((xyz.shape[0], 1), dtype=torch.float32, device=device),
        )
    get = gmodel.__getitem__ if isinstance(gmodel, Mapping) else (
        lambda k: getattr(gmodel, k)
    )
    return GaussianFrame(
        t(get("xyz")), t(get("cholesky")), t(get("features_dc")),
        t(get("rgb_w")).reshape(-1, 1),
    )


def init_splats(
    num_points: int,
    capacity: Optional[int] = None,
    rgb_w_value: float = 1.0,
    uniforms: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> tuple[GaussianFrame, torch.Tensor]:
    """Random splat init matching the reference distributions.

    _xyz = atanh(U(-1,1)), _cholesky ~ U(0,1), _features ~ U(0,1),
    rgb_w = rgb_w_value. `uniforms` = (u_xyz [cap,2] in U(-1,1), u_chol
    [cap,3], u_feat [cap,3] in U(0,1)) injects the draws (parity tests feed
    both packages the same numbers); otherwise they come from `generator`.
    Returns (frame, alive) with slots >= num_points dead.
    """
    cap = num_points if capacity is None else capacity
    if uniforms is None:
        def draw(*shape):
            return torch.rand(shape, generator=generator, dtype=torch.float32)

        uniforms = (2.0 * draw(cap, 2) - 1.0, draw(cap, 3), draw(cap, 3))
    u_xyz, u_chol, u_feat = (
        torch.as_tensor(np.asarray(u, np.float32), device=device) for u in uniforms
    )
    xyz = torch.atanh(torch.clamp(u_xyz, -1.0 + 1e-7, 1.0 - 1e-7))
    rgb_w = torch.full((cap, 1), rgb_w_value, dtype=torch.float32, device=device)
    alive = torch.arange(cap, device=device) < num_points
    return GaussianFrame(xyz, u_chol, u_feat, rgb_w), alive

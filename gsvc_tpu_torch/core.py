"""Core splat data model (PyTorch port of gsvc_tpu/core.py).

A frame's splats are one `nn.Module` holding the four per-splat parameters
of the reference model (GaussianSplats_Represent.py:28-38) at a fixed
capacity N, beside an `alive` mask as in the JAX package.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# Added to the raw cholesky parameters before building the covariance
# (reference GaussianSplats_Represent.py:45).
CHOLESKY_BOUND = (0.5, 0.0, 0.5)


@functools.lru_cache(maxsize=None)
def cholesky_bound(device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CHOLESKY_BOUND on `device`, made once a device (a copy from host
    memory, which a step under CUDA-graph capture could not make)."""
    return torch.tensor(CHOLESKY_BOUND, dtype=dtype, device=device)


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
        # a buffer, so the training step adds it without a host-to-device copy
        self.register_buffer("_bound", cholesky_bound(cholesky.device, cholesky.dtype),
                             persistent=False)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def get_xyz(self) -> torch.Tensor:
        return torch.tanh(self.xyz)

    @property
    def get_cholesky_elements(self) -> torch.Tensor:
        return self.cholesky + self._bound

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
        torch.tensor(np.asarray(u, np.float32), device=device) for u in uniforms
    )
    xyz = torch.atanh(torch.clamp(u_xyz, -1.0 + 1e-7, 1.0 - 1e-7))
    rgb_w = torch.full((cap, 1), rgb_w_value, dtype=torch.float32, device=device)
    alive = torch.arange(cap, device=device) < num_points
    return GaussianFrame(xyz, u_chol, u_feat, rgb_w), alive


def _field(obj, k):
    """Field `k` of a mapping or an object."""
    return obj[k] if isinstance(obj, Mapping) else getattr(obj, k)


def _adan_from_numpy(opt, device):
    """A gsvc_tpu `AdanState` (numpy-convertible leaves) as the port's;
    the step and the fresh flags become host values."""
    from gsvc_tpu_torch.optim.adan import AdanState

    def tree(k):
        return {name: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                for name, v in _field(opt, k).items()}

    return AdanState(
        step=int(np.asarray(_field(opt, "step"))),
        exp_avg=tree("exp_avg"), exp_avg_sq=tree("exp_avg_sq"),
        exp_avg_diff=tree("exp_avg_diff"), neg_pre_grad=tree("neg_pre_grad"),
        fresh={k: bool(np.asarray(v)) for k, v in _field(opt, "fresh").items()},
    )


def compress_state_from_numpy(state, device="cpu"):
    """Carry a gsvc_tpu `CompressState` across as the port's `CompressState`.

    `state` is the JAX state or any object (or mapping) with its fields as
    numpy-convertible arrays: params and best_params (xyz, cholesky,
    features_dc, q_scale, q_beta), vq and best_vq (embed, cluster_size,
    embed_avg, initted), opt (as in `train_state_from_numpy`), it,
    best_psnr, loss, psnr, p_xyz, p_cholesky, p_features_dc. The JAX PRNG
    key has no counterpart: the port takes its k-means draws as an
    argument. The iteration counter, Adan's step and fresh flags and the
    VQ `initted` flags become host values."""
    from gsvc_tpu_torch.compress.quantizers import VQState
    from gsvc_tpu_torch.models.compress import CompressParams, CompressState

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    def params(p):
        return CompressParams(**{k: t(_field(p, k)) for k in (
            "xyz", "cholesky", "features_dc", "q_scale", "q_beta")})

    def vq(v):
        return VQState(embed=t(_field(v, "embed")), cluster_size=t(_field(v, "cluster_size")),
                       embed_avg=t(_field(v, "embed_avg")),
                       initted=bool(np.asarray(_field(v, "initted"))))

    return CompressState(
        params=params(_field(state, "params")),
        vq=vq(_field(state, "vq")),
        opt=_adan_from_numpy(_field(state, "opt"), device),
        it=int(np.asarray(_field(state, "it"))),
        best_psnr=t(_field(state, "best_psnr")),
        best_params=params(_field(state, "best_params")),
        best_vq=vq(_field(state, "best_vq")),
        loss=t(_field(state, "loss")),
        psnr=t(_field(state, "psnr")),
        p_xyz=t(_field(state, "p_xyz")),
        p_cholesky=t(_field(state, "p_cholesky")),
        p_features_dc=t(_field(state, "p_features_dc")),
    )


def train_state_from_numpy(state, device="cpu"):
    """Carry a gsvc_tpu `TrainState` across as the port's `TrainState`.

    `state` is the JAX state or any object (or mapping) with the same
    fields, as numpy-convertible arrays: params (see `from_numpy`), alive,
    opt (step, exp_avg / exp_avg_sq / exp_avg_diff / neg_pre_grad dicts
    keyed like `_trainable`, fresh), it, lr_frozen, best_loss, patience,
    grace, stop, loss, psnr, max_overflow. The iteration counter, Adan's
    step and fresh flags, lr_frozen and grace become host values. Tests use
    it to start both packages mid-run.
    """
    from gsvc_tpu_torch.models.represent import TrainState

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return TrainState(
        params=from_numpy(_field(state, "params"), device),
        alive=t(_field(state, "alive"), torch.bool),
        opt=_adan_from_numpy(_field(state, "opt"), device),
        it=int(np.asarray(_field(state, "it"))),
        lr_frozen=bool(np.asarray(_field(state, "lr_frozen"))),
        best_loss=t(_field(state, "best_loss")),
        patience=t(_field(state, "patience"), torch.int32),
        grace=int(np.asarray(_field(state, "grace"))),
        stop=t(_field(state, "stop"), torch.bool),
        loss=t(_field(state, "loss")),
        psnr=t(_field(state, "psnr")),
        max_overflow=t(_field(state, "max_overflow"), torch.int32),
    )

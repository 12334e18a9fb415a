"""Training losses (PyTorch port of gsvc_tpu/utils/losses.py, the
reference `loss_fn`, utils.py:21-41).

Same loss-type names and lambda semantics; inputs are [C,H,W] or
[N,C,H,W], and the SSIM-based losses reshape to NCHW.
"""

from __future__ import annotations

import torch

from gsvc_tpu_torch.utils.metrics import ms_ssim, ssim


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 3 else x


def loss_fn(
    pred: torch.Tensor,
    target: torch.Tensor,
    loss_type: str = "L2",
    lambda_value: float = 0.7,
) -> torch.Tensor:
    target = target.detach().float()
    pred = pred.float()

    def l2():
        return torch.mean((pred - target) ** 2)

    def l1():
        return torch.mean(torch.abs(pred - target))

    def dssim(fn=ssim, **kw):
        return 1.0 - fn(_as_nchw(pred), _as_nchw(target), data_range=1.0, **kw)

    lam = lambda_value
    if loss_type == "L2":
        return l2()
    if loss_type == "L1":
        return l1()
    if loss_type == "SSIM":
        return dssim()
    if loss_type == "Fusion1":
        return lam * l2() + (1 - lam) * dssim()
    if loss_type == "Fusion2":
        return lam * l1() + (1 - lam) * dssim()
    if loss_type == "Fusion3":
        return lam * l2() + (1 - lam) * l1()
    if loss_type == "Fusion4":
        return lam * l1() + (1 - lam) * dssim(ms_ssim)
    if loss_type == "Fusion_hinerv":
        return lam * l1() + (1 - lam) * dssim(ms_ssim, win_size=5)
    raise ValueError(f"unknown loss_type {loss_type!r}")

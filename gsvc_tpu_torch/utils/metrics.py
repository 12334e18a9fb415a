"""Image quality metrics: PSNR, SSIM, MS-SSIM (PyTorch port of
gsvc_tpu/utils/metrics.py, pytorch_msssim-compatible math).

Images are NCHW float in [0, data_range]. The Gaussian filtering runs as
float32 depthwise convolutions with cuDNN's TF32 switched off for the
call (TF32 keeps about three decimal digits).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """10*log10(data_range^2 / mse) (reference GaussianSplats_Represent.py:196-198)."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


@contextlib.contextmanager
def _no_tf32():
    """Exact float32 convolutions and matmuls on the card for the block."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _gaussian_window(win_size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(win_size, dtype=torch.float32, device=device) - (win_size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_separable(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-mode separable Gaussian filter over NCHW."""
    n, c, h, w = x.shape
    k = win.shape[0]
    y = x.reshape(n * c, 1, h, w)
    with _no_tf32():
        y = F.conv2d(y, win.reshape(1, 1, k, 1).to(x.dtype))
        y = F.conv2d(y, win.reshape(1, 1, 1, k).to(x.dtype))
    return y.reshape(n, c, y.shape[-2], y.shape[-1])


def _ssim_maps(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # centre by the joint mean first (exact algebra; avoids f32 cancellation)
    c = (0.5 * (torch.mean(x) + torch.mean(y))).detach()
    xc = x - c
    yc = y - c
    mu1c = _filter2d_separable(xc, win)
    mu2c = _filter2d_separable(yc, win)
    mu1 = mu1c + c
    mu2 = mu2c + c
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_separable(xc * xc, win) - mu1c * mu1c
    sigma2_sq = _filter2d_separable(yc * yc, win) - mu2c * mu2c
    sigma12 = _filter2d_separable(xc * yc, win) - mu1c * mu2c
    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map, cs_map


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM over NCHW images."""
    win = _gaussian_window(win_size, win_sigma, pred.device)
    ssim_map, _ = _ssim_maps(pred.float(), target.float(), win, data_range)
    per_channel = torch.mean(ssim_map, dim=(-2, -1))
    return torch.mean(per_channel) if size_average else torch.mean(per_channel, dim=1)


def _avg_pool2_padded(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, odd dims zero-padded on both sides."""
    pad_h = x.shape[-2] % 2
    pad_w = x.shape[-1] % 2
    x = F.pad(x, (pad_w, pad_w, pad_h, pad_h))
    n, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[..., : 2 * h2, : 2 * w2].reshape(n, c, h2, 2, w2, 2)
    return x.sum(dim=(3, 5)) / 4.0


@functools.lru_cache(maxsize=None)
def _ms_weights(levels: int, device: torch.device) -> torch.Tensor:
    """The first `levels` MS-SSIM weights, normalised, on `device`: made
    once (a copy from host memory, which a step under CUDA-graph capture
    could not make)."""
    weights = torch.tensor(MS_SSIM_WEIGHTS[:levels], dtype=torch.float32, device=device)
    return weights / torch.sum(weights)


def ms_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """Multi-scale SSIM over NCHW images; drops scales that no longer fit
    the window (weights renormalised), as the JAX version does."""
    x = pred.float()
    y = target.float()
    win = _gaussian_window(win_size, win_sigma, pred.device)
    min_side = min(pred.shape[-2], pred.shape[-1])
    levels = len(MS_SSIM_WEIGHTS)
    while levels > 1 and (min_side >> (levels - 1)) < win_size:
        levels -= 1
    weights = _ms_weights(levels, pred.device)
    mcs = []
    ssim_pc = None
    for lvl in range(levels):
        ssim_map, cs_map = _ssim_maps(x, y, win, data_range)
        ssim_pc = torch.mean(ssim_map, dim=(-2, -1))
        if lvl < levels - 1:
            mcs.append(torch.relu(torch.mean(cs_map, dim=(-2, -1))))
            x = _avg_pool2_padded(x)
            y = _avg_pool2_padded(y)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)  # [levels, N, C]
    val = torch.prod(stack ** weights[:, None, None], dim=0)
    return torch.mean(val) if size_average else torch.mean(val, dim=1)

"""Depth-sorted alpha-compositing rasterizer (PyTorch port of
gsvc_tpu/ops/rasterize_alpha.py, the inherited 3DGS pipeline).

The reference's `rasterize_forward` / `nd_rasterize_forward`
(forward.cu:168, :252-374) and their backwards (backward.cu:7-121,
:138-315), wrapped by gsplat/rasterize.py:14. Semantics, as gsvc_tpu's:

- splats composite front to back in `argsort(depths, stable=True)` order,
  each over the pixels of the tiles of its bbox (`_tile_bbox` of its
  radius; a splat is valid where radii > 0, and `num_tiles_hit` is not
  read);
- alpha = min(0.999, opac * exp(-sigma)) at integer pixel coordinates,
  skipped where sigma < 0 or alpha < 1/255;
- a pixel stops before the splat whose T * (1 - alpha) <= 1e-4;
- out = sum(c_i alpha_i T_i) + T_final * background, and 1 - T_final as
  the alpha channel when `return_alpha` is set.

Backends:
- "auto": on a CUDA tensor the hand-written kernels A1 (forward) and A2
  (backward) through ops/rasterize_alpha_cuda.py, which touch only the
  (tile, splat) intersections; on a CPU tensor the plain version.
- "torch": the plain version on either device. It is gsvc_tpu's scan op
  for op: splats sorted once, then chunks of `chunk` splats evaluated
  densely over every pixel, the transmittance carried as
  log1p / cumsum and a chunk-end `dead` flag, differentiated by
  autograd. It holds [chunk, H*W] intermediates, so on the card it is
  the oracle of the kernels only (at 1080p a gradient through it needs
  hundreds of GB).
"""

from __future__ import annotations

from typing import Optional

import torch

from gsvc_tpu_torch.ops.projection import _tile_bbox

ALPHA_CUTOFF = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
BACKENDS = ("auto", "torch")


def rasterize_gaussians_alpha(
    xys: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    conics: torch.Tensor,
    num_tiles_hit: Optional[torch.Tensor],
    colors: torch.Tensor,
    opacity: torch.Tensor,
    img_height: int,
    img_width: int,
    block_w: int = 16,
    block_h: int = 16,
    background: Optional[torch.Tensor] = None,
    return_alpha: bool = False,
    chunk: int = 256,
    backend: str = "auto",
):
    """Front-to-back alpha compositing of N splats into [H, W, C] (and the
    [H, W] alpha with `return_alpha`).

    colors [N, C] may have any channel count C. Differentiable in xys,
    conics, colors, opacity and background. `num_tiles_hit` is accepted
    for API parity and ignored; `chunk` sizes the plain version's steps.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if background is None:
        background = torch.zeros((colors.shape[1],), dtype=colors.dtype,
                                 device=colors.device)
    if backend == "auto" and xys.is_cuda:
        from gsvc_tpu_torch.ops import rasterize_alpha_cuda

        return rasterize_alpha_cuda.rasterize_alpha(
            xys, depths, radii, conics, colors, opacity, img_height, img_width,
            block_w, block_h, background, return_alpha,
        )
    out, T = composite_torch(xys, depths, radii, conics, colors, opacity,
                             img_height, img_width, block_w, block_h, chunk)
    out = out + T[:, None] * background[None, :]
    img = out.reshape(img_height, img_width, colors.shape[1])
    if return_alpha:
        return img, (1.0 - T).reshape(img_height, img_width)
    return img


def composite_torch(xys, depths, radii, conics, colors, opacity,
                    img_height: int, img_width: int, block_w: int = 16,
                    block_h: int = 16, chunk: int = 256):
    """The plain version's scan: (sum of c_i alpha_i T_i [H*W, C], the
    final transmittance T [H*W]), before the background."""
    n, c_dim = colors.shape
    dtype, dev = xys.dtype, xys.device
    # the global depth order is every pixel's compositing order; ties by index
    order = torch.argsort(depths, stable=True)
    xys_s = xys[order]
    conics_s = conics[order]
    colors_s = colors[order]
    opac_s = opacity.reshape(-1)[order]
    valid_s = (radii > 0)[order]

    tb_x = (img_width + block_w - 1) // block_w
    tb_y = (img_height + block_h - 1) // block_h
    radius_f = radii.to(dtype)[order]
    tminx, tminy, tmaxx, tmaxy = _tile_bbox(
        xys_s, radius_f, (tb_x, tb_y, 1), block_w, block_h
    )

    pad = (-n) % chunk

    def padc(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    per_splat = [padc(a) for a in (xys_s, conics_s, colors_s, opac_s, valid_s,
                                   tminx, tminy, tmaxx, tmaxy)]
    pix = img_height * img_width
    lin = torch.arange(pix, device=dev)
    px = (lin % img_width).to(dtype)
    py = (lin // img_width).to(dtype)
    ptx = (lin % img_width) // block_w
    pty = (lin // img_width) // block_h

    out = torch.zeros((pix, c_dim), dtype=colors.dtype, device=dev)
    T = torch.ones((pix,), dtype=colors.dtype, device=dev)
    dead = torch.zeros((pix,), dtype=torch.bool, device=dev)
    for s0 in range(0, n + pad, chunk):
        cxy, cconic, ccol, copac, cvalid, cx0, cy0, cx1, cy1 = (
            a[s0:s0 + chunk] for a in per_splat)
        dx = cxy[:, 0][:, None] - px[None, :]  # [chunk, pix]
        dy = cxy[:, 1][:, None] - py[None, :]
        sigma = (
            0.5 * (cconic[:, 0][:, None] * dx * dx
                   + cconic[:, 2][:, None] * dy * dy)
            + cconic[:, 1][:, None] * dx * dy
        )
        alpha = torch.clamp(copac[:, None] * torch.exp(-sigma), max=ALPHA_MAX)
        member = (
            (ptx[None, :] >= cx0[:, None]) & (ptx[None, :] < cx1[:, None])
            & (pty[None, :] >= cy0[:, None]) & (pty[None, :] < cy1[:, None])
            & cvalid[:, None]
        )
        hit = member & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
        a = torch.where(hit, alpha, 0.0)
        log1m = torch.log1p(-a)
        incl = torch.cumsum(log1m, dim=0)  # log inclusive cumprod
        T_next = T[None, :] * torch.exp(incl)  # T after splat k (unfrozen)
        T_before = T[None, :] * torch.exp(incl - log1m)
        # the pixel breaks before the splat whose T_next <= 1e-4; T_next is
        # monotone along k, so live fails at and past the break
        live = (~dead)[None, :] & (T_next > T_EPS)
        w = torch.where(live, a * T_before, 0.0)  # [chunk, pix]
        out = out + w.T @ ccol
        T = T * torch.exp(torch.sum(torch.where(live, log1m, 0.0), dim=0))
        dead = dead | (T_next[-1] <= T_EPS)
    return out, T


def rasterize_gaussians_alpha_np_oracle(
    xys, depths, radii, conics, colors, opacity, H, W,
    block_w=16, block_h=16, background=None,
):
    """Loop-style numpy oracle of forward.cu:252-374, for tests."""
    import numpy as np

    n, c_dim = colors.shape
    xys = np.asarray(xys)
    radii = np.asarray(radii).reshape(-1)
    conics = np.asarray(conics)
    colors = np.asarray(colors)
    opacity = np.asarray(opacity).reshape(-1)
    if background is None:
        background = np.zeros(c_dim, np.float32)
    order = np.argsort(depths, kind="stable")
    tb_x = (W + block_w - 1) // block_w
    tb_y = (H + block_h - 1) // block_h
    out = np.zeros((H, W, c_dim), np.float32)
    for i in range(H):
        for j in range(W):
            T = 1.0
            for k in order:
                if radii[k] <= 0:
                    continue
                r = float(radii[k])
                tx0 = min(max(int(np.floor(xys[k, 0] / block_w - r / block_w)), 0), tb_x)
                tx1 = min(max(int(np.floor(xys[k, 0] / block_w + r / block_w + 1)), 0), tb_x)
                ty0 = min(max(int(np.floor(xys[k, 1] / block_h - r / block_h)), 0), tb_y)
                ty1 = min(max(int(np.floor(xys[k, 1] / block_h + r / block_h + 1)), 0), tb_y)
                if not (tx0 <= j // block_w < tx1 and ty0 <= i // block_h < ty1):
                    continue
                dx = xys[k, 0] - j
                dy = xys[k, 1] - i
                sigma = (
                    0.5 * (conics[k, 0] * dx * dx + conics[k, 2] * dy * dy)
                    + conics[k, 1] * dx * dy
                )
                if sigma < 0:
                    continue
                alpha = min(ALPHA_MAX, float(opacity[k]) * np.exp(-sigma))
                if alpha < ALPHA_CUTOFF:
                    continue
                next_T = T * (1.0 - alpha)
                if next_T <= T_EPS:
                    break
                out[i, j] += colors[k] * alpha * T
                T = next_T
            out[i, j] += T * background
    return out

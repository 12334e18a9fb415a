"""Plain reference of the 2D splat codec's render, its L2 fit step and Adan.

Plain PyTorch in any float dtype (float64 for the reference, bfloat16 for
the control), on any device, with no kernels, no cache and no code of the
measured package. Frozen copies of plain arithmetic, each naming its
source at commit a2bb42d:

- `project`: gsvc_tpu_torch/ops/projection.py (`compute_cov2d_bounds`,
  `_tile_bbox`, `_footprint`), the reference forward2d.cu / helpers.cuh.
- `bin_pairs`: the semantics of gsvc_tpu_torch/ops/binning.py worked out
  again: whole splats past the intersection budget are dropped from the
  tail, each tile keeps its first `cap` splats in splat order.
- `render`: gsvc_tpu_torch/ops/rasterize_dense.py (alpha = min(1,
  exp(-sigma)) with identity backward, the sigma >= 0 and 1/255 gates, a
  sum over the tile's kept splats), evaluated per (tile, splat) pair.
- `adan_step`: gsvc_tpu_torch/optim/adan.py's update rule (no clip, no
  weight decay), in the reference's dtype.
- `revive`: the adaptive control's first step, worked out again from
  gsvc_tpu_torch/models/represent.py's `_revive` and `make_train_step`:
  the first dead slots take fresh splats, the step makes no update and
  Adan's moments restart while its step count goes on.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

CHOLESKY_BOUND = (0.5, 0.0, 0.5)
ALPHA_CUTOFF = 1.0 / 255.0
BLOCK = 16
CAP = 256
BETAS = (0.98, 0.92, 0.99)
EPS = 1e-8
# (pixel, pair) values a render chunk holds at once
CHUNK_VALUES = 1 << 26


def grid(H: int, W: int) -> tuple:
    """(tiles across, tiles down) of 16 x 16 tiles."""
    return (W + BLOCK - 1) // BLOCK, (H + BLOCK - 1) // BLOCK


def default_budget(n: int, num_tiles: int, factor: int = 16) -> int:
    """The intersection budget of a fit with no budget given: 16 (or
    `factor`) intersections a splat, at least 4 a tile, in 1024s."""
    budget = max(n * factor, num_tiles * 4, 1024)
    return (budget + 1023) // 1024 * 1024


def bucket_budget(intersections: int, slack: float) -> int:
    """`intersections` x `slack`, rounded up to a multiple of 8192."""
    return int(math.ceil(intersections * slack / 8192)) * 8192


class Projected(NamedTuple):
    xys: torch.Tensor  # [N, 2] pixel centres
    conics: torch.Tensor  # [N, 3]
    tmin: torch.Tensor  # [N, 2] int64 tile bbox, inclusive
    tmax: torch.Tensor  # [N, 2] int64 tile bbox, exclusive
    nth: torch.Tensor  # [N] int64 tiles hit (0: none)


def project(means: torch.Tensor, chol: torch.Tensor, H: int, W: int,
            alive: Optional[torch.Tensor] = None) -> Projected:
    """NDC means [N, 2] and cholesky elements with their bound [N, 3] ->
    pixel centres, conics and tile boxes, in the inputs' dtype."""
    l11, l21, l22 = chol.unbind(-1)
    a, b, c = l11 * l11, l11 * l21, l21 * l21 + l22 * l22
    det = a * c - b * b
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv, -b * inv, a * inv], -1) * ok[:, None]
    half = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(half * half - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(half + disc, min=0.0)))
    if alive is not None:
        ok = ok & alive
    radius = torch.where(ok, radius, torch.zeros_like(radius)).detach()
    xys = torch.stack([0.5 * W * means[:, 0] + 0.5 * W, 0.5 * H * means[:, 1] + 0.5 * H], -1)
    tb = torch.tensor(grid(H, W), device=means.device)
    centre = xys.detach() / BLOCK
    r = (radius / BLOCK)[:, None]
    tmin = torch.minimum(torch.clamp(torch.floor(centre - r).long(), min=0), tb)
    tmax = torch.minimum(torch.clamp(torch.floor(centre + r + 1.0).long(), min=0), tb)
    area = (tmax - tmin).prod(-1)
    nth = torch.where(ok & (area > 0), area, torch.zeros_like(area))
    return Projected(xys, conics, tmin, tmax, nth)


class Pairs(NamedTuple):
    tile: torch.Tensor  # [P] int64 tile of each kept (tile, splat) pair
    gauss: torch.Tensor  # [P] int64 splat of each pair


def bin_pairs(p: Projected, H: int, W: int, budget: int, cap: int = CAP) -> Pairs:
    """The kept (tile, splat) pairs, sorted by (tile, splat)."""
    tb_x, tb_y = grid(H, W)
    n = p.nth.shape[0]
    cum = torch.cumsum(p.nth, 0)
    kept = (cum <= budget) & (p.nth > 0)
    nth = torch.where(kept, p.nth, torch.zeros_like(p.nth))
    total = int(nth.sum())
    dev = p.nth.device
    g = torch.repeat_interleave(torch.arange(n, device=dev), nth)
    start = torch.cumsum(nth, 0) - nth
    j = torch.arange(total, device=dev) - start[g]
    w = (p.tmax[:, 0] - p.tmin[:, 0])[g]
    tile = (p.tmin[g, 1] + j // w) * tb_x + p.tmin[g, 0] + j % w
    order = torch.argsort(tile * n + g)
    tile, g = tile[order], g[order]
    counts = torch.bincount(tile, minlength=tb_x * tb_y)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(total, device=dev) - first[tile]
    keep = rank < cap
    return Pairs(tile[keep], g[keep])


def _pair_pixels(tile: torch.Tensor, W: int, dtype) -> tuple:
    """[P, 256] pixel x and y of each pair's tile, and its flat pixel index
    into the padded grid."""
    tb_x = (W + BLOCK - 1) // BLOCK
    local = torch.arange(BLOCK * BLOCK, device=tile.device)
    px = (tile % tb_x * BLOCK)[:, None] + local % BLOCK
    py = (tile // tb_x * BLOCK)[:, None] + local // BLOCK
    return px.to(dtype), py.to(dtype), py * (tb_x * BLOCK) + px


def pair_weights(pairs: Pairs, xys, conics, W: int, lo: int = 0, hi: Optional[int] = None):
    """(alpha weights [P, 256], flat pixel indices) of pairs lo:hi: each
    splat's weight at each pixel of its tile, 0 where a gate fails."""
    tile, g = pairs.tile[lo:hi], pairs.gauss[lo:hi]
    px, py, flat = _pair_pixels(tile, W, xys.dtype)
    dx = xys[g, 0][:, None] - px
    dy = xys[g, 1][:, None] - py
    co = conics[g]
    sigma = 0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy) + co[:, 1:2] * dx * dy
    vis = torch.exp(-sigma)
    alpha = vis + (torch.clamp(vis, max=1.0) - vis).detach()  # min(1, .), identity grad
    live = (sigma >= 0) & (alpha >= ALPHA_CUTOFF)
    return torch.where(live, alpha, torch.zeros_like(alpha)), flat


def render(pairs: Pairs, xys, conics, colors, H: int, W: int) -> torch.Tensor:
    """[H, W, 3] sum of each kept pair's alpha x colour, not clipped;
    differentiable in xys, conics and colors."""
    tb_x, tb_y = grid(H, W)
    out = xys.new_zeros((tb_y * BLOCK * tb_x * BLOCK, 3))
    total = pairs.tile.shape[0]
    step = max(1, CHUNK_VALUES // (BLOCK * BLOCK))
    for lo in range(0, total, step):
        w, flat = pair_weights(pairs, xys, conics, W, lo, lo + step)
        contrib = w[:, :, None] * colors[pairs.gauss[lo:lo + step]][:, None, :]
        out = out.index_add(0, flat.reshape(-1), contrib.reshape(-1, 3))
    return out.reshape(tb_y * BLOCK, tb_x * BLOCK, 3)[:H, :W]


def clip01(x: torch.Tensor) -> torch.Tensor:
    """clip to [0, 1] with the gradient split at a tie (jnp.clip's)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def render_splats(means, chol, colors, H: int, W: int, budget: int,
                  alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project, bin and render, clipped to [0, 1]: [H, W, 3]."""
    p = project(means, chol, H, W, alive)
    pairs = bin_pairs(p, H, W, budget)
    return clip01(render(pairs, p.xys, p.conics, colors, H, W))


def bound(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(CHOLESKY_BOUND, dtype=like.dtype, device=like.device)


class Adan:
    """Adan's moments over a dict of leaves, in the leaves' dtype."""

    def __init__(self, params: dict):
        z = {k: torch.zeros_like(v) for k, v in params.items()}
        self.m, self.n, self.d = dict(z), dict(z), dict(z)
        self.prev: Optional[dict] = None
        self.t = 0

    def step(self, params: dict, grads: dict, lr: float, betas=BETAS, eps=EPS) -> dict:
        """The parameters after one update (the first takes the previous
        gradient to be this one)."""
        b1, b2, b3 = betas
        self.t += 1
        t = self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            diff = g - (g if self.prev is None else self.prev[k])
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.d[k] = b2 * self.d[k] + (1 - b2) * diff
            u = g + b2 * diff
            self.n[k] = b3 * self.n[k] + (1 - b3) * u * u
            denom = torch.sqrt(self.n[k]) / math.sqrt(1 - b3 ** t) + eps
            out[k] = (p - lr / (1 - b1 ** t) * self.m[k] / denom
                      - lr * b2 / (1 - b2 ** t) * self.d[k] / denom)
        self.prev = {k: g.detach() for k, g in grads.items()}
        return out


class FitSteps(NamedTuple):
    losses: list  # the loss of each step
    first_grads: dict  # leaf -> gradient of step 1
    start: dict  # leaf -> parameters before step 1
    after: list  # leaf -> parameters, after each step


def revive(params: dict, alive: torch.Tensor, uniforms, count: int) -> tuple:
    """(params, alive) with the first `count` dead slots revived: xyz the
    atanh of u_xyz (in float32, as the splats are made), cholesky u_chol,
    features u_feat, rgb_w 0.01; `uniforms` (u_xyz [N, 2] in U(-1, 1),
    u_chol, u_feat [N, 3]) are float32."""
    u_xyz, u_chol, u_feat = uniforms
    dead = ~alive
    picked = (dead & (torch.cumsum(dead.long(), 0) - 1 < count))[:, None]
    dtype = params["xyz"].dtype
    fresh = {"xyz": torch.atanh(torch.clamp(u_xyz, -1.0 + 1e-7, 1.0 - 1e-7)),
             "cholesky": u_chol, "features_dc": u_feat}
    out = {k: torch.where(picked, fresh[k].to(dtype), v) if k in fresh else v
           for k, v in params.items()}
    out["rgb_w"] = torch.where(picked, torch.full_like(params["rgb_w"], 0.01), params["rgb_w"])
    return out, alive | picked[:, 0]


def represent_steps(init: dict, alive: torch.Tensor, gt: torch.Tensor, budget: int,
                    steps: int, lr: float, dtype, revived=None) -> FitSteps:
    """`steps` represent-fit steps: render the alive splats (tanh means,
    cholesky + bound, colours features x rgb_w), L2 against gt [H, W, 3],
    Adan. `init` holds xyz, cholesky, features_dc, rgb_w. `revived`
    (uniforms, count), a P-frame's adaptive control: step 1 takes its loss
    and gradient, then `revive`s, updates nothing and restarts Adan's
    moments (its step count goes on)."""
    H, W = gt.shape[0], gt.shape[1]
    params = {k: v.to(dtype) for k, v in init.items()}
    target = gt.to(dtype)
    opt = Adan(params)
    losses, first, after = [], None, []
    start = {k: v.clone() for k, v in params.items()}
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        img = render_splats(torch.tanh(leaves["xyz"]), leaves["cholesky"] + bound(target),
                            leaves["features_dc"] * leaves["rgb_w"], H, W, budget, alive)
        loss = torch.sum((img - target) ** 2) / (H * W * 3)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            if i == 0 and revived is not None:
                params, alive = revive(params, alive, *revived)
                opt = Adan(params)
                opt.t = 1
            else:
                params = opt.step({k: v.detach() for k, v in leaves.items()}, grads, lr)
        after.append(params)
    return FitSteps(losses, first, start, after)

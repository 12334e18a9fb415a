"""Inputs made from the seed, on the device, in a few large calls.

- `clip`: the RD clip of gsvc_tpu_torch/scripts/run_rd_point.py
  (`_value_noise`, `make_clip`, commit a2bb42d), made in memory as float32
  RGB frames in [0, 1] instead of an I420 file: multi-octave value noise
  panned 8 px a frame under four textured discs moving over it, the
  frames quantised to 8-bit levels as the file holds them.
- `splat_stream`: bench.py's scene (means U(-0.999, 0.999), cholesky
  diagonals U(1, 6), off-diagonal N(0, 1), colours U(0, 1): ~8
  intersections a splat at 1080p), moved smoothly from frame to frame.
- `reshuffled`: one splat stream in another order, so that every seed
  draws the same work.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream of a run: the same seed and stream
    give the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _lerp_grid(grid: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear sample of grid [gh, gw] at H x W points spread over it
    (np.linspace(0, g - 1, n) on each axis)."""
    gh, gw = grid.shape
    dev = grid.device
    yy = torch.linspace(0, gh - 1, H, dtype=torch.float64, device=dev)
    xx = torch.linspace(0, gw - 1, W, dtype=torch.float64, device=dev)
    y0, x0 = yy.floor().long(), xx.floor().long()
    fy = (yy - y0).float()[:, None]
    fx = (xx - x0).float()[None, :]
    y1, x1 = (y0 + 1).clamp(max=gh - 1), (x0 + 1).clamp(max=gw - 1)
    return (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y1][:, x0] * fy * (1 - fx)
            + grid[y0][:, x1] * (1 - fy) * fx + grid[y1][:, x1] * fy * fx)


def value_noise(g: torch.Generator, H: int, W: int, octaves: int = 5, base: int = 8):
    """Multi-octave value noise in [0, 1], [H, W]."""
    acc = torch.zeros((H, W), device=g.device)
    amp, tot = 1.0, 0.0
    for o in range(octaves):
        gh, gw = base * 2 ** o + 1, base * 2 ** o * 2 + 1
        grid = torch.rand((gh, gw), generator=g, device=g.device)
        acc += amp * _lerp_grid(grid, H, W)
        tot += amp
        amp *= 0.55
    return acc / tot


def clip(seed: int, frames: int, H: int, W: int, device) -> torch.Tensor:
    """[frames, H, W, 3] float32 in [0, 1], 8-bit levels."""
    g = generator(seed, 1, device)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (1,), generator=g, device=device)

    margin = max(64, 8 * frames + 8)
    bg = 0.25 + 0.6 * torch.stack([value_noise(g, H, W + margin) for _ in range(3)], -1)
    tex = [value_noise(g, 256, 256, octaves=4, base=4) for _ in range(4)]
    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    mx, my = (200 if W >= 400 else W // 4), (150 if H >= 300 else H // 4)
    objs = [dict(cx=u(mx, W - mx), cy=u(my, H - my), r=u(60, 160), vx=u(-25, 25),
                 vy=u(-12, 12), col=u(0.4, 1.0, 3), tex=tex[k]) for k in range(4)]
    out = torch.empty((frames, H, W, 3), device=device)
    for f in range(frames):
        img = bg[:, 8 * f:8 * f + W].clone()
        for o in objs:
            cx, cy = o["cx"] + o["vx"] * f, o["cy"] + o["vy"] * f
            d = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            m = torch.clamp(1.2 - d / o["r"], 0, 1)[..., None]
            ty = torch.clamp((yy - cy) / o["r"] * 96 + 128, 0, 255).long()
            tx = torch.clamp((xx - cx) / o["r"] * 96 + 128, 0, 255).long()
            t = o["tex"][ty, tx][..., None]
            img = img * (1 - m) + m * (o["col"] * (0.5 + 0.5 * t))
        out[f] = torch.floor(torch.clamp(img, 0, 1) * 255) / 255
    return out


def splat_stream(seed: int, frames: int, n: int, device, stream: int = 2) -> dict:
    """A stream of `frames` frames of n splats in the representation's raw
    form: xyz [F, n, 2] (atanh of NDC means), cholesky [F, n, 3] (the
    elements less their bound), features_dc [F, n, 3]; the means move on
    smooth loops, the shapes and colours stay."""
    g = generator(seed, stream, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    means = -0.999 + 1.998 * rand(n, 2)
    L = torch.stack([1.0 + 5.0 * rand(n), torch.randn(n, generator=g, device=device),
                     1.0 + 5.0 * rand(n)], -1)
    colors = rand(n, 3)
    phase = 2 * math.pi * rand(n, 2)
    amp = 0.01 * rand(n, 2)
    t = 2 * math.pi * torch.arange(frames, device=device, dtype=torch.float32) / frames
    moved = torch.clamp(means + amp * torch.sin(t[:, None, None] + phase), -0.999, 0.999)
    bound = torch.tensor((0.5, 0.0, 0.5), device=device)
    return {
        "xyz": torch.atanh(moved),
        "cholesky": (L - bound).expand(frames, n, 3).contiguous(),
        "features_dc": colors.expand(frames, n, 3).contiguous(),
    }


def reshuffled(stream: dict, seed: int, device, key: int = 4) -> dict:
    """The frames of `stream` in an order drawn from the seed: a permutation
    of the splats (the same in every frame, so the motion stays smooth),
    their colours drawn anew, and the frame the stream starts at. Each
    frame keeps its splats' shapes and places, so its intersections, and
    the work a render of it does, are the same for every seed."""
    g = generator(seed, key, device)
    frames, n, _ = stream["xyz"].shape
    perm = torch.randperm(n, generator=g, device=device)
    start = int(torch.randint(0, frames, (1,), generator=g, device=device))
    colors = torch.rand((n, 3), generator=g, device=device)
    return {
        "xyz": torch.roll(stream["xyz"][:, perm], -start, 0).contiguous(),
        "cholesky": torch.roll(stream["cholesky"][:, perm], -start, 0).contiguous(),
        "features_dc": colors.expand(frames, n, 3).contiguous(),
    }

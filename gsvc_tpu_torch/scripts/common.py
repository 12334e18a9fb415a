"""What the profiling harnesses share: the bench scene and its binning,
the slots' library reduction, the flags, the card check, the full-sum
fold and the two timings.

Every stage is reported twice: "events" ms, from CUDA events (around a
chained loop: what the program pays, host enqueue included where the host
is the slower side; around calls queued behind a spin kernel: the call's
device time), and "busy" ms, the device-side events of torch.profiler
(what the device does).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gsvc_tpu_torch.ops.binning import BinnedSplats, bin_gaussians
from gsvc_tpu_torch.ops.projection import project_gaussians_2d
from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum
from gsvc_tpu_torch.utils.profiling import (
    device_busy_ms,
    device_loop_time,
    event_ms,
    tensors,
)


def bench_scene(n: int, device, seed: int = 0):
    """bench.py's scene (bench.py:70-83, seed 0): means U(-0.999, 0.999),
    cholesky L with diagonals U(1, 6) and off-diagonal N(0, 1), colours
    U(0, 1), unit opacity."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.999, 0.999, (n, 2))
    L = np.stack([rng.uniform(1.0, 6.0, n), rng.normal(0.0, 1.0, n),
                  rng.uniform(1.0, 6.0, n)], axis=1)
    colors = rng.uniform(0, 1, (n, 3))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return t(means), t(L), t(colors), torch.ones((n, 1), device=device)


def budget_for(nth: torch.Tensor) -> int:
    """The intersection budget of the bench runs: 5 % over this frame's
    intersections, rounded up to 8192 (81,920 at 1080p/10k)."""
    return int(np.ceil(int(nth.sum()) * 1.05 / 8192)) * 8192


class Scene(NamedTuple):
    H: int
    W: int
    n: int
    tb: Tuple[int, int, int]
    means: torch.Tensor
    L: torch.Tensor
    colors: torch.Tensor
    opacity: torch.Tensor
    xys: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    conics: torch.Tensor
    nth: torch.Tensor
    budget: int
    binned: BinnedSplats

    @property
    def rargs(self):
        """The kernels' common arguments (binned splats, geometry)."""
        return (self.binned, self.xys, self.conics, self.colors, self.opacity,
                self.H, self.W, self.tb, 16, 16, 256)


def scene(n: int, H: int, W: int, device) -> Scene:
    """The bench scene projected and binned through the kernels."""
    tb = ((W + 15) // 16, (H + 15) // 16, 1)
    means, L, colors, opacity = bench_scene(n, device)
    with torch.no_grad():
        xys, depths, radii, conics, nth = project_gaussians_2d(means, L, H, W, tb)
        budget = budget_for(nth)
        binned = bin_gaussians(xys, radii, nth, tb, 16, 16, budget)
    return Scene(H, W, n, tb, means, L, colors, opacity, xys, depths, radii,
                 conics, nth, budget, binned)


def render(sc: Scene, means, L, colors, layout: str = "image") -> torch.Tensor:
    """The harnesses' forward: projection and the full API render through
    the kernels (backend "cuda", the scene's budget), differentiable."""
    xys, depths, radii, conics, nth = project_gaussians_2d(means, L, sc.H, sc.W, sc.tb)
    return rasterize_gaussians_sum(xys, depths, radii, conics, nth, colors, sc.opacity,
                                   sc.H, sc.W, backend="cuda", layout=layout,
                                   max_intersects=sc.budget)


def slot_owners(gauss_slot_start: torch.Tensor, s: int) -> torch.Tensor:
    """[S] int64 splat owning each expansion slot (N past the kept total)."""
    return torch.searchsorted(gauss_slot_start.to(torch.int64),
                              torch.arange(s, device=gauss_slot_start.device),
                              right=True) - 1


def segsum_index_add(vslots: torch.Tensor, owners: torch.Tensor, n: int) -> torch.Tensor:
    """[N, 9] per-splat sums of the [9, S] slots by `index_add_`: the one
    library call for the reduction K3 and its gather serve (the
    counterpart of jax.ops.segment_sum). Float atomics on the card, so
    not deterministic: a yardstick only, used nowhere in the port."""
    out = torch.zeros((n + 1, vslots.shape[0]), dtype=vslots.dtype, device=vslots.device)
    return out.index_add_(0, owners, vslots.T)[:n]


def parse(doc: str, argv, iters: int) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--num-points", type=int, default=10000)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=iters,
                    help="timed repetitions of each stage")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device; the harness refuses any other")
    return ap.parse_args(argv)


def cuda_device(name: str) -> Optional[torch.device]:
    """The CUDA device `name`, made current; None (after a message on
    stderr) where there is no card or `name` is not a CUDA device."""
    dev = torch.device(name)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print(f"{sys.argv[0]}: needs a CUDA device (got --device {name}, "
              f"torch.cuda.is_available() {torch.cuda.is_available()}): a timing "
              "is never taken on the CPU", file=sys.stderr)
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev


def card_line() -> str:
    """`name, power.limit` of the current card (nvidia-smi's own line)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or torch.cuda.get_device_name()


def fullsum(*trees) -> torch.Tensor:
    """A float32 scalar that depends on every element of every tensor in
    `trees` (the TPU harnesses' fold, so no stage's output goes unread)."""
    tot = None
    for t in tensors(trees):
        s = torch.sum(t.detach().to(torch.float32))
        tot = s if tot is None else tot + s
    return tot


def fold(x: torch.Tensor, *outs) -> torch.Tensor:
    """x, made to depend on `outs`: the chain link x -> x + 0 * sum(outs)."""
    return x + fullsum(*outs) * 0.0


def chained(fn: Callable, x0, iters: int, busy_reps: int) -> Tuple[float, float]:
    """(events ms, busy ms) an iteration of the chain x -> fn(x)."""
    ms = device_loop_time(fn, x0, reps=iters, outer=1) * 1e3
    box = [x0]

    def once():
        box[0] = fn(box[0])

    return ms, device_busy_ms(once, busy_reps)


def alone(fn: Callable[[], object], iters: int, busy_reps: int) -> Tuple[float, float]:
    """(events ms, busy ms) of one call of fn() timed alone."""
    return event_ms(fn, iters), device_busy_ms(fn, busy_reps)


def print_rows(title: str, rows: List[tuple]) -> None:
    """rows of (stage, events ms, busy ms[, note])."""
    print(title)
    print(f"  {'stage':34s} {'events ms':>11s} {'busy ms':>11s}")
    for name, ms, busy, *note in rows:
        print(f"  {name:34s} {ms:11.4f} {busy:11.4f}  {' '.join(note)}")

"""Tile-sharded training at 1920x1080, the ragged case (67.5 tile rows),
against the single-process fit: the port's counterpart of
scripts/validate_1080p_sharding.py.

    python -m gsvc_tpu_torch.scripts.validate_1080p_sharding [--device cuda]
        [--height 1080 --width 1920] [--shards 2,4,8]

The JAX script's case: 256 splats, 2 iterations, removal control with
densification_interval 2, the target uniform from default_rng(42). Each
shard count runs `parallel.sharded.fit_frame_sharded` on that many gloo
ranks (`parallel.launch`; on a card, every rank shares it unless there are
more) from the state `fit_frame` starts from, and holds rank 0's result to
the single-process fit with the JAX script's limits: |dloss| < 1e-5,
parameters max-abs < 2e-3, image max-abs < 5e-3. 8 shards of 68 tile rows
leave ragged spans (9 rows each, the last one 5 and past the image). It
prints one MATCH or MISMATCH line a shard count and exits 1 on a
mismatch. The fits take the kernel path ("cuda"): the kernels on a card,
their plain versions on the CPU (`--device cpu`, where `--height` and
`--width` shrink the case).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

N, ITERS, SEED = 256, 2, 42
LIMITS = {"loss": 1e-5, "param": 2e-3, "image": 5e-3}
PARAMS = ("xyz", "cholesky", "features_dc", "rgb_w")


def case(height: int, width: int, device):
    """(cfg, the target, the initial state) of the validation on `device`."""
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.models.represent import init_train_state

    cfg = FrameConfig(H=height, W=width, num_points=N, max_num_points=N, iterations=ITERS,
                      backend="cuda", isremoval=True, densification_interval=2)
    rng = np.random.default_rng(SEED)
    gt = torch.as_tensor(rng.uniform(0, 1, (height, width, 3)).astype(np.float32),
                         device=device)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(5), device=device)
    return cfg, gt, state


def result(res) -> dict:
    """A fit's loss, parameters and image as CPU values."""
    return {"loss": float(res.state.loss),
            "params": {k: getattr(res.state.params, k).detach().cpu() for k in PARAMS},
            "image": res.image.detach().cpu()}


def sharded_rank(rank: int, world_size: int, height: int, width: int,
                 device: str) -> Optional[dict]:
    """One rank of the sharded fit (`parallel.launch`); rank 0 returns it."""
    from gsvc_tpu_torch.parallel import sharded
    from gsvc_tpu_torch.parallel.launch import rank_device

    dev = rank_device(rank, device)
    cfg, gt, state = case(height, width, dev)
    res = sharded.fit_frame_sharded(state, gt, cfg, sharded.tile_mesh(world_size))
    return result(res) if rank == 0 else None


def differences(ref: dict, got: dict) -> dict:
    """|dloss|, the parameters' and the image's max-abs difference."""
    return {"loss": abs(got["loss"] - ref["loss"]),
            "param": max(float((got["params"][k] - ref["params"][k]).abs().max())
                         for k in PARAMS),
            "image": float((got["image"] - ref["image"]).abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--shards", default="2,4,8", help="comma-separated shard counts")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds each sharded launch may take (none by default)")
    args = ap.parse_args(argv)
    from gsvc_tpu_torch.drivers.common import resolve_device
    from gsvc_tpu_torch.models.represent import fit_frame
    from gsvc_tpu_torch.parallel.launch import launch

    dev = resolve_device(args.device)
    cfg, gt, state = case(args.height, args.width, dev)
    ref = result(fit_frame(state, gt, cfg))
    print(f"single process: loss={ref['loss']:.6f} ({args.width}x{args.height}, {N} splats, "
          f"{ITERS} its, {dev})", flush=True)
    ok_all = True
    for shards in (int(s) for s in args.shards.split(",")):
        got = launch(sharded_rank, shards, (args.height, args.width, str(dev)),
                     timeout=args.timeout)[0]
        d = differences(ref, got)
        ok = all(d[k] < LIMITS[k] for k in LIMITS)
        ok_all &= ok
        print(f"--tile_shards {shards} @{args.width}x{args.height}: |dloss|={d['loss']:.2e} "
              f"max|dparam|={d['param']:.2e} max|dimage|={d['image']:.2e} "
              f"{'MATCH' if ok else 'MISMATCH'}", flush=True)
    print("ragged tile sharding: " + ("ALL SHARD COUNTS MATCH the single process" if ok_all
                                      else "A SHARD COUNT MISMATCHES the single process"))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())

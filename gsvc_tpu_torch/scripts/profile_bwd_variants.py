"""P5: the job-based backward, a design study for K6's load imbalance.

The port of scripts/profile_bwd_variants.py (pallas_call :109, variants
A-E at :123-243). That script no longer runs against gsvc_tpu (it reads
`rp.WINDOW`, `_pack_intersections`, `_image_to_vtiles`, `_build_jobs`,
`_window_mask` and a three-argument `_splat_features`, all removed since),
so this module ports what it computed.

A job is one tile's window of up to WINDOW = 32 lanes: one warp's worth,
so the mean tile at 1080p/10k (~9.5 lanes) is one job and a tile at the
256 cap is eight. `build_jobs` lists them with torch ops (a cumsum of
ceil(min(count, cap) / WINDOW) a tile). The kernel
(csrc/profile_bwd_variants.cu) runs a CTA of 256 threads per job, one per
pixel, and reduces over pixels per lane with a fixed warp-shuffle tree
and the 8 warps in order: no float atomics.

  A  load the job's lanes and write them to their expansion slots
  B  A plus the tile's image gradient fetched (its sum added)
  C  full gradients, one CTA per tile walking its windows in order
  D  full gradients, one CTA per job
  E  sigma and exp only: sum over pixels of exp(-sigma), slot row 0
  F  K6's kernel with a warp per lane, 8 pixels a thread (one CTA a tile;
     csrc/rasterize_bwd.cuh, the rows layout)
  G  the same with 16 threads a lane, 16 pixels a thread

F and G are K6's two pixel splits, timed against each other here; K6
(csrc/rasterize_bwd.cu) runs the faster. The jobs list is unused by both.
C, D, F and G compute K6's function, the [9, S] per-slot gradients, C and
D in another summation order (rel 1e-4 of the largest entry).

    python -m gsvc_tpu_torch.scripts.profile_bwd_variants [--iters 30]

prints each variant's events and busy ms beside K6's, and C's and D's
error against K6's slots. Each variant's wrapper (`BACKWARD_JOBS[v]`,
counted as the recorder's `launches.backward_jobs_<v>`) runs its kernel on
a CUDA tensor and its plain version, `backward_jobs_torch`, on a CPU
tensor.
"""

from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.ops import rasterize_cuda
from gsvc_tpu_torch.ops.rasterize_cuda import (
    GRAD_FIELDS,
    check_inputs,
    grad_tiles,
    lane_grads,
    lane_slots,
    padded_splats,
    round8,
)
from gsvc_tpu_torch.scripts import common
from gsvc_tpu_torch.utils import work

WINDOW = 32
VARIANTS = ("A", "B", "C", "D", "E", "F", "G")
K6_FUNCTION = ("C", "D", "F", "G")  # the variants that compute K6's slots
JOB_CHUNK = 256  # jobs a step of the plain version: [256, 32, 256] floats


class Jobs(NamedTuple):
    """One entry a job, int32 [J]: its tile, its first lane in the sorted
    binning arrays, its lane count (1..window)."""

    tile: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    window: int


def build_jobs(binned, cap: int = 256, window: int = WINDOW) -> Jobs:
    """Every tile's first min(count, cap) lanes, cut into windows of
    `window` lanes in lane order."""
    dev = binned.tile_counts.device
    cnt = torch.clamp(binned.tile_counts, max=cap).to(torch.int64)
    per_tile = (cnt + window - 1) // window
    tile = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), per_tile)
    w = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(per_tile, 0) - per_tile)[tile]
    first = binned.tile_bin_start.to(torch.int64)[tile] + w * window
    count = torch.clamp(cnt[tile] - w * window, max=window)
    return Jobs(tile.to(torch.int32), first.to(torch.int32), count.to(torch.int32),
                window)


def backward_jobs_torch(variant, binned, xys, conics, colors, opacity, v_rows,
                        img_height, img_width, tile_bounds, jobs: Jobs, cap=256):
    """Plain version of a P5 variant: [9, S] slot values, computed job by
    job as dense [jobs, WINDOW, pixels] tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev, n = xys.device, xys.shape[0]
    s = binned.sorted_gauss_ids.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    splats = padded_splats(xys, conics, colors, opacity)
    vt = grad_tiles(v_rows.to(torch.float32), "rows", img_height, img_width,
                    tb_x, tb_y, 16, 16)  # [T, 256, 3]
    k = torch.arange(jobs.window, device=dev)
    ids_all = binned.sorted_gauss_ids.to(torch.int64)
    out = torch.zeros((GRAD_FIELDS, s + 1), dtype=torch.float32, device=dev)
    for j0 in range(0, jobs.tile.shape[0], JOB_CHUNK):
        tids = jobs.tile[j0:j0 + JOB_CHUNK].to(torch.int64)
        lane = jobs.first[j0:j0 + JOB_CHUNK].to(torch.int64)[:, None] + k
        used = k < jobs.count[j0:j0 + JOB_CHUNK].to(torch.int64)[:, None]
        g = torch.where(used, ids_all[lane.clamp(max=max(s - 1, 0))], n)
        g = torch.where((g >= 0) & (g < n), g, n)  # [jc, WINDOW]
        slots = lane_slots(binned, g, tids, tb_x, n).reshape(-1)
        if variant in K6_FUNCTION:
            vals = lane_grads(g, tids, vt[tids], splats, tb_x)
        elif variant == "E":
            vals = torch.zeros((GRAD_FIELDS,) + g.shape, device=dev)
            vals[0] = _exp_sums(g, tids, splats, tb_x)
        else:
            xys_p, conics_p, colors_p, opac_p = splats
            vals = torch.stack([xys_p[g, 0], xys_p[g, 1], conics_p[g, 0], conics_p[g, 1],
                                conics_p[g, 2], opac_p[g], colors_p[g, 0],
                                colors_p[g, 1], colors_p[g, 2]])
            if variant == "B":
                vals = vals + vt[tids].sum((1, 2))[None, :, None]
        out[:, slots] = vals.reshape(GRAD_FIELDS, -1)
    return out[:, :s]


def _exp_sums(g, tids, splats, tb_x):
    """[jc, k] sum over each lane's tile pixels of exp(-sigma)."""
    xys_p, conics_p, _c, _o = splats
    dev = xys_p.device
    local_y = torch.arange(16, dtype=torch.float32, device=dev).repeat_interleave(16)
    local_x = torch.arange(16, dtype=torch.float32, device=dev).repeat(16)
    px = ((tids % tb_x) * 16).to(torch.float32)[:, None] + local_x
    py = ((tids // tb_x) * 16).to(torch.float32)[:, None] + local_y
    dx = xys_p[g, 0][:, :, None] - px[:, None, :]
    dy = xys_p[g, 1][:, :, None] - py[:, None, :]
    c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
    return torch.exp(-(0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy)).sum(-1)


def _jobs_wrapper(variant: str):
    vid = VARIANTS.index(variant)

    def wrapper(binned, xys, conics, colors, opacity, v_rows, img_height, img_width,
                tile_bounds, jobs: Jobs, cap=256):
        if not xys.is_cuda:
            return backward_jobs_torch(variant, binned, xys, conics, colors, opacity,
                                       v_rows, img_height, img_width, tile_bounds,
                                       jobs, cap)
        dev = xys.device
        tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
        f32 = check_inputs("backward_jobs", binned, xys, conics, colors, opacity,
                           tile_bounds, 16, 16, cap)
        if jobs.window > WINDOW:
            raise ValueError(f"backward_jobs: jobs of {jobs.window} lanes; the kernel "
                             f"takes at most {WINDOW}")
        r_out = round8(3 * tb_x)
        if v_rows.dtype != torch.float32 or tuple(v_rows.shape) != (
                tb_y * r_out, 256) or v_rows.device != dev:
            raise ValueError(f"backward_jobs: v_rows must be float32 [{tb_y * r_out}, "
                             f"256] on {dev}, got {v_rows.dtype} {tuple(v_rows.shape)}")
        i32 = [t.contiguous() for t in (
            binned.tile_bin_start, binned.tile_counts, binned.sorted_gauss_ids,
            binned.gauss_slot_start, binned.bbox_pack, jobs.tile, jobs.first,
            jobs.count)]
        if any(t.dtype != torch.int32 or t.device != dev for t in i32):
            raise ValueError(f"backward_jobs: binning and job arrays must be int32 on {dev}")
        s = binned.sorted_gauss_ids.shape[0]
        out = torch.zeros((GRAD_FIELDS, s), dtype=torch.float32, device=dev)
        v = v_rows.contiguous()
        _build.launch(
            _lib(), "backward_jobs", dev, *(_build.ptr(t) for t in i32[:5] + f32),
            _build.ptr(v), *(_build.ptr(t) for t in i32[5:]), xys.shape[0], img_height,
            img_width, tb_x, tb_y, cap, r_out, s, jobs.tile.shape[0], vid, _build.ptr(out),
            counter=wrapper.__name__)
        return out

    wrapper.__name__ = wrapper.__qualname__ = f"backward_jobs_{variant}"
    wrapper.__doc__ = f"P5 variant {variant}: the job-based backward into [9, S] slots."
    return wrapper


BACKWARD_JOBS = {v: _jobs_wrapper(v) for v in VARIANTS}


def _lib() -> ctypes.CDLL:
    return _build.bind("profile_bwd_variants", {
        "backward_jobs": (I32, [VP] * 13 + [I32] * 7 + [I64, I32, I32, VP, VP])})


def main(argv=None) -> int:
    args = common.parse(__doc__, argv, iters=30)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    busy_reps = max(args.iters // 4, 3)
    jobs = build_jobs(sc.binned)
    v_rows = rasterize_cuda.image_to_rows(
        torch.randn((sc.H, sc.W, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0)),
        sc.tb[0], sc.tb[1])
    bargs = (*sc.rargs[:5], v_rows, sc.H, sc.W, sc.tb)
    print(f"P5 profile_bwd_variants [{common.card_line()}]: {sc.W}x{sc.H}, {sc.n} "
          f"splats, {work.lanes(sc)} lanes in {jobs.tile.shape[0]} jobs of <= "
          f"{WINDOW} ({sc.tb[0] * sc.tb[1]} tiles)")
    with torch.no_grad():
        k6 = rasterize_cuda.backward_slots(*bargs, 16, 16, 256, "rows")
        rows = [("K6 backward", *common.alone(
            lambda: rasterize_cuda.backward_slots(*bargs, 16, 16, 256, "rows"),
            args.iters, busy_reps))]
        for v in VARIANTS:
            def call(v=v):
                return BACKWARD_JOBS[v](*bargs, jobs)

            note = ""
            if v in K6_FUNCTION:
                err = float((call() - k6).abs().max()) / float(k6.abs().max())
                note = f"rel err vs K6 {err:.3e}"
            rows.append((f"{v}", *common.alone(call, args.iters, busy_reps), note))
    common.print_rows("P5 job-based backward variants (each alone):", rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())

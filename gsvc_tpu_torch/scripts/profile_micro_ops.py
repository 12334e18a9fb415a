"""P3: each piece of the eval forward and of the binning timed alone on the
card, and every kernel K1-K6 beside its bound, its launches a main-path
step and its library call.

The port of scripts/profile_micro_ops.py, which timed the TPU's forward
kernels alone (`rp._forward_kernel`, K4, pallas_call :209;
`rp._forward_kernel_chw`, K5, :239) beside the binning primitives.

    python -m gsvc_tpu_torch.scripts.profile_micro_ops [--iters 100]

Each op runs alone, behind a spin kernel, between CUDA events
(`utils.profiling.event_ms`: the call's device time, not the host's
launch rate), and again under torch.profiler (`device_busy_ms`). The
bound of a kernel (`utils.work.kernel_work`, `utils.profiling.roofline_ms`)
counts each input byte read once and each output byte written once, and
the operations these inputs need: (pixel, lane) pairs are 256 x sum over
tiles of min(count, 256), of which those past the alpha gate do the
gated part of the work. `+pack` of the TPU harness has no counterpart:
`_pack_lanes` is folded into K4's load (ops/rasterize_cuda.py:12-13).

Beside the ops: the sort of the port's keys (`fill_cuda.key_layout`:
int32 at 1080p and 4K below 65,536 splats) and of the same keys as int64,
and the sort of wide keys (a 17-bit gauss field: the bench scene at
WIDE_SORT_N splats at 1080p, int32 and as int64, and at 4K UHD, int64);
an empty kernel, the floor under every kernel's time; K3 by itself, on
K6's slots, over rows and lanes, and as the whole reduction (segment flags, K3, gather) beside `index_add_`;
`searchsorted` of the tile edges, K2's library call; and the device
kernels each of K1, K2, K3 and `bin_gaussians` launches, with their busy
ms a call (`--split-only` prints only these; run as a file with another
tree's package first on PYTHONPATH, it splits that tree's kernels, where
its wrappers take the same arguments).
"""

from __future__ import annotations

import sys

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch.ops import fill_cuda, rasterize_cuda
from gsvc_tpu_torch.ops.binning import bin_gaussians, key_inputs
from gsvc_tpu_torch.ops.projection import _tile_bbox, project_gaussians_2d
from gsvc_tpu_torch.scripts import common
from gsvc_tpu_torch.utils import work
from gsvc_tpu_torch.utils.profiling import device_events, profile_device, roofline_ms

# Launches of each kernel in one step of the main paths (from the code):
# the eval render (`render_frame`, layout chw) and the represent step
# (`make_train_step`, the rows loss).
LAUNCHES_PER_STEP = {
    "K1 fill_decode_keys": {"eval render": 1, "represent step": 1},
    "K2 rank_cap_decode": {"eval render": 1, "represent step": 1},
    "K3 segmented_cumsum": {"eval render": 0, "represent step": 1},
    "K4 forward image": {"eval render": 0, "represent step": 0},
    "K4 forward rows": {"eval render": 0, "represent step": 1},
    "K5 forward chw": {"eval render": 1, "represent step": 0},
    "K6 backward": {"eval render": 0, "represent step": 1},
}

# The one PyTorch call computing the same function, where there is one (a
# row of the ops table).
LIBRARY = {"K2 rank_cap_decode": "searchsorted tile edges [T+1]"}

# The bench scene's splats and grids (H, W) whose keys' sort is also timed
# at the wide layout
WIDE_SORT_N, WIDE_SORT_GRIDS = 100000, ((1080, 1920), (2160, 3840))


def kernel_split(sc, dev, reps: int) -> None:
    """Print the device kernels of one call of K1, K2, K3 (on K6's slots)
    and `bin_gaussians` with their busy ms a call
    (`utils.profiling.profile_device`)."""
    with torch.no_grad():
        ki = key_inputs(sc.xys, sc.radii, sc.nth, sc.tb, 16, 16, sc.budget)
        skeys = torch.sort(fill_cuda.fill_decode_keys(*ki.k1)).values
        v_rows = rasterize_cuda.image_to_rows(torch.randn(
            (sc.H, sc.W, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0)),
            sc.tb[0], sc.tb[1])
        vslots = rasterize_cuda.backward_slots(*sc.rargs[:5], v_rows, *sc.rargs[5:], "rows")
        flags = rasterize_cuda.segment_flags(sc.binned.gauss_slot_start, sc.budget)
        calls = {
            "K1 fill_decode_keys": lambda: fill_cuda.fill_decode_keys(*ki.k1),
            "K2 rank_cap_decode": lambda: fill_cuda.rank_cap_decode(skeys, 256, sc.n,
                                                                    ki.num_tiles),
            "K3 segmented_cumsum [9,S] (K6 slots)":
                lambda: fill_cuda.segmented_cumsum(vslots, flags),
            "bin_gaussians": lambda: bin_gaussians(sc.xys, sc.radii, sc.nth, sc.tb, 16, 16,
                                                   sc.budget),
        }
        print("P3 device kernels of each call (busy ms a call):")
        for name, fn in calls.items():
            busy, events = profile_device(fn, reps)
            kernels = sorted(device_events(events), key=lambda e: -e.self_device_time_total)
            print(f"  {name}: {busy:.4f} ms busy; " + "; ".join(
                f"{e.key[:60]} x{e.count / reps:g} {e.self_device_time_total / reps / 1e3:.4f} ms"
                for e in kernels))


def main(argv=None) -> int:
    # --split-only is taken here, not by common.parse, so that this file
    # runs against an older tree's package as well
    argv = list(sys.argv[1:] if argv is None else argv)
    split_only = "--split-only" in argv
    args = common.parse(__doc__, [a for a in argv if a != "--split-only"], iters=100)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    if split_only:
        print(f"P3 profile_micro_ops [{common.card_line()}]: {sc.W}x{sc.H}, n={sc.n} "
              f"budget={sc.budget}")
        kernel_split(sc, dev, max(args.iters // 10, 3))
        return 0
    H, W, n, tb, s = sc.H, sc.W, sc.n, sc.tb, sc.budget
    it, busy_reps = args.iters, max(args.iters // 10, 3)
    b = sc.binned
    print(f"P3 profile_micro_ops [{common.card_line()}]: {W}x{H}, n={n} "
          f"isect={int(b.num_intersects)} budget={s} lanes={work.lanes(sc)} "
          f"tiles={tb[0] * tb[1]}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, ms = [], {}

    def t(name, fn, note=""):
        ms[name], busy = common.alone(fn, it, busy_reps)
        rows.append((name, ms[name], busy, note))

    with torch.no_grad():
        ki = key_inputs(sc.xys, sc.radii, sc.nth, tb, 16, 16, s)
        keys = fill_cuda.fill_decode_keys(*ki.k1)
        skeys = torch.sort(keys).values
        t(f"sort {str(keys.dtype)[6:]} [S] (the port's)", lambda: torch.sort(keys))
        if keys.dtype == torch.int32:
            keys64 = keys.to(torch.int64)
            t("sort int64 [S] (same keys)", lambda: torch.sort(keys64),
              "the earlier port's key width; the same order")
        for wh, ww in WIDE_SORT_GRIDS:
            wsc = common.scene(WIDE_SORT_N, wh, ww, dev)
            wki = key_inputs(wsc.xys, wsc.radii, wsc.nth, wsc.tb, 16, 16, wsc.budget)
            wkeys = fill_cuda.fill_decode_keys(*wki.k1)
            tag, note = f"{ww}x{wh}/{WIDE_SORT_N // 1000}k", f"[{wsc.budget}] keys"
            t(f"sort {str(wkeys.dtype)[6:]} wide {tag}", lambda k=wkeys: torch.sort(k),
              f"{note}, a {fill_cuda.key_layout(wki.num_tiles, wsc.n).gauss_bits}-bit "
              "gauss field")
            if wkeys.dtype == torch.int32:
                wkeys64 = wkeys.to(torch.int64)
                t(f"sort int64 wide {tag}", lambda k=wkeys64: torch.sort(k),
                  f"{note}, the same as int64")
        t("empty kernel (the floor)", lambda: _build.empty_launch(dev),
          "one launch of a kernel that does nothing")
        idx = torch.cumsum(sc.nth, 0) - sc.nth
        keep = idx < s
        idx, payload = idx[keep].to(torch.int64), torch.arange(n, device=dev)[keep]
        seeds = torch.zeros(s, dtype=torch.int64, device=dev)
        t("seed scatter [N->S] (amax)",
          lambda: seeds.clone().scatter_reduce_(0, idx, payload, "amax"))
        t("K1 fill_decode_keys", lambda: fill_cuda.fill_decode_keys(*ki.k1))
        t("K2 rank_cap_decode", lambda: fill_cuda.rank_cap_decode(skeys, 256, n, ki.num_tiles))
        tile_ids = fill_cuda.rank_cap_decode(skeys, 256, n, ki.num_tiles)[0]
        tile_range = torch.arange(ki.num_tiles + 1, dtype=torch.int32, device=dev)
        t("searchsorted tile edges [T+1]", lambda: torch.searchsorted(tile_ids, tile_range),
          "K2's library call: its tile edges alone")
        vals16 = torch.randn((16, s), device=dev, generator=gen)
        flags8 = (torch.arange(s, device=dev) % 8 == 0).to(torch.int32)
        t("K3 segmented_cumsum", lambda: fill_cuda.segmented_cumsum(vals16, flags8),
          "[16,S], a segment every 8 lanes (the TPU harness's input)")
        sparse = (torch.rand(s, device=dev, generator=gen) < 5e-5).to(torch.int32)
        t("K3 [16,S] sparse flags", lambda: fill_cuda.segmented_cumsum(vals16, sparse),
          "p = 5e-5: segments longer than a CTA's span")
        table = torch.cat([sc.xys, sc.conics, sc.opacity, sc.colors,
                           b.bbox_pack[:, None].float(), b.gauss_slot_start[:-1, None].float()],
                          1)
        table = torch.cat([table, torch.zeros((1, 11), device=dev)])
        gauss_mask = fill_cuda.key_layout(tb[0] * tb[1], n).gauss_mask
        gidx = torch.clamp(b.sorted_keys & gauss_mask, max=n).long()
        t("lane gather [S,11]", lambda: table[gidx])
        t("bin_gaussians", lambda: bin_gaussians(sc.xys, sc.radii, sc.nth, tb, 16, 16, s))
        tmin_x, tmin_y, tmax_x, tmax_y = _tile_bbox(sc.xys, sc.radii.float(), tb, 16, 16)
        rr, cc = torch.arange(tb[1], device=dev), torch.arange(tb[0], device=dev)

        def counts():
            rowind = ((rr[None] >= tmin_y[:, None]) & (rr[None] < tmax_y[:, None])).float()
            colind = ((cc[None] >= tmin_x[:, None]) & (cc[None] < tmax_x[:, None])).float()
            return torch.matmul(rowind.T, colind)

        t("counts matmul", counts, "torch.matmul: XLA computed it outside Pallas")
        t("projection", lambda: project_gaussians_2d(sc.means, sc.L, H, W, tb))
        rows.append(("+pack", float("nan"), float("nan"),
                     "none: _pack_lanes is folded into K4's load"))
        for name, layout in (("K4 forward image", "image"), ("K4 forward rows", "rows"),
                             ("K5 forward chw", "chw")):
            t(name, lambda layout=layout: rasterize_cuda.FORWARD[layout](*sc.rargs))
        v_rows = rasterize_cuda.image_to_rows(
            torch.randn((H, W, 3), device=dev, generator=gen), tb[0], tb[1])
        bargs = (*sc.rargs[:5], v_rows, H, W, tb, 16, 16, 256, "rows")
        t("K6 backward", lambda: rasterize_cuda.backward_slots(*bargs))
        vslots = rasterize_cuda.backward_slots(*bargs)
        flags = rasterize_cuda.segment_flags(b.gauss_slot_start, s)
        t("K3 segmented_cumsum [9,S] (K6 slots)",
          lambda: fill_cuda.segmented_cumsum(vslots, flags))
        # what bounds K3: its time against the rows and the lanes it scans
        for rows_, lanes_ in ((1, s), (4, s), (16, s), (32, s), (9, s // 8), (9, s // 2),
                              (9, 2 * s), (9, 8 * s)):
            v_ = torch.randn((rows_, lanes_), device=dev, generator=gen)
            f_ = (torch.arange(lanes_, device=dev) % 8 == 0).to(torch.int32)
            t(f"K3 [{rows_},{lanes_}]", lambda v_=v_, f_=f_: fill_cuda.segmented_cumsum(v_, f_),
              "sweep, a segment every 8 lanes")
        t("K3 reduction (flags, K3, gather)",
          lambda: rasterize_cuda.reduce_slot_grads(vslots, b.gauss_slot_start))
        owners = common.slot_owners(b.gauss_slot_start, s)
        t("index_add_ slots->splats [9,S]", lambda: common.segsum_index_add(vslots, owners, n),
          "the reduction K3 + gather serve; not K3's library call")
        valid = work.gated_pairs(sc)
    common.print_rows("P3 ops (each alone):", rows)

    print(f"P3 kernels: pairs {work.pairs(sc)}, past the alpha gate {valid}; bounds "
          "against an H100 SXM's 3.35 TB/s and 67 TFLOP/s f32 (a card below 700 W is "
          "slower)")
    print(f"  {'kernel':22s} {'ms':>9s} {'bound ms':>9s} {'by':>10s} {'% bound':>8s} "
          f"{'eval/step launches':>19s}  library")
    for name, (n_bytes, ops) in work.kernel_work(sc, valid, k3_rows=16).items():
        k_ms = ms[name]
        bound, by = roofline_ms(n_bytes, ops)
        launches = LAUNCHES_PER_STEP[name]
        lib = LIBRARY.get(name)
        print(f"  {name:22s} {k_ms:9.4f} {bound:9.4f} {by:>10s} {100 * bound / k_ms:7.1f} "
              f"{launches['eval render']:>9d}/{launches['represent step']:<9d}  "
              + ("none" if lib is None else f"{ms[lib]:.4f} ms ({lib})"))
    print(f"  beside K3: index_add_ of the slots {ms['index_add_ slots->splats [9,S]']:.4f} ms, "
          f"the port's reduction {ms['K3 reduction (flags, K3, gather)']:.4f} ms; the empty "
          f"kernel's floor {ms['empty kernel (the floor)']:.4f} ms")
    kernel_split(sc, dev, busy_reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

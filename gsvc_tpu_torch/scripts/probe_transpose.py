"""P6: the transposes of K5's planar store, timed on the card.

The port of scripts/probe_mxu_transpose.py, which probed the TPU's MXU
for identity-matmul transposes of one tile-row block, [R, C] = [360, 256]
-> [256, 360] (`variant_kernel` :32, pallas_call :71), and of
[16, 16, R] -> [16, R, 16] (`minor_kernel` :79, pallas_call :97), for
K5's CHW epilogue. On the card a transpose is a copy through shared
memory (csrc/probe_transpose.cu), exact:

- `transpose_last2`: [..., R, C] -> [..., C, R], a 32x33 shared tile;
- `rows_to_chw`: K4's rows blocks [tb_y * r_out, 256] -> planar [3, H, W].

    python -m gsvc_tpu_torch.scripts.probe_transpose [--iters 100]

times both transposes at the probe's shapes and over a whole frame's rows
buffer, beside the library call (`x.transpose(-1, -2).contiguous()`),
then answers the probe's question for the card: K5's in-kernel planar
store against K4 rows followed by `rows_to_chw`. Each wrapper (with
`.launches`) runs its kernel on a CUDA tensor and its plain version on a
CPU tensor.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch.ops import rasterize_cuda
from gsvc_tpu_torch.scripts import common

R, C = 360, 256  # one tile-row block of the rows layout at 1080p


def transpose_last2_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `transpose_last2` (also the library call)."""
    return x.transpose(-1, -2).contiguous()


def transpose_last2(x: torch.Tensor) -> torch.Tensor:
    """[..., R, C] float32 -> [..., C, R], contiguous."""
    if not x.is_cuda:
        return transpose_last2_torch(x)
    if x.dtype != torch.float32 or x.dim() < 2:
        raise ValueError(f"transpose_last2: want float32 [..., R, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape[-2], x.shape[-1]
    batch = x.numel() // max(rows * cols, 1)
    if batch > 65535:
        raise ValueError(f"transpose_last2: batch {batch} exceeds one grid axis")
    src = x.contiguous()
    out = torch.empty((*x.shape[:-2], cols, rows), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.transpose_batched(_build.ptr(src), _build.ptr(out), batch, rows, cols,
                                   _build.stream_ptr(x.device))
    _build.check(lib, rc, "transpose_last2")
    transpose_last2.launches += 1
    return out


transpose_last2.launches = 0


def rows_to_chw_torch(rows: torch.Tensor, img_height: int, img_width: int,
                      tile_bounds, block_w: int = 16, block_h: int = 16):
    """Plain version of `rows_to_chw`."""
    img = rasterize_cuda.rows_to_image(rows, int(tile_bounds[0]), int(tile_bounds[1]),
                                       img_height, img_width, block_w, block_h)
    return img.permute(2, 0, 1).contiguous()


def rows_to_chw(rows: torch.Tensor, img_height: int, img_width: int, tile_bounds,
                block_w: int = 16, block_h: int = 16) -> torch.Tensor:
    """K4's rows blocks -> the planar [3, H, W] image K5 stores."""
    if not rows.is_cuda:
        return rows_to_chw_torch(rows, img_height, img_width, tile_bounds, block_w,
                                 block_h)
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    r_out = rasterize_cuda.round8(3 * tb_x)
    want = (tb_y * r_out, block_h * block_w)
    if rows.dtype != torch.float32 or tuple(rows.shape) != want or block_w * block_h > 1024:
        raise ValueError(f"rows_to_chw: want float32 {want}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    src = rows.contiguous()
    out = torch.empty((3, img_height, img_width), dtype=torch.float32, device=rows.device)
    lib = _lib()
    with torch.cuda.device(rows.device):
        rc = lib.rows_to_chw(_build.ptr(src), _build.ptr(out), img_height, img_width,
                             tb_x, tb_y, block_w, block_h, r_out,
                             _build.stream_ptr(rows.device))
    _build.check(lib, rc, "rows_to_chw")
    rows_to_chw.launches += 1
    return out


rows_to_chw.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("probe_transpose")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.transpose_batched.restype = i32
        lib.transpose_batched.argtypes = [vp, vp, i32, i32, i32, vp]
        lib.rows_to_chw.restype = i32
        lib.rows_to_chw.argtypes = [vp, vp] + [i32] * 7 + [vp]
        lib._gsvc_bound = True
    return lib


def probe_inputs(sc: common.Scene, device):
    """{name: x} the transposes are timed on: the probe's two shapes
    (uniform [0, 1), seeds 0 and 1 as the probe draws them) and the
    frame's rows buffer (K4 rows of the scene)."""
    gen = torch.Generator(device=device)
    k4_rows = rasterize_cuda.FORWARD["rows"](*sc.rargs)
    return {
        f"[{R},{C}]": torch.rand((R, C), generator=gen.manual_seed(0), device=device),
        f"[16,16,{R}]": torch.rand((16, 16, R), generator=gen.manual_seed(1),
                                   device=device),
        "rows [{},{}]".format(*k4_rows.shape): k4_rows,
    }


def main(argv=None) -> int:
    args = common.parse(__doc__, argv, iters=100)
    dev = common.cuda_device(args.device)
    if dev is None:
        return 1
    sc = common.scene(args.num_points, args.height, args.width, dev)
    busy_reps = max(args.iters // 10, 3)
    print(f"P6 probe_transpose [{common.card_line()}]: {sc.W}x{sc.H}, {sc.n} splats")
    rows = []
    with torch.no_grad():
        for name, x in probe_inputs(sc, dev).items():
            exact = torch.equal(transpose_last2(x), transpose_last2_torch(x))
            ms, busy = common.alone(lambda x=x: transpose_last2(x), args.iters, busy_reps)
            lib_ms, lib_busy = common.alone(lambda x=x: transpose_last2_torch(x),
                                            args.iters, busy_reps)
            gbs = 2 * x.numel() * 4 / (ms * 1e-3) / 1e9
            rows.append((f"transpose {name}", ms, busy,
                         f"{gbs:.0f} GB/s; exact {exact}"))
            rows.append((f"  library transpose().contiguous()", lib_ms, lib_busy))
        rargs, geom = sc.rargs, (sc.H, sc.W, sc.tb)
        k4_rows = rasterize_cuda.FORWARD["rows"](*rargs)
        exact = torch.equal(rows_to_chw(k4_rows, *geom),
                            rasterize_cuda.FORWARD["chw"](*rargs))
        rows.append(("K5 forward chw (planar store)",
                     *common.alone(lambda: rasterize_cuda.FORWARD["chw"](*rargs),
                                   args.iters, busy_reps)))
        rows.append(("K4 forward rows",
                     *common.alone(lambda: rasterize_cuda.FORWARD["rows"](*rargs),
                                   args.iters, busy_reps)))
        rows.append(("rows_to_chw alone",
                     *common.alone(lambda: rows_to_chw(k4_rows, *geom), args.iters,
                                   busy_reps), f"= K5 exactly: {exact}"))
        rows.append(("K4 rows + rows_to_chw",
                     *common.alone(lambda: rows_to_chw(
                         rasterize_cuda.FORWARD["rows"](*rargs), *geom),
                         args.iters, busy_reps)))
    common.print_rows("P6 transposes (each alone):", rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())

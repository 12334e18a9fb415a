"""The sum rasterizer's kernels and their autograd: forward K4/K5 with the
`rows` store (csrc/rasterize_fwd.cu), backward K6 (csrc/rasterize_bwd.cu),
and the lane->splat gradient reduction on K3 (ops/fill_cuda.py), each
beside its plain PyTorch version.

Forward. Replaces `_forward_kernel` (layouts "image" and "rows", K4) and
`_forward_kernel_chw` (layout "chw", K5) of gsvc_tpu/ops/rasterize_pallas.py,
launched from `_forward_impl`. The TPU streams each tile row's lanes through
VMEM and evaluates sigma and the colour sum as MXU matmuls over a whole row
of tiles. On the card the reference CUDA design fits directly: one CTA per
16x16 tile, one thread per pixel, the tile's first min(count, cap) splats
gathered once into shared memory (9 floats each, 9 KB at cap 256; the TPU's
`_pack_lanes` gather folds into this load), then each thread sums
rgb * alpha over them in lane order, in f32 registers: deterministic, no
atomics. One template writes [H, W, 3], [3, H, W] or the tile-row blocks of
`image_to_rows`, masking pixels past the image edge (1080 is 67.5 tile
rows). What bounds it: one expf and ~12 FLOPs per (pixel, lane) pair, about
2e7 pairs at 1080p/10k, so the SFU/FP32 pipes and the per-tile load
imbalance rather than memory. `expf`, not `__expf`: fast math belongs to
the later fast-colour mode.

Backward. Replaces `_backward_kernel` (K6) and the permutation-inverting
`_reduce_lane_grads` of rasterize_pallas.py. K6 runs one CTA per tile: the
tile's 3x256 image gradient is read once into shared memory straight from
the layout the forward wrote (no untile transpose), and one thread per lane
walks the 256 pixels in order, accumulating the lane's 9 gradients
[x, y, c1, c2, c3, opac, r, g, b] in registers (the reference's
backward.cu:790-840 math, with the min(1, .) forward-only and the conic's
off-diagonal gradient unhalved, so autograd through conic = inv(cov) gives
the reference's end-to-end gradient). Each lane writes its gradients to its
own expansion slot, gauss_slot_start[g] + its tile's row-major rank in g's
bbox, so slots are gaussian-major and the TPU path's two-sort permutation
inversion is not needed. The slot buffer is zero-filled, so lanes past the
per-tile cap keep exact zeros in their real slots. K3 then takes a
segmented cumsum over the slots, and each splat's total is read at the last
slot of its span. Deterministic: fixed order everywhere, no atomics. What
bounds K6: ~30 FLOPs and one expf per (lane, pixel) pair on a thread per
lane, so tiles with few lanes leave most of their threads idle (load
imbalance, work for a later redesign).

Each kernel wrapper counts its launches (`<wrapper>.launches`). On a CPU
tensor a wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch.ops import fill_cuda
from gsvc_tpu_torch.ops.binning import BinnedSplats
from gsvc_tpu_torch.ops.rasterize_binned import (
    TILE_CHUNK,
    rasterize_binned,
    tile_lane_ids,
    zrow,
)
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF

LAYOUTS = ("image", "chw", "rows")
_LAYOUT_ID = {name: i for i, name in enumerate(LAYOUTS)}
GRAD_FIELDS = 9  # x y c1 c2 c3 opac r g b


def round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def image_to_rows(img: torch.Tensor, tb_x: int, tb_y: int, block_w: int = 16,
                  block_h: int = 16) -> torch.Tensor:
    """[h, w, 3] image -> [tb_y * round8(3*tb_x), block_h*block_w] tile-row
    blocks: channel c of tile (tx, ty), pixel p = ly*block_w + lx, sits at
    row ty*round8(3*tb_x) + 3*tx + c, column p. Pixels past the image and
    the padding rows are zero (gsvc_tpu's `_image_to_vrows`)."""
    h_pad = tb_y * block_h - img.shape[0]
    w_pad = tb_x * block_w - img.shape[1]
    r_out = round8(3 * tb_x)
    gp = torch.nn.functional.pad(img, (0, 0, 0, w_pad, 0, h_pad))
    gp = gp.reshape(tb_y, block_h, tb_x, block_w, 3).permute(0, 2, 4, 1, 3)
    gp = gp.reshape(tb_y, 3 * tb_x, block_h * block_w)
    gp = torch.nn.functional.pad(gp, (0, 0, 0, r_out - 3 * tb_x))
    return gp.reshape(tb_y * r_out, block_h * block_w)


def rows_to_image(rows: torch.Tensor, tb_x: int, tb_y: int, img_height: int,
                  img_width: int, block_w: int = 16,
                  block_h: int = 16) -> torch.Tensor:
    """Inverse of `image_to_rows`: tile-row blocks -> [H, W, 3]."""
    r_out = rows.shape[0] // tb_y
    t = rows.reshape(tb_y, r_out, block_h * block_w)[:, : 3 * tb_x]
    t = t.reshape(tb_y, tb_x, 3, block_h, block_w).permute(0, 3, 1, 4, 2)
    img = t.reshape(tb_y * block_h, tb_x * block_w, 3)
    return img[:img_height, :img_width]


def rasterize_forward_torch(
    binned: BinnedSplats, xys, conics, colors, opacity,
    img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
    block_w: int = 16, block_h: int = 16, cap: int = 256,
    layout: str = "image",
) -> torch.Tensor:
    """Plain version of K4/K5: the binned renderer in the chosen layout."""
    img = rasterize_binned(
        binned, xys, conics, colors, opacity, img_height, img_width,
        tile_bounds, block_w, block_h, cap,
    )
    if layout == "chw":
        return img.permute(2, 0, 1).contiguous()
    if layout == "rows":
        return image_to_rows(img, int(tile_bounds[0]), int(tile_bounds[1]),
                             block_w, block_h)
    return img


def _forward_wrapper(layout: str, doc: str):
    def wrapper(binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w=16, block_h=16, cap=256):
        if not xys.is_cuda:
            return rasterize_forward_torch(
                binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w, block_h, cap, layout,
            )
        out = _launch_forward(binned, xys, conics, colors, opacity, img_height,
                              img_width, tile_bounds, block_w, block_h, cap,
                              layout)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = f"forward_{layout}"
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


forward_image = _forward_wrapper("image", "K4: the sum render as [H, W, 3].")
forward_chw = _forward_wrapper("chw", "K5: the sum render as planar [3, H, W].")
forward_rows = _forward_wrapper(
    "rows", "K4, rows store: the sum render as `image_to_rows` blocks.")
FORWARD = {"image": forward_image, "chw": forward_chw, "rows": forward_rows}


def check_inputs(what, binned, xys, conics, colors, opacity, tile_bounds,
                 block_w, block_h, cap):
    """Raise ValueError unless the splats are float32 [N, .] and the binning
    int32 on one device, on `tile_bounds`' grid, and one tile's lanes fit a
    CTA; the splats' float32 buffers, contiguous (`what` names the caller)."""
    dev = xys.device
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    f32 = {"xys": (xys, (n, 2)), "conics": (conics, (n, 3)),
           "colors": (colors, (n, 3)), "opacity": (opacity.reshape(-1), (n,))}
    for name, (t, shape) in f32.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in (binned.tile_bin_start, binned.tile_counts, binned.sorted_gauss_ids):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{what}: binning arrays must be int32 on {dev}")
    if binned.tile_counts.shape[0] != tb_x * tb_y:
        raise ValueError(f"{what}: binning tile grid mismatch")
    if block_w * block_h > 1024 or 36 * cap > 48 * 1024:
        raise ValueError(f"{what}: block {block_w}x{block_h} / cap {cap} "
                         "exceeds one CTA")
    return [t.contiguous() for t, _ in f32.values()]


def _launch_forward(binned, xys, conics, colors, opacity, img_height,
                    img_width, tile_bounds, block_w, block_h, cap,
                    layout) -> torch.Tensor:
    dev = xys.device
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    f32 = check_inputs("rasterize_forward", binned, xys, conics, colors,
                       opacity, tile_bounds, block_w, block_h, cap)
    i32 = [t.contiguous() for t in (binned.tile_bin_start, binned.tile_counts,
                                    binned.sorted_gauss_ids)]
    r_out = round8(3 * tb_x)
    if layout == "rows":
        # the kernel writes every pixel of every tile; only the padding rows
        # past 3*tb_x (none when 3*tb_x is a multiple of 8) need the fill
        shape = (tb_y * r_out, block_h * block_w)
        alloc = torch.empty if r_out == 3 * tb_x else torch.zeros
        out = alloc(shape, dtype=torch.float32, device=dev)
    else:
        shape = (3, img_height, img_width) if layout == "chw" else (
            img_height, img_width, 3)
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _fwd_lib()
    with torch.cuda.device(dev):
        rc = lib.rasterize_forward(
            *(_build.ptr(t) for t in i32 + f32), xys.shape[0], img_height,
            img_width, tb_x, tb_y, block_w, block_h, cap, _LAYOUT_ID[layout],
            r_out, _build.ptr(out), _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "rasterize_forward")
    return out


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("rasterize_fwd")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rasterize_forward.restype = i32
        lib.rasterize_forward.argtypes = [vp] * 7 + [i32] * 10 + [vp, vp]
        lib._gsvc_bound = True
    return lib


# -- backward ---------------------------------------------------------------


def lane_slots(binned: BinnedSplats, ids: torch.Tensor, tiles: torch.Tensor,
               tb_x: int, n: int) -> torch.Tensor:
    """Expansion slot of each (tile, lane) whose gaussian id is < n; the
    others map to slot S, one past the buffer (dropped)."""
    s = binned.sorted_gauss_ids.shape[0]
    real = ids < n
    g = torch.where(real, ids, 0)
    pack = binned.bbox_pack.to(torch.int64)[g]
    bw, ty0, tx0 = pack >> 16, (pack >> 8) & 0xFF, pack & 0xFF
    ty, tx = (tiles // tb_x)[:, None], (tiles % tb_x)[:, None]
    slot = binned.gauss_slot_start.to(torch.int64)[g] + (ty - ty0) * bw + (tx - tx0)
    return torch.where(real, slot, s)


def grad_tiles(v_out: torch.Tensor, layout: str, img_height: int,
               img_width: int, tb_x: int, tb_y: int, block_w: int,
               block_h: int) -> torch.Tensor:
    """The image gradient in any layout -> [T, pix, 3] per tile, zero past
    the image edge (the forward writes constants there)."""
    if layout == "rows":
        v_out = rows_to_image(v_out, tb_x, tb_y, img_height, img_width,
                              block_w, block_h)
    elif layout == "chw":
        v_out = v_out.permute(1, 2, 0)
    g = torch.nn.functional.pad(
        v_out, (0, 0, 0, tb_x * block_w - img_width, 0, tb_y * block_h - img_height))
    g = g.reshape(tb_y, block_h, tb_x, block_w, 3).permute(0, 2, 1, 3, 4)
    return g.reshape(tb_x * tb_y, block_h * block_w, 3)


def rasterize_backward_torch(
    binned: BinnedSplats, xys, conics, colors, opacity, v_out,
    img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
    block_w: int = 16, block_h: int = 16, cap: int = 256,
    layout: str = "image",
) -> torch.Tensor:
    """Plain version of K6: per-slot gradients [9, S] (rows x y c1 c2 c3
    opac r g b, columns the expansion slots; zero where no lane wrote), in
    chunks of TILE_CHUNK tiles of dense [tiles, cap, pixels] math."""
    dev, dtype = xys.device, torch.float32
    n = xys.shape[0]
    s = binned.sorted_gauss_ids.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    num_tiles = tb_x * tb_y
    vt = grad_tiles(v_out.to(dtype), layout, img_height, img_width, tb_x,
                    tb_y, block_w, block_h)

    ids = tile_lane_ids(binned, cap, n)  # [T, cap]
    splats = padded_splats(xys, conics, colors, opacity)
    out = torch.zeros((GRAD_FIELDS, s + 1), dtype=dtype, device=dev)
    for t0 in range(0, num_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, num_tiles)
        tids = torch.arange(t0, t1, device=dev)
        g = ids[t0:t1]  # [tc, cap]
        grads = lane_grads(g, tids, vt[t0:t1], splats, tb_x, block_w, block_h)
        slots = lane_slots(binned, g, tids, tb_x, n)
        out[:, slots.reshape(-1)] = grads.reshape(GRAD_FIELDS, -1)
    return out[:, :s]


def padded_splats(xys, conics, colors, opacity):
    """(xys, conics, colors, opacity [N]) in float32, each with a zero row
    appended at index N (the id of lanes that hold no splat)."""
    f32 = torch.float32
    return (zrow(xys.to(f32)), zrow(conics.to(f32)), zrow(colors.to(f32)),
            zrow(opacity.reshape(-1).to(f32)))


def lane_grads(g, tids, v, splats, tb_x: int, block_w: int = 16,
               block_h: int = 16) -> torch.Tensor:
    """[9, tc, k] gradients (x y c1 c2 c3 opac r g b) of the lanes with
    splat ids g [tc, k] (into `padded_splats`) in tiles tids [tc], each
    summed over its tile's pixels against the tile's image gradient
    v [tc, pix, 3]: K6's per-pair math as dense [tc, k, pix] tensors."""
    xys_p, conics_p, colors_p, opac_p = splats
    dtype, dev = xys_p.dtype, xys_p.device
    local_y = torch.arange(block_h, dtype=dtype, device=dev).repeat_interleave(block_w)
    local_x = torch.arange(block_w, dtype=dtype, device=dev).repeat(block_h)
    px = ((tids % tb_x) * block_w).to(dtype)[:, None] + local_x  # [tc, pix]
    py = ((tids // tb_x) * block_h).to(dtype)[:, None] + local_y
    dx = xys_p[g, 0][:, :, None] - px[:, None, :]  # [tc, k, pix]
    dy = xys_p[g, 1][:, :, None] - py[:, None, :]
    c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
    sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
    vis = torch.exp(-sigma)
    alpha_u = opac_p[g][:, :, None] * vis
    alpha = torch.clamp(alpha_u, max=1.0)
    valid = (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
    v_alpha = torch.where(valid, torch.einsum("tkc,tpc->tkp", colors_p[g], v), 0.0)
    v_sigma = -alpha_u * v_alpha  # the min(1, .) is forward-only
    w = torch.where(valid, alpha, 0.0)
    return torch.stack([
        torch.sum((c1 * dx + c2 * dy) * v_sigma, -1),  # x
        torch.sum((c3 * dy + c2 * dx) * v_sigma, -1),  # y
        torch.sum(0.5 * dx * dx * v_sigma, -1),  # c1
        torch.sum(dx * dy * v_sigma, -1),  # c2, unhalved
        torch.sum(0.5 * dy * dy * v_sigma, -1),  # c3
        torch.sum(vis * v_alpha, -1),  # opacity
        *torch.einsum("tkp,tpc->ctk", w, v),  # r g b
    ])


def backward_slots(binned, xys, conics, colors, opacity, v_out, img_height,
                   img_width, tile_bounds, block_w=16, block_h=16, cap=256,
                   layout="image"):
    """K6: the image gradient `v_out` (in `layout`) -> per-slot gradients
    [9, S], zero in every slot no lane below the cap owns."""
    if not xys.is_cuda:
        return rasterize_backward_torch(
            binned, xys, conics, colors, opacity, v_out, img_height,
            img_width, tile_bounds, block_w, block_h, cap, layout,
        )
    dev = xys.device
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    f32 = check_inputs("rasterize_backward", binned, xys, conics, colors,
                       opacity, tile_bounds, block_w, block_h, cap)
    r_out = round8(3 * tb_x)
    want = {"image": (img_height, img_width, 3), "chw": (3, img_height, img_width),
            "rows": (tb_y * r_out, block_h * block_w)}[layout]
    if v_out.dtype != torch.float32 or tuple(v_out.shape) != want or v_out.device != dev:
        raise ValueError(f"rasterize_backward: v_out must be float32 {want} on "
                         f"{dev}, got {v_out.dtype} {tuple(v_out.shape)}")
    i32 = [t.contiguous() for t in (
        binned.tile_bin_start, binned.tile_counts, binned.sorted_gauss_ids,
        binned.gauss_slot_start, binned.bbox_pack)]
    if any(t.dtype != torch.int32 or t.device != dev for t in i32):
        raise ValueError(f"rasterize_backward: binning arrays must be int32 on {dev}")
    s = binned.sorted_gauss_ids.shape[0]
    out = torch.zeros((GRAD_FIELDS, s), dtype=torch.float32, device=dev)
    v = v_out.contiguous()
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.rasterize_backward(
            *(_build.ptr(t) for t in i32 + f32), _build.ptr(v), xys.shape[0],
            img_height, img_width, tb_x, tb_y, block_w, block_h, cap,
            _LAYOUT_ID[layout], r_out, s, _build.ptr(out), _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "rasterize_backward")
    backward_slots.launches += 1
    return out


backward_slots.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rasterize_bwd")
    if not getattr(lib, "_gsvc_bound", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rasterize_backward.restype = i32
        lib.rasterize_backward.argtypes = [vp] * 10 + [i32] * 10 + [i64, vp, vp]
        lib._gsvc_bound = True
    return lib


def segment_flags(gauss_slot_start: torch.Tensor, s: int) -> torch.Tensor:
    """[S] int32, 1 at the first slot of every splat's span (an empty
    span's start is its successor's)."""
    flags = torch.zeros((s + 1,), dtype=torch.int32, device=gauss_slot_start.device)
    flags.index_fill_(0, gauss_slot_start[:-1].to(torch.int64), 1)
    return flags[:s]


def reduce_slot_grads(vslots: torch.Tensor, gauss_slot_start: torch.Tensor):
    """Per-slot [9, S] grads -> per-splat (v_xys [N,2], v_conics [N,3],
    v_colors [N,3], v_opacity [N,1]) via K3: a segmented cumsum over the
    gaussian-major slots, each splat's total read at its span's last slot
    (rasterize_pallas.py:1195-1213)."""
    dev = vslots.device
    s = vslots.shape[1]
    gss = gauss_slot_start.to(torch.int64)
    n = gss.shape[0] - 1
    if s == 0:
        z = torch.zeros((n, GRAD_FIELDS), dtype=vslots.dtype, device=dev)
        return z[:, 0:2], z[:, 2:5], z[:, 6:9], z[:, 5:6]
    seg = fill_cuda.segmented_cumsum(vslots, segment_flags(gauss_slot_start, s))
    ends = torch.clamp(gss[1:] - 1, min=0)
    width = (gss[1:] - gss[:-1]) > 0
    tot = torch.where(width[None, :], seg[:, ends], 0.0).T  # [N, 9]
    return tot[:, 0:2], tot[:, 2:5], tot[:, 6:9], tot[:, 5:6]


class RasterizeSum(torch.autograd.Function):
    """The sum render through the kernels, differentiable w.r.t. xys,
    conics, colors and opacity (gsvc_tpu's `_rasterize_pallas_vjp`).

    Forward: K4 / K5 / K4-rows by layout. Backward: K6 into the slots,
    then the K3 reduction. Saves the inputs and the binning; the forward's
    per-lane data is not kept (K6 gathers it again)."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, binned, geom, layout):
        out = FORWARD[layout](binned, xys, conics, colors, opacity, *geom)
        ctx.save_for_backward(xys, conics, colors, opacity, *binned)
        ctx.geom, ctx.layout = geom, layout
        return out

    @staticmethod
    def backward(ctx, v_out):
        xys, conics, colors, opacity, *b = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        if not any(need):
            return (None,) * 7
        binned = BinnedSplats(*b)
        vslots = backward_slots(binned, xys, conics, colors, opacity,
                                v_out.contiguous(), *ctx.geom, ctx.layout)
        grads = reduce_slot_grads(vslots, binned.gauss_slot_start)
        grads = [g.reshape(t.shape).to(t.dtype) if nd else None
                 for g, t, nd in zip(grads, (xys, conics, colors, opacity), need)]
        return (*grads, None, None, None)


def rasterize_sum(binned: BinnedSplats, xys, conics, colors, opacity,
                  img_height: int, img_width: int,
                  tile_bounds: Tuple[int, int, int], block_w: int = 16,
                  block_h: int = 16, cap: int = 256, layout: str = "image"):
    """Differentiable sum render through the kernel wrappers."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    geom = (img_height, img_width, tuple(tile_bounds), block_w, block_h, cap)
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (xys, conics, colors, opacity))):
        # an eval render: no autograd node, no saved tensors
        return FORWARD[layout](binned, xys, conics, colors, opacity, *geom)
    return RasterizeSum.apply(xys, conics, colors, opacity, binned, geom, layout)

"""The sum rasterizer's kernels and their autograd: forward K4/K5 with the
`rows` store (csrc/rasterize_fwd.cu), backward K6 (csrc/rasterize_bwd.cu),
and the lane->splat gradient reduction on K3 (ops/fill_cuda.py), each
beside its plain PyTorch version. The kernels take 16x16 tiles.

Forward. Replaces `_forward_kernel` (layouts "image" and "rows", K4) and
`_forward_kernel_chw` (layout "chw", K5) of gsvc_tpu/ops/rasterize_pallas.py,
launched from `_forward_impl`. The TPU streams each tile row's lanes through
VMEM and evaluates sigma and the colour sum as MXU matmuls over a whole row
of tiles. On the card each pixel sums rgb * alpha over its tile's first
min(count, cap) splats in lane order, in f32 registers: deterministic, no
atomics; one template writes [H, W, 3], [3, H, W] or the tile-row blocks of
`image_to_rows`, masking pixels past the image edge (1080 is 67.5 tile
rows). What bounds it on the H100: issuing the ~17 FP32 operations and
one expf of each (pixel, lane) pair, ~2e7 pairs at 1080p/10k; a first
design with a thread per pixel issued 39 instructions a pair, 9 of them
scalar shared-memory loads, on too few warps. So
(csrc/rasterize_fwd.cuh): a lane is staged as three 16-byte
words and read with vector loads, a thread computes four pixels of a
column so each lane load serves four pairs, and each CTA of a grid of
FWD_CTAS_PER_SM CTAs of 64 threads an SM (`forward_grid`: tiles in a
static stride) gathers the next 32 lanes, of its tile or of its next
tile, with cp.async into a second 3 KiB shared buffer while the current
ones compute. `expf`, not `__expf`, but in the fast-colour mode (below).

Backward. Replaces `_backward_kernel` (K6) and the permutation-inverting
`_reduce_lane_grads` of rasterize_pallas.py. Each lane's 9 gradients
[x, y, c1, c2, c3, opac, r, g, b] are sums over its tile's 256 pixels (the
reference's backward.cu:790-840 math, with the min(1, .) forward-only and
the conic's off-diagonal gradient unhalved, so autograd through
conic = inv(cov) gives the reference's end-to-end gradient). What bounds
it: a thread per lane (the first design) left ~10 of a CTA's 256 threads
busy on a serial, latency-bound loop; a thread per pixel pays a 9 x 5
shuffle tree on every lane. K6 (csrc/rasterize_bwd.cuh) sits between: a
warp per lane, each thread owning 8 fixed pixels of the tile whose image
gradient it holds in registers (read once, straight from the layout the
forward wrote: no untile transpose), summing them in a fixed order before
one shuffle tree (`backward_smem_bytes`: the gradient and the staged
lanes). Each lane writes its gradients to its own expansion slot,
gauss_slot_start[g] + its tile's row-major rank in g's bbox, so slots are
gaussian-major and the TPU path's two-sort permutation inversion is not
needed. The slot buffer is zero-filled, so lanes past the per-tile cap keep
exact zeros in their real slots. K3 then takes a segmented cumsum over the
slots, and each splat's total is read at the last slot of its span.
Deterministic: fixed order everywhere, no atomics.

The fast-colour mode (`fast_color=True`; gsvc_tpu's COLOR_BF16,
rasterize_pallas.py:279-287) trades the same sum render, to a stated
tolerance, for speed. On the TPU it runs the colour and gradient matmuls
as single bf16 MXU passes and relays the CHW store out in bf16 (max
~6.5e-3 absolute, its stated bound). The card has no such matmul to
cheapen: its lever of that class, the reference's --use_fast_math, is the
exponential. So the mode's kernels are K4, K5 and K6 with `__expf(-sigma)`
(one FMUL by log2(e) and MUFU.EX2) in place of `expf` (forward_kernel<.,
kFastExp>, backward_kernel<., ., true>), forward and backward on the same
alpha; their plain versions take `splat_vis(sigma, True)`. Off by default;
each fast kernel counts its launches apart (`launches.<wrapper>_fast`).

The eval render's epilogue (`forward_image_clipped`, `forward_chw_clipped`):
exact K4 / K5 whose store writes the final image, the blend on the default
background (ones) and the clamp to [0, 1] of `ops.rasterize`'s chain
(`blend_background`, then `torch.clamp`), bitwise, in the one launch. As
PyTorch ops the chain is three image-sized passes over what the kernel has
just written (~3x K5's time at 1080p: two of them stride-0 broadcasts) and
~6 scalar launches; in the store it is two instructions a value. The
kernel reads the kept total from device memory, so a launch stays
capturable. Their plain version, `forward_clipped_torch`, is that chain.

Every forward and K6 takes a tile-row span, `tile_rows=(row0, num_rows)`
(gsvc_tpu's `row0_ref` scalar prefetch, for the tile-sharded trainer):
only the span's tiles render or write their slots, in the grid's
coordinates; a span's rows past the grid are empty. None is the whole
grid, bitwise as before.

Each kernel wrapper counts its launches as the recorder's
`launches.<wrapper>` (`_build.launch`). On a CPU tensor a wrapper runs its
plain version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from gsvc_tpu_torch import _build
from gsvc_tpu_torch._build import I32, I64, VP
from gsvc_tpu_torch.ops import fill_cuda
from gsvc_tpu_torch.ops.binning import BinnedSplats
from gsvc_tpu_torch.ops.rasterize_binned import (
    TILE_CHUNK,
    rasterize_binned,
    span_height,
    span_lane_ids,
    splat_vis,
    tile_span,
    zrow,
)
from gsvc_tpu_torch.ops.rasterize_dense import ALPHA_CUTOFF

LAYOUTS = ("image", "chw", "rows")
_LAYOUT_ID = {name: i for i, name in enumerate(LAYOUTS)}
GRAD_FIELDS = 9  # x y c1 c2 c3 opac r g b
TILE = 16  # the kernels' tile side
LANE_BYTES = 48  # a lane staged in K6's shared memory, with its slot
# The forward's CTAs (64 threads, 48 registers a thread) an SM: more than
# the 21 that stay resident, so the block scheduler balances the tiles'
# uneven work (rasterize_fwd.cuh); each takes two tiles at 1080p.
FWD_CTAS_PER_SM = 32
SMEM_LIMIT = 48 * 1024  # a CTA's shared bytes without the opt-in attribute


def backward_smem_bytes(cap: int) -> int:
    """Dynamic shared bytes of K6: the tile's 3 x 256 image gradient and
    its `cap` staged lanes (48 bytes with the lane's expansion slot)."""
    return 4 * 3 * TILE * TILE + LANE_BYTES * cap


def forward_grid(num_tiles: int, sm_count: int) -> int:
    """CTAs of the forward's grid: FWD_CTAS_PER_SM an SM, never more than
    there are tiles (CTA b takes tiles b, b + grid, ...)."""
    return min(num_tiles, FWD_CTAS_PER_SM * sm_count)


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
    layout: str = "image", tile_rows=None, fast_color: bool = False,
) -> torch.Tensor:
    """Plain version of K4/K5: the binned renderer in the chosen layout, over
    the grid or the tile-row span `tile_rows` (`span_height` pixel rows in
    "image" / "chw", num_rows blocks of rows in "rows"); `fast_color`: of
    their fast-colour variants."""
    img = rasterize_binned(
        binned, xys, conics, colors, opacity, img_height, img_width,
        tile_bounds, block_w, block_h, cap, tile_rows, fast_color,
    )
    if layout == "chw":
        return img.permute(2, 0, 1).contiguous()
    if layout == "rows":
        num_rows = tile_span(tile_rows, int(tile_bounds[1]))[1]
        return image_to_rows(img, int(tile_bounds[0]), num_rows, block_w, block_h)
    return img


def blend_background(img: torch.Tensor, total: torch.Tensor, background: torch.Tensor,
                     layout: str) -> torch.Tensor:
    """`img` where the frame kept an intersection (`total` >= 1), else
    `background` everywhere: gsplat's zero-intersect fast path as an
    arithmetic select (no host sync)."""
    live = (total >= 1).to(img.dtype)
    bg = background.to(img.dtype)
    if layout == "rows":
        # background per block row (t, c) is background[row % 3], as in
        # gsvc_tpu (the padding rows past 3*tb_x shift that phase)
        bg = bg[torch.arange(img.shape[0], device=img.device) % 3][:, None]
    elif layout == "chw":
        bg = bg[:, None, None]
    else:
        bg = bg[None, None, :]
    return img * live + bg * (1.0 - live)


def forward_clipped_torch(
    binned: BinnedSplats, xys, conics, colors, opacity,
    img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
    block_w: int = 16, block_h: int = 16, cap: int = 256,
    layout: str = "image", tile_rows=None,
) -> torch.Tensor:
    """Plain version of K4 / K5 with the eval render's epilogue: the chain
    it folds, `torch.clamp(blend_background(raw), 0, 1)` on the kept total
    `binned.num_intersects` and a background of ones."""
    raw = rasterize_forward_torch(binned, xys, conics, colors, opacity, img_height,
                                  img_width, tile_bounds, block_w, block_h, cap, layout,
                                  tile_rows)
    return torch.clamp(blend_background(raw, binned.num_intersects, raw.new_ones((3,)),
                                        layout), 0.0, 1.0)


def _forward_wrapper(layout: str, doc: str):
    def wrapper(binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w=16, block_h=16, cap=256, tile_rows=None,
                fast_color=False):
        if not xys.is_cuda:
            return rasterize_forward_torch(
                binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w, block_h, cap, layout, tile_rows, fast_color,
            )
        return _launch_forward(binned, xys, conics, colors, opacity, img_height,
                               img_width, tile_bounds, block_w, block_h, cap,
                               layout, tile_rows, fast_color)

    wrapper.__name__ = wrapper.__qualname__ = f"forward_{layout}"
    wrapper.__doc__ = doc
    return wrapper


_FAST_DOC = " fast_color=True launches the fast-colour variant."
forward_image = _forward_wrapper(
    "image", "K4: the sum render as [H, W, 3] (a tile-row span: [span_height, W, 3])."
    + _FAST_DOC)
forward_chw = _forward_wrapper(
    "chw", "K5: the sum render as planar [3, H, W] (a span: [3, span_height, W])."
    + _FAST_DOC)
forward_rows = _forward_wrapper(
    "rows", "K4, rows store: the sum render as `image_to_rows` blocks (a span's "
    "num_rows blocks)." + _FAST_DOC)
FORWARD = {"image": forward_image, "chw": forward_chw, "rows": forward_rows}


def _clipped_wrapper(layout: str, doc: str):
    def wrapper(binned, xys, conics, colors, opacity, img_height, img_width,
                tile_bounds, block_w=16, block_h=16, cap=256, tile_rows=None):
        args = (binned, xys, conics, colors, opacity, img_height, img_width, tile_bounds,
                block_w, block_h, cap, layout, tile_rows)
        if not xys.is_cuda:
            return forward_clipped_torch(*args)
        return _launch_forward(*args, False, clip=True)

    wrapper.__name__ = wrapper.__qualname__ = f"forward_{layout}_clipped"
    wrapper.__doc__ = doc
    return wrapper


_CLIP_DOC = (", ones where the binning kept no intersection, clamped to [0, 1]: "
             "`forward_clipped_torch`'s values, bitwise.")
forward_image_clipped = _clipped_wrapper(
    "image", "K4 with the eval render's epilogue: the final [H, W, 3] image" + _CLIP_DOC)
forward_chw_clipped = _clipped_wrapper(
    "chw", "K5 with the eval render's epilogue: the final [3, H, W] image" + _CLIP_DOC)
CLIPPED = {"image": forward_image_clipped, "chw": forward_chw_clipped}


def check_inputs(what, binned, xys, conics, colors, opacity, tile_bounds,
                 block_w, block_h, cap):
    """Raise ValueError unless the splats are float32 [N, .] and the binning
    int32 on one device, on `tile_bounds`' grid of 16x16 tiles, and a
    tile's staged lanes fit K6's shared memory (`backward_smem_bytes`);
    the splats' float32 buffers, contiguous (`what` names the caller)."""
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
    if (block_w, block_h) != (TILE, TILE):
        raise ValueError(f"{what}: the kernels take {TILE}x{TILE} tiles, got "
                         f"{block_w}x{block_h}")
    smem = backward_smem_bytes(cap)
    if cap < 1 or smem > SMEM_LIMIT:
        raise ValueError(f"{what}: cap {cap} needs {smem} shared bytes a CTA; "
                         f"the kernels take at most {SMEM_LIMIT}")
    return [t.contiguous() for t, _ in f32.values()]


def _launch_forward(binned, xys, conics, colors, opacity, img_height,
                    img_width, tile_bounds, block_w, block_h, cap,
                    layout, tile_rows, fast_color, clip=False) -> torch.Tensor:
    dev = xys.device
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    row0, num_rows = tile_span(tile_rows, tb_y)
    out_h = span_height(tile_rows, tb_y, img_height, block_h)
    f32 = check_inputs("rasterize_forward", binned, xys, conics, colors,
                       opacity, tile_bounds, block_w, block_h, cap)
    i32 = [t.contiguous() for t in (binned.tile_bin_start, binned.tile_counts,
                                    binned.sorted_gauss_ids)]
    r_out = round8(3 * tb_x)
    if layout == "rows":
        # the kernel writes every pixel of every tile; only the padding rows
        # past 3*tb_x (none when 3*tb_x is a multiple of 8) need the fill
        shape = (num_rows * r_out, block_h * block_w)
        alloc = torch.empty if r_out == 3 * tb_x else torch.zeros
        out = alloc(shape, dtype=torch.float32, device=dev)
    else:
        shape = (3, out_h, img_width) if layout == "chw" else (out_h, img_width, 3)
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    total = binned.num_intersects if clip else None
    if clip and (total.dtype != torch.int32 or total.numel() != 1 or total.device != dev):
        raise ValueError(f"rasterize_forward: num_intersects must be one int32 on {dev}, "
                         f"got {total.dtype} {tuple(total.shape)} on {total.device}")
    grid = forward_grid(tb_x * num_rows, sm_count(dev))
    _build.launch(
        _fwd_lib(), "rasterize_forward", dev, *(_build.ptr(t) for t in i32 + f32),
        xys.shape[0], img_height, img_width, tb_x, tb_y, row0, num_rows, out_h, cap,
        _LAYOUT_ID[layout], int(fast_color), r_out, grid,
        None if total is None else _build.ptr(total), _build.ptr(out),
        counter=f"forward_{layout}" + ("_clipped" if clip else "_fast" if fast_color else ""),
    )
    return out


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _fwd_lib() -> ctypes.CDLL:
    return _build.bind("rasterize_fwd", {
        "rasterize_forward": (I32, [VP] * 7 + [I32] * 13 + [VP] * 3)})


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
               block_h: int, tile_rows=None) -> torch.Tensor:
    """The image gradient in any layout, over the grid or the tile-row span
    `tile_rows` (the forward's shapes) -> [span tiles, pix, 3] per tile, zero
    past the image edge (the forward writes constants there)."""
    row0, num_rows = tile_span(tile_rows, tb_y)
    out_h = span_height(tile_rows, tb_y, img_height, block_h)
    if layout == "rows":
        v_out = rows_to_image(v_out, tb_x, num_rows, out_h, img_width, block_w, block_h)
    elif layout == "chw":
        v_out = v_out.permute(1, 2, 0)
    valid = min(out_h, max(img_height - row0 * block_h, 0))  # rows inside the image
    g = torch.nn.functional.pad(
        v_out[:valid], (0, 0, 0, tb_x * block_w - img_width, 0, num_rows * block_h - valid))
    g = g.reshape(num_rows, block_h, tb_x, block_w, 3).permute(0, 2, 1, 3, 4)
    return g.reshape(tb_x * num_rows, block_h * block_w, 3)


def rasterize_backward_torch(
    binned: BinnedSplats, xys, conics, colors, opacity, v_out,
    img_height: int, img_width: int, tile_bounds: Tuple[int, int, int],
    block_w: int = 16, block_h: int = 16, cap: int = 256,
    layout: str = "image", tile_rows=None, fast_color: bool = False,
) -> torch.Tensor:
    """Plain version of K6: per-slot gradients [9, S] (rows x y c1 c2 c3
    opac r g b, columns the expansion slots; zero where no lane wrote), in
    chunks of TILE_CHUNK tiles of dense [tiles, cap, pixels] math. With
    `tile_rows`, v_out covers that span (the forward's shapes) and only its
    tiles' lanes write; `fast_color`: of K6's fast-colour variant."""
    dev, dtype = xys.device, torch.float32
    n = xys.shape[0]
    s = binned.sorted_gauss_ids.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    row0, num_rows = tile_span(tile_rows, tb_y)
    num_tiles = tb_x * num_rows
    vt = grad_tiles(v_out.to(dtype), layout, img_height, img_width, tb_x,
                    tb_y, block_w, block_h, tile_rows)

    out = torch.zeros((GRAD_FIELDS, s + 1), dtype=dtype, device=dev)
    if n == 0:  # no splat, no lane writes
        return out[:, :s]
    ids = span_lane_ids(binned, cap, n, tb_x, tb_y, tile_rows)  # [span tiles, cap]
    splats = padded_splats(xys, conics, colors, opacity)
    for t0 in range(0, num_tiles, TILE_CHUNK):
        t1 = min(t0 + TILE_CHUNK, num_tiles)
        tids = torch.arange(row0 * tb_x + t0, row0 * tb_x + t1, device=dev)  # grid tiles
        g = ids[t0:t1]  # [tc, cap]
        grads = lane_grads(g, tids, vt[t0:t1], splats, tb_x, block_w, block_h,
                           fast_color)
        slots = lane_slots(binned, g, tids, tb_x, n)
        out[:, slots.reshape(-1)] = grads.reshape(GRAD_FIELDS, -1)
    return out[:, :s]


def near_gate(binned: BinnedSplats, xys, conics, opacity, img_height: int,
              img_width: int, tile_bounds: Tuple[int, int, int], cap: int = 256,
              fast_color: bool = False, rel: float = 1e-4) -> torch.Tensor:
    """[H, W] bool: the pixels one of whose pairs (a lane of the tile's
    first `cap`, sigma >= 0) has an alpha within `rel` (relative) of the
    cutoff 1/255. There a kernel and its plain version, whose sigma and
    exponential differ by a few ulp, may gate the pair differently: a flip
    moves the pixel by the pair's rgb * alpha, up to ~3.9e-3."""
    n = xys.shape[0]
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    ids = span_lane_ids(binned, cap, n, tb_x, tb_y)
    xys_p, conics_p, _c, opac_p = padded_splats(xys, conics, xys.new_zeros((n, 3)), opacity)
    dev, dtype = xys_p.device, xys_p.dtype
    local_y = torch.arange(TILE, dtype=dtype, device=dev).repeat_interleave(TILE)
    local_x = torch.arange(TILE, dtype=dtype, device=dev).repeat(TILE)
    near = torch.zeros((tb_x * tb_y, TILE * TILE), dtype=torch.bool, device=dev)
    for t0 in range(0, tb_x * tb_y, TILE_CHUNK):
        tids = torch.arange(t0, min(t0 + TILE_CHUNK, tb_x * tb_y), device=dev)
        g = ids[tids]
        px = ((tids % tb_x) * TILE).to(dtype)[:, None] + local_x  # [tc, pix]
        py = ((tids // tb_x) * TILE).to(dtype)[:, None] + local_y
        dx = xys_p[g, 0][:, :, None] - px[:, None, :]  # [tc, cap, pix]
        dy = xys_p[g, 1][:, :, None] - py[:, None, :]
        c1, c2, c3 = (conics_p[g, i][:, :, None] for i in range(3))
        sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
        alpha = torch.clamp(opac_p[g][:, :, None] * splat_vis(sigma, fast_color), max=1.0)
        close = (alpha - ALPHA_CUTOFF).abs() <= rel * ALPHA_CUTOFF
        near[tids] = ((sigma >= 0.0) & close & (g < n)[:, :, None]).any(1)
    img = near.reshape(tb_y, tb_x, TILE, TILE).permute(0, 2, 1, 3)
    return img.reshape(tb_y * TILE, tb_x * TILE)[:img_height, :img_width]


def padded_splats(xys, conics, colors, opacity):
    """(xys, conics, colors, opacity [N]) in float32, each with a zero row
    appended at index N (the id of lanes that hold no splat)."""
    f32 = torch.float32
    return (zrow(xys.to(f32)), zrow(conics.to(f32)), zrow(colors.to(f32)),
            zrow(opacity.reshape(-1).to(f32)))


def lane_grads(g, tids, v, splats, tb_x: int, block_w: int = 16,
               block_h: int = 16, fast_color: bool = False) -> torch.Tensor:
    """[9, tc, k] gradients (x y c1 c2 c3 opac r g b) of the lanes with
    splat ids g [tc, k] (into `padded_splats`) in tiles tids [tc], each
    summed over its tile's pixels against the tile's image gradient
    v [tc, pix, 3]: K6's per-pair math as dense [tc, k, pix] tensors
    (`fast_color`: its fast-colour variant's exponential)."""
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
    vis = splat_vis(sigma, fast_color)
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
                   layout="image", tile_rows=None, fast_color=False):
    """K6: the image gradient `v_out` (in `layout`; over the tile-row span
    `tile_rows`, in the forward's span shapes) -> per-slot gradients [9, S],
    zero in every slot no lane below the cap of the span's tiles owns.
    fast_color=True launches the fast-colour variant (the gradient of the
    fast-colour forward)."""
    if not xys.is_cuda:
        return rasterize_backward_torch(
            binned, xys, conics, colors, opacity, v_out, img_height,
            img_width, tile_bounds, block_w, block_h, cap, layout, tile_rows,
            fast_color,
        )
    dev = xys.device
    tb_x, tb_y = int(tile_bounds[0]), int(tile_bounds[1])
    row0, num_rows = tile_span(tile_rows, tb_y)
    out_h = span_height(tile_rows, tb_y, img_height, block_h)
    f32 = check_inputs("rasterize_backward", binned, xys, conics, colors,
                       opacity, tile_bounds, block_w, block_h, cap)
    r_out = round8(3 * tb_x)
    want = {"image": (out_h, img_width, 3), "chw": (3, out_h, img_width),
            "rows": (num_rows * r_out, block_h * block_w)}[layout]
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
    _build.launch(
        _bwd_lib(), "rasterize_backward", dev, *(_build.ptr(t) for t in i32 + f32),
        _build.ptr(v), xys.shape[0], img_height, img_width, tb_x, tb_y,
        row0, num_rows, out_h, cap, _LAYOUT_ID[layout], int(fast_color), r_out, s,
        _build.ptr(out), counter="backward_slots_fast" if fast_color else "backward_slots",
    )
    return out


def _bwd_lib() -> ctypes.CDLL:
    return _build.bind("rasterize_bwd", {
        "rasterize_backward": (I32, [VP] * 10 + [I32] * 12 + [I64, VP, VP])})


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
    per-lane data is not kept (K6 gathers it again). `tile_rows` renders
    a tile-row span, whose gradient reaches only the span's lanes;
    `fast_color` runs the fast-colour variants both ways."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, binned, geom, layout, tile_rows,
                fast_color):
        out = FORWARD[layout](binned, xys, conics, colors, opacity, *geom, tile_rows,
                              fast_color)
        ctx.save_for_backward(xys, conics, colors, opacity, *binned)
        ctx.geom, ctx.layout, ctx.tile_rows = geom, layout, tile_rows
        ctx.fast_color = fast_color
        return out

    @staticmethod
    def backward(ctx, v_out):
        xys, conics, colors, opacity, *b = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        if not any(need):
            return (None,) * 9
        binned = BinnedSplats(*b)
        vslots = backward_slots(binned, xys, conics, colors, opacity,
                                v_out.contiguous(), *ctx.geom, ctx.layout, ctx.tile_rows,
                                ctx.fast_color)
        grads = reduce_slot_grads(vslots, binned.gauss_slot_start)
        grads = [g.reshape(t.shape).to(t.dtype) if nd else None
                 for g, t, nd in zip(grads, (xys, conics, colors, opacity), need)]
        return (*grads, None, None, None, None, None)


def rasterize_sum(binned: BinnedSplats, xys, conics, colors, opacity,
                  img_height: int, img_width: int,
                  tile_bounds: Tuple[int, int, int], block_w: int = 16,
                  block_h: int = 16, cap: int = 256, layout: str = "image",
                  tile_rows=None, fast_color: bool = False):
    """Differentiable sum render through the kernel wrappers, over the grid
    or the tile-row span `tile_rows` (`span_height`); `fast_color` takes
    the fast-colour variants."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    geom = (img_height, img_width, tuple(tile_bounds), block_w, block_h, cap)
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (xys, conics, colors, opacity))):
        # an eval render: no autograd node, no saved tensors
        return FORWARD[layout](binned, xys, conics, colors, opacity, *geom, tile_rows,
                               fast_color)
    return RasterizeSum.apply(xys, conics, colors, opacity, binned, geom, layout,
                              tile_rows, fast_color)

// Backward sum-rasterizer K6: the image gradient, read in the layout the
// forward wrote ("image" [H, W, 3], "chw" [3, H, W] or "rows" tile-row
// blocks), -> each lane's 9 gradients [x, y, c1, c2, c3, opac, r, g, b],
// written to the lane's expansion slot, over the whole tile grid or a span
// of its tile rows [row0, row0 + num_rows) (the tile-sharded trainer's; the
// gradient then covers the span alone, in the forward's span shapes).
// Replaces `_backward_kernel` of gsvc_tpu/ops/rasterize_pallas.py. The kernel is rasterize_bwd.cuh's
// backward_kernel<layout, kSplit, fast> (`fast`: the fast-colour mode's
// __expf, the alpha its forward, forward_kernel<layout, kFastExp>, took): a warp per lane with the tile's gradient
// in registers; its design is at the head of that header. What bounds it
// on the H100: issuing ~62 instructions a (pixel, lane) pair, the gated
// part predicated for every pair and a 45-shuffle tree a lane among them,
// on 8 CTAs of 4 warps an SM (its bound by bytes is a sixth of its time).
// The Python side, with the plain PyTorch version, is
// gsvc_tpu_torch/ops/rasterize_cuda.py.
#include "rasterize_bwd.cuh"

namespace {

// Threads a lane: 32 (a warp, 8 pixels a thread) measured faster than 16
// (two lanes a warp, 16 pixels a thread) on the bench scene (P5's F and G).
constexpr int kSplit = 32;

}  // namespace

GSVC_EXPORT int rasterize_backward(
    const void* tile_bin_start, const void* tile_counts, const void* gauss_ids,
    const void* gauss_slot_start, const void* bbox_pack, const void* xys,
    const void* conics, const void* colors, const void* opacity,
    const void* v_out, int n, int img_h, int img_w, int tb_x, int tb_y, int row0,
    int num_rows, int out_h, int cap, int layout, int fast, int r_out,
    long long num_slots, void* out, void* stream) {
  using namespace gsvc_bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(tile_bin_start),
               static_cast<const int*>(tile_counts),
               static_cast<const int*>(gauss_ids),
               static_cast<const int*>(gauss_slot_start),
               static_cast<const int*>(bbox_pack),
               static_cast<const float*>(xys),
               static_cast<const float*>(conics),
               static_cast<const float*>(colors),
               static_cast<const float*>(opacity),
               static_cast<const float*>(v_out),
               n,
               img_h,
               img_w,
               tb_x,
               cap,
               r_out,
               num_slots,
               static_cast<float*>(out),
               row0,
               tb_y,
               out_h};
  if (fast) {
    if (layout == kChw) return launch_backward<kChw, kSplit, true>(a, num_rows, s);
    if (layout == kRows) return launch_backward<kRows, kSplit, true>(a, num_rows, s);
    if (layout == kImage) return launch_backward<kImage, kSplit, true>(a, num_rows, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == kChw) return launch_backward<kChw, kSplit>(a, num_rows, s);
  if (layout == kRows) return launch_backward<kRows, kSplit>(a, num_rows, s);
  if (layout == kImage) return launch_backward<kImage, kSplit>(a, num_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

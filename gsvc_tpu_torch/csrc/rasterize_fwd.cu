// Forward sum-rasterizer, K4 (layout "image", [H, W, 3], and layout "rows",
// the tile-row blocks of image_to_rows) and K5 (layout "chw", [3, H, W]):
// one kernel, rasterize_fwd.cuh's forward_kernel<layout, kFull>, templated
// on the store, over the whole tile grid or a span of its tile rows (the
// tile-sharded trainer's; gsvc_tpu's `row0_ref` scalar prefetch). Replaces
// `_forward_kernel` and `_forward_kernel_chw` of
// gsvc_tpu/ops/rasterize_pallas.py. `fast` selects the fast-colour mode
// (gsvc_tpu's COLOR_BF16): forward_kernel<layout, kFastExp>, whose alpha
// takes __expf (ex2.approx of -sigma * log2(e)) in place of expf. A non-null
// `total` selects the eval render's epilogue in the exact image and chw
// stores (forward_kernel<layout, kFull, true>): the store writes
// clamp(blend_background(raw), 0, 1) on the default background, the three
// image-sized PyTorch passes of ops/rasterize.py's chain folded into this
// launch. What bounds it on the H100: issuing
// the per-pair arithmetic, ~25 instructions a (pixel, lane) pair (its bound
// by bytes is under a third of its time). The design (vector lane loads,
// four pixels a thread, CTAs that prefetch their next chunk of lanes with
// cp.async) is at the head of rasterize_fwd.cuh; the Python side, with the
// plain PyTorch version, is gsvc_tpu_torch/ops/rasterize_cuda.py.
#include "rasterize_fwd.cuh"

// Renders tile rows [row0, row0 + num_rows) of the tb_x x tb_y grid (the
// whole grid: 0, tb_y), out_h pixel rows in the image and chw stores (the
// grid: img_h; a partial span: num_rows * 16, zero past img_h), on a grid
// of `grid` CTAs over the span's num_rows * tb_x tiles. total (one int32)
// non-null: the image or chw store blended on ones and clamped to [0, 1];
// the rows store and the fast-colour mode take none.
GSVC_EXPORT int rasterize_forward(const void* tile_bin_start,
                                  const void* tile_counts,
                                  const void* gauss_ids, const void* xys,
                                  const void* conics, const void* colors,
                                  const void* opacity, int n, int img_h,
                                  int img_w, int tb_x, int tb_y, int row0,
                                  int num_rows, int out_h, int cap, int layout,
                                  int fast, int r_out, int grid, const void* total,
                                  void* out, void* stream) {
  using namespace gsvc_fwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row0 < 0 || num_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(tile_bin_start), static_cast<const int*>(tile_counts),
               static_cast<const int*>(gauss_ids),      static_cast<const float*>(xys),
               static_cast<const float*>(conics),       static_cast<const float*>(colors),
               static_cast<const float*>(opacity),      n,
               img_h,                                   img_w,
               tb_x,                                    tb_x * num_rows,
               cap,                                     r_out,
               static_cast<float*>(out),                row0,
               tb_x * tb_y,                             out_h,
               static_cast<const int*>(total)};
  if (total != nullptr) {
    if (fast) return static_cast<int>(cudaErrorInvalidValue);
    if (layout == kChw) return launch_forward<kChw, kFull, true>(a, grid, s);
    if (layout == kImage) return launch_forward<kImage, kFull, true>(a, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fast) {
    if (layout == kChw) return launch_forward<kChw, kFastExp>(a, grid, s);
    if (layout == kRows) return launch_forward<kRows, kFastExp>(a, grid, s);
    if (layout == kImage) return launch_forward<kImage, kFastExp>(a, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (layout == kChw) return launch_forward<kChw, kFull>(a, grid, s);
  if (layout == kRows) return launch_forward<kRows, kFull>(a, grid, s);
  if (layout == kImage) return launch_forward<kImage, kFull>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// P1: K4 (the "rows" store) with one part of its inner loop ablated or
// re-typed, to attribute the kernel's time to its parts. Replaces the
// variants of `make_kernel` in scripts/profile_kernel_parts.py
// (pallas_call at :174). The Python side, with the plain PyTorch version of
// each variant, is gsvc_tpu_torch/scripts/profile_kernel_parts.py.
//
// The kernel is K4's own, rasterize_fwd.cuh's forward_kernel<kRows,
// variant>, so `full` is K4 by construction and the ablations describe the
// loop that runs. The TPU variants ablated the sigma and colour matmuls and
// traded MXU passes for precision (bf16 x3 splits). K4 on the card has no
// matmul: the quadratic form and the colour sum are FP32 FMAs and the
// exponential goes through the SFU, so the precision trade it has is the
// exponential:
//   kFull     the real K4 loop (expf)
//   kNoSigma  sigma = 0.01 * the lane's sigma at its tile's origin (the
//             TPU's B[5] row): no per-pixel quadratic form
//   kNoExp    vis = sigma
//   kNoAcc    one select-add a pair in place of the three colour FMAs;
//             out[c] = (sum_k w_k) * (sum_k rgb_c,k) * 1e-6
//   kFastExp  __expf (the --use_fast_math exponential)
//   kExp2     exp2f of sigma computed from conics scaled by log2(e)
// Bound, design and determinism are K4's (rasterize_fwd.cuh).
#include "rasterize_fwd.cuh"

namespace {

using gsvc_fwd::Args;
using gsvc_fwd::kRows;
using PartsLaunch = int (*)(const Args&, int, cudaStream_t);
// indexed by gsvc_fwd::Variant
const PartsLaunch kPartsLaunches[] = {
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kFull>,
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kNoSigma>,
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kNoExp>,
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kNoAcc>,
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kFastExp>,
    gsvc_fwd::launch_forward<kRows, gsvc_fwd::kExp2>};
constexpr int kNumVariants = sizeof(kPartsLaunches) / sizeof(kPartsLaunches[0]);

}  // namespace

GSVC_EXPORT int forward_parts(const void* tile_bin_start, const void* tile_counts,
                              const void* gauss_ids, const void* xys,
                              const void* conics, const void* colors,
                              const void* opacity, int n, int img_h, int img_w,
                              int tb_x, int tb_y, int cap, int variant, int r_out,
                              int grid, void* out, void* stream) {
  if (variant < 0 || variant >= kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int*>(tile_bin_start), static_cast<const int*>(tile_counts),
               static_cast<const int*>(gauss_ids),      static_cast<const float*>(xys),
               static_cast<const float*>(conics),       static_cast<const float*>(colors),
               static_cast<const float*>(opacity),      n,
               img_h,                                   img_w,
               tb_x,                                    tb_x * tb_y,
               cap,                                     r_out,
               static_cast<float*>(out),                0,
               tb_x * tb_y,                             img_h,
               nullptr};
  return kPartsLaunches[variant](a, grid, static_cast<cudaStream_t>(stream));
}

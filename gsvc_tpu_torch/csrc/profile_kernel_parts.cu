// P1: K4 (csrc/rasterize_fwd.cu, the "rows" store) with one part of its
// inner loop ablated or re-typed, to attribute the kernel's time to its
// parts. Replaces the variants of `make_kernel` in
// scripts/profile_kernel_parts.py (pallas_call at :174). The Python side,
// with the plain PyTorch version of each variant, is
// gsvc_tpu_torch/scripts/profile_kernel_parts.py.
//
// The TPU variants ablated the sigma and colour matmuls and traded MXU
// passes for precision (bf16 x3 splits). K4 on the card has no matmul: the
// quadratic form and the colour sum are FP32 FMAs and the exponential goes
// through the SFU, so the precision trade it has is the exponential:
//   kFull     the real K4 loop (expf)
//   kNoSigma  sigma = 0.01 * the lane's sigma at its tile's origin (the
//             TPU's B[5] row): no per-pixel quadratic form
//   kNoExp    vis = sigma
//   kNoAcc    one select-add a lane in place of the three colour FMAs;
//             out[c] = (sum_k w_k) * (sum_k rgb_c,k) * 1e-6
//   kFastExp  __expf (the --use_fast_math exponential)
//   kExp2     exp2f of sigma computed from conics pre-scaled by log2(e)
// Like K4, one CTA per 16x16 tile and one thread per pixel, the tile's
// lanes gathered once into shared memory; bound by the same per-pair
// FP32/SFU work. Deterministic: lane order, no atomics.
#include "common.cuh"

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFields = 9;  // x y c1 c2 c3 opac r g b
enum Variant { kFull = 0, kNoSigma = 1, kNoExp = 2, kNoAcc = 3, kFastExp = 4, kExp2 = 5 };

template <int kVariant>
__global__ void parts_kernel(const int* __restrict__ tile_bin_start,
                             const int* __restrict__ tile_counts,
                             const int* __restrict__ gauss_ids,
                             const float* __restrict__ xys,
                             const float* __restrict__ conics,
                             const float* __restrict__ colors,
                             const float* __restrict__ opacity, int n,
                             int img_h, int img_w, int tb_x, int cap,
                             int r_out, float* __restrict__ out) {
  extern __shared__ float lanes[];  // [kFields][cap], then 3 colour sums
  float* s_x = lanes;
  float* s_y = lanes + cap;
  float* s_c1 = lanes + 2 * cap;  // kNoSigma: the lane's sigma at the origin
  float* s_c2 = lanes + 3 * cap;
  float* s_c3 = lanes + 4 * cap;
  float* s_op = lanes + 5 * cap;
  float* s_r = lanes + 6 * cap;
  float* s_g = lanes + 7 * cap;
  float* s_b = lanes + 8 * cap;
  float* s_sum = lanes + kFields * cap;

  const int tile = blockIdx.y * tb_x + blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int start = tile_bin_start[tile];
  const int count = min(tile_counts[tile], cap);
  const float ox = static_cast<float>(blockIdx.x * blockDim.x);
  const float oy = static_cast<float>(blockIdx.y * blockDim.y);

  for (int k = tid; k < count; k += nthreads) {
    const int g = gauss_ids[start + k];
    const bool real = g >= 0 && g < n;
    const int gs = real ? g : 0;
    const float x = xys[2 * gs], y = xys[2 * gs + 1];
    float c1 = conics[3 * gs], c2 = conics[3 * gs + 1], c3 = conics[3 * gs + 2];
    if (kVariant == kExp2) {
      c1 *= kLog2e;
      c2 *= kLog2e;
      c3 *= kLog2e;
    }
    if (kVariant == kNoSigma) {
      const float gx = x - ox, gy = y - oy;
      c1 = 0.5f * (c1 * gx * gx + c3 * gy * gy) + c2 * gx * gy;
    }
    s_x[k] = x;
    s_y[k] = y;
    s_c1[k] = c1;
    s_c2[k] = c2;
    s_c3[k] = c3;
    s_op[k] = real ? opacity[gs] : 0.0f;  // alpha 0 is below the cutoff
    s_r[k] = colors[3 * gs];
    s_g[k] = colors[3 * gs + 1];
    s_b[k] = colors[3 * gs + 2];
  }
  __syncthreads();
  if (kVariant == kNoAcc) {
    // the tile's colour sums, by warp 0 in a fixed order
    if (tid < 32) {
      float r = 0.0f, g = 0.0f, b = 0.0f;
      for (int k = tid; k < count; k += 32) {
        r += s_r[k];
        g += s_g[k];
        b += s_b[k];
      }
      for (int off = 16; off > 0; off >>= 1) {
        r += __shfl_down_sync(0xffffffffu, r, off);
        g += __shfl_down_sync(0xffffffffu, g, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
      }
      if (tid == 0) {
        s_sum[0] = r;
        s_sum[1] = g;
        s_sum[2] = b;
      }
    }
    __syncthreads();
  }

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, wsum = 0.0f;
  for (int k = 0; k < count; ++k) {
    float sigma;
    if (kVariant == kNoSigma) {
      sigma = 0.01f * s_c1[k];
    } else {
      const float dx = s_x[k] - fx;
      const float dy = s_y[k] - fy;
      sigma = 0.5f * (s_c1[k] * dx * dx + s_c3[k] * dy * dy) + s_c2[k] * dx * dy;
    }
    float vis;
    if (kVariant == kNoExp) {
      vis = sigma;
    } else if (kVariant == kFastExp) {
      vis = __expf(-sigma);
    } else if (kVariant == kExp2) {
      vis = exp2f(-sigma);
    } else {
      vis = expf(-sigma);
    }
    const float alpha = fminf(1.0f, s_op[k] * vis);
    const bool valid = sigma >= 0.0f && alpha >= kAlphaCutoff;
    if (kVariant == kNoAcc) {
      wsum += valid ? alpha : 0.0f;
    } else if (valid) {
      acc_r += s_r[k] * alpha;
      acc_g += s_g[k] * alpha;
      acc_b += s_b[k] * alpha;
    }
  }
  if (kVariant == kNoAcc) {
    acc_r = wsum * s_sum[0] * 1e-6f;
    acc_g = wsum * s_sum[1] * 1e-6f;
    acc_b = wsum * s_sum[2] * 1e-6f;
  }

  // the rows store of K4: row ty*r_out + 3*tx + c, column ly*block_w + lx;
  // zero past the image edge, as image_to_rows pads
  const bool inside = px < img_w && py < img_h;
  const long long npix = static_cast<long long>(blockDim.x) * blockDim.y;
  const long long base =
      (static_cast<long long>(blockIdx.y) * r_out + 3 * blockIdx.x) * npix + tid;
  out[base] = inside ? acc_r : 0.0f;
  out[base + npix] = inside ? acc_g : 0.0f;
  out[base + 2 * npix] = inside ? acc_b : 0.0f;
}

using PartsKernel = void (*)(const int*, const int*, const int*, const float*,
                            const float*, const float*, const float*, int, int,
                            int, int, int, int, float*);
// indexed by Variant
const PartsKernel kPartsKernels[] = {
    parts_kernel<kFull>,  parts_kernel<kNoSigma>,  parts_kernel<kNoExp>,
    parts_kernel<kNoAcc>, parts_kernel<kFastExp>, parts_kernel<kExp2>};
constexpr int kNumVariants = sizeof(kPartsKernels) / sizeof(kPartsKernels[0]);

}  // namespace

GSVC_EXPORT int forward_parts(const void* tile_bin_start, const void* tile_counts,
                              const void* gauss_ids, const void* xys,
                              const void* conics, const void* colors,
                              const void* opacity, int n, int img_h, int img_w,
                              int tb_x, int tb_y, int block_w, int block_h,
                              int cap, int variant, int r_out, void* out,
                              void* stream) {
  if (variant < 0 || variant >= kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tb_x <= 0 || tb_y <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float) * (kFields * cap + 3);
  kPartsKernels[variant]<<<dim3(tb_x, tb_y), dim3(block_w, block_h), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_bin_start), static_cast<const int*>(tile_counts),
      static_cast<const int*>(gauss_ids), static_cast<const float*>(xys),
      static_cast<const float*>(conics), static_cast<const float*>(colors),
      static_cast<const float*>(opacity), n, img_h, img_w, tb_x, cap, r_out,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Forward sum-rasterizer, K4 (layout "image", [H, W, 3], and layout "rows",
// the tile-row blocks of image_to_rows) and K5 (layout "chw", [3, H, W]) as
// one kernel templated on the store. The Python side, with the plain
// PyTorch version and the design note, is gsvc_tpu_torch/ops/rasterize_cuda.py.
//
// One CTA per tile and one thread per pixel. The tile's first
// min(count, cap) lanes are gathered once into shared memory; every thread
// then walks them in lane order and accumulates rgb * alpha in f32 in
// registers, so the result is deterministic with no atomics.
#include "common.cuh"

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr int kFields = 9;  // x y c1 c2 c3 opac r g b
enum Layout { kImage = 0, kChw = 1, kRows = 2 };

template <int kLayout>
__global__ void forward_kernel(const int* __restrict__ tile_bin_start,
                               const int* __restrict__ tile_counts,
                               const int* __restrict__ gauss_ids,
                               const float* __restrict__ xys,
                               const float* __restrict__ conics,
                               const float* __restrict__ colors,
                               const float* __restrict__ opacity, int n,
                               int img_h, int img_w, int tb_x, int cap,
                               int r_out, float* __restrict__ out) {
  extern __shared__ float lanes[];  // [kFields][cap]
  float* s_x = lanes;
  float* s_y = lanes + cap;
  float* s_c1 = lanes + 2 * cap;
  float* s_c2 = lanes + 3 * cap;
  float* s_c3 = lanes + 4 * cap;
  float* s_op = lanes + 5 * cap;
  float* s_r = lanes + 6 * cap;
  float* s_g = lanes + 7 * cap;
  float* s_b = lanes + 8 * cap;

  const int tile = blockIdx.y * tb_x + blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int start = tile_bin_start[tile];
  const int count = min(tile_counts[tile], cap);

  // The _pack_lanes gather of the TPU path, folded into the tile's load.
  for (int k = tid; k < count; k += nthreads) {
    const int g = gauss_ids[start + k];
    const bool real = g >= 0 && g < n;
    const int gs = real ? g : 0;
    s_x[k] = xys[2 * gs];
    s_y[k] = xys[2 * gs + 1];
    s_c1[k] = conics[3 * gs];
    s_c2[k] = conics[3 * gs + 1];
    s_c3[k] = conics[3 * gs + 2];
    s_op[k] = real ? opacity[gs] : 0.0f;  // alpha 0 is below the cutoff
    s_r[k] = colors[3 * gs];
    s_g[k] = colors[3 * gs + 1];
    s_b[k] = colors[3 * gs + 2];
  }
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int k = 0; k < count; ++k) {
    const float dx = s_x[k] - fx;
    const float dy = s_y[k] - fy;
    const float sigma =
        0.5f * (s_c1[k] * dx * dx + s_c3[k] * dy * dy) + s_c2[k] * dx * dy;
    const float alpha = fminf(1.0f, s_op[k] * expf(-sigma));
    if (sigma >= 0.0f && alpha >= kAlphaCutoff) {
      acc_r += s_r[k] * alpha;
      acc_g += s_g[k] * alpha;
      acc_b += s_b[k] * alpha;
    }
  }

  const bool inside = px < img_w && py < img_h;
  if (kLayout == kRows) {
    // row ty*r_out + 3*tx + c, column ly*block_w + lx; zero past the image
    // edge, as image_to_rows pads
    const long long npix = static_cast<long long>(blockDim.x) * blockDim.y;
    const long long base =
        (static_cast<long long>(blockIdx.y) * r_out + 3 * blockIdx.x) * npix +
        threadIdx.y * blockDim.x + threadIdx.x;
    out[base] = inside ? acc_r : 0.0f;
    out[base + npix] = inside ? acc_g : 0.0f;
    out[base + 2 * npix] = inside ? acc_b : 0.0f;
    return;
  }
  if (!inside) return;
  const long long pix = static_cast<long long>(py) * img_w + px;
  if (kLayout == kChw) {
    const long long plane = static_cast<long long>(img_h) * img_w;
    out[pix] = acc_r;
    out[plane + pix] = acc_g;
    out[2 * plane + pix] = acc_b;
  } else {
    out[3 * pix] = acc_r;
    out[3 * pix + 1] = acc_g;
    out[3 * pix + 2] = acc_b;
  }
}

}  // namespace

GSVC_EXPORT int rasterize_forward(const void* tile_bin_start,
                                  const void* tile_counts,
                                  const void* gauss_ids, const void* xys,
                                  const void* conics, const void* colors,
                                  const void* opacity, int n, int img_h,
                                  int img_w, int tb_x, int tb_y, int block_w,
                                  int block_h, int cap, int layout,
                                  int r_out, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tb_x, tb_y);
  const dim3 block(block_w, block_h);
  const size_t smem = sizeof(float) * kFields * cap;
  const int* tbs = static_cast<const int*>(tile_bin_start);
  const int* cnt = static_cast<const int*>(tile_counts);
  const int* ids = static_cast<const int*>(gauss_ids);
  const float* x = static_cast<const float*>(xys);
  const float* c = static_cast<const float*>(conics);
  const float* rgb = static_cast<const float*>(colors);
  const float* op = static_cast<const float*>(opacity);
  float* o = static_cast<float*>(out);
  if (tb_x > 0 && tb_y > 0) {
    if (layout == kChw) {
      forward_kernel<kChw><<<grid, block, smem, s>>>(
          tbs, cnt, ids, x, c, rgb, op, n, img_h, img_w, tb_x, cap, r_out, o);
    } else if (layout == kRows) {
      forward_kernel<kRows><<<grid, block, smem, s>>>(
          tbs, cnt, ids, x, c, rgb, op, n, img_h, img_w, tb_x, cap, r_out, o);
    } else {
      forward_kernel<kImage><<<grid, block, smem, s>>>(
          tbs, cnt, ids, x, c, rgb, op, n, img_h, img_w, tb_x, cap, r_out, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

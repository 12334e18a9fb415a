// Backward sum-rasterizer K6: the image gradient, read in the layout the
// forward wrote ("image" [H, W, 3], "chw" [3, H, W] or "rows" tile-row
// blocks), -> each lane's 9 gradients [x, y, c1, c2, c3, opac, r, g, b],
// written to the lane's expansion slot. The Python side, with the plain
// PyTorch version and the design note, is gsvc_tpu_torch/ops/rasterize_cuda.py.
//
// One CTA per tile. The tile's 3 x block_h*block_w gradient goes to shared
// memory once (zero past the image edge, where the forward writes
// constants); then one thread per lane walks the tile's pixels in order and
// sums in f32 registers: deterministic, no atomics. The output buffer is
// zero-filled by the caller, so slots of lanes past the cap stay exactly 0.
#include "common.cuh"

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr int kThreads = 256;
enum Layout { kImage = 0, kChw = 1, kRows = 2 };

template <int kLayout>
__global__ void backward_kernel(
    const int* __restrict__ tile_bin_start, const int* __restrict__ tile_counts,
    const int* __restrict__ gauss_ids, const int* __restrict__ gauss_slot_start,
    const int* __restrict__ bbox_pack, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ colors,
    const float* __restrict__ opacity, const float* __restrict__ v_out, int n,
    int img_h, int img_w, int tb_x, int block_w, int block_h, int cap,
    int r_out, long long num_slots, float* __restrict__ out) {
  extern __shared__ float sv[];  // [3][npix]: this tile's image gradient
  const int npix = block_w * block_h;
  const int tx = blockIdx.x;
  const int ty = blockIdx.y;
  const int tile = ty * tb_x + tx;

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int px = tx * block_w + p % block_w;
    const int py = ty * block_h + p / block_w;
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    if (px < img_w && py < img_h) {
      if (kLayout == kImage) {
        const long long i = 3LL * (static_cast<long long>(py) * img_w + px);
        v0 = v_out[i];
        v1 = v_out[i + 1];
        v2 = v_out[i + 2];
      } else if (kLayout == kChw) {
        const long long plane = static_cast<long long>(img_h) * img_w;
        const long long i = static_cast<long long>(py) * img_w + px;
        v0 = v_out[i];
        v1 = v_out[plane + i];
        v2 = v_out[2 * plane + i];
      } else {
        const long long i =
            (static_cast<long long>(ty) * r_out + 3 * tx) * npix + p;
        v0 = v_out[i];
        v1 = v_out[i + npix];
        v2 = v_out[i + 2 * npix];
      }
    }
    sv[p] = v0;
    sv[npix + p] = v1;
    sv[2 * npix + p] = v2;
  }
  __syncthreads();

  const int start = tile_bin_start[tile];
  const int count = min(tile_counts[tile], cap);
  const float fx0 = static_cast<float>(tx * block_w);
  const float fy0 = static_cast<float>(ty * block_h);
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int g = gauss_ids[start + k];
    if (g < 0 || g >= n) continue;
    const float x = xys[2 * g], y = xys[2 * g + 1];
    const float c1 = conics[3 * g], c2 = conics[3 * g + 1], c3 = conics[3 * g + 2];
    const float op = opacity[g];
    const float cr = colors[3 * g], cg = colors[3 * g + 1], cb = colors[3 * g + 2];
    float v_x = 0.0f, v_y = 0.0f, v_c1 = 0.0f, v_c2 = 0.0f, v_c3 = 0.0f;
    float v_op = 0.0f, v_r = 0.0f, v_g = 0.0f, v_b = 0.0f;
    for (int ly = 0; ly < block_h; ++ly) {
      const float dy = y - (fy0 + static_cast<float>(ly));
      for (int lx = 0; lx < block_w; ++lx) {
        const float dx = x - (fx0 + static_cast<float>(lx));
        const float sigma = 0.5f * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy;
        const float vis = expf(-sigma);
        const float alpha_u = op * vis;
        const float alpha = fminf(1.0f, alpha_u);
        if (sigma >= 0.0f && alpha >= kAlphaCutoff) {
          const int p = ly * block_w + lx;
          const float vr = sv[p], vg = sv[npix + p], vb = sv[2 * npix + p];
          const float v_alpha = cr * vr + cg * vg + cb * vb;
          // the min(1, .) is forward-only (backward.cu:824-837)
          const float v_sigma = -alpha_u * v_alpha;
          v_r += alpha * vr;
          v_g += alpha * vg;
          v_b += alpha * vb;
          v_op += vis * v_alpha;
          v_c1 += 0.5f * dx * dx * v_sigma;
          v_c2 += dx * dy * v_sigma;  // unhalved: autograd through inv(cov)
          v_c3 += 0.5f * dy * dy * v_sigma;
          v_x += (c1 * dx + c2 * dy) * v_sigma;
          v_y += (c3 * dy + c2 * dx) * v_sigma;
        }
      }
    }
    // expansion slot: the tile's row-major rank inside g's tile bbox
    const int pack = bbox_pack[g];
    const int bw = pack >> 16, ty0 = (pack >> 8) & 0xFF, tx0 = pack & 0xFF;
    const long long slot =
        static_cast<long long>(gauss_slot_start[g]) + (ty - ty0) * bw + (tx - tx0);
    if (slot < 0 || slot >= num_slots) continue;
    const float vals[9] = {v_x, v_y, v_c1, v_c2, v_c3, v_op, v_r, v_g, v_b};
#pragma unroll
    for (int f = 0; f < 9; ++f) out[f * num_slots + slot] = vals[f];
  }
}

}  // namespace

GSVC_EXPORT int rasterize_backward(
    const void* tile_bin_start, const void* tile_counts, const void* gauss_ids,
    const void* gauss_slot_start, const void* bbox_pack, const void* xys,
    const void* conics, const void* colors, const void* opacity,
    const void* v_out, int n, int img_h, int img_w, int tb_x, int tb_y,
    int block_w, int block_h, int cap, int layout, int r_out,
    long long num_slots, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tb_x, tb_y);
  const size_t smem = sizeof(float) * 3 * block_w * block_h;
  const int* tbs = static_cast<const int*>(tile_bin_start);
  const int* cnt = static_cast<const int*>(tile_counts);
  const int* ids = static_cast<const int*>(gauss_ids);
  const int* gss = static_cast<const int*>(gauss_slot_start);
  const int* bbox = static_cast<const int*>(bbox_pack);
  const float* x = static_cast<const float*>(xys);
  const float* c = static_cast<const float*>(conics);
  const float* rgb = static_cast<const float*>(colors);
  const float* op = static_cast<const float*>(opacity);
  const float* v = static_cast<const float*>(v_out);
  float* o = static_cast<float*>(out);
  if (tb_x > 0 && tb_y > 0 && num_slots > 0) {
    if (layout == kChw) {
      backward_kernel<kChw><<<grid, kThreads, smem, s>>>(
          tbs, cnt, ids, gss, bbox, x, c, rgb, op, v, n, img_h, img_w, tb_x,
          block_w, block_h, cap, r_out, num_slots, o);
    } else if (layout == kRows) {
      backward_kernel<kRows><<<grid, kThreads, smem, s>>>(
          tbs, cnt, ids, gss, bbox, x, c, rgb, op, v, n, img_h, img_w, tb_x,
          block_w, block_h, cap, r_out, num_slots, o);
    } else {
      backward_kernel<kImage><<<grid, kThreads, smem, s>>>(
          tbs, cnt, ids, gss, bbox, x, c, rgb, op, v, n, img_h, img_w, tb_x,
          block_w, block_h, cap, r_out, num_slots, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

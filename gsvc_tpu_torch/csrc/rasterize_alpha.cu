// The depth-ordered alpha compositor's kernels: A1 (forward) and A2
// (backward). They replace no Pallas kernel: gsvc_tpu computes the
// compositor in XLA (gsvc_tpu/ops/rasterize_alpha.py:92-176) as a dense
// [chunk, H*W] scan, whose gradient at 1080p/10k does not fit a card. These
// are tile kernels after gsplat's forward.cu:252-374 and backward.cu:242-315.
// The Python side, with the plain PyTorch versions and the design note, is
// gsvc_tpu_torch/ops/rasterize_alpha_cuda.py.
//
// Both take the splats in depth order, binned by tile with every
// intersection kept (so a tile's lanes run in depth order), one CTA a 16x16
// tile and a thread a pixel, and colours of cg <= CMAX channels of a [N, C]
// array from column c0 (the wrapper launches groups for wider colours).
//
// A1 stages kBatch1 lanes at a time in shared memory; each pixel
// composites them front to back, stopping before the splat whose
// T (1 - alpha) <= 1e-4, and the CTA leaves once every pixel stopped. It
// writes the image columns, and from the first group 1 - T_final, T_final
// and the last contributing lane of each pixel (for A2).
//
// A2 sweeps back over the tile's lanes from the CTA's furthest last
// contributor, kBatch2 lanes a batch. A pixel recovers T before a splat as
// T / (1 - alpha) and carries D, the sum of the later contributions dotted
// with its image gradient, so its state is T, D and its gradient's cg
// values. Each lane's 6 + cg gradients are summed over a warp by a fixed
// shuffle tree, stored per warp, and after the batch summed over the 8
// warps in order into the lane's expansion slot. v_background is summed
// per tile the same way. No float is added atomically: two launches are
// bitwise equal.
//
// Every (splat, pixel) pair is evaluated with explicitly rounded
// operations in the order of the plain versions' separate float32 ops,
// and expf, as ATen's exp: the sigma < 0 and alpha < 1/255 skips are the
// plain version's on the card. Their least time is set by bytes, with the
// ~17 operations and one expf of each evaluated pair close behind
// (utils/work.py); what bounds them is issuing those operations a pixel a
// thread, and A2's shuffle trees.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch1 = 256;  // A1's staged lanes
constexpr int kBatch2 = 32;   // A2's staged lanes
constexpr int kGeo = 6;       // x y c1 c2 c3 opac, before a lane's colours
constexpr unsigned kFull = 0xffffffffu;
// the plain version's constants, Python floats rounded to float32 once
constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaCutoff = static_cast<float>(1.0 / 255.0);
constexpr float kTEps = static_cast<float>(1e-4);

// One (splat, pixel) pair: dx = x - px, sigma = 0.5 (a dx dx + c dy dy) +
// b dx dy, vis = exp(-sigma), alpha = min(0.999, op vis). False where the
// pair is skipped (sigma < 0 or alpha < 1/255).
__device__ __forceinline__ bool eval_pair(float x, float y, float a, float b, float c,
                                          float op, float fx, float fy, float& dx,
                                          float& dy, float& vis, float& alpha_u,
                                          float& alpha) {
  dx = __fsub_rn(x, fx);
  dy = __fsub_rn(y, fy);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
  if (sigma < 0.f) return false;
  vis = expf(-sigma);
  alpha_u = __fmul_rn(op, vis);
  alpha = fminf(kAlphaMax, alpha_u);
  return alpha >= kAlphaCutoff;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;  // in lane 0
}

// A1. Dynamic shared memory: kBatch1 x (6 + cg) floats.
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
    alpha_forward_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                         const int* __restrict__ gauss_ids, const float* __restrict__ xys,
                         const float* __restrict__ conics, const float* __restrict__ colors,
                         const float* __restrict__ opacity,
                         const float* __restrict__ background, int n, int C, int c0, int cg,
                         int img_h, int img_w, int tb_x, float* __restrict__ out,
                         float* __restrict__ alpha_out, float* __restrict__ T_out,
                         int* __restrict__ last_out) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + kBatch1;
  float* s_a = s_y + kBatch1;
  float* s_b = s_a + kBatch1;
  float* s_c = s_b + kBatch1;
  float* s_op = s_c + kBatch1;
  float* s_col = s_op + kBatch1;  // [kBatch1][cg]

  const int tile = blockIdx.x;
  const int px = (tile % tb_x) * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int py = (tile / tb_x) * kTile + static_cast<int>(threadIdx.x) / kTile;
  const bool inside = px < img_w && py < img_h;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  const int start = tile_start[tile], count = tile_count[tile];

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  int last = -1;
  bool done = !inside;
  for (int b0 = 0; b0 < count; b0 += kBatch1) {
    // every pixel stopped: the tile is done. Also the barrier before the
    // staging buffers are overwritten.
    if (__syncthreads_count(done) == kThreads) break;
    const int m = min(kBatch1, count - b0);
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int g = gauss_ids[start + b0 + k];
      const bool real = g >= 0 && g < n;  // an opacity of 0 skips the rest
      s_x[k] = real ? xys[2 * g] : 0.f;
      s_y[k] = real ? xys[2 * g + 1] : 0.f;
      s_a[k] = real ? conics[3 * g] : 0.f;
      s_b[k] = real ? conics[3 * g + 1] : 0.f;
      s_c[k] = real ? conics[3 * g + 2] : 0.f;
      s_op[k] = real ? opacity[g] : 0.f;
      for (int c = 0; c < cg; ++c) {
        s_col[k * cg + c] = real ? colors[static_cast<long long>(g) * C + c0 + c] : 0.f;
      }
    }
    __syncthreads();
    if (!done) {
      for (int k = 0; k < m; ++k) {
        float dx, dy, vis, alpha_u, alpha;
        if (!eval_pair(s_x[k], s_y[k], s_a[k], s_b[k], s_c[k], s_op[k], fx, fy, dx, dy,
                       vis, alpha_u, alpha)) {
          continue;
        }
        const float next_T = T * (1.f - alpha);
        if (next_T <= kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < cg) acc[c] += s_col[k * cg + c] * w;
        }
        T = next_T;
        last = start + b0 + k;
      }
    }
  }
  if (!inside) return;
  const long long pid = static_cast<long long>(py) * img_w + px;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < cg) out[pid * C + c0 + c] = acc[c] + T * background[c0 + c];
  }
  if (alpha_out != nullptr) alpha_out[pid] = 1.f - T;
  if (T_out != nullptr) T_out[pid] = T;
  if (last_out != nullptr) last_out[pid] = last;
}

// A2. Dynamic shared memory: kBatch2 x (6 + cg) floats of staged lanes,
// kBatch2 ints of their slots, kBatch2 x kWarps x (6 + cg) floats of the
// warps' sums. v_slots is [6 + cg, S], zero-filled by the caller: lanes
// past every pixel's last contributor keep their zeros.
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
    alpha_backward_kernel(const int* __restrict__ tile_start,
                          const int* __restrict__ gauss_ids,
                          const int* __restrict__ gauss_slot_start,
                          const int* __restrict__ bbox_pack, const float* __restrict__ xys,
                          const float* __restrict__ conics, const float* __restrict__ colors,
                          const float* __restrict__ opacity,
                          const float* __restrict__ background,
                          const float* __restrict__ T_final, const int* __restrict__ last,
                          const float* __restrict__ v_img, const float* __restrict__ v_alpha,
                          int n, int C, int c0, int cg, int img_h, int img_w, int tb_x,
                          long long S, float* __restrict__ v_slots,
                          float* __restrict__ v_bg_part) {
  extern __shared__ float smem[];
  const int F = kGeo + cg;
  float* s_x = smem;
  float* s_y = s_x + kBatch2;
  float* s_a = s_y + kBatch2;
  float* s_b = s_a + kBatch2;
  float* s_c = s_b + kBatch2;
  float* s_op = s_c + kBatch2;
  float* s_col = s_op + kBatch2;  // [kBatch2][cg]
  int* s_slot = reinterpret_cast<int*>(s_col + kBatch2 * cg);
  float* s_part = reinterpret_cast<float*>(s_slot + kBatch2);  // [kBatch2][kWarps][F]
  __shared__ float s_bg[kWarps][CMAX];
  __shared__ int s_maxlast;

  const int tile = blockIdx.x;
  const int tx = tile % tb_x, ty = tile / tb_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int px = tx * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int py = ty * kTile + static_cast<int>(threadIdx.x) / kTile;
  const bool inside = px < img_w && py < img_h;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  const long long pid = static_cast<long long>(py) * img_w + px;

  float G[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) G[c] = (inside && c < cg) ? v_img[pid * C + c0 + c] : 0.f;
  const float T_fin = inside ? T_final[pid] : 1.f;
  const int my_last = inside ? last[pid] : -1;
  float vT = 0.f;  // d loss / d T_final, this group's part
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < cg) vT += G[c] * background[c0 + c];
  }
  if (v_alpha != nullptr && inside) vT -= v_alpha[pid];

  // v_background's part of this tile: sum of T_final G over its pixels
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < cg) {
      const float v = warp_sum(inside ? T_fin * G[c] : 0.f);
      if (lane == 0) s_bg[warp][c] = v;
    }
  }
  if (threadIdx.x == 0) s_maxlast = -1;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < cg) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_bg[w][threadIdx.x];
    v_bg_part[static_cast<long long>(tile) * cg + threadIdx.x] = t;
  }
  atomicMax(&s_maxlast, my_last);  // an integer max: the same in any order
  __syncthreads();
  const int start = tile_start[tile];
  const int end = s_maxlast + 1 - start;  // lanes [0, end) may have contributed

  float T = T_fin, D = 0.f;
  for (int b1 = end; b1 > 0; b1 -= kBatch2) {
    const int b0 = max(b1 - kBatch2, 0), m = b1 - b0;
    __syncthreads();  // the last batch's sums are read
    if (static_cast<int>(threadIdx.x) < m) {
      const int k = threadIdx.x;
      const int g = gauss_ids[start + b0 + k];
      const bool real = g >= 0 && g < n;
      s_x[k] = real ? xys[2 * g] : 0.f;
      s_y[k] = real ? xys[2 * g + 1] : 0.f;
      s_a[k] = real ? conics[3 * g] : 0.f;
      s_b[k] = real ? conics[3 * g + 1] : 0.f;
      s_c[k] = real ? conics[3 * g + 2] : 0.f;
      s_op[k] = real ? opacity[g] : 0.f;
      for (int c = 0; c < cg; ++c) {
        s_col[k * cg + c] = real ? colors[static_cast<long long>(g) * C + c0 + c] : 0.f;
      }
      int slot = -1;
      if (real) {  // K6's layout: g's first slot + this tile's rank in g's bbox
        const int pack = bbox_pack[g];
        const int bw = pack >> 16, ty0 = (pack >> 8) & 0xFF, tx0 = pack & 0xFF;
        slot = gauss_slot_start[g] + (ty - ty0) * bw + (tx - tx0);
      }
      s_slot[k] = slot;
    }
    __syncthreads();
    for (int k = m - 1; k >= 0; --k) {
      float f[kGeo + CMAX];
#pragma unroll
      for (int i = 0; i < kGeo + CMAX; ++i) f[i] = 0.f;
      bool contrib = false;
      float dx, dy, vis, alpha_u, alpha;
      if (start + b0 + k <= my_last &&
          eval_pair(s_x[k], s_y[k], s_a[k], s_b[k], s_c[k], s_op[k], fx, fy, dx, dy, vis,
                    alpha_u, alpha)) {
        contrib = true;
        const float ra = 1.f / (1.f - alpha);
        T *= ra;  // the transmittance before this splat
        const float w = alpha * T;
        float gc = 0.f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < cg) {
            gc += s_col[k * cg + c] * G[c];
            f[kGeo + c] = w * G[c];
          }
        }
        const float v_a = T * gc - (D + vT * T_fin) * ra;
        D += gc * w;
        if (alpha_u <= kAlphaMax) {  // min(0.999, .) passes the gradient
          const float v_sigma = -v_a * alpha_u;
          f[0] = (s_a[k] * dx + s_b[k] * dy) * v_sigma;
          f[1] = (s_c[k] * dy + s_b[k] * dx) * v_sigma;
          f[2] = 0.5f * dx * dx * v_sigma;
          f[3] = dx * dy * v_sigma;
          f[4] = 0.5f * dy * dy * v_sigma;
          f[5] = v_a * vis;
        }
      }
      float* part = s_part + (k * kWarps + warp) * F;
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int i = 0; i < kGeo + CMAX; ++i) {
          if (i < F) {
            const float v = warp_sum(f[i]);
            if (lane == 0) part[i] = v;
          }
        }
      } else if (lane == 0) {
        for (int i = 0; i < F; ++i) part[i] = 0.f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * F; idx += kThreads) {
      const int k = idx / F, i = idx - k * F;
      const int slot = s_slot[k];
      if (slot < 0) continue;
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += s_part[(k * kWarps + w) * F + i];
      v_slots[static_cast<long long>(i) * S + slot] = t;
    }
  }
}

bool group_ok(int C, int c0, int cg, int cmax) {
  return (cmax == 4 || cmax == 8 || cmax == 16 || cmax == 32) && cg >= 1 && cg <= cmax &&
         c0 >= 0 && c0 + cg <= C;
}

}  // namespace

// A1 on one channel group [c0, c0 + cg) (cmax: the template, 4/8/16/32 >=
// cg). alpha_out, T_out and last_out may be null (groups after the first).
GSVC_EXPORT int alpha_forward(const void* tile_start, const void* tile_count,
                              const void* gauss_ids, const void* xys, const void* conics,
                              const void* colors, const void* opacity,
                              const void* background, int n, int C, int c0, int cg,
                              int cmax, int img_h, int img_w, int tb_x, int num_tiles,
                              void* out, void* alpha_out, void* T_out, void* last_out,
                              void* stream) {
  if (!group_ok(C, c0, cg, cmax) || num_tiles < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float) * kBatch1 * (kGeo + cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSVC_A1(CM)                                                                        \
  alpha_forward_kernel<CM><<<num_tiles, kThreads, smem, s>>>(                              \
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),            \
      static_cast<const int*>(gauss_ids), static_cast<const float*>(xys),                  \
      static_cast<const float*>(conics), static_cast<const float*>(colors),                \
      static_cast<const float*>(opacity), static_cast<const float*>(background), n, C, c0, \
      cg, img_h, img_w, tb_x, static_cast<float*>(out), static_cast<float*>(alpha_out),    \
      static_cast<float*>(T_out), static_cast<int*>(last_out))
  switch (cmax) {
    case 4: GSVC_A1(4); break;
    case 8: GSVC_A1(8); break;
    case 16: GSVC_A1(16); break;
    default: GSVC_A1(32); break;
  }
#undef GSVC_A1
  return static_cast<int>(cudaGetLastError());
}

// A2 on one channel group: writes rows 0-5 (x y c1 c2 c3 opac) and 6 ..
// 5 + cg (the group's colours) of the zero-filled v_slots [6 + cg, S], and
// v_bg_part [num_tiles, cg]. v_alpha may be null (no alpha output, or a
// group after the first). tile_count is unused: a tile's lanes past its
// pixels' last contributors never contributed.
GSVC_EXPORT int alpha_backward(const void* tile_start, const void* tile_count,
                               const void* gauss_ids, const void* gauss_slot_start,
                               const void* bbox_pack, const void* xys, const void* conics,
                               const void* colors, const void* opacity,
                               const void* background, const void* T_final,
                               const void* last, const void* v_img, const void* v_alpha,
                               int n, int C, int c0, int cg, int cmax, int img_h, int img_w,
                               int tb_x, int num_tiles, long long S, void* v_slots,
                               void* v_bg_part, void* stream) {
  (void)tile_count;
  if (!group_ok(C, c0, cg, cmax) || num_tiles < 0 || n < 0 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(float) * kBatch2 * (kGeo + cg) + sizeof(int) * kBatch2 +
                      sizeof(float) * kBatch2 * kWarps * (kGeo + cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSVC_A2(CM)                                                                         \
  alpha_backward_kernel<CM><<<num_tiles, kThreads, smem, s>>>(                              \
      static_cast<const int*>(tile_start), static_cast<const int*>(gauss_ids),              \
      static_cast<const int*>(gauss_slot_start), static_cast<const int*>(bbox_pack),        \
      static_cast<const float*>(xys), static_cast<const float*>(conics),                    \
      static_cast<const float*>(colors), static_cast<const float*>(opacity),                \
      static_cast<const float*>(background), static_cast<const float*>(T_final),            \
      static_cast<const int*>(last), static_cast<const float*>(v_img),                      \
      static_cast<const float*>(v_alpha), n, C, c0, cg, img_h, img_w, tb_x, S,              \
      static_cast<float*>(v_slots), static_cast<float*>(v_bg_part))
  switch (cmax) {
    case 4: GSVC_A2(4); break;
    case 8: GSVC_A2(8); break;
    case 16: GSVC_A2(16); break;
    default: GSVC_A2(32); break;
  }
#undef GSVC_A2
  return static_cast<int>(cudaGetLastError());
}

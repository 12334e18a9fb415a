// E1: the training loss in the tile-row layout, from K4's raw rows to the
// gradient K6 reads, in one pass. Replaces no TPU kernel: gsvc_tpu leaves
// this chain (the background blend of ops/rasterize.py, the clip to [0, 1]
// of models/represent.py `_clip01`, the masked difference and its squared
// sum) to XLA's fusion. The port's plain chain, one PyTorch op at a time,
// is 8 image-sized kernels forward and 15 in autograd's backward, ~49 reads
// and writes of a [rows, 256] float32 array a step. The Python side, with
// the checks, the plain version and the autograd function, is
// gsvc_tpu_torch/ops/loss_cuda.py.
//
// Bytes bound it (a few operations an element): each element reads K4's
// raw value, the target and the mask and writes one gradient, 16 bytes
// (100 MB at 1080p's 24,480 x 256 rows: 0.030 ms at 3.35 TB/s). So a
// thread takes float4 units in a grid-stride loop over a fixed grid, and
// computes, each rounded once as the chain's ops round it (__f*_rn: nvcc
// would otherwise contract a multiply and an add into one FFMA):
//   x = raw * live + (1 - live)                 the blend on the default
//                                               background, ones (live: K1's
//                                               kept total >= 1, read here)
//   out = min(max(x, 0), 1)                     torch.maximum / minimum
//   diff = (out - gt) * mask
//   gd = 2 diff mask c live (L2) or sign(diff) mask c live (L1)
// where c is the clip's gradient with torch's tie halves: 0 past the
// bounds, 1/2 where max(x, 0) or min(., 1) ties, else 1. The factors 2,
// 1/2, c, live and a 0/1 mask are powers of two or zero, so the caller's
// fl(s * gd) is bitwise autograd's 2 fl(s * diff) mask c live.
//
// Sums, in a fixed order with no float atomics: a thread's units in its
// loop order, a CTA's threads in a fixed shuffle tree, one float32 partial
// a CTA (of sum diff^2, and for L1 of sum |diff|); the CTA that takes the
// last integer ticket sums the partials the same way and resets the
// ticket for the next launch. The ticket is one per device, so launches
// of this kernel must not overlap (the port runs one a step, on one
// stream).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ unsigned int g_ticket = 0;

__device__ __forceinline__ float max0(float x) { return x != x ? x : (x < 0.0f ? 0.0f : x); }
__device__ __forceinline__ float min1(float y) { return y != y ? y : (1.0f < y ? 1.0f : y); }

// One element: (diff, gd). dead = 1 - live is the blend's 1 * (1 - live).
template <bool kL1>
__device__ __forceinline__ float element(float live, float dead, float raw, float gt, float m,
                                         float& gd) {
  const float x = __fadd_rn(__fmul_rn(raw, live), dead);
  const float y = max0(x);
  const float out = min1(y);
  const float diff = __fmul_rn(__fsub_rn(out, gt), m);
  float g = kL1 ? static_cast<float>((diff > 0.0f) - (diff < 0.0f)) : __fadd_rn(diff, diff);
  g = __fmul_rn(g, m);
  if (y == 1.0f) g = __fmul_rn(g, 0.5f);  // torch.minimum's backward
  if (y > 1.0f) g = 0.0f;
  if (x == 0.0f) g = __fmul_rn(g, 0.5f);  // torch.maximum's backward
  if (x < 0.0f) g = 0.0f;
  gd = __fmul_rn(g, live);
  return diff;
}

// The CTA's sum of v in a fixed order; every thread gets it.
__device__ __forceinline__ float cta_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may hold an earlier sum's warps
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < kWarps ? smem[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kL1>
__global__ void __launch_bounds__(kThreads)
    rows_loss_kernel(const float4* __restrict__ raw, const float4* __restrict__ gt,
                     const float4* __restrict__ mask, int units, const int* __restrict__ total,
                     float4* __restrict__ gd, float* partials, float* loss, float* sq) {
  __shared__ float smem[kWarps];
  __shared__ bool last;
  const float live = *total >= 1 ? 1.0f : 0.0f;
  const float dead = __fsub_rn(1.0f, live);
  float acc_sq = 0.0f, acc_abs = 0.0f;
  const int stride = gridDim.x * kThreads;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < units; u += stride) {
    const float4 r = raw[u], t = gt[u], m = mask[u];
    float4 g;
    const float d0 = element<kL1>(live, dead, r.x, t.x, m.x, g.x);
    const float d1 = element<kL1>(live, dead, r.y, t.y, m.y, g.y);
    const float d2 = element<kL1>(live, dead, r.z, t.z, m.z, g.z);
    const float d3 = element<kL1>(live, dead, r.w, t.w, m.w, g.w);
    gd[u] = g;
    acc_sq = __fmaf_rn(d0, d0, acc_sq);
    acc_sq = __fmaf_rn(d1, d1, acc_sq);
    acc_sq = __fmaf_rn(d2, d2, acc_sq);
    acc_sq = __fmaf_rn(d3, d3, acc_sq);
    if (kL1) {
      acc_abs = __fadd_rn(acc_abs, fabsf(d0));
      acc_abs = __fadd_rn(acc_abs, fabsf(d1));
      acc_abs = __fadd_rn(acc_abs, fabsf(d2));
      acc_abs = __fadd_rn(acc_abs, fabsf(d3));
    }
  }
  const int grid = gridDim.x;
  acc_sq = cta_sum(acc_sq, smem);
  if (kL1) acc_abs = cta_sum(acc_abs, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc_sq;
    if (kL1) partials[grid + blockIdx.x] = acc_abs;
    __threadfence();  // the partials before the ticket
    last = atomicAdd(&g_ticket, 1u) == static_cast<unsigned int>(grid - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f, a = 0.0f;
  for (int i = threadIdx.x; i < grid; i += kThreads) {
    s = __fadd_rn(s, __ldcg(partials + i));
    if (kL1) a = __fadd_rn(a, __ldcg(partials + grid + i));
  }
  s = cta_sum(s, smem);
  if (kL1) a = cta_sum(a, smem);
  if (threadIdx.x == 0) {
    *sq = s;
    *loss = kL1 ? a : s;
    g_ticket = 0;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// raw, gt, mask, gd: [rows, cols] float32 (cols a multiple of 4, fewer
// than 2^30 float4 units, every pointer 16-byte aligned); total: the kept
// intersections, int32; partials: 2 * grid float32; loss, sq: one float32
// each. l1: the L1 loss (sum |diff|) in loss, else sum diff^2.
GSVC_EXPORT int rows_loss(const void* raw, const void* gt, const void* mask, long long rows,
                          int cols, const void* total, void* gd, void* partials, void* loss,
                          void* sq, int l1, int grid, void* stream) {
  if (cols <= 0 || cols % 4 != 0 || rows <= 0 || rows * (cols / 4) >= (1LL << 30) || grid <= 0 ||
      !aligned16(raw) || !aligned16(gt) || !aligned16(mask) || !aligned16(gd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = static_cast<int>(rows * (cols / 4));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(raw), static_cast<const float4*>(gt),
        static_cast<const float4*>(mask), units, static_cast<const int*>(total),
        static_cast<float4*>(gd), static_cast<float*>(partials), static_cast<float*>(loss),
        static_cast<float*>(sq));
  };
  if (l1) {
    launch(rows_loss_kernel<true>);
  } else {
    launch(rows_loss_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

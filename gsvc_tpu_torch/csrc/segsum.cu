// Segmented cumsum K3: inclusive scan of [R, S] f32 values along S, restarted
// at every lane whose flag is set. The Python side, with the plain PyTorch
// version and the design note, is gsvc_tpu_torch/ops/fill_cuda.py.
//
// Three passes, each in a fixed order, so the result is deterministic:
//  1. local: one CTA per (1024-lane block, row) scans its block (4 lanes a
//     thread sequentially, then a shuffle scan across the warp and a scan of
//     the 8 warp totals), writes the block-local scan, the block's tail
//     value and whether it holds a flag, and the block-relative index of its
//     first flag;
//  2. carry: one thread per row walks the blocks in order and turns the
//     tails into each block's incoming carry;
//  3. fix-up: lanes before their block's first flag add the carry.
// A scan element is (v, f); combining an earlier a with a later b gives
// (b.f ? b.v : a.v + b.v, a.f | b.f).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlock = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void combine(float& v, int& f, float av, int af) {
  // (av, af) comes before (v, f)
  if (!f) v = av + v;
  f |= af;
}

__global__ void segscan_local(const float* __restrict__ vals,
                              const int* __restrict__ flags, long long s,
                              int nb, float* __restrict__ out,
                              float* __restrict__ tail, int* __restrict__ bflag,
                              int* __restrict__ first_flag) {
  __shared__ float wv[kWarps];
  __shared__ int wf[kWarps];
  __shared__ int first;
  const int b = blockIdx.x;
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(b) * kBlock + threadIdx.x * kPerThread;
  const float* rv = vals + row * s;
  if (threadIdx.x == 0) first = kBlock;
  __syncthreads();

  float ev[kPerThread];
  int ef[kPerThread];
  float tv = 0.0f;
  int tf = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + j;
    ev[j] = i < s ? rv[i] : 0.0f;
    ef[j] = i < s ? (flags[i] != 0) : 0;
    if (ef[j]) atomicMin(&first, threadIdx.x * kPerThread + j);
    combine(ev[j], ef[j], tv, tf);  // ev[j] becomes the thread's running scan
    tv = ev[j];
    tf = ef[j];
  }
  // inclusive warp scan of the thread aggregates
  float iv = tv;
  int jf = tf;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ov = __shfl_up_sync(kFull, iv, d);
    const int of = __shfl_up_sync(kFull, jf, d);
    if (lane >= d) combine(iv, jf, ov, of);
  }
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = jf;
  }
  // exclusive prefix inside the warp
  float xv = __shfl_up_sync(kFull, iv, 1);
  int xf = __shfl_up_sync(kFull, jf, 1);
  if (lane == 0) {
    xv = 0.0f;
    xf = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive scan of the warp totals, in order
    float cv = 0.0f;
    int cf = 0;
    for (int w = 0; w < kWarps; ++w) {
      const float v = wv[w];
      const int f = wf[w];
      wv[w] = cv;
      wf[w] = cf;
      float nv = v;
      int nf = f;
      combine(nv, nf, cv, cf);
      cv = nv;
      cf = nf;
    }
  }
  __syncthreads();
  // the thread's exclusive prefix in the block: warp prefix, then lanes
  combine(xv, xf, wv[warp], wf[warp]);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    float v = ev[j];
    int f = ef[j];
    combine(v, f, xv, xf);
    const long long i = base + j;
    if (i < s) out[row * s + i] = v;
    if (j == kPerThread - 1 && threadIdx.x == kThreads - 1) {
      tail[row * nb + b] = v;
      bflag[row * nb + b] = f;
    }
  }
  if (row == 0 && threadIdx.x == 0) first_flag[b] = first;
}

__global__ void segscan_carry(const float* __restrict__ tail,
                              const int* __restrict__ bflag, int rows, int nb,
                              float* __restrict__ carry) {
  const int row = threadIdx.x;
  if (row >= rows) return;
  float c = 0.0f;
  for (int b = 0; b < nb; ++b) {
    carry[row * nb + b] = c;
    const float t = tail[row * nb + b];
    c = bflag[row * nb + b] ? t : c + t;
  }
}

__global__ void segscan_fixup(const float* __restrict__ carry,
                              const int* __restrict__ first_flag, long long s,
                              int nb, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int row = blockIdx.y;
  const float c = carry[row * nb + b];
  const int first = first_flag[b];
  for (int j = threadIdx.x; j < first; j += blockDim.x) {
    const long long i = static_cast<long long>(b) * kBlock + j;
    if (i < s) out[row * s + i] += c;
  }
}

}  // namespace

// scratch: tail [rows*nb] f32, bflag [rows*nb] i32, first_flag [nb] i32,
// carry [rows*nb] f32, nb = ceil(s / 1024).
GSVC_EXPORT int segmented_cumsum(const void* vals, const void* flags,
                                 int rows, long long s, void* tail,
                                 void* bflag, void* first_flag, void* carry,
                                 void* out, void* stream) {
  if (rows <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>((s + kBlock - 1) / kBlock);
  const dim3 grid(nb, rows);
  float* o = static_cast<float*>(out);
  segscan_local<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(vals), static_cast<const int*>(flags), s, nb,
      o, static_cast<float*>(tail), static_cast<int*>(bflag),
      static_cast<int*>(first_flag));
  segscan_carry<<<1, 32, 0, st>>>(static_cast<const float*>(tail),
                                  static_cast<const int*>(bflag), rows, nb,
                                  static_cast<float*>(carry));
  segscan_fixup<<<grid, kThreads, 0, st>>>(static_cast<const float*>(carry),
                                           static_cast<const int*>(first_flag),
                                           s, nb, o);
  return static_cast<int>(cudaGetLastError());
}

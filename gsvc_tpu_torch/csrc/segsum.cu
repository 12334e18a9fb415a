// Segmented cumsum K3: inclusive scan of [R, S] f32 values along S, restarted
// at every lane whose flag is set. Replaces gsvc_tpu/ops/fill_pallas.py
// `_segsum_kernel` / `segmented_cumsum`, the lane -> splat gradient
// reduction's scan. The Python side, with the plain PyTorch version, is
// gsvc_tpu_torch/ops/fill_cuda.py.
//
// What bounds it: bytes. The function reads R*S values and S flags and writes
// R*S values once (8RS + 4S bytes: 6.2 MB, 1.9 us at 3.35 TB/s for [9, 81920]);
// its 2 operations a value are nothing beside them. The TPU carries each row's
// running sum from one sequential grid step to the next; CUDA blocks run in no
// order, so the carry crosses blocks through a thread-block cluster instead,
// and the whole scan is one launch that reads and writes each value once:
//
// - Grid (kCluster, R): a cluster of 16 CTAs per row, the largest
//   (non-portable) size; the portable 8 ran 18 % slower on an H100 SXM. The
//   row is cut into steps of 128 lanes; CTA c owns a contiguous run of steps,
//   and each of its 8 warps a contiguous run of those.
// - A warp walks its steps in order with no CTA barrier: each step's values
//   and flags arrive by cp.async into the warp's own ring of kStages shared
//   buffers, kStages - 1 steps ahead; a thread scans its 4 lanes, the warp its
//   32 thread totals by shuffles, and the warp's running carry, held in
//   registers, joins them. Every step is written once, except the warp's
//   first, which it holds in registers until its incoming carry is known.
// - The warps' totals meet in shared memory (one barrier), giving each warp
//   the part of its carry from the warps before it and the CTA its span's
//   aggregate (tail value, has-flag). The first flagged lane of each warp is
//   a __ballot_sync / __ffs a step.
// - Each CTA pushes its aggregate into the shared memory of every later rank
//   of the cluster (distributed shared memory), then one cluster barrier;
//   CTA c then combines the aggregates of ranks 0..c-1 in rank order into its
//   incoming carry. As no CTA reads another's shared memory after the barrier,
//   none has to wait for the others to exit. Lanes before their warp's first
//   flag take the carry: those of the held first step in registers, later
//   ones (a segment over more than a step) by reading back what was written.
//
// The order of every sum is fixed and no float is added atomically, so two
// launches are bitwise equal. A scan element is (v, f); combining an earlier a
// with a later b gives (b.f ? b.v : a.v + b.v, a.f | b.f).
#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // lanes a thread, in order
constexpr int kStep = 32 * kPer;  // lanes a warp step
constexpr int kStages = 8;  // steps in a warp's ring: kStages - 1 ahead of the scan
constexpr int kCluster = 16;  // CTAs a row: fill_cuda.SEG_CLUSTER
constexpr int kSmemBytes = kWarps * kStages * kStep * 8;  // values and flags
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void combine(float& v, int& f, float av, int af) {
  // (av, af) comes before (v, f)
  if (!f) v = av + v;
  f |= af;
}

// global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Stage step lanes [base, base + kStep) of one row into a warp's buffers;
// lanes past s are (0, no flag). kVec: s % 4 == 0 and every pointer 16-byte
// aligned, so a thread copies its own 4 lanes as one 16-byte copy each of
// values and flags.
template <bool kVec>
__device__ __forceinline__ void load_step(float* sv, int* sf, const float* rv,
                                          const int* flags, long long base,
                                          long long s, int lane) {
  if (kVec) {
    const long long i = base + lane * kPer;
    const bool in = i < s;
    cp_async16(sv + lane * kPer, in ? rv + i : rv, in ? 16 : 0);
    cp_async16(sf + lane * kPer, in ? flags + i : flags, in ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = j * 32 + lane;
      const long long i = base + k;
      const bool in = i < s;
      cp_async4(sv + k, in ? rv + i : rv, in ? 4 : 0);
      cp_async4(sf + k, in ? flags + i : flags, in ? 4 : 0);
    }
  }
  commit();
}

template <bool kVec>
__device__ __forceinline__ void store4(float* ro, long long i, long long s,
                                       const float (&v)[kPer]) {
  if (kVec) {
    if (i < s) *reinterpret_cast<float4*>(ro + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i + j < s) ro[i + j] = v[j];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segscan_cluster(const float* __restrict__ vals, const int* __restrict__ flags,
                    long long s, int steps_per_cta, float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];  // [kWarps][kStages][kStep] values, then flags
  __shared__ float wv[kWarps];  // each warp's total
  __shared__ int wf[kWarps];
  __shared__ float agg_v[kCluster];  // rank r's aggregate, pushed by rank r
  __shared__ int agg_f[kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  // every CTA of the cluster has started once this phase completes, before
  // any CTA writes into another's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int c = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* rv = vals + blockIdx.y * s;
  float* ro = out + blockIdx.y * s;
  float* sv = ring + warp * kStages * kStep;
  int* sf = reinterpret_cast<int*>(ring + kWarps * kStages * kStep) + warp * kStages * kStep;

  const long long nsteps = (s + kStep - 1) / kStep;
  const int per_warp = (steps_per_cta + kWarps - 1) / kWarps;
  const long long w0 = static_cast<long long>(c) * steps_per_cta +
                       static_cast<long long>(warp) * per_warp;
  const long long cta_end = min(nsteps, static_cast<long long>(c + 1) * steps_per_cta);
  const int count = static_cast<int>(max(0LL, min(static_cast<long long>(per_warp),
                                                  cta_end - w0)));
  const long long span0 = w0 * kStep;  // the warp's first lane

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < count) {
      load_step<kVec>(sv + k * kStep, sf + k * kStep, rv, flags, span0 + k * kStep, s, lane);
    } else {
      commit();  // keep one group a step
    }
  }
  float cv = 0.0f;  // the warp's running scan
  int cf = 0;
  int first = -1;  // the warp's lane of its first flag, -1 while none
  float held[kPer] = {0.0f, 0.0f, 0.0f, 0.0f};  // step 0, before any carry
  int held_f[kPer] = {1, 1, 1, 1};
  for (int k = 0; k < count; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    // step k is in place for the whole warp, and every lane is done with
    // step k - 1, whose buffer the next copy fills
    __syncwarp();
    const int nk = k + kStages - 1;
    if (nk < count) {
      const int b = nk % kStages;
      load_step<kVec>(sv + b * kStep, sf + b * kStep, rv, flags,
                      span0 + static_cast<long long>(nk) * kStep, s, lane);
    } else {
      commit();
    }
    const int b = k % kStages;
    const float4 v4 = reinterpret_cast<const float4*>(sv + b * kStep)[lane];
    const int4 f4 = reinterpret_cast<const int4*>(sf + b * kStep)[lane];
    float ev[kPer] = {v4.x, v4.y, v4.z, v4.w};
    int ef[kPer] = {f4.x != 0, f4.y != 0, f4.z != 0, f4.w != 0};
    const int jfirst = ef[0] ? 0 : ef[1] ? 1 : ef[2] ? 2 : ef[3] ? 3 : -1;
#pragma unroll
    for (int j = 1; j < kPer; ++j) combine(ev[j], ef[j], ev[j - 1], ef[j - 1]);
    // inclusive warp scan of the thread totals
    float iv = ev[kPer - 1];
    int jf = ef[kPer - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ov = __shfl_up_sync(kFull, iv, d);
      const int of = __shfl_up_sync(kFull, jf, d);
      if (lane >= d) combine(iv, jf, ov, of);
    }
    const unsigned ball = __ballot_sync(kFull, jfirst >= 0);
    if (first < 0 && ball != 0) {
      const int t = __ffs(ball) - 1;
      first = k * kStep + t * kPer + __shfl_sync(kFull, jfirst, t);
    }
    // the thread's exclusive prefix: the warp's carry, then the lanes before
    float xv = __shfl_up_sync(kFull, iv, 1);
    int xf = __shfl_up_sync(kFull, jf, 1);
    if (lane == 0) {
      xv = 0.0f;
      xf = 0;
    }
    combine(xv, xf, cv, cf);
    combine(iv, jf, cv, cf);
    cv = __shfl_sync(kFull, iv, 31);
    cf = __shfl_sync(kFull, jf, 31);
#pragma unroll
    for (int j = 0; j < kPer; ++j) combine(ev[j], ef[j], xv, xf);
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        held[j] = ev[j];
        held_f[j] = ef[j];
      }
    } else {
      store4<kVec>(ro, span0 + static_cast<long long>(k) * kStep + lane * kPer, s, ev);
    }
  }

  if (lane == 0) {
    wv[warp] = cv;
    wf[warp] = cf;
  }
  __syncthreads();
  float pv = 0.0f;  // warps 0..warp-1 of this CTA, in order
  int pf = 0;
  float tv = 0.0f;  // the CTA's aggregate
  int tf = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      pv = tv;
      pf = tf;
    }
    float nv = wv[w];
    int nf = wf[w];
    combine(nv, nf, tv, tf);
    tv = nv;
    tf = nf;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0 && lane > c && lane < kCluster) {
    *cluster.map_shared_rank(&agg_v[c], lane) = tv;
    *cluster.map_shared_rank(&agg_f[c], lane) = tf;
  }
  // the pushes are visible to their ranks once this phase completes
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float carry = 0.0f;  // ranks 0..c-1 in rank order, then this CTA's warps
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    if (r < c) carry = agg_f[r] ? agg_v[r] : carry + agg_v[r];
  }
  int carry_f = 0;
  combine(pv, pf, carry, carry_f);
  if (count > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) combine(held[j], held_f[j], pv, 0);
    store4<kVec>(ro, span0 + lane * kPer, s, held);
    // lanes after the first step that come before the warp's first flag
    const int fix = first < 0 ? count * kStep : first;
    for (int k = kStep + lane; k < fix; k += 32) {
      const long long i = span0 + k;
      if (i < s) ro[i] = pv + ro[i];
    }
  }
}

cudaLaunchConfig_t cluster_config(int rows, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kVec>
cudaError_t configure() {
  cudaError_t e = cudaFuncSetAttribute(
      segscan_cluster<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(segscan_cluster<kVec>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// configure<kVec>() once for each device (the attributes are per device)
template <bool kVec>
cudaError_t configured() {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return configure<kVec>();
  std::call_once(once[dev], [dev] { result[dev] = configure<kVec>(); });
  return result[dev];
}

template <bool kVec>
cudaError_t launch(const float* vals, const int* flags, int rows, long long s,
                   float* out, cudaStream_t st) {
  const cudaError_t e = configured<kVec>();
  if (e != cudaSuccess) return e;
  const long long nsteps = (s + kStep - 1) / kStep;
  const int per = static_cast<int>((nsteps + kCluster - 1) / kCluster);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(rows, st, &attr);
  return cudaLaunchKernelEx(&cfg, segscan_cluster<kVec>, vals, flags, s, per, out);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One launch of grid (kCluster, rows); rows <= 65535.
GSVC_EXPORT int segmented_cumsum(const void* vals, const void* flags, int rows,
                                 long long s, void* out, void* stream) {
  if (rows <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* f = static_cast<const int*>(flags);
  float* o = static_cast<float*>(out);
  const bool vec = s % kPer == 0 && aligned16(v) && aligned16(f) && aligned16(o);
  const cudaError_t e = vec ? launch<true>(v, f, rows, s, o, st)
                            : launch<false>(v, f, rows, s, o, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

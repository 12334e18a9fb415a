// Adan's update (arXiv 2208.06677) on every leaf of a step in one launch.
// Replaces no TPU kernel: gsvc_tpu/optim/adan.py is plain jnp, which XLA
// fuses into one update; the port's plain version, one PyTorch op at a time
// (31 kernels a leaf: 125 for the represent step's 4 leaves, ~155 for QAT's
// 5), is optim/adan.py `_update`. The Python side, with the leaf table and
// the checks, is gsvc_tpu_torch/optim/adan_cuda.py.
//
// Bytes bound it: each element reads p, g, m, n, d and -g_prev and writes
// all but g (44 bytes; 3.96 MB at 1080p/10k's 90,000 elements, 1.2 us at
// 3.35 TB/s), far under one launch of the plain version's 125. So the
// design is one launch over the leaves' concatenated range: a thread takes
// a unit of 4 consecutive elements of one leaf, as float4 loads and stores
// where the leaf's six pointers are 16-byte aligned and the unit is whole,
// else one element at a time. Each leaf's units start at its entry's
// `first` (`adan_cuda.leaf_table`); a thread finds its leaf by a scan of
// at most kMaxLeaves entries of the parameter table. One wave covers the
// represent and QAT steps' leaves at 50k splats; a grid-stride loop the
// rest.
//
// The step's scalars are read on the device, so a CUDA graph of the step
// replays every later step: the row `*row` of the [rows, 5] table
// (optim/adan.py `adan_table`: step_size, step_size_diff, 1 / sqrt(1 -
// b3^t), 1 / (1 + lr wd), 1 - lr wd), the fresh flag and, with a global
// clip, its factor. The arithmetic is `_update`'s on a CUDA tensor, op for
// op and in its order, each rounded once (__f*_rn: nvcc would otherwise
// contract a multiply and an add into one FFMA), so the results are bitwise
// the plain version's: a Python float is the float32 PyTorch rounds it to,
// a division by a table entry is the multiply by its reciprocal that
// PyTorch makes of a division of a CUDA tensor by a Python float.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;  // elements a unit
constexpr int kMaxLeaves = 8;
constexpr int kCols = 5;  // the table's columns

struct Leaf {
  float* p;
  const float* g;
  float* m;    // exp_avg
  float* n;    // exp_avg_sq
  float* d;    // exp_avg_diff
  float* npg;  // neg_pre_grad: -g of the last step
  long long count;
  long long first;  // its first unit
  int vec;          // every pointer 16-byte aligned
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int num;
  long long units;
};

struct Step {
  const float* table;   // [rows, kCols]
  const long long* row; // the step's row
  long long rows;
  const bool* fresh;    // -g_prev is re-seeded from this g
  const float* clip;    // the global-norm clip factor, or null
  float b1, c1, b2, c2, b3, c3, eps;  // betas, 1 - betas, eps as float32
};

struct Scalars {
  float step_size, step_size_diff, bc3_inv, decay_inv, shrink, clip;
  bool fresh;
};

// One element: `_update` at optim/adan.py, in its order of operations.
template <bool kNoProx>
__device__ __forceinline__ void update(const Step& s, const Scalars& k, float& p, float g,
                                       float& m, float& n, float& d, float& npg) {
  if (s.clip != nullptr) g = __fmul_rn(g, k.clip);
  const float neg = -g;
  const float diff = __fadd_rn(k.fresh ? neg : npg, g);
  const float m_t = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  const float d_t = __fadd_rn(__fmul_rn(s.b2, d), __fmul_rn(s.c2, diff));
  const float u = __fadd_rn(g, __fmul_rn(s.b2, diff));
  const float n_t = __fadd_rn(__fmul_rn(s.b3, n), __fmul_rn(__fmul_rn(s.c3, u), u));
  const float denom = __fadd_rn(__fmul_rn(__fsqrt_rn(n_t), k.bc3_inv), s.eps);
  const float a = __fdiv_rn(__fmul_rn(k.step_size, m_t), denom);
  const float b = __fdiv_rn(__fmul_rn(k.step_size_diff, d_t), denom);
  float q;
  if (kNoProx) {
    q = __fsub_rn(__fsub_rn(__fmul_rn(p, k.shrink), a), b);
  } else {
    q = __fmul_rn(__fsub_rn(__fsub_rn(p, a), b), k.decay_inv);
  }
  p = q;
  m = m_t;
  n = n_t;
  d = d_t;
  npg = neg;
}

template <bool kNoProx>
__global__ void __launch_bounds__(kThreads)
    adan_kernel(const __grid_constant__ Leaves t, const __grid_constant__ Step s) {
  const long long r = *s.row;
  if (r < 0 || r >= s.rows) __trap();  // as index_select's device assert
  const float* row = s.table + r * kCols;
  const Scalars k{row[0], row[1], row[2], row[3], row[4],
                  s.clip != nullptr ? *s.clip : 1.0f, *s.fresh};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       u < t.units; u += stride) {
    int l = 0;
    while (l + 1 < t.num && u >= t.leaf[l + 1].first) ++l;
    const Leaf& f = t.leaf[l];
    const long long i = (u - f.first) * kPer;
    const long long left = f.count - i;
    if (f.vec && left >= kPer) {
      float4 p = *reinterpret_cast<const float4*>(f.p + i);
      const float4 g = *reinterpret_cast<const float4*>(f.g + i);
      float4 m = *reinterpret_cast<const float4*>(f.m + i);
      float4 n = *reinterpret_cast<const float4*>(f.n + i);
      float4 d = *reinterpret_cast<const float4*>(f.d + i);
      float4 npg = *reinterpret_cast<const float4*>(f.npg + i);
      update<kNoProx>(s, k, p.x, g.x, m.x, n.x, d.x, npg.x);
      update<kNoProx>(s, k, p.y, g.y, m.y, n.y, d.y, npg.y);
      update<kNoProx>(s, k, p.z, g.z, m.z, n.z, d.z, npg.z);
      update<kNoProx>(s, k, p.w, g.w, m.w, n.w, d.w, npg.w);
      *reinterpret_cast<float4*>(f.p + i) = p;
      *reinterpret_cast<float4*>(f.m + i) = m;
      *reinterpret_cast<float4*>(f.n + i) = n;
      *reinterpret_cast<float4*>(f.d + i) = d;
      *reinterpret_cast<float4*>(f.npg + i) = npg;
    } else {
      const int c = left < kPer ? static_cast<int>(left) : kPer;
#pragma unroll 1
      for (int j = 0; j < c; ++j) {
        const long long e = i + j;
        float p = f.p[e], m = f.m[e], n = f.n[e], d = f.d[e], npg = f.npg[e];
        update<kNoProx>(s, k, p, f.g[e], m, n, d, npg);
        f.p[e] = p;
        f.m[e] = m;
        f.n[e] = n;
        f.d[e] = d;
        f.npg[e] = npg;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// ptrs: 6 a leaf (p, g, m, n, d, npg); counts and firsts: a leaf's
// elements and first unit; units: every leaf's. table [rows, 5] float32,
// row int64, fresh bool and clip float32 (or null) are device pointers;
// consts: b1, 1 - b1, b2, 1 - b2, b3, 1 - b3, eps as float32.
GSVC_EXPORT int adan_update(int num, void* const* ptrs, const long long* counts,
                            const long long* firsts, long long units, const void* table,
                            long long rows, const void* row, const void* fresh,
                            const void* clip, const float* consts, int no_prox,
                            int max_blocks, void* stream) {
  if (num < 1 || num > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  if (units <= 0) return static_cast<int>(cudaGetLastError());
  Leaves t{};
  t.num = num;
  t.units = units;
  for (int l = 0; l < num; ++l) {
    void* const* q = ptrs + 6 * l;
    Leaf& f = t.leaf[l];
    f.p = static_cast<float*>(q[0]);
    f.g = static_cast<const float*>(q[1]);
    f.m = static_cast<float*>(q[2]);
    f.n = static_cast<float*>(q[3]);
    f.d = static_cast<float*>(q[4]);
    f.npg = static_cast<float*>(q[5]);
    f.count = counts[l];
    f.first = firsts[l];
    f.vec = 1;
    for (int j = 0; j < 6; ++j) f.vec &= aligned16(q[j]) ? 1 : 0;
  }
  const Step s{static_cast<const float*>(table), static_cast<const long long*>(row), rows,
               static_cast<const bool*>(fresh), static_cast<const float*>(clip),
               consts[0], consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  const long long want = (units + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (no_prox) {
    adan_kernel<true><<<blocks, kThreads, 0, st>>>(t, s);
  } else {
    adan_kernel<false><<<blocks, kThreads, 0, st>>>(t, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// P5: the job-based backward, a design study for K6's load imbalance.
// Replaces the variants of scripts/profile_bwd_variants.py (pallas_call at
// :109, bodies :123-243). The Python side, with the job list and the plain
// PyTorch version of each variant, is
// gsvc_tpu_torch/scripts/profile_bwd_variants.py.
//
// K6 (csrc/rasterize_bwd.cu) runs one CTA per tile and one thread per
// lane: a tile holds ~9.5 lanes on average at 1080p/10k, so most of each
// 256-thread CTA idles while a few threads walk all 256 pixels. Here a job
// is one tile's window of up to kWindow = 32 lanes (one warp's worth: the
// mean tile fits in one job, the 256 cap in 8), and a CTA of 256 threads
// takes one pixel each, so every thread works on every lane of the window.
// Each thread computes its pixel's contribution to each lane; the CTA sums
// them over pixels per lane with a fixed warp-shuffle tree, then across
// the 8 warps in shared memory in warp order. No float atomics: the result
// is deterministic, in another order than K6's (per-lane sums over
// pixels), so it matches K6 to rounding, not bitwise.
//
// Variants (the TPU's A-E, translated):
//   kA  load the job's lanes and write them to their expansion slots
//   kB  kA plus the tile's image gradient fetched, its sum added to each
//       value (so the fetch is used)
//   kC  full gradients, one CTA per tile walking its windows in order (the
//       GPU form of the TPU's "revisit out")
//   kD  full gradients, one CTA per job, each writing its lanes' slots
//   kE  sigma and exp only: sum over pixels of exp(-sigma) a lane, in
//       slot row 0
// kC and kD compute K6's function: [9, S] per-slot gradients, zero where
// no lane below the cap writes. Bound by the same per-pair FP32/SFU work as
// K6 plus 45 shuffles a lane a warp for the reduction.
#include "common.cuh"

namespace {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr int kBlock = 16;  // 16 x 16 tiles
constexpr int kThreads = kBlock * kBlock;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;
constexpr int kFields = 9;  // x y c1 c2 c3 opac r g b
enum Variant { kA = 0, kB = 1, kC = 2, kD = 3, kE = 4 };

struct Args {
  const int* tile_bin_start;
  const int* tile_counts;
  const int* gauss_ids;
  const int* gauss_slot_start;
  const int* bbox_pack;
  const float* xys;
  const float* conics;
  const float* colors;
  const float* opacity;
  const float* v_rows;
  const int* job_tile;
  const int* job_first;
  const int* job_count;
  int n, img_h, img_w, tb_x, cap, r_out;
  long long num_slots;
  float* out;
};

struct Shared {
  long long slot[kWindow];
  float lane[kFields][kWindow];
  float v[3][kThreads];
  float part[kWarps][kFields][kWindow];
  float red[kWarps + 1];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the warp's sum
}

// Threads k < count load lane k of the window: its splat's 9 fields and
// its expansion slot (-1 for lanes of no splat or out of range).
__device__ void load_lanes(const Args& a, Shared& sh, int tile, int first,
                           int count) {
  const int k = threadIdx.x;
  if (k >= count) return;
  const int tx = tile % a.tb_x, ty = tile / a.tb_x;
  const int g = a.gauss_ids[first + k];
  const bool real = g >= 0 && g < a.n;
  const int gs = real ? g : 0;
  sh.lane[0][k] = a.xys[2 * gs];
  sh.lane[1][k] = a.xys[2 * gs + 1];
  sh.lane[2][k] = a.conics[3 * gs];
  sh.lane[3][k] = a.conics[3 * gs + 1];
  sh.lane[4][k] = a.conics[3 * gs + 2];
  sh.lane[5][k] = real ? a.opacity[gs] : 0.0f;  // alpha 0 is below the cutoff
  sh.lane[6][k] = a.colors[3 * gs];
  sh.lane[7][k] = a.colors[3 * gs + 1];
  sh.lane[8][k] = a.colors[3 * gs + 2];
  long long slot = -1;
  if (real) {
    const int pack = a.bbox_pack[g];
    const int bw = pack >> 16, ty0 = (pack >> 8) & 0xFF, tx0 = pack & 0xFF;
    slot = static_cast<long long>(a.gauss_slot_start[g]) + (ty - ty0) * bw + (tx - tx0);
    if (slot >= a.num_slots) slot = -1;
  }
  sh.slot[k] = slot < 0 ? -1 : slot;
}

// The tile's image gradient from the rows layout, zero past the image edge
// (where the forward writes constants), one pixel a thread.
__device__ void load_grad(const Args& a, Shared& sh, int tile) {
  const int p = threadIdx.x;
  const int tx = tile % a.tb_x, ty = tile / a.tb_x;
  const int px = tx * kBlock + (p % kBlock), py = ty * kBlock + (p / kBlock);
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  if (px < a.img_w && py < a.img_h) {
    const long long i = (static_cast<long long>(ty) * a.r_out + 3 * tx) * kThreads + p;
    v0 = a.v_rows[i];
    v1 = a.v_rows[i + kThreads];
    v2 = a.v_rows[i + 2 * kThreads];
  }
  sh.v[0][p] = v0;
  sh.v[1][p] = v1;
  sh.v[2][p] = v2;
}

// Threads t < rows * count sum part[0..7][f][k] in warp order and write
// slot k's field f.
__device__ void write_parts(const Args& a, Shared& sh, int rows, int count) {
  for (int t = threadIdx.x; t < rows * count; t += kThreads) {
    const int f = t / count, k = t % count;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh.part[w][f][k];
    const long long slot = sh.slot[k];
    if (slot >= 0) a.out[f * a.num_slots + slot] = s;
  }
}

// kC / kD: each thread's pixel against each lane of the window (K6's
// per-pair math), reduced over pixels per lane.
__device__ void window_grads(const Args& a, Shared& sh, int tile, int count) {
  const int p = threadIdx.x, warp = p >> 5, lane = p & 31;
  const int tx = tile % a.tb_x, ty = tile / a.tb_x;
  const float fx = static_cast<float>(tx * kBlock + (p % kBlock));
  const float fy = static_cast<float>(ty * kBlock + (p / kBlock));
  const float vr = sh.v[0][p], vg = sh.v[1][p], vb = sh.v[2][p];
  for (int k = 0; k < count; ++k) {
    const float dx = sh.lane[0][k] - fx, dy = sh.lane[1][k] - fy;
    const float c1 = sh.lane[2][k], c2 = sh.lane[3][k], c3 = sh.lane[4][k];
    const float sigma = 0.5f * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy;
    const float vis = expf(-sigma);
    const float alpha_u = sh.lane[5][k] * vis;
    const float alpha = fminf(1.0f, alpha_u);
    float g[kFields] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (sigma >= 0.0f && alpha >= kAlphaCutoff) {
      const float v_alpha = sh.lane[6][k] * vr + sh.lane[7][k] * vg + sh.lane[8][k] * vb;
      const float v_sigma = -alpha_u * v_alpha;  // the min(1, .) is forward-only
      g[0] = (c1 * dx + c2 * dy) * v_sigma;
      g[1] = (c3 * dy + c2 * dx) * v_sigma;
      g[2] = 0.5f * dx * dx * v_sigma;
      g[3] = dx * dy * v_sigma;  // unhalved: autograd through inv(cov)
      g[4] = 0.5f * dy * dy * v_sigma;
      g[5] = vis * v_alpha;
      g[6] = alpha * vr;
      g[7] = alpha * vg;
      g[8] = alpha * vb;
    }
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const float s = warp_sum(g[f]);
      if (lane == 0) sh.part[warp][f][k] = s;
    }
  }
  __syncthreads();
  write_parts(a, sh, kFields, count);
}

// kE: sum over the tile's pixels of exp(-sigma) a lane.
__device__ void window_exp(const Args& a, Shared& sh, int tile, int count) {
  const int p = threadIdx.x, warp = p >> 5, lane = p & 31;
  const int tx = tile % a.tb_x, ty = tile / a.tb_x;
  const float fx = static_cast<float>(tx * kBlock + (p % kBlock));
  const float fy = static_cast<float>(ty * kBlock + (p / kBlock));
  for (int k = 0; k < count; ++k) {
    const float dx = sh.lane[0][k] - fx, dy = sh.lane[1][k] - fy;
    const float sigma = 0.5f * (sh.lane[2][k] * dx * dx + sh.lane[4][k] * dy * dy) +
                        sh.lane[3][k] * dx * dy;
    const float s = warp_sum(expf(-sigma));
    if (lane == 0) sh.part[warp][0][k] = s;
  }
  __syncthreads();
  write_parts(a, sh, 1, count);
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads) jobs_kernel(Args a) {
  __shared__ Shared sh;
  int tile, first, total;
  if (kVariant == kC) {
    tile = blockIdx.x;
    first = a.tile_bin_start[tile];
    total = min(a.tile_counts[tile], a.cap);
  } else {
    tile = a.job_tile[blockIdx.x];
    first = a.job_first[blockIdx.x];
    total = a.job_count[blockIdx.x];
  }
  if (kVariant == kB || kVariant == kC || kVariant == kD) load_grad(a, sh, tile);
  if (kVariant == kB) {
    // the tile's gradient sum, in a fixed order
    const int p = threadIdx.x;
    const float s = warp_sum(sh.v[0][p] + sh.v[1][p] + sh.v[2][p]);
    if ((p & 31) == 0) sh.red[p >> 5] = s;
    __syncthreads();
    if (p == 0) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t += sh.red[w];
      sh.red[kWarps] = t;
    }
  }
  for (int w0 = 0; w0 < total; w0 += kWindow) {
    const int count = min(kWindow, total - w0);
    load_lanes(a, sh, tile, first + w0, count);
    __syncthreads();
    if (kVariant == kA || kVariant == kB) {
      const int k = threadIdx.x;
      const float add = kVariant == kB ? sh.red[kWarps] : 0.0f;
      if (k < count && sh.slot[k] >= 0) {
        for (int f = 0; f < kFields; ++f) a.out[f * a.num_slots + sh.slot[k]] = sh.lane[f][k] + add;
      }
    } else if (kVariant == kE) {
      window_exp(a, sh, tile, count);
    } else {
      window_grads(a, sh, tile, count);
    }
    __syncthreads();  // the next window reuses the lanes, slots and parts
  }
}

}  // namespace

GSVC_EXPORT int backward_jobs(
    const void* tile_bin_start, const void* tile_counts, const void* gauss_ids,
    const void* gauss_slot_start, const void* bbox_pack, const void* xys,
    const void* conics, const void* colors, const void* opacity,
    const void* v_rows, const void* job_tile, const void* job_first,
    const void* job_count, int n, int img_h, int img_w, int tb_x, int tb_y,
    int cap, int r_out, long long num_slots, int num_jobs, int variant,
    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int*>(tile_bin_start), static_cast<const int*>(tile_counts),
         static_cast<const int*>(gauss_ids), static_cast<const int*>(gauss_slot_start),
         static_cast<const int*>(bbox_pack), static_cast<const float*>(xys),
         static_cast<const float*>(conics), static_cast<const float*>(colors),
         static_cast<const float*>(opacity), static_cast<const float*>(v_rows),
         static_cast<const int*>(job_tile), static_cast<const int*>(job_first),
         static_cast<const int*>(job_count), n, img_h, img_w, tb_x, cap, r_out,
         num_slots, static_cast<float*>(out)};
  const int grid = variant == kC ? tb_x * tb_y : num_jobs;
  if (grid <= 0 || num_slots <= 0) return static_cast<int>(cudaGetLastError());
  switch (variant) {
    case kA: jobs_kernel<kA><<<grid, kThreads, 0, s>>>(a); break;
    case kB: jobs_kernel<kB><<<grid, kThreads, 0, s>>>(a); break;
    case kC: jobs_kernel<kC><<<grid, kThreads, 0, s>>>(a); break;
    case kD: jobs_kernel<kD><<<grid, kThreads, 0, s>>>(a); break;
    case kE: jobs_kernel<kE><<<grid, kThreads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

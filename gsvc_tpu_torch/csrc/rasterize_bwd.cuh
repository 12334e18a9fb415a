// The backward sum-rasterizer's kernel, shared by K6 (rasterize_bwd.cu,
// the chosen pixel split, three gradient layouts) and P5's variants F and G
// (profile_bwd_variants.cu: both splits, the rows layout), so that P5
// measures the kernel that runs.
//
// Design, for the H100. The first port ran a thread per lane over the
// tile's 256 pixels: ~9.5 lanes a tile at 1080p/10k, so ~10 busy threads
// in each 256-thread CTA and a latency-bound serial loop (3.3 % of its
// bound). P5's thread per pixel (C, D) fills the CTA but pays a 9 x 5
// shuffle tree on every lane in every warp. Here a CTA of 4 warps takes a
// tile, a lane goes to a group of kSplit threads of one warp (32: a warp a
// lane; 16: two lanes a warp), and each thread owns 256 / kSplit fixed
// pixels of the tile:
//  - the tile's image gradient is read once, in the layout the forward
//    wrote (zero past the image edge, where the forward writes constants),
//    through shared memory into registers, 3 x 256 / kSplit values a
//    thread, kept for every lane the thread handles;
//  - the tile's first min(count, cap) lanes are staged in shared memory
//    (one thread a lane: the splat's 9 fields and its expansion slot), and
//    read back by each group at one address (a broadcast);
//  - warp w takes lanes w * 32 / kSplit + (its group), stepping by
//    4 * 32 / kSplit; each thread sums its pixels in a fixed order into 9
//    registers, one fixed __shfl_xor_sync tree reduces the group, and the
//    group's first thread writes the lane's 9 gradients to its slot;
//  - 4 warps a CTA (not 8) and at most 64 registers a thread: 8 CTAs an
//    SM, each over ~2.4 lanes a warp at 1080p/10k rather than ~1.2, so a
//    tile's last warp holds its CTA's slot for less time.
// Shared bytes: 3 x 256 x 4 + 48 x cap (15 KiB at cap 256;
// rasterize_cuda.backward_smem_bytes). Deterministic: a fixed order
// everywhere, no atomics. The per-pair arithmetic is the first port's,
// expression for expression: a few ulp in sigma would flip the alpha gate
// (alpha >= 1/255) on pairs at the threshold, and the gate must agree with
// the forward's (rasterize_fwd.cuh).
#pragma once

#include "common.cuh"

namespace gsvc_bwd {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr int kTile = 16;                 // 16x16-pixel tiles
constexpr int kPixels = kTile * kTile;    // 256
constexpr int kThreads = 128;             // 4 warps
constexpr int kMinBlocks = 8;             // CTAs an SM: at most 64 registers a thread
constexpr int kWarps = kThreads / 32;
enum Layout { kImage = 0, kChw = 1, kRows = 2 };

// One lane in shared memory: x y c1 c2 | c3 opac r g | b, its slot (-1:
// no slot, or no splat).
struct __align__(16) Lane {
  float4 a;
  float4 b;
  float cb;
  int pad;
  long long slot;
};

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
  const float* v_out;
  int n, img_h, img_w, tb_x, cap, r_out;
  long long num_slots;
  float* out;
  // the span of tile rows the gradient covers, [row0, row0 + gridDim.y)
  // of the tb_y grid rows, and the pixel rows of its image / chw layout
  // (the whole grid: 0, img_h)
  int row0, tb_y, out_h;
};

// kFast: the fast-colour mode's alpha, __expf(-sigma) (ex2.approx of
// -sigma * log2(e)), as its forward (forward_kernel<layout, kFastExp>) took.
template <int kLayout, int kSplit, bool kFast = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks) backward_kernel(Args a) {
  static_assert(kSplit == 16 || kSplit == 32, "a lane takes half a warp or a warp");
  constexpr int kPer = kPixels / kSplit;              // pixels a thread
  constexpr int kGroups = 32 / kSplit;                // lanes a warp at once
  constexpr int kStride = kWarps * kGroups;           // lanes a CTA at once
  extern __shared__ float4 smem[];
  float* const sv = reinterpret_cast<float*>(smem);  // [3][256]: the tile's gradient
  Lane* const lanes = reinterpret_cast<Lane*>(smem + 3 * kPixels / 4);  // [cap]
  const int tx = blockIdx.x;
  const int ly = blockIdx.y;     // the tile's row in the span (the gradient's)
  const int ty = a.row0 + ly;    // and in the grid
  if (ty >= a.tb_y) return;      // a span's row past the grid holds no lanes
  const int tile = ty * a.tb_x + tx;
  const int start = a.tile_bin_start[tile];
  const int count = min(a.tile_counts[tile], a.cap);

  for (int p = threadIdx.x; p < kPixels; p += kThreads) {
    const int px = tx * kTile + p % kTile;
    const int py = ly * kTile + p / kTile;  // the gradient's pixel row
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    if (px < a.img_w && ty * kTile + p / kTile < a.img_h) {
      if (kLayout == kImage) {
        const long long i = 3LL * (static_cast<long long>(py) * a.img_w + px);
        v0 = a.v_out[i];
        v1 = a.v_out[i + 1];
        v2 = a.v_out[i + 2];
      } else if (kLayout == kChw) {
        const long long plane = static_cast<long long>(a.out_h) * a.img_w;
        const long long i = static_cast<long long>(py) * a.img_w + px;
        v0 = a.v_out[i];
        v1 = a.v_out[plane + i];
        v2 = a.v_out[2 * plane + i];
      } else {
        const long long i = (static_cast<long long>(ly) * a.r_out + 3 * tx) * kPixels + p;
        v0 = a.v_out[i];
        v1 = a.v_out[i + kPixels];
        v2 = a.v_out[i + 2 * kPixels];
      }
    }
    sv[p] = v0;
    sv[kPixels + p] = v1;
    sv[2 * kPixels + p] = v2;
  }
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int g = a.gauss_ids[start + k];
    Lane l;
    l.a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    l.b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // opacity 0: every pair fails the gate
    l.cb = 0.0f;
    l.pad = 0;
    l.slot = -1;
    if (g >= 0 && g < a.n) {
      l.a = make_float4(a.xys[2 * g], a.xys[2 * g + 1], a.conics[3 * g], a.conics[3 * g + 1]);
      l.b = make_float4(a.conics[3 * g + 2], a.opacity[g], a.colors[3 * g],
                        a.colors[3 * g + 1]);
      l.cb = a.colors[3 * g + 2];
      // expansion slot: the tile's row-major rank inside g's tile bbox
      const int pack = a.bbox_pack[g];
      const int bw = pack >> 16, ty0 = (pack >> 8) & 0xFF, tx0 = pack & 0xFF;
      const long long slot =
          static_cast<long long>(a.gauss_slot_start[g]) + (ty - ty0) * bw + (tx - tx0);
      if (slot >= 0 && slot < a.num_slots) l.slot = slot;
    }
    lanes[k] = l;
  }
  __syncthreads();

  const int wl = threadIdx.x % 32;
  const int sub = wl % kSplit;  // the thread's place in its lane's group
  // this thread's pixels p = i * kSplit + sub, their gradient in registers
  float vr[kPer], vg[kPer], vb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = i * kSplit + sub;
    vr[i] = sv[p];
    vg[i] = sv[kPixels + p];
    vb[i] = sv[2 * kPixels + p];
  }
  const float fx0 = static_cast<float>(tx * kTile);
  const float fy0 = static_cast<float>(ty * kTile);
  // warp-uniform: a group whose lane is past the count computes a lane of
  // opacity 0 and writes nothing, so the whole warp takes the shuffles
  for (int k0 = (threadIdx.x / 32) * kGroups; k0 < count; k0 += kStride) {
    const int k = k0 + wl / kSplit;
    const bool have = k < count;
    const Lane& l = lanes[have ? k : k0];
    const float4 l0 = l.a, l1 = l.b;
    const float x = l0.x, y = l0.y, c1 = l0.z, c2 = l0.w, c3 = l1.x;
    const float op = have ? l1.y : 0.0f;
    const float cr = l1.z, cg = l1.w, cb = l.cb;
    float v_x = 0.0f, v_y = 0.0f, v_c1 = 0.0f, v_c2 = 0.0f, v_c3 = 0.0f;
    float v_op = 0.0f, v_r = 0.0f, v_g = 0.0f, v_b = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = i * kSplit + sub;
      const float dy = y - (fy0 + static_cast<float>(p / kTile));
      const float dx = x - (fx0 + static_cast<float>(p % kTile));
      const float sigma = 0.5f * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy;
      const float vis = kFast ? __expf(-sigma) : expf(-sigma);
      const float alpha_u = op * vis;
      const float alpha = fminf(1.0f, alpha_u);
      if (sigma >= 0.0f && alpha >= kAlphaCutoff) {
        const float v_alpha = cr * vr[i] + cg * vg[i] + cb * vb[i];
        // the min(1, .) is forward-only (backward.cu:824-837)
        const float v_sigma = -alpha_u * v_alpha;
        v_r += alpha * vr[i];
        v_g += alpha * vg[i];
        v_b += alpha * vb[i];
        v_op += vis * v_alpha;
        v_c1 += 0.5f * dx * dx * v_sigma;
        v_c2 += dx * dy * v_sigma;  // unhalved: autograd through inv(cov)
        v_c3 += 0.5f * dy * dy * v_sigma;
        v_x += (c1 * dx + c2 * dy) * v_sigma;
        v_y += (c3 * dy + c2 * dx) * v_sigma;
      }
    }
    float vals[9] = {v_x, v_y, v_c1, v_c2, v_c3, v_op, v_r, v_g, v_b};
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int f = 0; f < 9; ++f) vals[f] += __shfl_xor_sync(0xffffffffu, vals[f], off);
    }
    if (have && sub == 0 && l.slot >= 0) {
#pragma unroll
      for (int f = 0; f < 9; ++f) a.out[f * a.num_slots + l.slot] = vals[f];
    }
  }
}

// Launch backward_kernel<kLayout, kSplit, kFast>, one CTA a tile of the span's
// num_rows rows (the whole grid: a.row0 = 0, num_rows = a.tb_y); the caller
// zero-fills out, so slots of lanes past the cap, and of tiles outside the
// span, stay exactly 0. Returns cudaGetLastError().
template <int kLayout, int kSplit, bool kFast = false>
int launch_backward(const Args& a, int num_rows, cudaStream_t stream) {
  if (a.tb_x <= 0 || num_rows <= 0 || a.num_slots <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 3 * kPixels + sizeof(Lane) * static_cast<size_t>(a.cap);
  backward_kernel<kLayout, kSplit, kFast>
      <<<dim3(a.tb_x, num_rows), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsvc_bwd

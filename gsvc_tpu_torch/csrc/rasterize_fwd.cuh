// The forward sum-rasterizer's kernel, shared by K4/K5 (rasterize_fwd.cu:
// the three stores, kFull, and kFastExp in the fast-colour mode) and P1's
// ablations (profile_kernel_parts.cu:
// kFull and five variants of the inner loop, the rows store), so that P1's
// `full` is K4 by construction.
//
// Design, for the H100. The work is ~17 FP32 operations and one expf a
// (pixel, lane) pair, ~2e7 pairs at 1080p/10k, and the kernel is bound by
// issuing them (its bound by bytes is 29 % of its time). The first port (a
// CTA per tile, a thread per pixel) issued 39 instructions a pair, 9 of
// them scalar shared-memory loads, and its 9 KiB of lanes a CTA and
// tiles of ~9.5 lanes left the SMs short of warps. Here:
//  - a lane is staged as three 16-byte words (x y c1 c2 | c3 opac r g |
//    b), read back with two 16-byte loads and one 4-byte load, all threads
//    at one address (a broadcast);
//  - a thread computes kPix = 4 pixels of one column of the 16x16 tile,
//    rows ly, ly + 4, ly + 8 and ly + 12, so each lane load serves four
//    pairs and the column's terms of sigma are shared (64 threads a CTA;
//    4 pixels measured ~5 % faster than 2 on the bench scene);
//  - CTA b of a grid of G takes tiles b, b + G, b + 2G, ... in that static
//    order (no atomic tile counter), a tile's lanes in chunks of kChunk =
//    32, and gathers the next chunk (of this tile or of the next) with
//    cp.async into the second of two shared buffers while the current one
//    computes. Shared bytes: 2 x 32 x 48 = 3 KiB whatever the cap, so
//    registers (48 a thread: 21 CTAs an SM), not shared memory, bound the
//    CTAs an SM holds. G is 32 CTAs an SM (rasterize_cuda.forward_grid),
//    more than stay resident: the block scheduler hands the queued ones
//    to the SMs that finish first, which balances the tiles' uneven lane
//    counts. On the bench scene a grid of 12 CTAs an SM, all resident,
//    took 7 % longer than 32; 64 (a tile a CTA, nothing to prefetch) took
//    as long as 32.
// Each pixel sums rgb * alpha over the tile's first min(count, cap) lanes
// in lane order, in f32 registers: deterministic, no atomics. The per-pair
// arithmetic is the first port's, expression for expression (the alpha
// gate must agree with the backward's, rasterize_bwd.cuh).
//
// The eval render's epilogue (kClip, the image and chw stores in kFull):
// the store writes the final image, clamp(blend_background(raw), 0, 1) of
// ops/rasterize.py on the default background (ones), in place of the raw
// sum, so the render leaves no image-sized pass behind it (as PyTorch ops
// the chain is three, each a read and a write of the image, ~3x this
// kernel's time at 1080p). It reads the binning's kept total from device
// memory at each tile's store, so a launch needs no host read and stays
// capturable. Where the frame kept an intersection (every thread alike) a
// value is clamped in two instructions; where it kept none, the chain's
// v * 0 + 1 is one FMA more. Each op rounds as PyTorch's kernel does:
// bitwise the chain, NaN passed on as torch.clamp passes it. On the bench
// scene (H100) the epilogue costs K5 ~1 us of ~27: read once a CTA into
// shared memory it cost 0.2 us more, as one FMA a value (no branch) 0.5
// more.
#pragma once

#include "common.cuh"

namespace gsvc_fwd {

constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 16;                        // 16x16-pixel tiles
constexpr int kPix = 4;                          // pixels a thread
constexpr int kRowStep = kTile / kPix;           // its rows ly, ly + 4, ly + 8, ly + 12
constexpr int kThreads = kTile * kTile / kPix;   // 64
constexpr int kChunk = 32;                       // lanes staged at a time
enum Layout { kImage = 0, kChw = 1, kRows = 2 };
// P1's variants of the inner loop (profile_kernel_parts.cu); K4/K5 run kFull,
// and kFastExp in the fast-colour mode (rasterize_fwd.cu).
enum Variant { kFull = 0, kNoSigma = 1, kNoExp = 2, kNoAcc = 3, kFastExp = 4, kExp2 = 5 };

// One lane in shared memory: x y c1 c2 | c3 opac r g | b and 3 unused.
struct __align__(16) Lane {
  float4 a;
  float4 b;
  float4 c;
};

// The kernel renders a span of tile rows, [row0, row0 + num_tiles / tb_x)
// of the grid's; a tile's index is its place in the span (local), its
// grid tile (row0 + local row) * tb_x + x. The whole grid is row0 = 0,
// num_tiles = grid_tiles, out_h = img_h.
struct Args {
  const int* tile_bin_start;
  const int* tile_counts;
  const int* gauss_ids;
  const float* xys;
  const float* conics;
  const float* colors;
  const float* opacity;
  int n, img_h, img_w, tb_x, num_tiles, cap, r_out;
  float* out;
  int row0;        // the span's first tile row
  int grid_tiles;  // tb_x * tb_y: a grid tile at or past it is empty
  int out_h;       // pixel rows of the image / chw store (img_h for the grid)
  const int* total;  // kClip: the binning's kept intersections, one int32
};

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Stage lanes [first, first + count) of the binning into buf: the TPU
// path's _pack_lanes gather, as cp.async copies.
__device__ __forceinline__ void gather_lanes(const Args& a, Lane* buf, int first,
                                             int count) {
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int g = a.gauss_ids[first + k];
    const bool real = g >= 0 && g < a.n;
    const int gs = real ? g : 0;
    float* d = reinterpret_cast<float*>(buf + k);
    cp_async4(d + 0, a.xys + 2 * gs, 4);
    cp_async4(d + 1, a.xys + 2 * gs + 1, 4);
    cp_async4(d + 2, a.conics + 3 * gs, 4);
    cp_async4(d + 3, a.conics + 3 * gs + 1, 4);
    cp_async4(d + 4, a.conics + 3 * gs + 2, 4);
    cp_async4(d + 5, a.opacity + gs, real ? 4 : 0);  // alpha 0 is below the cutoff
    cp_async4(d + 6, a.colors + 3 * gs, 4);
    cp_async4(d + 7, a.colors + 3 * gs + 1, 4);
    cp_async4(d + 8, a.colors + 3 * gs + 2, 4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A chunk of a tile's lanes: lanes [k0, min(k0 + kChunk, count)) of the
// tile's run, which starts at lane `start` and holds `count` (capped).
struct Chunk {
  int tile, start, count, k0;
  __device__ int lanes() const { return min(kChunk, count - k0); }
  __device__ bool last() const { return k0 + kChunk >= count; }
};

// The run of the span's tile `tile`; a tile past the span, or one whose
// grid tile lies past the grid (a span's rows past tb_y), is {tile, 0, 0, 0}.
__device__ __forceinline__ Chunk first_chunk(const Args& a, int tile) {
  Chunk c{tile, 0, 0, 0};
  const int grid_tile = a.row0 * a.tb_x + tile;
  if (tile < a.num_tiles && grid_tile < a.grid_tiles) {
    c.start = a.tile_bin_start[grid_tile];
    c.count = min(a.tile_counts[grid_tile], a.cap);
  }
  return c;
}

// torch.clamp(v, 0, 1) of one stored value in the epilogue: max.NaN /
// min.NaN pass a NaN on as torch.clamp's isnan test does (every NaN the
// card's arithmetic makes is the canonical one, the bits torch.clamp hands
// back). v is never -0 (a sum from +0, or +0 past the image), so the two
// signed zeros never meet in max / min.
__device__ __forceinline__ float clamp01(float v) {
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(v));
  asm("min.NaN.f32 %0, %0, 0f3F800000;" : "+f"(y));
  return y;
}

template <int kLayout, int kVariant, bool kClip = false>
__global__ void __launch_bounds__(kThreads) forward_kernel(Args a) {
  __shared__ Lane bufs[2][kChunk];
  __shared__ float s_sum[3];  // kNoAcc: the tile's colour sums
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const int stride = gridDim.x;

  // cur is computed from its staged lanes while nxt's are gathered; the
  // tile after nxt's tile has its run loaded a chunk ahead (after)
  Chunk cur = first_chunk(a, blockIdx.x);
  if (cur.tile >= a.num_tiles) return;
  gather_lanes(a, bufs[0], cur.start, cur.lanes());
  Chunk after = first_chunk(a, cur.tile + stride);
  Chunk nxt = cur;
  nxt.k0 += kChunk;
  if (cur.last()) {
    nxt = after;
    after = first_chunk(a, nxt.tile + stride);
  }

  float acc[kPix][3];
  float wsum[kPix];
  float csum[3] = {0.0f, 0.0f, 0.0f};  // kNoAcc: warp 0's colour sums
#pragma unroll
  for (int j = 0; j < kPix; ++j) acc[j][0] = acc[j][1] = acc[j][2] = wsum[j] = 0.0f;
  for (int it = 0;; ++it) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // this chunk's lanes are in place; every thread is done with the other
    // buffer (the previous chunk), so the next chunk's gather may fill it
    __syncthreads();
    const Lane* lanes = bufs[it & 1];
    if (nxt.tile < a.num_tiles) {
      gather_lanes(a, bufs[(it + 1) & 1], nxt.start + nxt.k0, nxt.lanes());
    }
    Chunk nxt2 = nxt, after2 = after;  // the chunk after nxt, and the tile after its tile
    nxt2.k0 += kChunk;
    if (nxt.last()) {
      nxt2 = after;
      after2 = first_chunk(a, nxt2.tile + stride);
    }
    const int count = cur.lanes();
    if (kVariant == kNoAcc) {
      // the tile's colour sums, by warp 0 in a fixed order: thread t adds
      // lanes t, t + 32, ... of the tile, then one shuffle tree
      if (threadIdx.x < 32) {
        for (int k = threadIdx.x; k < count; k += 32) {
          csum[0] += lanes[k].b.z;
          csum[1] += lanes[k].b.w;
          csum[2] += lanes[k].c.x;
        }
        if (cur.last()) {
          float r = csum[0], g = csum[1], b = csum[2];
          for (int off = 16; off > 0; off >>= 1) {
            r += __shfl_down_sync(0xffffffffu, r, off);
            g += __shfl_down_sync(0xffffffffu, g, off);
            b += __shfl_down_sync(0xffffffffu, b, off);
          }
          if (threadIdx.x == 0) {
            s_sum[0] = r;
            s_sum[1] = g;
            s_sum[2] = b;
          }
          csum[0] = csum[1] = csum[2] = 0.0f;
        }
      }
      if (cur.last()) __syncthreads();
    }

    // ty: the tile's row in the span (the store's), gy: in the grid
    const int tx = cur.tile % a.tb_x, ty = cur.tile / a.tb_x;
    const int gy = a.row0 + ty;
    const float ox = static_cast<float>(tx * kTile);
    const float oy = static_cast<float>(gy * kTile);
    const float fx = static_cast<float>(tx * kTile + lx);
    float fy[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) fy[j] = static_cast<float>(gy * kTile + ly + j * kRowStep);
    for (int k = 0; k < count; ++k) {
      const float4 l0 = lanes[k].a;  // x y c1 c2
      const float4 l1 = lanes[k].b;  // c3 opac r g
      const float cb = lanes[k].c.x;
      float c1 = l0.z, c2 = l0.w, c3 = l1.x;
      if (kVariant == kExp2) {  // conics pre-scaled by log2(e)
        c1 *= kLog2e;
        c2 *= kLog2e;
        c3 *= kLog2e;
      }
      float sigma0 = 0.0f;
      if (kVariant == kNoSigma) {  // the lane's sigma at the tile origin
        const float gx = l0.x - ox, gy = l0.y - oy;
        sigma0 = 0.5f * (c1 * gx * gx + c3 * gy * gy) + c2 * gx * gy;
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float sigma;
        if (kVariant == kNoSigma) {
          sigma = 0.01f * sigma0;
        } else {
          const float dx = l0.x - fx;
          const float dy = l0.y - fy[j];
          sigma = 0.5f * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy;
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
        const float alpha = fminf(1.0f, l1.y * vis);
        const bool valid = sigma >= 0.0f && alpha >= kAlphaCutoff;
        if (kVariant == kNoAcc) {
          wsum[j] += valid ? alpha : 0.0f;
        } else if (valid) {
          acc[j][0] += l1.z * alpha;
          acc[j][1] += l1.w * alpha;
          acc[j][2] += cb * alpha;
        }
      }
    }

    if (cur.last()) {
      const bool live = !kClip || __ldg(a.total) >= 1;  // kClip: the frame kept one
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (kVariant == kNoAcc) {
          acc[j][0] = wsum[j] * s_sum[0] * 1e-6f;
          acc[j][1] = wsum[j] * s_sum[1] * 1e-6f;
          acc[j][2] = wsum[j] * s_sum[2] * 1e-6f;
        }
        const int row = ly + j * kRowStep;
        const int px = tx * kTile + lx;
        const int py = ty * kTile + row;  // the store's pixel row
        // zero past the image edge (the grid's pixel row gy * 16 + row),
        // as image_to_rows pads; for the grid, the store's rows past img_h
        // are not stored at all
        const bool inside = px < a.img_w && gy * kTile + row < a.img_h;
        if (kLayout == kRows) {
          // row ty*r_out + 3*tx + c, column row*16 + lx
          constexpr long long kNpix = kTile * kTile;
          const long long base =
              (static_cast<long long>(ty) * a.r_out + 3 * tx) * kNpix + row * kTile + lx;
          a.out[base] = inside ? acc[j][0] : 0.0f;
          a.out[base + kNpix] = inside ? acc[j][1] : 0.0f;
          a.out[base + 2 * kNpix] = inside ? acc[j][2] : 0.0f;
        } else if (px < a.img_w && py < a.out_h) {
          const long long pix = static_cast<long long>(py) * a.img_w + px;
          float r = inside ? acc[j][0] : 0.0f;
          float g = inside ? acc[j][1] : 0.0f;
          float b = inside ? acc[j][2] : 0.0f;
          // the span's pixels past the image too, as the chain's: v * live +
          // 1 * (1 - live) is v where live (v * 1 + 0, v never -0) and
          // v * 0 + 1 where not (one rounding: v * 0 is exact)
          if (kClip && live) {
            r = clamp01(r);
            g = clamp01(g);
            b = clamp01(b);
          } else if (kClip) {
            r = clamp01(__fmaf_rn(r, 0.0f, 1.0f));
            g = clamp01(__fmaf_rn(g, 0.0f, 1.0f));
            b = clamp01(__fmaf_rn(b, 0.0f, 1.0f));
          }
          if (kLayout == kChw) {
            const long long plane = static_cast<long long>(a.out_h) * a.img_w;
            a.out[pix] = r;
            a.out[plane + pix] = g;
            a.out[2 * plane + pix] = b;
          } else {
            a.out[3 * pix] = r;
            a.out[3 * pix + 1] = g;
            a.out[3 * pix + 2] = b;
          }
        }
        acc[j][0] = acc[j][1] = acc[j][2] = wsum[j] = 0.0f;
      }
    }

    if (nxt.tile >= a.num_tiles) break;
    cur = nxt;
    nxt = nxt2;
    after = after2;
  }
}

// Launch forward_kernel<kLayout, kVariant, kClip> on a grid of `grid` CTAs;
// returns cudaGetLastError().
template <int kLayout, int kVariant, bool kClip = false>
int launch_forward(const Args& a, int grid, cudaStream_t stream) {
  static_assert(!kClip || (kLayout != kRows && kVariant == kFull),
                "the epilogue is the exact image and chw stores' (rows: E1, rows_loss.cu)");
  if (a.num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (grid <= 0 || grid > a.num_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (kClip && a.total == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  forward_kernel<kLayout, kVariant, kClip><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsvc_fwd

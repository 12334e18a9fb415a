// Tile-binning index kernels: K1 (fill/decode sort keys) and K2 (rank/cap
// decode of the sorted keys, with the tile edges). Replace
// gsvc_tpu/ops/fill_pallas.py `_fill_kernel` / `fill_decode_keys` and
// `_rank_kernel` / `rank_cap_decode`. The Python side, with the plain PyTorch
// versions and the design note, is gsvc_tpu_torch/ops/fill_cuda.py.
//
// Keys are (tile << gauss_bits | gauss), laid out by fill_cuda.key_layout:
// the gauss field is max(16, bit length of n) bits, its all-ones value the
// sentinel of a slot past the kept total (>= n, never a real id), and the
// keys int32 where the sentinel key (num_tiles << gauss_bits | sentinel) fits
// 31 bits, int64 above. Both kernels are templates on the key type and take
// the field's width at run time; below 65,536 splats it is 16, the JAX
// package's uint32 keys.
//
// K1 is one launch, one CTA per block of kSlots consecutive output slots;
// what bounds it is bytes (16 n + 4 + 4 S at int32 keys, 0.15 us) and, far
// above that, the latency of dependent loads, which the design holds to two
// rounds. In the first, a CTA reads the kept total and brackets the owners
// of its first and last slot by one 256-way round of search over `starts`
// (every thread tests one sample, one barrier counts them). In the second it
// stages the bracketed gaussians in shared memory (start, tile bbox origin
// and width: ~200 at 1080p/10k), and each thread finds its kPer consecutive
// slots' owners there by a binary search and writes the keys as one vector
// store. Slots at or past the kept total get the sentinel; a block wholly
// past it writes only sentinels.
//
// K2 is one launch, one CTA per block of kSlots consecutive lanes, and
// writes the tile and gauss ids of every lane and the [T + 1] tile edges
// (edge u: the first lane whose tile is >= u). Bytes bound it: a key read
// and two ids written a lane plus 4 (T + 1) bytes of edges, 12 x 81,920 +
// 4 x 8,161 = 1.02 MB at 1080p/10k with int32 keys, 0.0003 ms at 3.35 TB/s,
// far under one launch, so the design is one launch with one round of
// independent loads and no carry between blocks. Each thread loads its kPer
// keys as one vector and the kPer keys `cap` lanes back as another; the keys
// are sorted, so a lane's rank in its tile run reaches the cap exactly when
// the lane `cap` back holds the same tile, which needs no run start. A lane
// whose tile t differs from its predecessor's p (p = -1 before lane 0)
// writes edge u = its lane for every u in (p, t], and the thread holding
// the last lane writes the count into (t, T]: every edge is written once,
// by one thread, with no atomics. A gap of more than kShortGap edges (empty
// tiles: all T + 1 of them with no splats) is written by its whole warp.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // consecutive slots a thread
constexpr int kSlots = kThreads * kPer;
constexpr int kWindow = 1024;  // gaussians staged at once
constexpr unsigned kFull = 0xffffffffu;

// One 256-way round of the search for the last g with starts[g] <= key
// (starts is non-decreasing, starts[0] = 0 <= a <= b): every thread tests
// the sample at its index times the step against both keys and one barrier
// counts the samples at or below each. The owner of a lies in
// [lo_a, lo_a + step) and that of b in [lo_b, lo_b + step), so
// [lo_a, min(lo_b + step, n)) holds every owner between them. Called by the
// whole CTA.
__device__ int2 bracket(const int* __restrict__ starts, int n, long long a,
                        long long b, int* s_cnt) {
  const int step = (n + kThreads - 1) / kThreads;
  const int idx = threadIdx.x * step;
  const int v = idx < n ? starts[idx] : INT_MAX;
  const int ca = __popc(__ballot_sync(kFull, v <= a));
  const int cb = __popc(__ballot_sync(kFull, v <= b));
  if ((threadIdx.x & 31) == 0) {
    s_cnt[threadIdx.x >> 5] = ca;
    s_cnt[kWarps + (threadIdx.x >> 5)] = cb;
  }
  __syncthreads();
  int na = 0, nb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    na += s_cnt[w];
    nb += s_cnt[kWarps + w];
  }
  return make_int2((na - 1) * step, min(nb * step, n));
}

template <typename Key>
__device__ __forceinline__ void store_keys(Key* keys, long long i, long long count,
                                           const Key (&k)[kPer]);

template <>
__device__ __forceinline__ void store_keys<int>(int* keys, long long i, long long count,
                                                const int (&k)[kPer]) {
  if (i + kPer <= count) {
    *reinterpret_cast<int4*>(keys + i) = make_int4(k[0], k[1], k[2], k[3]);
  } else {
    for (int j = 0; j < kPer && i + j < count; ++j) keys[i + j] = k[j];
  }
}

template <>
__device__ __forceinline__ void store_keys<long long>(long long* keys, long long i,
                                                      long long count,
                                                      const long long (&k)[kPer]) {
  if (i + kPer <= count) {
    longlong2* v = reinterpret_cast<longlong2*>(keys + i);
    v[0] = make_longlong2(k[0], k[1]);
    v[1] = make_longlong2(k[2], k[3]);
  } else {
    for (int j = 0; j < kPer && i + j < count; ++j) keys[i + j] = k[j];
  }
}

// K1: slots [b0, b0 + kSlots) of blockIdx.x, kPer consecutive a thread. A
// slot i < total_kept belongs to the last gaussian g with starts[g] <= i
// (gaussians that hit no tile share their successor's start, and every
// gaussian past the budget starts at or after total_kept); its rank j =
// i - starts[g] in g's tile bbox decodes row-major (binning.py:183-192).
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    fill_keys_kernel(const int* __restrict__ starts, const int* __restrict__ tmin_x,
                     const int* __restrict__ tmin_y, const int* __restrict__ bbox_w,
                     const int* __restrict__ total_kept, int n, int tb_x, int gauss_bits,
                     Key sentinel, long long count, Key* __restrict__ keys) {
  __shared__ int s_start[kWindow];
  __shared__ int s_tx[kWindow];
  __shared__ int s_ty[kWindow];
  __shared__ int s_bw[kWindow];
  __shared__ int s_cnt[2 * kWarps];
  __shared__ int s_next;
  const long long b0 = static_cast<long long>(blockIdx.x) * kSlots;
  const long long i0 = b0 + threadIdx.x * kPer;
  const long long total = *total_kept;  // its load overlaps the search
  Key key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) key[j] = sentinel;
  if (n > 0) {
    const long long last = min(b0 + kSlots, count) - 1;
    const int2 g = bracket(starts, n, b0, last, s_cnt);  // stage gaussians [x, y)
    for (int w0 = g.x; b0 < total && w0 < g.y; w0 += kWindow) {
      const int m = min(kWindow, g.y - w0);
      __syncthreads();  // every thread is done with the last window
      for (int k = threadIdx.x; k < m; k += kThreads) {
        s_start[k] = starts[w0 + k];
        s_tx[k] = tmin_x[w0 + k];
        s_ty[k] = tmin_y[w0 + k];
        s_bw[k] = max(bbox_w[w0 + k], 1);
      }
      if (threadIdx.x == 0) s_next = w0 + m < n ? starts[w0 + m] : INT_MAX;
      __syncthreads();
      const long long lo = s_start[0];
      const long long next = s_next;  // the window owns slots [lo, next)
      if (lo >= total) break;  // the rest start past the kept total
      int k = -1;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long i = i0 + j;
        if (i >= total || i < lo || i >= next) continue;
        if (k < 0) {  // the last staged start <= i
          int a = 0, z = m;
          while (z - a > 1) {
            const int mid = (a + z) >> 1;
            if (s_start[mid] <= i) a = mid; else z = mid;
          }
          k = a;
        }
        while (k + 1 < m && s_start[k + 1] <= i) ++k;
        const int rel = static_cast<int>(i - s_start[k]);
        const int bw = s_bw[k];
        const int q = rel / bw;
        const int tile = (s_ty[k] + q) * tb_x + s_tx[k] + (rel - q * bw);
        key[j] = (static_cast<Key>(tile) << gauss_bits) | static_cast<Key>(w0 + k);
      }
    }
  }
  if (i0 < count) store_keys<Key>(keys, i0, count, key);
}

template <typename Key>
__device__ __forceinline__ void load_keys(const Key* __restrict__ p, bool vec,
                                          Key (&k)[kPer]);

template <>
__device__ __forceinline__ void load_keys<int>(const int* __restrict__ p, bool vec,
                                               int (&k)[kPer]) {
  if (vec) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) k[j] = p[j];
  }
}

template <>
__device__ __forceinline__ void load_keys<long long>(const long long* __restrict__ p,
                                                     bool vec, long long (&k)[kPer]) {
  if (vec) {
    const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
    k[0] = a.x, k[1] = a.y, k[2] = b.x, k[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) k[j] = p[j];
  }
}

template <typename Key>
__device__ __forceinline__ int tile_of(Key key, int gauss_bits) {
  return static_cast<int>(key >> gauss_bits);  // -1 for key -1
}

constexpr int kShortGap = 4;  // edges a thread writes alone; longer gaps: its warp

// K2: lanes [i0, i0 + kPer) of each thread, i0 = kPer x its global index.
// `vec`: keys and ids 16-byte aligned; the keys `cap` back are one vector
// too when cap % kPer == 0. Every thread of a warp runs the edge loop (it
// votes), so no thread returns early.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
    rank_cap_kernel(const Key* __restrict__ keys, int count, int gauss_bits, int cap,
                    int n, int num_tiles, bool vec, int* __restrict__ tile_ids,
                    int* __restrict__ gauss_ids, int* __restrict__ edges) {
  const int lane = threadIdx.x & 31;
  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  const bool whole = i0 + kPer <= count;
  const int b0 = i0 - cap;  // the lanes cap back
  Key key[kPer], back[kPer];
  if (whole) {
    load_keys<Key>(keys + i0, vec, key);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) key[j] = i0 + j < count ? keys[i0 + j] : Key(0);
  }
  if (whole && b0 >= 0) {
    load_keys<Key>(keys + b0, vec && cap % kPer == 0, back);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      back[j] = (i0 + j < count && b0 + j >= 0) ? keys[b0 + j] : Key(-1);
    }
  }
  // the tile before lane i0: the previous thread's last, or a load at a warp's start
  const int before =
      (lane == 0 && i0 > 0 && i0 <= count) ? tile_of(keys[i0 - 1], gauss_bits) : -1;
  int tile[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) tile[j] = tile_of(key[j], gauss_bits);
  const int left = __shfl_up_sync(kFull, tile[kPer - 1], 1);
  const int prev = lane == 0 ? before : left;

  const Key mask = (Key(1) << gauss_bits) - 1;  // the gauss field and its sentinel
  int gid[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const Key gauss = key[j] & mask;
    const bool capped = b0 + j >= 0 && tile_of(back[j], gauss_bits) == tile[j];
    gid[j] = (capped || gauss == mask) ? n : static_cast<int>(gauss);
  }
  if (whole && vec) {
    *reinterpret_cast<int4*>(tile_ids + i0) = make_int4(tile[0], tile[1], tile[2], tile[3]);
    *reinterpret_cast<int4*>(gauss_ids + i0) = make_int4(gid[0], gid[1], gid[2], gid[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i0 + j < count) {
        tile_ids[i0 + j] = tile[j];
        gauss_ids[i0 + j] = gid[j];
      }
    }
  }

  // edges: gap j < kPer is (last tile, lane i0 + j's tile], worth its lane;
  // gap kPer, of the thread holding the last lane (lane 0 when count is
  // 0), is (the last lane's tile, num_tiles], worth count
  const int last_lane = max(count - 1, 0);
  const bool ends = i0 <= last_lane && last_lane < i0 + kPer;
  int last = prev;
#pragma unroll
  for (int j = 0; j <= kPer; ++j) {
    int lo = 1, hi = 0, val = 0;  // edges [lo, hi] get val
    if (j < kPer && i0 + j < count) {
      lo = max(last + 1, 0), hi = min(tile[j], num_tiles), val = i0 + j;
      last = tile[j];
    } else if (j == kPer && ends) {
      lo = max(last + 1, 0), hi = num_tiles, val = count;
    }
    if (hi - lo < kShortGap) {
      for (int u = lo; u <= hi; ++u) edges[u] = val;
    }
    unsigned long_gaps = __ballot_sync(kFull, hi - lo >= kShortGap);
    while (long_gaps) {
      const int src = __ffs(long_gaps) - 1;
      long_gaps &= long_gaps - 1;
      const int l = __shfl_sync(kFull, lo, src);
      const int h = __shfl_sync(kFull, hi, src);
      const int v = __shfl_sync(kFull, val, src);
      for (int u = l + lane; u <= h; u += 32) edges[u] = v;
    }
  }
}

template <typename Key>
void launch_fill(const void* starts, const void* tmin_x, const void* tmin_y,
                 const void* bbox_w, const void* total_kept, int n, int tb_x,
                 int num_tiles, int gauss_bits, long long num_slots, void* keys,
                 cudaStream_t s) {
  const Key sentinel =
      (static_cast<Key>(num_tiles) << gauss_bits) | ((Key(1) << gauss_bits) - 1);
  const long long blocks = (num_slots + kSlots - 1) / kSlots;
  fill_keys_kernel<Key><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(starts), static_cast<const int*>(tmin_x),
      static_cast<const int*>(tmin_y), static_cast<const int*>(bbox_w),
      static_cast<const int*>(total_kept), n, tb_x, gauss_bits, sentinel, num_slots,
      static_cast<Key*>(keys));
}

template <typename Key>
void launch_rank(const void* sorted_keys, int count, int gauss_bits, int cap, int n,
                 int num_tiles, bool vec, void* tile_ids, void* gauss_ids,
                 void* tile_edges, cudaStream_t s) {
  const int blocks = count > 0 ? (count + kSlots - 1) / kSlots : 1;
  rank_cap_kernel<Key><<<blocks, kThreads, 0, s>>>(
      static_cast<const Key*>(sorted_keys), count, gauss_bits, cap, n, num_tiles, vec,
      static_cast<int*>(tile_ids), static_cast<int*>(gauss_ids),
      static_cast<int*>(tile_edges));
}

// Whether keys of key_bytes bytes hold the layout of n splats on num_tiles
// tiles in a gauss field of gauss_bits bits (16 to 23: ids below 2^23).
bool layout_ok(int key_bytes, int gauss_bits, int n, int num_tiles) {
  if (key_bytes != 4 && key_bytes != 8) return false;
  if (gauss_bits < 16 || gauss_bits > 23 || n < 0 || num_tiles < 0) return false;
  const long long mask = (1ll << gauss_bits) - 1;
  if (n > mask) return false;
  const long long sentinel = (static_cast<long long>(num_tiles) << gauss_bits) | mask;
  return key_bytes == 8 || sentinel <= INT_MAX;
}

}  // namespace

// key_bytes 4 (int32 keys, where the layout's sentinel key fits 31 bits) or
// 8 (int64); keys 16-byte aligned.
GSVC_EXPORT int fill_decode_keys(const void* starts, const void* tmin_x,
                                 const void* tmin_y, const void* bbox_w,
                                 const void* total_kept, int n, int tb_x,
                                 int num_tiles, long long num_slots, int key_bytes,
                                 int gauss_bits, void* keys, void* stream) {
  if (!layout_ok(key_bytes, gauss_bits, n, num_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_slots <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    launch_fill<int>(starts, tmin_x, tmin_y, bbox_w, total_kept, n, tb_x, num_tiles,
                     gauss_bits, num_slots, keys, s);
  } else {
    launch_fill<long long>(starts, tmin_x, tmin_y, bbox_w, total_kept, n, tb_x,
                           num_tiles, gauss_bits, num_slots, keys, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sorted keys [count] -> tile ids, gauss ids [count] and tile edges
// [num_tiles + 1], all int32; one launch, also at count 0 (edges all 0).
GSVC_EXPORT int rank_cap_decode(const void* sorted_keys, long long count, int key_bytes,
                                int gauss_bits, int cap, int n, int num_tiles,
                                void* tile_ids, void* gauss_ids, void* tile_edges,
                                void* stream) {
  if (!layout_ok(key_bytes, gauss_bits, n, num_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count < 0 || count > INT_MAX - kSlots || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = aligned(sorted_keys) && aligned(tile_ids) && aligned(gauss_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(count);
  if (key_bytes == 4) {
    launch_rank<int>(sorted_keys, c, gauss_bits, cap, n, num_tiles, vec, tile_ids,
                     gauss_ids, tile_edges, s);
  } else {
    launch_rank<long long>(sorted_keys, c, gauss_bits, cap, n, num_tiles, vec, tile_ids,
                           gauss_ids, tile_edges, s);
  }
  return static_cast<int>(cudaGetLastError());
}

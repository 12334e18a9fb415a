// Tile-binning index kernels: K1 (fill/decode sort keys) and K2 (rank/cap
// decode of the sorted keys). Replace gsvc_tpu/ops/fill_pallas.py
// `_fill_kernel` / `fill_decode_keys` and `_rank_kernel` / `rank_cap_decode`.
// The Python side, with the plain PyTorch versions and the design note, is
// gsvc_tpu_torch/ops/fill_cuda.py.
//
// Keys are (tile << 16 | gauss), int32 while num_tiles <= 32767 (the
// sentinel (num_tiles << 16 | 0xFFFF) then fits 31 bits) and int64 above;
// both kernels are templates on the key type.
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
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // consecutive slots a thread
constexpr int kSlots = kThreads * kPer;
constexpr int kWindow = 1024;  // gaussians staged at once
constexpr long long kMaxBlocks = 8192;
constexpr unsigned kFull = 0xffffffffu;

int grid_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

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
                     const int* __restrict__ total_kept, int n, int tb_x, Key sentinel,
                     long long count, Key* __restrict__ keys) {
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
        key[j] = (static_cast<Key>(tile) << 16) | static_cast<Key>(w0 + k);
      }
    }
  }
  if (i0 < count) store_keys<Key>(keys, i0, count, key);
}

// K2a: the first lane of every tile run records its lane as the run start.
template <typename Key>
__global__ void run_start_kernel(const Key* __restrict__ keys, long long count,
                                 int* __restrict__ run_start) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += stride) {
    const int tile = static_cast<int>(keys[i] >> 16);
    if (i == 0 || tile != static_cast<int>(keys[i - 1] >> 16)) {
      run_start[tile] = static_cast<int>(i);
    }
  }
}

// K2b: rank inside the tile run; lanes ranked >= cap and sentinel lanes get
// gauss id n (forward.cu:613 semantics).
template <typename Key>
__global__ void rank_cap_kernel(const Key* __restrict__ keys, long long count,
                                const int* __restrict__ run_start, int cap,
                                int n, int* __restrict__ tile_ids,
                                int* __restrict__ gauss_ids) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += stride) {
    const Key key = keys[i];
    const int tile = static_cast<int>(key >> 16);
    const int gauss = static_cast<int>(key & 0xFFFF);
    const long long rank = i - run_start[tile];
    tile_ids[i] = tile;
    gauss_ids[i] = (rank < cap && gauss != 0xFFFF) ? gauss : n;
  }
}

template <typename Key>
void launch_fill(const void* starts, const void* tmin_x, const void* tmin_y,
                 const void* bbox_w, const void* total_kept, int n, int tb_x,
                 int num_tiles, long long num_slots, void* keys, cudaStream_t s) {
  const Key sentinel = (static_cast<Key>(num_tiles) << 16) | 0xFFFF;
  const long long blocks = (num_slots + kSlots - 1) / kSlots;
  fill_keys_kernel<Key><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(starts), static_cast<const int*>(tmin_x),
      static_cast<const int*>(tmin_y), static_cast<const int*>(bbox_w),
      static_cast<const int*>(total_kept), n, tb_x, sentinel, num_slots,
      static_cast<Key*>(keys));
}

template <typename Key>
void launch_rank(const void* sorted_keys, long long count, int cap, int n,
                 void* run_start, void* tile_ids, void* gauss_ids, cudaStream_t s) {
  const Key* keys = static_cast<const Key*>(sorted_keys);
  int* starts = static_cast<int*>(run_start);
  run_start_kernel<Key><<<grid_for(count), kThreads, 0, s>>>(keys, count, starts);
  rank_cap_kernel<Key><<<grid_for(count), kThreads, 0, s>>>(
      keys, count, starts, cap, n, static_cast<int*>(tile_ids),
      static_cast<int*>(gauss_ids));
}

}  // namespace

// key_bytes 4 (int32 keys, num_tiles <= 32767) or 8 (int64); keys 16-byte
// aligned.
GSVC_EXPORT int fill_decode_keys(const void* starts, const void* tmin_x,
                                 const void* tmin_y, const void* bbox_w,
                                 const void* total_kept, int n, int tb_x,
                                 int num_tiles, long long num_slots, int key_bytes,
                                 void* keys, void* stream) {
  if (key_bytes != 4 && key_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (key_bytes == 4 && num_tiles > 32767) return static_cast<int>(cudaErrorInvalidValue);
  if (num_slots <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    launch_fill<int>(starts, tmin_x, tmin_y, bbox_w, total_kept, n, tb_x, num_tiles,
                     num_slots, keys, s);
  } else {
    launch_fill<long long>(starts, tmin_x, tmin_y, bbox_w, total_kept, n, tb_x,
                           num_tiles, num_slots, keys, s);
  }
  return static_cast<int>(cudaGetLastError());
}

GSVC_EXPORT int rank_cap_decode(const void* sorted_keys, long long count, int key_bytes,
                                int cap, int n, void* run_start, void* tile_ids,
                                void* gauss_ids, void* stream) {
  if (key_bytes != 4 && key_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    launch_rank<int>(sorted_keys, count, cap, n, run_start, tile_ids, gauss_ids, s);
  } else {
    launch_rank<long long>(sorted_keys, count, cap, n, run_start, tile_ids, gauss_ids, s);
  }
  return static_cast<int>(cudaGetLastError());
}

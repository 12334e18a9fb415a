// Tile-binning index kernels: K1 (fill/decode sort keys) and K2 (rank/cap
// decode of the sorted keys). The Python side, with the plain PyTorch
// versions and the design note, is gsvc_tpu_torch/ops/fill_cuda.py.
//
// Keys are int64 (tile << 16 | gauss); the sentinel is
// (num_tiles << 16 | 0xFFFF).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

int grid_for(long long count) {
  long long blocks = (count + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// K1a: one thread per gaussian. A kept gaussian writes its nth keys at its
// exclusive offset, row-major over its tile bbox (binning.py:183-192).
__global__ void expand_keys_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ nth,
                                   const unsigned char* __restrict__ kept,
                                   const int* __restrict__ tmin_x,
                                   const int* __restrict__ tmin_y,
                                   const int* __restrict__ bbox_w, int n,
                                   int tb_x, long long* __restrict__ keys) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n || !kept[g]) return;
  const long long s = starts[g];
  const int cnt = nth[g];
  const int bw = max(bbox_w[g], 1);
  const int tx0 = tmin_x[g];
  const int ty0 = tmin_y[g];
  for (int j = 0; j < cnt; ++j) {
    const int ty = ty0 + j / bw;
    const int tx = tx0 + j % bw;
    keys[s + j] = (static_cast<long long>(ty * tb_x + tx) << 16) | g;
  }
}

// K1b: slots [total_kept, count) get the sentinel key. total_kept stays on
// the device, so the caller needs no host sync.
__global__ void sentinel_kernel(const int* __restrict__ total_kept,
                                long long sentinel, long long count,
                                long long* __restrict__ keys) {
  const long long first = *total_kept;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += stride) {
    if (i >= first) keys[i] = sentinel;
  }
}

// K2a: the first lane of every tile run records its lane as the run start.
__global__ void run_start_kernel(const long long* __restrict__ keys,
                                 long long count, int* __restrict__ run_start) {
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
__global__ void rank_cap_kernel(const long long* __restrict__ keys,
                                long long count,
                                const int* __restrict__ run_start, int cap,
                                int n, int* __restrict__ tile_ids,
                                int* __restrict__ gauss_ids) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += stride) {
    const long long key = keys[i];
    const int tile = static_cast<int>(key >> 16);
    const int gauss = static_cast<int>(key & 0xFFFF);
    const long long rank = i - run_start[tile];
    tile_ids[i] = tile;
    gauss_ids[i] = (rank < cap && gauss != 0xFFFF) ? gauss : n;
  }
}

}  // namespace

GSVC_EXPORT int fill_decode_keys(const void* starts, const void* nth,
                                 const void* kept, const void* tmin_x,
                                 const void* tmin_y, const void* bbox_w,
                                 const void* total_kept, int n, int tb_x,
                                 int num_tiles, long long num_slots,
                                 void* keys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* out = static_cast<long long*>(keys);
  if (num_slots > 0) {
    const long long sentinel =
        (static_cast<long long>(num_tiles) << 16) | 0xFFFF;
    sentinel_kernel<<<grid_for(num_slots), kThreads, 0, s>>>(
        static_cast<const int*>(total_kept), sentinel, num_slots, out);
  }
  if (n > 0) {
    expand_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const int*>(starts), static_cast<const int*>(nth),
        static_cast<const unsigned char*>(kept),
        static_cast<const int*>(tmin_x), static_cast<const int*>(tmin_y),
        static_cast<const int*>(bbox_w), n, tb_x, out);
  }
  return static_cast<int>(cudaGetLastError());
}

GSVC_EXPORT int rank_cap_decode(const void* sorted_keys, long long count,
                                int cap, int n, void* run_start,
                                void* tile_ids, void* gauss_ids,
                                void* stream) {
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* keys = static_cast<const long long*>(sorted_keys);
  int* starts = static_cast<int*>(run_start);
  run_start_kernel<<<grid_for(count), kThreads, 0, s>>>(keys, count, starts);
  rank_cap_kernel<<<grid_for(count), kThreads, 0, s>>>(
      keys, count, starts, cap, n, static_cast<int*>(tile_ids),
      static_cast<int*>(gauss_ids));
  return static_cast<int>(cudaGetLastError());
}

// P6: the transposes of K5's planar epilogue. Replaces the probes of
// scripts/probe_mxu_transpose.py (`variant_kernel` :32 at pallas_call :71,
// `minor_kernel` :79 at :97), which asked which identity-matmul
// orientations the TPU's MXU takes to transpose [360, 256] -> [256, 360]
// and [16, 16, 360] -> [16, 360, 16] in f32. The Python side, with the
// plain PyTorch versions, is gsvc_tpu_torch/scripts/probe_transpose.py.
//
// On the card a transpose is a copy, bound by memory traffic: one read and
// one write of every element. Both kernels are exact.
//   transpose_batched  [B, R, C] -> [B, C, R] through a 32x33 shared-memory
//                      tile (the padding column keeps the column reads
//                      free of bank conflicts), so both the loads and the
//                      stores are coalesced; [R, C] is B = 1 and
//                      [16, 16, R] -> [16, R, 16] is B = 16 of [16, R].
//   rows_to_chw        K4's tile-row blocks ("rows", [tb_y * r_out, 256])
//                      -> planar [3, H, W]: one CTA per tile, one thread per
//                      pixel, reading the tile's three 1 KB channel rows and
//                      writing 16-float runs of each plane. K4 "rows" then
//                      this kernel is the two-pass form of K5's in-kernel
//                      planar store.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // block 32 x 8: each thread moves 4 elements

__global__ void transpose_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int rows, int cols) {
  __shared__ float tile[kTile][kTile + 1];
  const long long plane = static_cast<long long>(rows) * cols;
  in += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int c = c0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int r = r0 + j;
    if (r < rows && c < cols) tile[j][threadIdx.x] = in[static_cast<long long>(r) * cols + c];
  }
  __syncthreads();
  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int cc = c0 + j;
    if (cc < cols && r < rows) out[static_cast<long long>(cc) * rows + r] = tile[threadIdx.x][j];
  }
}

__global__ void rows_to_chw_kernel(const float* __restrict__ rows,
                                   float* __restrict__ out, int img_h,
                                   int img_w, int r_out) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= img_w || py >= img_h) return;
  const long long npix = static_cast<long long>(blockDim.x) * blockDim.y;
  const long long base =
      (static_cast<long long>(blockIdx.y) * r_out + 3 * blockIdx.x) * npix +
      threadIdx.y * blockDim.x + threadIdx.x;
  const long long plane = static_cast<long long>(img_h) * img_w;
  const long long pix = static_cast<long long>(py) * img_w + px;
  out[pix] = rows[base];
  out[plane + pix] = rows[base + npix];
  out[2 * plane + pix] = rows[base + 2 * npix];
}

}  // namespace

GSVC_EXPORT int transpose_batched(const void* in, void* out, int batch, int rows,
                                  int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch > 0 && rows > 0 && cols > 0) {
    const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, batch);
    transpose_kernel<<<grid, dim3(kTile, kRowsPerPass), 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

GSVC_EXPORT int rows_to_chw(const void* rows, void* out, int img_h, int img_w,
                            int tb_x, int tb_y, int block_w, int block_h,
                            int r_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb_x > 0 && tb_y > 0) {
    rows_to_chw_kernel<<<dim3(tb_x, tb_y), dim3(block_w, block_h), 0, s>>>(
        static_cast<const float*>(rows), static_cast<float*>(out), img_h, img_w,
        r_out);
  }
  return static_cast<int>(cudaGetLastError());
}

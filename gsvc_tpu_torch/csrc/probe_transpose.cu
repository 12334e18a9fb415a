// P6: the transposes of K5's planar epilogue. Replaces the probes of
// scripts/probe_mxu_transpose.py (`variant_kernel` :32 at pallas_call :71,
// `minor_kernel` :79 at :97), which asked which identity-matmul
// orientations the TPU's MXU takes to transpose [360, 256] -> [256, 360]
// and [16, 16, 360] -> [16, 360, 16] in f32. The Python side, with the
// plain PyTorch versions, is gsvc_tpu_torch/scripts/probe_transpose.py.
//
// On the card a transpose is a copy, bound by memory traffic: one read and
// one write of every element. Both kernels are exact.
//   transpose_batched  [B, R, C] -> [B, C, R] through a TR x TC tile of
//                      1024 floats in shared memory, a CTA of 256 threads
//                      each loading one 16-byte vector along C and storing
//                      one along R. The tile follows the shape: a short R
//                      (<= 16) takes 16 x 64, so [16, 16, 360] ->
//                      [16, 360, 16] moves whole 64-byte output rows in 96
//                      CTAs (a 32-row tile left half of every CTA idle);
//                      else 32 x 32. The row pitch keeps the four-row
//                      reads of the store phase free of bank conflicts.
//                      Where C (R) is not a multiple of 4 or the input
//                      (output) is not 16-byte aligned, the loads (stores)
//                      are 4-byte ones.
//   rows_to_chw        K4's tile-row blocks ("rows", [tb_y * r_out, 256])
//                      -> planar [3, H, W]: one CTA per tile, one thread per
//                      pixel, reading the tile's three 1 KB channel rows and
//                      writing 16-float runs of each plane. K4 "rows" then
//                      this kernel is the two-pass form of K5's in-kernel
//                      planar store.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // one 4-float vector in and one out a thread

// A row pitch of the [TR][TC] tile with 4 x pitch = 128 / TR (mod 32): the
// store phase's warp reads rows r + k of TR / 4 row groups and 128 / TR
// columns, which then fall in 32 distinct banks.
__host__ __device__ constexpr int pitch(int tr, int tc) {
  return tc + ((32 / tr - tc % 8) % 8 + 8) % 8;
}

template <int TR, int TC>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
                     int cols, bool vec_in, bool vec_out) {
  static_assert(TR * TC == 4 * kThreads, "one vector in and out a thread");
  constexpr int P = pitch(TR, TC);
  __shared__ float tile[TR * P];
  const long long plane = static_cast<long long>(rows) * cols;
  in += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int r0 = blockIdx.y * TR;
  const int c0 = blockIdx.x * TC;
  {
    const int r = threadIdx.x / (TC / 4), c = 4 * (threadIdx.x % (TC / 4));
    const int gr = r0 + r, gc = c0 + c;
    if (gr < rows && gc < cols) {
      const float* src = in + static_cast<long long>(gr) * cols + gc;
      float v[4];
      if (vec_in) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = gc + k < cols ? src[k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) tile[r * P + c + k] = v[k];
    }
  }
  __syncthreads();
  const int c = threadIdx.x / (TR / 4), r = 4 * (threadIdx.x % (TR / 4));
  const int gc = c0 + c, gr = r0 + r;
  if (gc >= cols || gr >= rows) return;
  float* dst = out + static_cast<long long>(gc) * rows + gr;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = tile[(r + k) * P + c];
  if (vec_out) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (gr + k < rows) dst[k] = v[k];
    }
  }
}

template <int TR, int TC>
void launch_transpose(const float* in, float* out, int batch, int rows, int cols,
                      cudaStream_t s) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const dim3 grid((cols + TC - 1) / TC, (rows + TR - 1) / TR, batch);
  transpose_kernel<TR, TC><<<grid, kThreads, 0, s>>>(
      in, out, rows, cols, cols % 4 == 0 && aligned(in), rows % 4 == 0 && aligned(out));
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

// A short R (<= 16) takes the 16 x 64 tile, any other the 32 x 32 one.
GSVC_EXPORT int transpose_batched(const void* in, void* out, int batch, int rows,
                                  int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  if (batch > 0 && rows > 0 && cols > 0) {
    if (rows <= 16) {
      launch_transpose<16, 64>(src, dst, batch, rows, cols, s);
    } else {
      launch_transpose<32, 32>(src, dst, batch, rows, cols, s);
    }
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

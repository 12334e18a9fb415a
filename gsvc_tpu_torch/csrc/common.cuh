// Shared by the kernel libraries of gsvc_tpu_torch (built by _build.py with
// nvcc into one shared library per .cu file, bound with ctypes).
//
// Every C entry point takes raw device pointers and the CUDA stream as
// void*, launches on that stream, never synchronises or allocates, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>

#define GSVC_EXPORT extern "C" __attribute__((visibility("default")))

GSVC_EXPORT const char* gsvc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A kernel that does nothing: one launch of it is the floor under any
// kernel's time, timed by the same harness as the kernels.
__global__ void gsvc_empty_kernel() {}

GSVC_EXPORT int gsvc_empty_launch(void* stream) {
  gsvc_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (extern "C", pointers and
// ints only) that kernels/ops.py loads with ctypes. Each entry point launches
// on the stream it is given, allocates nothing, and returns the value of
// cudaGetLastError() right after its launches (0 = success); the Python
// wrapper raises on anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes: must match kernels/ops.py::_DTYPE_CODE
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

static inline int launch_status() { return (int)cudaGetLastError(); }

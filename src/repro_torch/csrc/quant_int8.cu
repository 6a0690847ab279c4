// INT8 block quantize / dequantize on the flat wire layout.
//
// Replaces src/repro/kernels/quant_blockwise.py::quantize_int8_pallas (:40)
// and ::dequantize_int8_pallas (:63). A flat tensor is cut into contiguous
// blocks of `bs` elements; each block gets scale = absmax * (1/127) (1 for an
// all-zero block) and q = clamp(rint(x / scale), -127, 127).
//
// Bound on the H100: bytes. Quantize reads each input once (2 or 4 bytes)
// and writes 1 byte plus 4/bs bytes of scale; dequantize reads 1 + 4/bs and
// writes the output dtype. The arithmetic is a few f32 operations per
// element, far below what the card can issue for those bytes.
//
// Design: quantize gives one warp to each block (the TPU kernel's (8, bs)
// VMEM tile becomes 8 warps of 32 lanes). Lanes stride the block so every
// warp load touches consecutive addresses; the absmax is a warp-shuffle
// reduction, and the second pass over the block hits L1. Dequantize is a
// grid-stride elementwise loop. Numerics: the scale multiplies by the f32
// reciprocal constant (what XLA does to `absmax / 127` under jit, which the
// reference always runs under), the quotient uses IEEE division (no
// --use_fast_math), and rintf rounds half to even like jnp.round.
#include "common.cuh"

namespace {

constexpr int QUANT_WARPS = 8;
constexpr int DEQ_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QUANT_WARPS * 32)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, long long nb, int bs) {
  const long long b = (long long)blockIdx.x * QUANT_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= nb) return;
  const T* xb = x + b * bs;
  float amax = 0.f;
  for (int i = lane; i < bs; i += 32) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax == 0.f ? 1.f : amax * (1.0f / 127.0f);
  int8_t* qb = q + b * bs;
  for (int i = lane; i < bs; i += 32) {
    const float v = fminf(fmaxf(rintf(to_f32(xb[i]) / scale), -127.f), 127.f);
    qb[i] = (int8_t)v;
  }
  if (lane == 0) s[b] = scale;
}

template <typename T>
__global__ void __launch_bounds__(DEQ_THREADS)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                       T* __restrict__ out, long long n, int bs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = from_f32<T>((float)q[i] * s[i / bs]);
}

}  // namespace

// x: (nb * bs,) f32 or bf16 -> q: (nb * bs,) int8, s: (nb,) f32
extern "C" int quantize_int8(const void* x, int dtype, void* q, void* s,
                             long long nb, int bs, void* stream) {
  if (nb <= 0) return 0;
  const unsigned grid = (unsigned)((nb + QUANT_WARPS - 1) / QUANT_WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    quantize_int8_kernel<float><<<grid, QUANT_WARPS * 32, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)s, nb, bs);
  else if (dtype == DT_BF16)
    quantize_int8_kernel<__nv_bfloat16><<<grid, QUANT_WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)s, nb, bs);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

// q: (n,) int8, s: (n / bs,) f32 -> out: (n,) f32 or bf16
extern "C" int dequantize_int8(const void* q, const void* s, void* out, int dtype,
                               long long n, int bs, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + DEQ_THREADS - 1) / DEQ_THREADS;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    dequantize_int8_kernel<float><<<grid, DEQ_THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)out, n, bs);
  else if (dtype == DT_BF16)
    dequantize_int8_kernel<__nv_bfloat16><<<grid, DEQ_THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (__nv_bfloat16*)out, n, bs);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

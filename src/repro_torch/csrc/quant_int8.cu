// INT8 block quantize / dequantize on the flat wire layout, and the fused
// dequant-sum of the INT8 a2a gradient reduce-scatter.
//
// Replaces src/repro/kernels/quant_blockwise.py::quantize_int8_pallas (:40),
// ::dequantize_int8_pallas (:63) and ::dequantize_int8_sum_pallas (:92). A
// flat tensor is cut into contiguous blocks of `bs` elements; each block gets
// scale = absmax * (1/127) (1 for an all-zero block) and
// q = clamp(rint(x / scale), -127, 127). The sum takes d received chunks of
// nb blocks and their scales -> (nb, bs) f32 = sum_j q_j * s_j, in order
// j = 0..d-1 (the receive side of the bits=8 reduce-scatter).
//
// Bound on the H100: bytes. Quantize reads each input once (2 or 4 bytes)
// and writes 1 byte plus 4/bs bytes of scale; dequantize reads 1 + 4/bs and
// writes the output dtype (falcon-mamba's w_xproj, 8192 x 288 to bf16, the
// weight every layer dequantizes whole: 7.15 MB, 2.13 us at 3.35 TB/s); the
// sum reads d * (1 + 4/bs) and writes 4 bytes per element. The arithmetic is
// a few operations per element, far below what the card can issue for those
// bytes, but not below what its conversion unit takes (16 int -> float a
// clock an SM). Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W):
// dequantize at w_xproj 0.00294 ms against that 0.00213 ms bound (one
// element a thread: 0.00595); at a prefill's 128 embedding rows 0.00176 ms,
// the cost of a launch.
//
// Design: quantize gives one warp to each block (the TPU kernel's (8, bs)
// VMEM tile becomes 8 warps of 32 lanes). Lanes stride the block so every
// warp load touches consecutive addresses; the absmax is a warp-shuffle
// reduction, and the second pass over the block hits L1. Dequantize takes 16
// int8 a thread where bs % 16 == 0 and q and out are 16-byte aligned, with
// every load and 16-byte store contiguous across the warp, one scale load
// for each 4 or 8 int8, and int8 -> f32 on the ALU and f32 pipes instead of
// the conversion unit; offsets are 32-bit where n allows, 64-bit past that.
// Any other block or alignment (a q view at an odd offset) takes one element
// a thread. Both are bit for bit the plain version: an exact int8 -> f32,
// one f32 multiply, round-to-nearest-even to bf16. The sum gives each thread
// 4 contiguous int8 of one block (one 4-byte load per chunk, one float4
// store) when the block size allows it, else one element; offsets are 64-bit
// (the tied embedding's stage-1 payload is 136 M elements). It writes every
// product and every add as its own rounded operation (__fmul_rn, __fadd_rn),
// so nvcc cannot contract them into an FMA and the result is bit for bit the
// plain version's q * s, then +, like the INT4 sum in quant_int4.cu.
// Numerics of the quantize: the scale multiplies by the f32 reciprocal
// constant (what XLA does to `absmax / 127` under jit, which the reference
// always runs under), the quotient uses IEEE division (no --use_fast_math),
// and rintf rounds half to even like jnp.round.
#include <type_traits>

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

// A warp owns 512 elements; in slot k lane l takes the E int8 at
// 32 * E * k + E * l (E = 8 for bf16, 4 for f32: one 8- or 4-byte load, one
// 16-byte store), all under one scale since E divides bs. int8 -> f32: byte
// e of w ^ 0x80808080 is v + 128; put under the exponent of 2^23
// (0x4B000000) it reads 2^23 + v + 128, and subtracting that bias is exact.
template <typename T, typename I>
__global__ void __launch_bounds__(DEQ_THREADS)
dequantize_int8_vec(const int8_t* __restrict__ q, const float* __restrict__ s,
                    T* __restrict__ out, I n, I bs) {
  constexpr int E = std::is_same<T, float>::value ? 4 : 8;
  const I base = ((I)blockIdx.x * DEQ_THREADS + threadIdx.x) / 32 * 512 +
                 (threadIdx.x % 32) * E;
#pragma unroll
  for (int k = 0; k < 16 / E; ++k) {
    const I e0 = base + (I)k * 32 * E;
    if (e0 >= n) break;
    const float sc = __ldg(s + e0 / bs);
    uint32_t w[E / 4];
    if constexpr (E == 8) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(q + e0));
      w[0] = r.x;
      w[1] = r.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(q + e0));
    }
    float f[E];
#pragma unroll
    for (int m = 0; m < E / 4; ++m) {
      const uint32_t u = w[m] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[4 * m + e] = __fmul_rn(
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + e)) - 8388736.0f, sc);
    }
    if constexpr (E == 8) {
      uint4 o;
      uint32_t* ou = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(f[2 * m], f[2 * m + 1]);
        ou[m] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      *reinterpret_cast<uint4*>(out + e0) = o;
    } else {
      *reinterpret_cast<float4*>(out + e0) = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

// one element a thread: any block size and any alignment
template <typename T, typename I>
__global__ void __launch_bounds__(DEQ_THREADS)
dequantize_int8_elem(const int8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, I n, I bs) {
  const I i = (I)blockIdx.x * DEQ_THREADS + threadIdx.x;
  if (i < n) out[i] = from_f32<T>(__fmul_rn((float)q[i], s[i / bs]));
}

template <typename T, typename I>
void dequantize_launch(const int8_t* q, const float* s, T* out, long long n, int bs,
                       bool vec, cudaStream_t st) {
  const long long items = vec ? n / 16 : n;
  const unsigned grid = (unsigned)((items + DEQ_THREADS - 1) / DEQ_THREADS);
  if (vec)
    dequantize_int8_vec<T, I><<<grid, DEQ_THREADS, 0, st>>>(q, s, out, (I)n, (I)bs);
  else
    dequantize_int8_elem<T, I><<<grid, DEQ_THREADS, 0, st>>>(q, s, out, (I)n, (I)bs);
}

template <typename T>
void dequantize_any(const int8_t* q, const float* s, T* out, long long n, int bs,
                    cudaStream_t st) {
  const bool vec = bs % 16 == 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  if (n <= 0xFFFF0000LL)  // a warp's last slot may start up to 504 past n
    dequantize_launch<T, unsigned>(q, s, out, n, bs, vec, st);
  else
    dequantize_launch<T, unsigned long long>(q, s, out, n, bs, vec, st);
}

constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float dq_add(int8_t v, float sc, bool first, float acc) {
  const float p = __fmul_rn((float)v, sc);
  return first ? p : __fadd_rn(acc, p);
}

// one thread per 4 int8 of one block: bs and the chunk length are multiples
// of 4, q is 4-byte and out 16-byte aligned
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int8_sum_vec4(const int8_t* __restrict__ q, const float* __restrict__ s,
                         float* __restrict__ out, int d, long long n, int bs) {
  const long long nb = n / bs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < n / 4;
       w += stride) {
    const long long i = w * 4;
    const long long blk = i / bs;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < d; ++j) {
      const char4 v = *reinterpret_cast<const char4*>(q + j * n + i);
      const float sc = s[j * nb + blk];
      acc.x = dq_add(v.x, sc, j == 0, acc.x);
      acc.y = dq_add(v.y, sc, j == 0, acc.y);
      acc.z = dq_add(v.z, sc, j == 0, acc.z);
      acc.w = dq_add(v.w, sc, j == 0, acc.w);
    }
    *reinterpret_cast<float4*>(out + i) = acc;
  }
}

// one thread per element: any block size and any alignment
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int8_sum_elem(const int8_t* __restrict__ q, const float* __restrict__ s,
                         float* __restrict__ out, int d, long long n, int bs) {
  const long long nb = n / bs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long blk = i / bs;
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = dq_add(q[j * n + i], s[j * nb + blk], j == 0, acc);
    out[i] = acc;
  }
}

unsigned sum_grid(long long items) {
  const long long blocks = (items + SUM_THREADS - 1) / SUM_THREADS;
  return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
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

// q: (n,) int8, s: (n / bs,) f32 -> out: (n,) f32 or bf16. 16 elements a
// thread where bs % 16 == 0 and q and out are 16-byte aligned, else one.
extern "C" int dequantize_int8(const void* q, const void* s, void* out, int dtype,
                               long long n, int bs, void* stream) {
  if (n <= 0) return 0;
  if (bs <= 0 || (n + DEQ_THREADS - 1) / DEQ_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    dequantize_any<float>((const int8_t*)q, (const float*)s, (float*)out, n, bs, st);
  else if (dtype == DT_BF16)
    dequantize_any<__nv_bfloat16>((const int8_t*)q, (const float*)s,
                                  (__nv_bfloat16*)out, n, bs, st);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

// q: (d, nb * bs) int8, s: (d, nb) f32 -> out: (nb * bs,) f32, summed over d in
// order. vec4 != 0 asks for the 4-elements-per-thread path: the caller
// guarantees that bs is a multiple of 4, q is 4-byte and out 16-byte aligned.
extern "C" int dequantize_int8_sum(const void* q, const void* s, void* out, int d,
                                   long long nb, int bs, int vec4, void* stream) {
  if (nb <= 0) return 0;
  if (d <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const long long n = nb * bs;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    if (bs % 4 != 0) return (int)cudaErrorInvalidValue;
    dequantize_int8_sum_vec4<<<sum_grid(n / 4), SUM_THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)out, d, n, bs);
  } else {
    dequantize_int8_sum_elem<<<sum_grid(n), SUM_THREADS, 0, st>>>(
        (const int8_t*)q, (const float*)s, (float*)out, d, n, bs);
  }
  return launch_status();
}

// INT4 block quantize (nibble-packed), its dequantize, and the fused
// unpack-dequant-sum of the a2a gradient reduce-scatter.
//
// Replaces src/repro/kernels/quant_int4.py::quantize_int4_pallas (:46),
// ::dequantize_int4_pallas (:68) and ::dequantize_int4_sum_pallas (:105).
//
// quantize_int4: a flat tensor is cut into contiguous blocks of `bs` elements
// (bs even); each block gets scale = absmax * (1/7) (1 for an all-zero block)
// and q = clamp(rint(x / scale), -7, 7) + 8, two nibbles per byte with the
// even element in the low nibble. It is the send side of the reduce-scatter.
//
// dequantize_int4: nb packed blocks and their scales -> (nb, bs) f32 or bf16,
// (nibble - 8) * s in f32 with the low nibble to the even element, then cast.
//
// dequantize_int4_sum: d received chunks of nb packed blocks and their scales
// -> (nb, bs) f32 = sum_j q_j * s_j, summed in order j = 0..d-1. It is the
// receive side.
//
// Bound on the H100: bytes. Quantize reads each input once (2 or 4 bytes) and
// writes half a byte plus 4/bs bytes of scale; the dequantize reads half a
// byte plus 4/bs and writes the output dtype; the sum reads d * (1/2 + 4/bs)
// bytes and writes 4 per element. A few f32 operations per element are far
// below what the card issues for those bytes.
//
// Design: quantize reads each element once into registers. Its wide
// variant gives each lane units of 8 elements (one 16-byte load in bf16,
// two in f32) and each block a group of G = min(bs / 8, 32) lanes (a power
// of two), bs / (8 G) units a lane (at most 8): the absmax is an xor
// shuffle inside the group, the quotients come from the registers, and a
// unit's 8 nibbles go out as one 32-bit store (a warp's stores are 128
// contiguous bytes). G and the units a lane are template parameters (the
// shuffles unrolled, the indices constant-folded), and each warp takes one
// row of 32 / G blocks in a grid over all rows, with no loop. The warp
// variant (a warp a block, lanes striding over element pairs, a second
// pass from L1) takes every other block size (bs % 8 != 0, bs / 8 not a
// power of two or 32 times one, bs > 2,048) and x off the 16-byte grid;
// quantize_int4_path picks the variant from shape and alignment alone.
// The dequantize gives each thread 4 packed
// bytes (8 outputs: two float4 or one 16-byte bf16 store) when the block
// allows it, else one byte; block sizes run from 4 to 16,384 and the scale
// index is the byte index over bs / 2. The sum gives each thread 4 packed bytes (one
// 4-byte load per chunk, two float4 stores) when the chunk length allows it,
// else one byte. Numerics: the scale multiplies by the f32 reciprocal
// constant, as XLA does to `absmax / 7` under jit; the quotient is an IEEE
// division (no --use_fast_math) and rintf rounds half to even like
// jnp.round. The sum writes every product and every add as its own rounded
// operation (__fmul_rn, __fadd_rn), so nvcc cannot contract them into an FMA
// and the result is bit for bit the plain version's q * s, then +.
#include "common.cuh"

namespace {

constexpr int QUANT_WARPS = 8;
constexpr int SUM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QUANT_WARPS * 32)
quantize_int4_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
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
  const float scale = amax == 0.f ? 1.f : amax * (1.0f / 7.0f);
  uint8_t* qb = q + b * (bs / 2);
  for (int p = lane; p < bs / 2; p += 32) {
    const float lo = fminf(fmaxf(rintf(to_f32(xb[2 * p]) / scale), -7.f), 7.f);
    const float hi = fminf(fmaxf(rintf(to_f32(xb[2 * p + 1]) / scale), -7.f), 7.f);
    qb[p] = (uint8_t)(((int)lo + 8) | (((int)hi + 8) << 4));
  }
  if (lane == 0) s[b] = scale;
}

constexpr int Q4_THREADS = 256;
constexpr int Q4_MAX_UNITS = 8;  // units of 8 elements a lane: bs <= 2,048
enum { Q4_WARP = 0, Q4_WIDE = 1 };

// element e of a unit of 8 as loaded: bf16 in one uint4, f32 in two
__device__ __forceinline__ float unit_elem(const uint4 (&u)[1], int e) {
  const uint32_t w = (&u[0].x)[e / 2];
  return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
}
__device__ __forceinline__ float unit_elem(const uint4 (&u)[2], int e) {
  return __uint_as_float((&u[e / 4].x)[e % 4]);
}

// the wide variant: blocks of bs = 8 * G * CPL elements, G = 1 << GLOG
// lanes a block, CPL units of 8 a lane (lane l of a group takes units
// i * G + l, so a warp's loads and stores at step i are contiguous); each
// warp takes one row of 32 / G blocks
template <typename T, int GLOG, int CPL>
__global__ void __launch_bounds__(Q4_THREADS)
quantize_int4_wide_kernel(const T* __restrict__ x, uint32_t* __restrict__ q,
                          float* __restrict__ s, long long nb) {
  constexpr int G = 1 << GLOG, WORDS = sizeof(T) / 2;  // 16-byte words a unit
  const int lane = threadIdx.x % 32, sub = lane & (G - 1);
  const long long b = ((long long)blockIdx.x * Q4_THREADS + threadIdx.x) / 32 * (32 / G) +
                      (lane >> GLOG);
  const long long unit0 = b * G * CPL + sub;
  uint4 v[CPL][WORDS];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (unit0 + i * G) * 8);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) v[i][w] = b < nb ? __ldcs(p + w) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(unit_elem(v[i], e)));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (b >= nb) return;
  const float scale = amax == 0.f ? 1.f : amax * (1.0f / 7.0f);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // clamp(rint(x / scale), -7, 7) + 8 + 2^23: its low 4 bits are the nibble
      const float c =
          fminf(fmaxf(rintf(unit_elem(v[i], e) / scale), -7.f), 7.f) + 8388616.0f;
      word |= (__float_as_uint(c) & 0xFu) << (4 * e);
    }
    q[unit0 + i * G] = word;
  }
  if (sub == 0) s[b] = scale;
}

// log2 of the wide variant's lanes a block and its units a lane, or false
// when it does not take blocks of bs elements
bool q4_wide_shape(int bs, int* glog, int* cpl) {
  if (bs <= 0 || bs % 8 != 0) return false;
  const int units = bs / 8;
  const int g = units < 32 ? units : 32;
  if ((g & (g - 1)) != 0 || units % g != 0) return false;
  const int c = units / g;
  if (c > Q4_MAX_UNITS || (c & (c - 1)) != 0) return false;
  int lg = 0;
  while ((1 << lg) < g) ++lg;
  *glog = lg;
  *cpl = c;
  return true;
}

template <typename T, int GLOG, int CPL>
int launch_q4_wide(const void* x, void* q, void* s, long long nb, cudaStream_t st) {
  const long long rows = (nb + (32 >> GLOG) - 1) / (32 >> GLOG);  // one a warp
  const long long blocks = (rows + Q4_THREADS / 32 - 1) / (Q4_THREADS / 32);
  quantize_int4_wide_kernel<T, GLOG, CPL><<<(unsigned)blocks, Q4_THREADS, 0, st>>>(
      (const T*)x, (uint32_t*)q, (float*)s, nb);
  return launch_status();
}

template <typename T>
int launch_q4_wide_shape(const void* x, void* q, void* s, long long nb, int glog, int cpl,
                         cudaStream_t st) {
  switch (glog < 5 ? glog : 4 + cpl) {  // 32 lanes: 4 + cpl (1, 2, 4, 8)
    case 0: return launch_q4_wide<T, 0, 1>(x, q, s, nb, st);
    case 1: return launch_q4_wide<T, 1, 1>(x, q, s, nb, st);
    case 2: return launch_q4_wide<T, 2, 1>(x, q, s, nb, st);
    case 3: return launch_q4_wide<T, 3, 1>(x, q, s, nb, st);
    case 4: return launch_q4_wide<T, 4, 1>(x, q, s, nb, st);
    case 5: return launch_q4_wide<T, 5, 1>(x, q, s, nb, st);
    case 6: return launch_q4_wide<T, 5, 2>(x, q, s, nb, st);
    case 8: return launch_q4_wide<T, 5, 4>(x, q, s, nb, st);
    default: return launch_q4_wide<T, 5, 8>(x, q, s, nb, st);
  }
}

__device__ __forceinline__ void unpack_add(uint32_t byte, float sc, bool first,
                                           float& lo, float& hi) {
  const float ql = (float)((int)(byte & 0xFu) - 8);
  const float qh = (float)((int)((byte >> 4) & 0xFu) - 8);
  if (first) {
    lo = __fmul_rn(ql, sc);
    hi = __fmul_rn(qh, sc);
  } else {
    lo = __fadd_rn(lo, __fmul_rn(ql, sc));
    hi = __fadd_rn(hi, __fmul_rn(qh, sc));
  }
}

// one thread per 4 packed bytes; `half` (bytes per block) and the chunk
// length are multiples of 4, so the 4 bytes share one block's scale
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int4_sum_vec4(const uint8_t* __restrict__ q, const float* __restrict__ s,
                         float* __restrict__ out, int d, long long nbytes, int half) {
  const long long nb = nbytes / half;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < nbytes / 4;
       w += stride) {
    const long long i = w * 4;
    const long long blk = i / half;
    float v[8];
    for (int j = 0; j < d; ++j) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(q + j * nbytes + i);
      const float sc = s[j * nb + blk];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        unpack_add((word >> (8 * t)) & 0xFFu, sc, j == 0, v[2 * t], v[2 * t + 1]);
    }
    float4* o = reinterpret_cast<float4*>(out + 2 * i);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// one thread per packed byte: any even block size and any alignment
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int4_sum_byte(const uint8_t* __restrict__ q, const float* __restrict__ s,
                         float* __restrict__ out, int d, long long nbytes, int half) {
  const long long nb = nbytes / half;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nbytes;
       i += stride) {
    const long long blk = i / half;
    float lo = 0.f, hi = 0.f;
    for (int j = 0; j < d; ++j)
      unpack_add(q[j * nbytes + i], s[j * nb + blk], j == 0, lo, hi);
    out[2 * i] = lo;
    out[2 * i + 1] = hi;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* o, const float* v);
template <>
__device__ __forceinline__ void store8<float>(float* o, const float* v) {
  float4* p = reinterpret_cast<float4*>(o);
  p[0] = make_float4(v[0], v[1], v[2], v[3]);
  p[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* o, const float* v) {
  __align__(16) __nv_bfloat16 b[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) b[t] = from_f32<__nv_bfloat16>(v[t]);
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(b);
}

// one thread per 4 packed bytes: `half` is a multiple of 4, q is 4-byte and
// out 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int4_vec4(const uint8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, long long nbytes, int half) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < nbytes / 4;
       w += stride) {
    const long long i = w * 4;
    const uint32_t word = *reinterpret_cast<const uint32_t*>(q + i);
    const float sc = s[i / half];
    float v[8];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      unpack_add((word >> (8 * t)) & 0xFFu, sc, true, v[2 * t], v[2 * t + 1]);
    store8<T>(out + 2 * i, v);
  }
}

// one thread per packed byte: any even block size and any alignment
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
dequantize_int4_byte(const uint8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, long long nbytes, int half) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nbytes;
       i += stride) {
    float lo, hi;
    unpack_add(q[i], s[i / half], true, lo, hi);
    out[2 * i] = from_f32<T>(lo);
    out[2 * i + 1] = from_f32<T>(hi);
  }
}

unsigned grid_for(long long items) {
  const long long blocks = (items + SUM_THREADS - 1) / SUM_THREADS;
  return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

}  // namespace

// The quantize variant blocks of bs elements take: 0 = warp, 1 = wide
// (x_aligned: x starts on the 16-byte grid)
extern "C" int quantize_int4_path(int bs, int dtype, int x_aligned) {
  int glog, cpl;
  const bool typed = dtype == DT_F32 || dtype == DT_BF16;
  return typed && x_aligned && q4_wide_shape(bs, &glog, &cpl) ? Q4_WIDE : Q4_WARP;
}

// x: (nb * bs,) f32 or bf16 -> q: (nb * bs / 2,) uint8, s: (nb,) f32, on
// the variant quantize_int4_path names
extern "C" int quantize_int4(const void* x, int dtype, void* q, void* s,
                             long long nb, int bs, void* stream) {
  if (nb <= 0) return 0;
  if (bs <= 0 || bs % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (quantize_int4_path(bs, dtype, (uintptr_t)x % 16 == 0) == Q4_WIDE) {
    int glog, cpl;
    q4_wide_shape(bs, &glog, &cpl);
    if ((uintptr_t)q % 4 != 0) return (int)cudaErrorInvalidValue;
    return dtype == DT_F32
               ? launch_q4_wide_shape<float>(x, q, s, nb, glog, cpl, st)
               : launch_q4_wide_shape<__nv_bfloat16>(x, q, s, nb, glog, cpl, st);
  }
  const unsigned grid = (unsigned)((nb + QUANT_WARPS - 1) / QUANT_WARPS);
  if (dtype == DT_F32)
    quantize_int4_kernel<float><<<grid, QUANT_WARPS * 32, 0, st>>>(
        (const float*)x, (uint8_t*)q, (float*)s, nb, bs);
  else if (dtype == DT_BF16)
    quantize_int4_kernel<__nv_bfloat16><<<grid, QUANT_WARPS * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (uint8_t*)q, (float*)s, nb, bs);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

// q: (nb * bs / 2,) uint8, s: (nb,) f32 -> out: (nb * bs,) f32 or bf16.
// vec4 != 0 asks for the 4-bytes-per-thread path: the caller guarantees that
// bs / 2 is a multiple of 4, q is 4-byte and out 16-byte aligned.
extern "C" int dequantize_int4(const void* q, const void* s, void* out, int dtype,
                               long long nb, int bs, int vec4, void* stream) {
  if (nb <= 0) return 0;
  if (bs <= 0 || bs % 2 != 0 || (vec4 && (bs / 2) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int half = bs / 2;
  const long long nbytes = nb * half;
  const unsigned grid = grid_for(vec4 ? nbytes / 4 : nbytes);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* qb = (const uint8_t*)q;
  const float* sf = (const float*)s;
  if (dtype == DT_F32 && vec4)
    dequantize_int4_vec4<float><<<grid, SUM_THREADS, 0, st>>>(qb, sf, (float*)out,
                                                               nbytes, half);
  else if (dtype == DT_F32)
    dequantize_int4_byte<float><<<grid, SUM_THREADS, 0, st>>>(qb, sf, (float*)out,
                                                               nbytes, half);
  else if (dtype == DT_BF16 && vec4)
    dequantize_int4_vec4<__nv_bfloat16><<<grid, SUM_THREADS, 0, st>>>(
        qb, sf, (__nv_bfloat16*)out, nbytes, half);
  else if (dtype == DT_BF16)
    dequantize_int4_byte<__nv_bfloat16><<<grid, SUM_THREADS, 0, st>>>(
        qb, sf, (__nv_bfloat16*)out, nbytes, half);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

// q: (d, nb * bs / 2) uint8, s: (d, nb) f32 -> out: (nb * bs,) f32.
// vec4 != 0 asks for the 4-bytes-per-thread path: the caller guarantees that
// bs / 2 is a multiple of 4 and that q and out are 16-byte aligned.
extern "C" int dequantize_int4_sum(const void* q, const void* s, void* out, int d,
                                   long long nb, int bs, int vec4, void* stream) {
  if (nb <= 0) return 0;
  if (d <= 0 || bs <= 0 || bs % 2 != 0) return (int)cudaErrorInvalidValue;
  const int half = bs / 2;
  const long long nbytes = nb * half;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    if (half % 4 != 0) return (int)cudaErrorInvalidValue;
    dequantize_int4_sum_vec4<<<grid_for(nbytes / 4), SUM_THREADS, 0, st>>>(
        (const uint8_t*)q, (const float*)s, (float*)out, d, nbytes, half);
  } else {
    dequantize_int4_sum_byte<<<grid_for(nbytes), SUM_THREADS, 0, st>>>(
        (const uint8_t*)q, (const float*)s, (float*)out, d, nbytes, half);
  }
  return launch_status();
}

// Weight-gradient matmul with the block-quantize in its epilogue.
//
// Replaces src/repro/kernels/dequant_matmul.py::matmul_quant_pallas (:209):
//   C (K, N) = x (M, K)^T @ g (M, N), f32 products and sums, then each run of
//   `block` consecutive columns of a row of C is quantized with
//   scale = absmax * (1/qmax) (1 for an all-zero block) and
//   q = clamp(rint(c / scale), -qmax, qmax): INT8 (qmax 127) as (K, N) int8,
//   INT4 (qmax 7) as (K, N/2) uint8 with q + 8 nibble-packed, even column in
//   the low nibble. Scales are (K, N / block) f32: the flat wire layout of
//   quantize_int{8,4}(C.reshape(-1)).
//
// Bound on the H100: operations. The training step calls it with M = 2048
// tokens per rank and (K, N) up to 896 x 4864: 2*M*K*N f32 operations
// against M*(K+N)*4 bytes read and K*N/2 or K*N bytes written, well above
// the ~20 f32 operations per byte where the CUDA cores, not HBM, become the
// limit. The dense f32 C never reaches device memory: that is the point of
// the fusion on the TPU, and it is kept here.
//
// Design (simple first; wgmma/TMA come later): a plain shared-memory tiled
// SGEMM on the CUDA cores. A CTA owns a TK x TN tile of C with TN a multiple
// of the quant block, so every quant block of its rows is whole inside the
// tile. It walks M in steps of BM rows, staging x[m:m+BM, k-tile] and
// g[m:m+BM, n-tile] in shared memory; each of its 256 threads keeps a 4 x 8
// micro-tile of C in registers and accumulates with fmaf in m order. The
// epilogue writes the tile to shared memory (reusing the staging buffer), and
// one warp per (row, quant block) takes the absmax with shuffles, quantizes
// and packs. The summation order differs from cuBLAS's, so the kernel is
// held against its plain version to a tolerance (scales relative, q +-1).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 16;     // rows of M staged per step
constexpr int RK = 4;      // micro-tile rows (K) per thread
constexpr int RN = 8;      // micro-tile columns (N) per thread

template <int TK, int TN>
struct Tile {
  static_assert((TK / RK) * (TN / RN) == THREADS, "one micro-tile per thread");
  static constexpr int STAGE = BM * (TK + TN);
  static constexpr int OUT = TK * (TN + 1);
  static constexpr int SMEM = STAGE > OUT ? STAGE : OUT;
};

template <int TK, int TN, int BITS>
__global__ void __launch_bounds__(THREADS)
matmul_quant_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    uint8_t* __restrict__ q, float* __restrict__ s,
                    int M, int K, int N, int block) {
  __shared__ __align__(16) float smem[Tile<TK, TN>::SMEM];
  float* xs = smem;              // [BM][TK]
  float* gs = smem + BM * TK;    // [BM][TN]
  const int tx = threadIdx.x % (TN / RN), ty = threadIdx.x / (TN / RN);
  const int k0 = blockIdx.y * TK, n0 = blockIdx.x * TN;

  float acc[RK][RN];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int i = threadIdx.x; i < BM * TK; i += THREADS) {
      const int m = m0 + i / TK, k = k0 + i % TK;
      xs[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    for (int i = threadIdx.x; i < BM * TN; i += THREADS) {
      const int m = m0 + i / TN, n = n0 + i % TN;
      gs[i] = (m < M && n < N) ? g[(size_t)m * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BM; ++i) {
      float a[RK], b[RN];
#pragma unroll
      for (int r = 0; r < RK; ++r) a[r] = xs[i * TK + ty * RK + r];
      const float4* bp = reinterpret_cast<const float4*>(gs + i * TN + tx * RN);
      const float4 b0 = bp[0], b1 = bp[1];
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  // epilogue: the C tile through shared memory, then one warp per
  // (row, quant block) of it
  float* cs = smem;              // [TK][TN + 1]
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) cs[(ty * RK + r) * (TN + 1) + tx * RN + c] = acc[r][c];
  __syncthreads();

  constexpr float QMAX = BITS == 4 ? 7.f : 127.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_row = TN / block, nblk = N / block;
  for (int t = warp; t < TK * per_row; t += THREADS / 32) {
    const int r = t / per_row, jb = t % per_row;
    const int k = k0 + r, col0 = n0 + jb * block;
    if (k >= K || col0 >= N) continue;   // whole blocks: col0 < N => block fits
    const float* cr = cs + r * (TN + 1) + jb * block;
    float amax = 0.f;
    for (int e = lane; e < block; e += 32) amax = fmaxf(amax, fabsf(cr[e]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax == 0.f ? 1.f : amax * (1.0f / QMAX);
    if (BITS == 4) {
      uint8_t* qr = q + (size_t)k * (N / 2) + col0 / 2;
      for (int p = lane; p < block / 2; p += 32) {
        const float lo = fminf(fmaxf(rintf(cr[2 * p] / scale), -QMAX), QMAX);
        const float hi = fminf(fmaxf(rintf(cr[2 * p + 1] / scale), -QMAX), QMAX);
        qr[p] = (uint8_t)(((int)lo + 8) | (((int)hi + 8) << 4));
      }
    } else {
      int8_t* qr = reinterpret_cast<int8_t*>(q) + (size_t)k * N + col0;
      for (int e = lane; e < block; e += 32)
        qr[e] = (int8_t)fminf(fmaxf(rintf(cr[e] / scale), -QMAX), QMAX);
    }
    if (lane == 0) s[(size_t)k * nblk + col0 / block] = scale;
  }
}

template <int TK, int TN>
int launch(const float* x, const float* g, uint8_t* q, float* s, int M, int K, int N,
           int block, int bits, cudaStream_t st) {
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((K + TK - 1) / TK));
  if (bits == 4)
    matmul_quant_kernel<TK, TN, 4><<<grid, THREADS, 0, st>>>(x, g, q, s, M, K, N, block);
  else
    matmul_quant_kernel<TK, TN, 8><<<grid, THREADS, 0, st>>>(x, g, q, s, M, K, N, block);
  return launch_status();
}

}  // namespace

// x: (M, K) f32, g: (M, N) f32 -> q: (K, N) int8 (bits 8) or (K, N/2) uint8
// (bits 4), s: (K, N / block) f32. block must divide 512 and N.
extern "C" int matmul_quant(const void* x, const void* g, void* q, void* s, int M,
                            int K, int N, int block, int bits, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  if (block <= 0 || (block & (block - 1)) != 0 || block > 512 || N % block != 0 ||
      (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* gf = (const float*)g;
  uint8_t* qb = (uint8_t*)q;
  float* sf = (float*)s;
  if (block <= 128) return launch<64, 128>(xf, gf, qb, sf, M, K, N, block, bits, st);
  if (block == 256) return launch<32, 256>(xf, gf, qb, sf, M, K, N, block, bits, st);
  return launch<16, 512>(xf, gf, qb, sf, M, K, N, block, bits, st);
}

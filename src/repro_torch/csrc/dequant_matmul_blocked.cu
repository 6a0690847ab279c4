// Fused INT8-dequant x matmul with 2-D blocked scales.
//
// Replaces src/repro/kernels/dequant_matmul.py::dequant_matmul_pallas (:39):
//   out (M, N) f32 = x (M, K) f32 @ (q (K, N) int8 * s[k / bk, n]),
// where s is (K / bk, N) f32: one scale per column for each run of bk rows
// of q (the weight was quantized down K, per column). This is not the flat
// per-row layout of dequant_matmul.cu, whose scale of q[k, n] is
// s[k, n / block]; the two layouts index different elements, so the kernels
// stay separate.
//
// Bound on the H100: operations. 2*M*K*N f32 multiply-adds against
// 4*M*K + K*N + 4*K*N/bk + 4*M*N bytes; at the training shape (x 2,048 x 896,
// q 896 x 4,864, bk 128) that is 17.85 GFLOP (0.266 ms at 67 TFLOP/s f32)
// against 51 MB (0.015 ms at 3.35 TB/s).
//
// Design (simple first; tensor cores come later): a shared-memory tiled
// SGEMM on the CUDA cores. Each CTA of 256 threads owns a 64 x 64 tile of the
// output and walks K in steps of 32 rows. Each step stages x[m0:m0+64, k:k+32]
// (transposed, so a thread's 4 rows are adjacent) and the q tile
// q[k:k+32, n0:n0+64] in shared memory; the q tile is dequantized as it is
// loaded, each element with the scale row of its own K block,
// s[(k / bk), n], so the weight never exists dense in device memory and a K
// step may cross a K-block edge. Each thread keeps a 4 x 4 micro-tile of
// the output in registers and accumulates with fmaf in k order. M, N and K
// edges are masked (zeros in shared memory, no store). The summation order
// differs from the plain version's one f32 matmul, so the kernel is held to
// a tolerance (rtol 2e-5, atol 5e-4 * max|ref|, the reference's own between
// its kernel and its oracle).
#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 32;
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int RM = 4, RN = 4;

__global__ void __launch_bounds__(THREADS)
dequant_matmul_blocked_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                              const float* __restrict__ s, float* __restrict__ out,
                              int M, int K, int N, int bk) {
  // x tile, transposed; 4 floats of padding keep the transposing stores off
  // one bank and each row 16-byte aligned
  __shared__ __align__(16) float xs[TK][TM + 4];
  __shared__ __align__(16) float ws[TK][TN];   // dequantized q tile
  const int tx = threadIdx.x % (TN / RN), ty = threadIdx.x / (TN / RN);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x: consecutive threads read consecutive k of one row
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      const int r = i / TK, kk = i % TK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    // q: consecutive threads read consecutive n of one row
    for (int i = threadIdx.x; i < TK * TN; i += THREADS) {
      const int kk = i / TN, c = i % TN;
      const int k = k0 + kk, n = n0 + c;
      ws[kk][c] = (k < K && n < N)
                      ? (float)q[(size_t)k * N + n] * s[(size_t)(k / bk) * N + n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * RM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * RN]);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      const float bv[RN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int n = n0 + tx * RN + c;
      if (n < N) out[(size_t)m * N + n] = acc[r][c];
    }
  }
}

}  // namespace

// x: (M, K) f32, q: (K, N) int8, s: (K / bk, N) f32 -> out: (M, N) f32.
// bk must divide K.
extern "C" int dequant_matmul_blocked(const void* x, const void* q, const void* s,
                                      void* out, int M, int K, int N, int bk,
                                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || bk <= 0 || K % bk != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((M + TM - 1) / TM));
  dequant_matmul_blocked_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)s, (float*)out, M, K, N, bk);
  return launch_status();
}

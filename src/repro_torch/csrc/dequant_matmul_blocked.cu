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
// Bounds on the H100 at the training shape (x 2,048 x 896, q 896 x 4,864,
// bk 128): 17.85 GFLOP, 0.266 ms at the f32 CUDA-core peak of 67 TFLOP/s
// (operations); the tensor-core path's three bf16 products 53.6 GFLOP,
// 0.054 ms at 989 TFLOP/s; 51 MB of bytes (4*M*K + K*N + 4*K*N/bk + 4*M*N),
// 0.015 ms at 3.35 TB/s.
//
// Two paths, chosen by shape alone (dequant_matmul_blocked_path):
//  * tensor cores (wgmma), for bk % 64 == 0, K % 8 == 0 and N % 8 == 0 (q
//    rows 8-byte, x, s and out rows 16-byte aligned): qwen2's w_up at the
//    training M and the reference test's shapes;
//  * SIMT f32 FMA for the rest (bk 20 or 32, ragged N).
//
// Tensor-core path. q is exact in bf16 (|q| <= 127). Each f32 x is split
// into three bf16 terms, h = bf16(x), m = bf16(x - h), l = bf16(x - h - m),
// which hold all 24 bits of x; each product of a term with q is exact in
// f32. A CTA owns a 128 x 128 tile of out, two warpgroups of 64 rows, and
// walks K in stages of 64 rows through a 4-deep cp.async ring of the raw
// f32 x tile (rows padded to 68 floats, so the fragment reads spread over
// the banks), the raw int8 q tile and the stage's 128 scales. Each stage:
// all threads widen q to bf16 into one buffer laid out MN-major under the
// 128-byte swizzle (two 64-column atoms), which wgmma reads through its
// transpose immediate as B; A comes from registers, each thread splitting
// its own fragment of x (rows g, g + 8; columns 2t, 2t + 1, 2t + 8, 2t + 9
// of a k16 slice) into the three terms while the tensor cores run the
// previous slice (wgmma.m64n128k16, three a slice, f32 accumulators). The
// tensor core's own accumulator rounds toward zero, so it runs over one
// stage only: each stage lies inside one bk block (bk % 64 == 0), and its
// sum is folded into the f32 result in ordinary arithmetic, scaled by the
// stage's s[kb, n]: acc += s * part. Only the order of the f32 sums differs
// from the reference; deterministic (no atomics).
//
// SIMT path (the port's first design): a shared-memory tiled SGEMM on the
// CUDA cores. Each CTA of 256 threads owns a 64 x 64 tile of the output and
// walks K in steps of 32 rows. Each step stages x[m0:m0+64, k:k+32]
// (transposed, so a thread's 4 rows are adjacent) and the q tile
// q[k:k+32, n0:n0+64] in shared memory; the q tile is dequantized as it is
// loaded, each element with the scale row of its own K block,
// s[(k / bk), n], so the weight never exists dense in device memory and a K
// step may cross a K-block edge. Each thread keeps a 4 x 4 micro-tile of
// the output in registers and accumulates with fmaf in k order. M, N and K
// edges are masked (zeros in shared memory, no store).
//
// Both paths sum in another order than the plain version's one f32 matmul,
// so the kernel is held to a tolerance (rtol 2e-5, atol 5e-4 * max|ref|,
// the reference's own between its kernel and its oracle).
#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// tensor-core path
// ---------------------------------------------------------------------------

enum { PATH_SIMT = 0, PATH_TC = 1 };

constexpr int BT_M = 128, BT_N = 128;  // output tile
constexpr int BT_K = 64;               // contraction rows a stage
constexpr int BT_STAGES = 4;           // cp.async ring depth
constexpr int BT_THREADS = 256;        // two warpgroups
constexpr int BT_XLD = BT_K + 4;       // floats of a staged x row
constexpr int BT_TERMS = 3;            // bf16 terms of each f32 x: h, m, l

struct BtStage {
  float x[BT_M * BT_XLD];   // x[m0 + r][kc + c] at r * BT_XLD + c
  int8_t q[BT_K * BT_N];    // q[kc + r][n0 + c] at r * BT_N + c
  float s[BT_N];            // s[kc / bk][n0 + c]
};
struct alignas(1024) BtWeights {  // the stage's q as bf16, MN-major, 128-byte swizzle
  __nv_bfloat16 w[2][BT_K * 64];  // two atoms of 64 columns, one 128-byte row a k
};
constexpr size_t BT_SMEM = sizeof(BtWeights) + BT_STAGES * sizeof(BtStage) + 1024;
constexpr uint32_t BT_ATOM_BYTES = BT_K * 64 * 2;

bool bt_takes(int K, int N, int bk) {
  return bk > 0 && bk % BT_K == 0 && K % bk == 0 && K % 8 == 0 && N % 8 == 0;
}

// two f32 -> their h, m, l bf16 terms, one bf16 pair each (exact: each
// residual fits the next term's 8 bits)
__device__ __forceinline__ void split3(float2 v, uint32_t (&r)[BT_TERMS]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float ax = v.x - __low2float(h), ay = v.y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ax, ay);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ax - __low2float(m), ay - __high2float(m));
  r[0] = *reinterpret_cast<const uint32_t*>(&h);
  r[1] = *reinterpret_cast<const uint32_t*>(&m);
  r[2] = *reinterpret_cast<const uint32_t*>(&l);
}

// out (M, N) f32 = x (M, K) f32 @ (q * s); grid (N tiles, M tiles)
__global__ void __launch_bounds__(BT_THREADS, 1)
dmb_tc_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, float* __restrict__ out, int M, int K, int N,
              int bk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  BtWeights& wt = *reinterpret_cast<BtWeights*>(smem);
  BtStage* st = reinterpret_cast<BtStage*>(smem + sizeof(BtWeights));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int m0 = blockIdx.y * BT_M, n0 = blockIdx.x * BT_N;
  const int nk = K / BT_K;

  auto load = [&](int kt) {
    BtStage& S = st[kt % BT_STAGES];
    const int kc = kt * BT_K;
#pragma unroll
    for (int h = 0; h < BT_M * (BT_K / 4) / BT_THREADS; ++h) {  // 16-byte chunks of x
      const int i = tid + h * BT_THREADS, r = i / (BT_K / 4), c = i % (BT_K / 4);
      const bool in = m0 + r < M;
      cp_async16(&S.x[r * BT_XLD + c * 4], in ? x + (size_t)(m0 + r) * K + kc + c * 4 : x, in);
    }
#pragma unroll
    for (int h = 0; h < BT_K * (BT_N / 8) / BT_THREADS; ++h) {  // 8-byte chunks of q
      const int i = tid + h * BT_THREADS, r = i / (BT_N / 8), c = i % (BT_N / 8);
      const bool in = n0 + c * 8 < N;
      cp_async8(&S.q[r * BT_N + c * 8], in ? q + (size_t)(kc + r) * N + n0 + c * 8 : q, in);
    }
    if (tid < BT_N / 4) {
      const bool in = n0 + tid * 4 < N;
      cp_async16(&S.s[tid * 4], in ? s + (size_t)(kc / bk) * N + n0 + tid * 4 : s, in);
    }
  };
  // the raw int8 q of stage kt -> bf16 (exact) in wgmma's MN-major layout
  auto widen = [&](int kt) {
    const BtStage& S = st[kt % BT_STAGES];
#pragma unroll
    for (int h = 0; h < BT_K * (BT_N / 8) / BT_THREADS; ++h) {
      const int i = tid + h * BT_THREADS, r = i / (BT_N / 8), j = i % (BT_N / 8);
      const uint2 raw = *reinterpret_cast<const uint2*>(&S.q[r * BT_N + j * 8]);
      uint4 w;
      i8x4_to_bf16x4(raw.x, w.x, w.y);
      i8x4_to_bf16x4(raw.y, w.z, w.w);
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(wt.w[j / 8]) + sw128(r, j % 8)) = w;
    }
  };
  // the A fragments (h, m, l) of k16 slice kk of stage kt: rows g, g + 8 of
  // this warp's 16, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3)
  const int r0 = wg * 64 + (warp % 4) * 16 + g;
  auto frag = [&](int kt, int kk, uint32_t (&A)[BT_TERMS][4]) {
    const float* xr = st[kt % BT_STAGES].x + r0 * BT_XLD + kk * 16 + 2 * t;
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // a0: (g, 2t) a1: (g + 8, 2t) a2: (g, 2t + 8) a3
      const float2 v = *reinterpret_cast<const float2*>(xr + (p & 1) * 8 * BT_XLD + (p >> 1) * 8);
      uint32_t r[BT_TERMS];
      split3(v, r);
#pragma unroll
      for (int e = 0; e < BT_TERMS; ++e) A[e][p] = r[e];
    }
  };
  auto keep = [&](uint32_t (&A)[BT_TERMS][4]) {
#pragma unroll
    for (int e = 0; e < BT_TERMS; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) keep_operand(A[e][i]);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int i = 0; i < BT_STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  const uint64_t db = sw128_mn_desc(wt.w[0], BT_ATOM_BYTES);
  uint32_t a[2][BT_TERMS][4];
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<BT_STAGES - 2>();
    __syncthreads();  // stage kt has landed; every thread is done with stage kt - 1
    widen(kt);
    fence_proxy_async();
    if (kt + BT_STAGES - 1 < nk) load(kt + BT_STAGES - 1);
    cp_async_commit();
    __syncthreads();  // the widened q is visible to both warpgroups' wgmma
    frag(kt, 0, a[0]);
#pragma unroll
    for (int kk = 0; kk < BT_K / 16; ++kk) {
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < BT_TERMS; ++e)
        wgmma_m64n128k16_rs<1>(part, a[kk & 1][e], db + 128 * kk, kk > 0 || e > 0);
      wgmma_commit();
      wgmma_wait<1>();  // slice kk - 1 is done: its fragments may be rewritten
      keep(a[(kk + 1) & 1]);
      if (kk + 1 < BT_K / 16) frag(kt, kk + 1, a[(kk + 1) & 1]);
    }
    wgmma_wait<0>();
    keep(a[1]);
    // the stage's sum, scaled by its block's s[kb, n], into the f32 result;
    // part[4 ni + 2 h + e] is row g + 8 h, column 8 ni + 2 t + e
    const float* sc = st[kt % BT_STAGES].s;
#pragma unroll
    for (int ni = 0; ni < BT_N / 8; ++ni) {
      const float2 v = *reinterpret_cast<const float2*>(&sc[ni * 8 + 2 * t]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fence_operand(part[4 * ni + 2 * h]);
        fence_operand(part[4 * ni + 2 * h + 1]);
        acc[4 * ni + 2 * h] = fmaf(part[4 * ni + 2 * h], v.x, acc[4 * ni + 2 * h]);
        acc[4 * ni + 2 * h + 1] = fmaf(part[4 * ni + 2 * h + 1], v.y, acc[4 * ni + 2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();

  const int row_base = m0 + r0;
#pragma unroll
  for (int ni = 0; ni < BT_N / 8; ++ni) {
    const int col = n0 + ni * 8 + 2 * t;  // N % 8 == 0: col + 1 < N too
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
      if (row < M)
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
            make_float2(acc[4 * ni + 2 * h], acc[4 * ni + 2 * h + 1]);
    }
  }
}

int launch_tc(const float* x, const int8_t* q, const float* s, float* out, int M, int K, int N,
              int bk, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmb_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BT_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((N + BT_N - 1) / BT_N), (unsigned)((M + BT_M - 1) / BT_M));
  dmb_tc_kernel<<<grid, BT_THREADS, BT_SMEM, st>>>(x, q, s, out, M, K, N, bk);
  return launch_status();
}

}  // namespace

// The path a call of this shape takes: 0 = SIMT, 1 = tensor cores
extern "C" int dequant_matmul_blocked_path(int M, int K, int N, int bk) {
  (void)M;
  return bt_takes(K, N, bk) ? PATH_TC : PATH_SIMT;
}

// x: (M, K) f32, q: (K, N) int8, s: (K / bk, N) f32 -> out: (M, N) f32 on the
// given path. bk must divide K; fails on a shape or alignment the path does
// not take (the tensor cores want 16-byte aligned x and s, 8-byte aligned q).
extern "C" int dequant_matmul_blocked_on_path(const void* x, const void* q, const void* s,
                                              void* out, int M, int K, int N, int bk,
                                              int path, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || bk <= 0 || K % bk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == PATH_TC) {
    if (!bt_takes(K, N, bk) || ((uintptr_t)x | (uintptr_t)s) % 16 != 0 || (uintptr_t)q % 8 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_tc((const float*)x, (const int8_t*)q, (const float*)s, (float*)out, M, K, N,
                     bk, st);
  }
  if (path != PATH_SIMT) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((M + TM - 1) / TM));
  dequant_matmul_blocked_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)x, (const int8_t*)q, (const float*)s, (float*)out, M, K, N, bk);
  return launch_status();
}

// Weight-gradient matmul with the block-quantize in its epilogue.
//
// Replaces src/repro/kernels/dequant_matmul.py::matmul_quant_pallas (:209):
//   C (K, N) = x (M, K)^T @ g (M, N), f32 products and sums, then each run of
//   `block` consecutive columns of a row of C is quantized with
//   scale = absmax * (1/qmax) (1 for an all-zero block) and
//   q = clamp(rint(c / scale), -qmax, qmax): INT8 (qmax 127) as (K, N) int8,
//   INT4 (qmax 7) as (K, N/2) uint8 with q + 8 nibble-packed, even column in
//   the low nibble. Scales are (K, N / block) f32: the flat wire layout of
//   quantize_int{8,4}(C.reshape(-1)). x and g share one dtype, f32 or bf16;
//   as on the TPU, each operand keeps its own dtype and is widened to f32
//   for the products (a bf16 x bf16 product is exact in f32).
//
// Bound on the H100: operations. The training step calls it with M = 2048
// tokens per rank and (K, N) up to 896 x 4864 in bf16: one layer's seven
// products are 61 GFLOP, 0.0617 ms at the bf16 tensor peak (0.911 ms at the
// f32 CUDA-core peak), against 0.1 ms of bytes. The dense f32 C never
// reaches device memory: that is the point of the fusion on the TPU, and it
// is kept here on both paths.
//
// Two paths, chosen by shape and dtype alone (matmul_quant_path):
//  * tensor cores (TMA + wgmma), for bf16 with K % 8 == 0 and N % 8 == 0
//    (TMA's 16-byte row strides) and a block of 8 ... 128 (whole 4-byte
//    words of q, whole inside the tile's 128 columns): every fused dW of
//    the bf16 training step;
//  * SIMT f32 FMA for everything else: f32 operands, rows off the 16-byte
//    grid, and blocks of 256 or 512 (or below 8).
//
// Tensor-core path: a CTA owns a 128 x 128 tile of C (128 rows of K, 128
// columns of N). One producer warp walks M in stages of 64 rows: for each it
// waits on the stage's `empty` mbarrier and has TMA copy four 64 x 64 bf16
// boxes (x[m:m+64, k0:k0+128] and g[m:m+64, n0:n0+128]) into a 4-deep ring
// under the 128-byte swizzle, completing on the stage's `full` mbarrier.
// Two consumer warpgroups each own 64 rows of the tile. The contraction
// index M is the row index of both x and g in device memory, so both wgmma
// operands are MN-major as TMA lays them down: wgmma.m64n128k16 reads them
// through its transpose immediates with an MN-major descriptor
// (sw128_mn_desc), which spares a transposing pass through shared memory.
// Each stage's four k16 products sum into a partial f32 tile that is added
// to the f32 accumulator in ordinary arithmetic after the stage (the tensor
// core's own accumulator rounds toward zero; 64 + 64 registers a thread).
// The epilogue writes the f32 tile into the ring's shared memory; each
// consumer thread then quantizes half a row (64 columns) and stores q as
// whole 4-byte words.
// Deterministic: no atomics, a fixed order of sums (64-row stages in order).
//
// SIMT path (the port's first design): a plain shared-memory tiled
// SGEMM on the CUDA cores. A CTA owns a TK x TN tile of C with TN a multiple
// of the quant block. It walks M in steps of BM rows, staging x and g in
// shared memory as f32 (a bf16 operand is widened on the load); each of its
// 256 threads keeps a 4 x 8 micro-tile of C in registers and accumulates
// with fmaf in m order. The epilogue writes the tile to shared memory, and
// one warp per (row, quant block) takes the absmax with shuffles, quantizes
// and packs.
//
// Both paths sum in another order than cuBLAS, so the kernel is held against
// its plain version to a tolerance (scales relative, q +-1).
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time

#include "tensor_core.cuh"

namespace {

enum { PATH_SIMT = 0, PATH_TC = 1 };

// ---------------------------------------------------------------------------
// SIMT path
// ---------------------------------------------------------------------------

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

template <typename T, int TK, int TN, int BITS>
__global__ void __launch_bounds__(THREADS)
matmul_quant_simt_kernel(const T* __restrict__ x, const T* __restrict__ g,
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
      xs[i] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < BM * TN; i += THREADS) {
      const int m = m0 + i / TN, n = n0 + i % TN;
      gs[i] = (m < M && n < N) ? to_f32(g[(size_t)m * N + n]) : 0.f;
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

template <typename T, int TK, int TN>
int launch_simt(const void* x, const void* g, uint8_t* q, float* s, int M, int K, int N,
                int block, int bits, cudaStream_t st) {
  const T* xt = (const T*)x;
  const T* gt = (const T*)g;
  dim3 grid((unsigned)((N + TN - 1) / TN), (unsigned)((K + TK - 1) / TK));
  if (bits == 4)
    matmul_quant_simt_kernel<T, TK, TN, 4><<<grid, THREADS, 0, st>>>(xt, gt, q, s, M, K, N, block);
  else
    matmul_quant_simt_kernel<T, TK, TN, 8><<<grid, THREADS, 0, st>>>(xt, gt, q, s, M, K, N, block);
  return launch_status();
}

template <typename T>
int launch_simt_tiles(const void* x, const void* g, uint8_t* q, float* s, int M, int K, int N,
                      int block, int bits, cudaStream_t st) {
  if (block <= 128) return launch_simt<T, 64, 128>(x, g, q, s, M, K, N, block, bits, st);
  if (block == 256) return launch_simt<T, 32, 256>(x, g, q, s, M, K, N, block, bits, st);
  return launch_simt<T, 16, 512>(x, g, q, s, M, K, N, block, bits, st);
}

// ---------------------------------------------------------------------------
// tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_TK = 128, TC_TN = 128;  // C tile: K rows x N columns
constexpr int TC_BM = 64;                // contraction rows a stage
constexpr int TC_STAGES = 4;             // TMA ring depth
constexpr int TC_CONSUMERS = 256;        // two warpgroups, 64 rows of the tile each
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and one producer warp
constexpr int BOX = 64;                  // TMA box: 64 rows x 64 bf16 (128 bytes)
constexpr uint32_t BOX_BYTES = BOX * BOX * 2;
constexpr int TC_MIN_BLOCK = 8;          // a quant block fills whole 4-byte words of q

constexpr int TC_LD = TC_TN + 1;  // odd: a warp reads one column of 32 rows conflict-free

struct alignas(1024) TcStage {
  __nv_bfloat16 x[2][BOX * BOX];  // x[m][k0 + 64 h + c]: warpgroup h's A
  __nv_bfloat16 g[2][BOX * BOX];  // g[m][n0 + 64 h + c]: B, two 64-column atoms
};
constexpr size_t TC_SMEM = TC_STAGES * sizeof(TcStage) + 2 * TC_STAGES * sizeof(uint64_t) + 1024;

static_assert((TC_TK * TC_LD + 2 * TC_TK) * sizeof(float) <= TC_STAGES * sizeof(TcStage),
              "the epilogue's C tile fits in the ring");

// a barrier of the two consumer warpgroups alone (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONSUMERS) : "memory");
}

bool tc_takes(int M, int K, int N, int block, int dtype) {
  return dtype == DT_BF16 && M > 0 && K % 8 == 0 && N % 8 == 0 && block >= TC_MIN_BLOCK &&
         block <= TC_TN;
}

// q, s from bf16 x (M, K) and g (M, N) read through the tensor maps tx, tg;
// grid (N tiles, K tiles)
template <int BITS>
__global__ void __launch_bounds__(TC_THREADS, 1)
matmul_quant_tc_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tg, uint8_t* __restrict__ q,
                       float* __restrict__ s, int M, int K, int N, int block) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  TcStage* st = reinterpret_cast<TcStage*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * sizeof(TcStage));
  uint64_t* empty = full + TC_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.y * TC_TK, n0 = blockIdx.x * TC_TN;
  const int nst = (M + TC_BM - 1) / TC_BM;

  if (tid == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TC_CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {
    // producer: a box wholly past K or N is not fetched (its rows or
    // columns of C are never stored); one partly past the edge is
    // zero-filled by TMA and still counts whole
    if (lane == 0) {
      const bool x1 = k0 + BOX < K, g1 = n0 + BOX < N;
      const uint32_t bytes = (2 + x1 + g1) * BOX_BYTES;
      for (int it = 0; it < nst; ++it) {
        const int i = it % TC_STAGES, m = it * TC_BM;
        mbar_wait(&empty[i], ((it / TC_STAGES) & 1) ^ 1);
        TcStage& S = st[i];
        mbar_arrive_expect_tx(&full[i], bytes);
        tma_load_2d(S.x[0], &tx, &full[i], k0, m);
        if (x1) tma_load_2d(S.x[1], &tx, &full[i], k0 + BOX, m);
        tma_load_2d(S.g[0], &tg, &full[i], n0, m);
        if (g1) tma_load_2d(S.g[1], &tg, &full[i], n0 + BOX, m);
      }
    }
    return;
  }

  const int wg = warp / 4, g8 = lane / 4, t = lane % 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int it = 0; it < nst; ++it) {
    const int i = it % TC_STAGES;
    mbar_wait(&full[i], (it / TC_STAGES) & 1);
    __syncwarp();  // the warp converged again for wgmma's .aligned instructions
    const TcStage& S = st[i];
    const uint64_t da = sw128_mn_desc(S.x[wg], BOX_BYTES);
    const uint64_t db = sw128_mn_desc(S.g[0], BOX_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BM / 16; ++kk)
      wgmma_m64n128k16<1>(part, da + 128 * kk, db + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) fence_operand(part[j]);
    if (lane == 0) mbar_arrive(&empty[i]);  // the warp's wgmma have read the stage
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
  }

  // epilogue: the f32 tile through shared memory, then thread (row r, half
  // hh) quantizes 64 columns of row r in compact loops. (Unrolled over the
  // tile held in registers, the quantize was 4,700 instructions of
  // straight-line code, fetched anew by every warp.) acc[4 ni + 2 h + e] is
  // C[row h][8 ni + 2 t + e] of the tile.
  float* cs = reinterpret_cast<float*>(smem);  // [TC_TK][TC_LD]
  float* ex = cs + TC_TK * TC_LD;               // [2][TC_TK]: a row's halves meet
  consumers_sync();  // every warpgroup's last wgmma has read the ring
  const int rl = wg * 64 + (warp % 4) * 16 + g8;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      cs[(rl + 8 * h) * TC_LD + ni * 8 + 2 * t] = acc[4 * ni + 2 * h];
      cs[(rl + 8 * h) * TC_LD + ni * 8 + 2 * t + 1] = acc[4 * ni + 2 * h + 1];
    }
  consumers_sync();

  constexpr float QMAX = BITS == 4 ? 7.f : 127.f;
  constexpr int HALF = TC_TN / 2;
  const int r = tid % TC_TK, hh = tid / TC_TK, k = k0 + r;
  const int span = block < HALF ? block : HALF;  // a block's columns in one half
  const int nblk = N / block;
  const float* cr = cs + r * TC_LD + hh * HALF;
  for (int b = 0; b < HALF; b += span) {
    const int col = n0 + hh * HALF + b;
    float amax = 0.f;
    for (int c = 0; c < span; ++c) amax = fmaxf(amax, fabsf(cr[b + c]));
    if (block > HALF) {  // block == 128: the row's two halves meet (once)
      ex[hh * TC_TK + r] = amax;
      consumers_sync();
      amax = fmaxf(amax, ex[(1 - hh) * TC_TK + r]);
    }
    if (k >= K || col >= N) continue;  // N % block == 0: a block is wholly in or out
    const float scale = amax == 0.f ? 1.f : amax * (1.0f / QMAX);
    if (col % block == 0) s[(size_t)k * nblk + col / block] = scale;
    // whole 4-byte words: col % 8 == 0 and N % 8 == 0
    if (BITS == 4) {
      uint32_t* qw = reinterpret_cast<uint32_t*>(q + (size_t)k * (N / 2) + col / 2);
      for (int c = 0; c < span; c += 8) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = fminf(fmaxf(rintf(cr[b + c + e] / scale), -QMAX), QMAX);
          w |= (uint32_t)((int)v + 8) << (4 * e);  // even column in the low nibble
        }
        qw[c / 8] = w;
      }
    } else {
      uint32_t* qw = reinterpret_cast<uint32_t*>(q + (size_t)k * N + col);
      for (int c = 0; c < span; c += 4) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = fminf(fmaxf(rintf(cr[b + c + e] / scale), -QMAX), QMAX);
          w |= ((uint32_t)(int)v & 0xFFu) << (8 * e);
        }
        qw[c / 4] = w;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (so the library needs no link against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// a row-major bf16 (rows, cols) matrix read in 64 x 64 boxes under the
// 128-byte swizzle; cols % 8 == 0 and a 16-byte aligned base
int tensor_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BITS>
int launch_tc(const void* x, const void* g, uint8_t* q, float* s, int M, int K, int N,
              int block, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_quant_tc_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tx, tg;
  int rc = tensor_map(&tx, x, M, K);
  if (rc == 0) rc = tensor_map(&tg, g, M, N);
  if (rc != 0) return rc;
  dim3 grid((unsigned)((N + TC_TN - 1) / TC_TN), (unsigned)((K + TC_TK - 1) / TC_TK));
  matmul_quant_tc_kernel<BITS><<<grid, TC_THREADS, TC_SMEM, st>>>(tx, tg, q, s, M, K, N, block);
  return launch_status();
}

}  // namespace

// The path a call of this shape and dtype takes: 0 = SIMT, 1 = tensor cores
extern "C" int matmul_quant_path(int M, int K, int N, int block, int dtype) {
  return tc_takes(M, K, N, block, dtype) ? PATH_TC : PATH_SIMT;
}

// x: (M, K), g: (M, N), both f32 or both bf16 (dtype) -> q: (K, N) int8
// (bits 8) or (K, N/2) uint8 (bits 4), s: (K, N / block) f32, on the given
// path. block must be a power of two up to 512 that divides N; fails on a
// shape, dtype or alignment the path does not take (the tensor cores want
// 16-byte aligned x and g).
extern "C" int matmul_quant_on_path(const void* x, const void* g, void* q, void* s, int dtype,
                                    int M, int K, int N, int block, int bits, int path,
                                    void* stream) {
  if (K <= 0 || N <= 0) return 0;
  if (block <= 0 || (block & (block - 1)) != 0 || block > 512 || N % block != 0 ||
      (bits != 4 && bits != 8) || (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* qb = (uint8_t*)q;
  float* sf = (float*)s;
  if (path == PATH_TC) {
    if (!tc_takes(M, K, N, block, dtype) || ((uintptr_t)x | (uintptr_t)g) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return bits == 4 ? launch_tc<4>(x, g, qb, sf, M, K, N, block, st)
                     : launch_tc<8>(x, g, qb, sf, M, K, N, block, st);
  }
  if (path != PATH_SIMT) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch_simt_tiles<float>(x, g, qb, sf, M, K, N, block, bits, st);
  return launch_simt_tiles<__nv_bfloat16>(x, g, qb, sf, M, K, N, block, bits, st);
}

// Fused INT8-dequant x matmul on the flat-shard scale layout.
//
// Replaces src/repro/kernels/dequant_matmul.py::dequant_matmul_flat_pallas
// (:113), both orientations:
//   transpose = 0: out (M, N) = x (M, K) @ dequant(q (K, N))
//   transpose = 1: out (M, K) = x (M, N) @ dequant(q (K, N)).T
// The scale of q[k, j] is s[k, j / block] (N % block == 0). x and out share
// the compute dtype (f32 or bf16); sums are f32.
//
// Three paths, chosen by shape and dtype alone (dequant_matmul_path), in
// this order (the crossovers measured on the card: PERF.md):
//  * decode, for x @ W.T at M <= DEC_MAX_M_T = 16 with block % 16 == 0:
//    f32 or bf16 rows of N <= 4,096 (dmm_dec_tn_kernel) and bf16 rows past
//    4,096 (dmm_dec_tn_wide_kernel): the LM heads of serving, NeoX's
//    untied heads (N = 6,144 and 5,120) among them; and for bf16 x @ W at
//    M <= DEC_MAX_M = 8 (block % 64 == 0, K % 8 == 0): every decode-step
//    layer product;
//  * tensor cores (wgmma), for bf16 with block % 64 == 0, K % 8 == 0 (every
//    bf16 row of x and out 16-byte aligned, as cp.async needs) and
//    M >= TC_MIN_M = 5 for x @ W (past the decode path's 8 in bf16),
//    M >= TC_MIN_M_T = 64 for x @ W.T: the
//    M = 128 prefills and the M = 2,048 training products;
//  * SIMT f32 FMA for everything else: f32 x @ W at any M, f32 at larger
//    M, f32 x @ W.T past N = 4,096, bf16 x @ W.T at M = 17 ... 63, blocks
//    that are not a multiple of 64 (x @ W) or 16 (x @ W.T), and shapes
//    neither of the others takes.
//
// Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16; weight, scales, x and out
// each moved once): decode at M = 4, bytes: qwen2-0.5b 0.04-1.36 us a layer
// call and 42 us its LM head (151,936 x 896), falcon-mamba-7b's w_in
// (4,096 x 16,384) 20.7 us, w_dt 0.67 us, w_out 10.4 us and its LM head
// (65,024 x 4,096) 82 us; prefill at M = 128 (qwen2 0.11-1.78 us a call,
// falcon-mamba's w_in 22.2 us, w_out 11.3 us: bytes, with the tensor work
// within 1.3x of them); the training step at M = 2,048, 0.47-18.1 us a call
// (operations: one layer's 7 products 61 GFLOP, 0.0617 ms).
//
// Decode path (x @ W.T, the LM head, N <= 4,096): at small M the call is a stream of
// int8 weight bytes, each read once. Persistent CTAs walk runs of
// consecutive q rows, one contiguous 16-byte cp.async copy (.cg, not kept in
// L1) a stage of a 3-deep ring in shared memory that all threads fill, so
// bytes stay in flight without holding registers. Thread t owns 16-byte
// chunk t of every row and holds those 16 columns of x (MT <= 4 rows) in
// registers, so x is read once a CTA; its partial sum of a row is its
// chunk's 16 exact products in order times the chunk's block scale. A warp
// reduces 4 rows at once (halving by lane bits 4 and 3, then an xor tree),
// and a row's warps are added in warp order. Deterministic: every sum runs
// in a fixed order.
//
// Decode path, x @ W.T past N = 4,096 (NeoX's untied heads: gpt-neox-20b's
// (50,432 x 6,144).T, 309.9 MB of q and 9.68 MB of scales, bound 0.0955 ms
// by bytes; gpt-neox-10b's (50,432 x 5,120).T, 258.2 + 8.07 MB, 0.0796
// ms): the kernel above keeps a thread's 16 columns of x in registers
// (16 x MT f32), and a second chunk a thread does not fit its register
// budget; its SIMT-FMA form also spends about 6 instructions a weight byte
// at M = 4 (the widening and M FMAs), near the SM's issue rate at HBM's
// byte rate. This kernel runs the products on mma.sync.m16n8k16 instead: A
// is 16 q rows x a k16 slice widened to bf16 exactly (i8x4_to_bf16x4: a
// byte permute and a subtract in f32 a byte, a pack a pair), B the
// slice of 8 (16) rows of x, bf16 as the decode step gives it, so every
// product is exact and the tensor cores take the M multiply-adds. A warp
// owns row tiles of 16 q rows and walks each whole row, so no sum crosses
// warps or CTAs; the tiles are dealt to the grid's warps in turn, with the
// grid cut to the fewest CTAs of one wave that give every warp the same
// number of tiles (50,432 rows: 3,152 tiles, 2 a warp on 394 CTAs of 4
// warps, about 3 an SM). Each warp streams its rows through its own
// 2-stage ring in shared memory (a stage: 16 rows x 256 columns of q, 4
// KB, their scales, and x's 256 columns), 16-byte cp.async copies (.cg),
// with no CTA barrier; ldmatrix hands each lane its 4 bytes of a slice
// row, rows 272 bytes apart so its 8 rows fall on distinct banks. The mma
// chain sums one quant block (8 slices at block 128) in f32, which is then
// scaled by s[k, b] and added to the row's f32 sum (fmaf), in block order,
// as the tensor-core x @ W.T below folds its blocks. Deterministic: fixed
// order, no atomics. Registers (ptxas): 80 (M <= 8) and 118 (M <= 16), no
// spill; shared memory 61 KB a CTA at M = 4 (3 CTAs an SM).
// The places in the rows and blocks advance by counters: integer divisions
// by the runtime block and row widths in the loop made the first form of
// this kernel no faster than cuBLAS (PERF.md, row 8e). A cheaper-looking
// widening (two logic ops, a byte permute and one bf16x2 subtract a pair)
// took 2-7 % longer on the card (probes/dmm_wide.py). A cp.async ring
// beats the register ring of the x @ W path here because a slice's 16
// columns of a row are 4 bytes a lane: loaded from global memory straight
// into fragments they would be 4-byte loads, a quarter sector each.
//
// Decode path, x @ W (the decode step's layer products): also a stream of
// int8 weight bytes, but along q's rows the scale changes every `block`
// columns and down its columns every row, and the products at M = 4 were
// bound by issue on the CUDA cores (an int8 -> f32 conversion, a multiply by
// the scale and M FMAs a weight). Within a CTA's 64 output columns, one
// quant block, the scale s[k, nb] depends on the contraction row k alone,
// so it goes into x: xs[m, k] = x[m, k] * s[k, nb] in f32, M products a
// row instead of N, split into hi = bf16(xs) and lo = bf16(xs - hi) (16
// bits, each product within 2^-16 of the f32 one). q is exact in bf16 and
// is widened without the conversion unit or a multiply (a byte permute
// into an f32 2^23 + 128 + q, a subtract, the top half of two such f32 as a
// bf16 pair). The product out.T = q.T @ xs.T runs on mma.sync.m16n8k16: A
// is 16 output columns x 16 rows of q, B the hi and lo
// of 4 rows of x (n = 8), so the tensor cores take the M FMAs and the
// CUDA cores keep about three instructions a weight. A CTA takes 64
// output columns and a run of K; each of its 4 warps takes every fourth
// k16 slice of that run, loaded (8 bytes of q a row a lane, with the
// rows' x and scales) straight into a ring of 3 slices in registers, so
// each warp keeps 3 KB of q in flight with no shared memory and no
// barrier, and an SM holds 4 CTAs. Each warp folds its mma chain into f32
// every 4 slices. K is split for about two CTAs an SM, never past one wave
// of CTAs (a second, partial wave costs as much as the first; on the card,
// rings in shared memory, deeper rings and wider tiles all moved fewer
// bytes); the
// tile's K splits are one thread block cluster, whose sums are added in
// split order through distributed shared memory in the same launch.
// Deterministic: every sum runs in a fixed order, no atomics.
//
// Tensor-core path: 128 x 128 output tiles, two warpgroups of 64 x 128
// (wgmma.m64n128k16, bf16 in, f32 accumulators in registers), contraction
// steps of 64 staged through a 4-deep cp.async ring in shared memory, the
// next step fetched and converted while the tensor cores run the current
// one. Deterministic: no atomics, a fixed order of sums.
//  * x @ W.T (the dX of training): the contraction runs along a q row, where
//    one quant block shares one scale. Both operands are K-major, so both
//    come from shared memory under the 128-byte swizzle: x as loaded, and
//    the raw int8 q widened to bf16 (exact: |q| <= 128) by all threads. The
//    products of bf16 x and int8 q are exact in f32. Each block's run of
//    the contraction sums into a partial f32 accumulator (wgmma restarts it
//    at the block's first step), which is then scaled by s[k, jb] per
//    output column k into the result. Only the order of the f32 sums
//    differs from the reference.
//  * x @ W (the forward): the scale changes with every contraction row, so
//    it stays with the weight, and W is N-major. The kernel computes
//    out.T = dequant(q).T @ x.T: A, the weight, comes from registers, where
//    each thread dequantizes its own fragment straight from the raw int8
//    tile (2-byte loads of two adjacent output columns, which the thread's
//    two A rows are mapped to); B is the staged x tile, K-major. Each weight
//    is w = q * s in f32 (the reference's value), split into hi = bf16(w)
//    and lo = bf16(w - hi); both run against the same x tile, which keeps
//    16 bits of each weight (each product within 2^-16 of the reference's)
//    at twice the tensor work of one bf16 weight, whose single rounding
//    would add an error the size of a second rounding of the output. A grid
//    that does not fill the card splits K, and a second kernel adds the f32
//    partial sums in split order.
//  * Both orientations fold the tensor cores' sums into an f32 accumulator
//    in ordinary arithmetic every 64 (x @ W) or `block` (x @ W.T)
//    contraction rows: the tensor core's own accumulator rounds toward
//    zero, and left to run over a whole contraction it rounded many times
//    more bf16 outputs away from the exact product than the plain version
//    does, most of them toward zero. chip_smoke.py reports the share of
//    outputs off the exact product for both (dequant_matmul_rounding).
//
// SIMT path (the port's first design, PR 11): the weight never leaves
// registers as a dense tile. Each lane loads 4 consecutive INT8 weights with
// one 4-byte load (a warp reads 128 contiguous bytes), scales them in
// registers with their flat-layout block scale, and applies them to MT <= 8
// rows of x that the block staged in shared memory as f32, so each weight
// byte is reused MT times from registers.
//  * x @ W: a block owns 128 output columns and a K range; its 8 warps split
//    the K rows and meet in shared memory. When the (column, row-tile) grid
//    is too small to fill 132 SMs, K is also split across blocks, and a
//    second kernel adds the f32 partial sums in split order (deterministic,
//    no atomics).
//  * x @ W.T: the contraction runs along a contiguous q row, so one warp
//    owns one output column k and reduces its lanes with shuffles.
#include <cooperative_groups.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT_COLS = 128;       // x @ W: output columns per block (4 per lane)
constexpr int NT_KSUB = 256;       // x @ W: K rows of x staged in shared memory at a time
constexpr int TN_NSUB = 1024;      // x @ W.T: contraction columns of x staged at a time
constexpr int TARGET_BLOCKS = 264; // two blocks per SM on 132 SMs
constexpr int MIN_SPLIT_ROWS = 64; // never split K finer than this

int row_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

// K split of the x @ W orientation: number of splits and rows per split.
void nt_split(int M, int K, int N, int* splits, int* chunk) {
  const int mt = row_tile(M);
  const long long natural =
      (long long)((N + NT_COLS - 1) / NT_COLS) * ((M + mt - 1) / mt);
  long long s = (TARGET_BLOCKS + natural - 1) / natural;
  const long long most = (K + MIN_SPLIT_ROWS - 1) / MIN_SPLIT_ROWS;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int c = (int)((K + s - 1) / s);
  *chunk = c;
  *splits = (K + c - 1) / c;
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
dmm_nt_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, T* __restrict__ out,
              float* __restrict__ part, int M, int K, int N, int block, int chunk) {
  __shared__ __align__(16) float xs[NT_KSUB][MT];
  __shared__ float red[WARPS][MT][NT_COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * NT_COLS + lane * 4;
  const int m0 = blockIdx.z * MT;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(K, k0 + chunk);
  const int nblk = N / block;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int kc = k0; kc < k1; kc += NT_KSUB) {
    const int kn = min(NT_KSUB, k1 - kc);
    for (int i = threadIdx.x; i < MT * NT_KSUB; i += THREADS) {
      const int m = i / NT_KSUB, kk = i % NT_KSUB;
      float v = 0.f;
      if (kk < kn && m0 + m < M) v = to_f32(x[(size_t)(m0 + m) * K + kc + kk]);
      xs[kk][m] = v;
    }
    __syncthreads();
    if (n < N) {
      for (int kk = warp; kk < kn; kk += WARPS) {
        const size_t k = (size_t)(kc + kk);
        const char4 qv = *reinterpret_cast<const char4*>(q + k * N + n);
        const float sc = s[k * nblk + n / block];
        const float w0 = (float)qv.x * sc, w1 = (float)qv.y * sc;
        const float w2 = (float)qv.z * sc, w3 = (float)qv.w * sc;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[kk][m];
          acc[m][0] = fmaf(xv, w0, acc[m][0]);
          acc[m][1] = fmaf(xv, w1, acc[m][1]);
          acc[m][2] = fmaf(xv, w2, acc[m][2]);
          acc[m][3] = fmaf(xv, w3, acc[m][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * NT_COLS; i += THREADS) {
    const int m = i / NT_COLS, c = i % NT_COLS;
    const int col = blockIdx.x * NT_COLS + c;
    if (m0 + m >= M || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][m][c];
    if (part != nullptr)
      part[((size_t)blockIdx.y * M + m0 + m) * N + col] = v;
    else
      out[(size_t)(m0 + m) * N + col] = from_f32<T>(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dmm_split_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int splits, long long mn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += part[sp * mn + i];
    out[i] = from_f32<T>(v);
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
dmm_tn_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, T* __restrict__ out,
              int M, int K, int N, int block) {
  __shared__ __align__(16) float xs[MT][TN_NSUB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x * WARPS + warp;
  const int m0 = blockIdx.y * MT;
  const int nblk = N / block;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int nc = 0; nc < N; nc += TN_NSUB) {
    const int nn = min(TN_NSUB, N - nc);
    for (int i = threadIdx.x; i < MT * TN_NSUB; i += THREADS) {
      const int m = i / TN_NSUB, j = i % TN_NSUB;
      float v = 0.f;
      if (j < nn && m0 + m < M) v = to_f32(x[(size_t)(m0 + m) * N + nc + j]);
      xs[m][j] = v;
    }
    __syncthreads();
    if (k < K) {
      const int8_t* qr = q + (size_t)k * N + nc;
      const float* sr = s + (size_t)k * nblk;
      for (int j = lane * 4; j < nn; j += 128) {
        const char4 qv = *reinterpret_cast<const char4*>(qr + j);
        const float sc = sr[(nc + j) / block];
        const float w0 = (float)qv.x * sc, w1 = (float)qv.y * sc;
        const float w2 = (float)qv.z * sc, w3 = (float)qv.w * sc;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[m][j]);
          acc[m] = fmaf(xv.x, w0, acc[m]);
          acc[m] = fmaf(xv.y, w1, acc[m]);
          acc[m] = fmaf(xv.z, w2, acc[m]);
          acc[m] = fmaf(xv.w, w3, acc[m]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && k < K && m0 + m < M) out[(size_t)(m0 + m) * K + k] = from_f32<T>(v);
  }
}

// ---------------------------------------------------------------------------
// tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_MIN_M = 5;        // x @ W: bf16 rows from which the tensor cores win
constexpr int TC_MIN_M_T = 64;     // x @ W.T: the same (its grid does not split K)
constexpr int TBM = 128, TBN = 128;  // output tile
constexpr int WG_BK = 64;          // contraction step: 128 bytes of bf16
constexpr int WG_STAGES = 4;       // cp.async ring depth
constexpr int TC_THREADS = 256;    // two warpgroups
constexpr int TC_NT_CTAS = 132;    // x @ W: one CTA an SM fills the card
constexpr int TC_MIN_SPLIT = 128;  // x @ W: never split K finer than this
constexpr int SC_SLOTS = 8;        // x @ W: scale columns a tile row can span
constexpr int QPAD = TBN + 16;     // x @ W: raw q row (bytes), 2-byte column reads without conflicts
constexpr int SC_PAD = SC_SLOTS + 1;

enum { PATH_SIMT = 0, PATH_TC = 1, PATH_DECODE = 2 };

bool tc_takes(int K, int block, int dtype) {
  return dtype == DT_BF16 && block % WG_BK == 0 && K % 8 == 0;
}

// K split of the tensor-core x @ W: number of splits and rows (a multiple
// of WG_BK) per split
void tc_split(int M, int K, int N, int* splits, int* chunk) {
  const long long natural = (long long)((N + TBN - 1) / TBN) * ((M + TBM - 1) / TBM);
  long long s = TC_NT_CTAS / natural;
  const long long most = (K + TC_MIN_SPLIT - 1) / TC_MIN_SPLIT;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int c = (int)((K + s - 1) / s);
  c = (c + WG_BK - 1) / WG_BK * WG_BK;
  *chunk = c;
  *splits = (K + c - 1) / c;
}

struct alignas(1024) WgStage {     // one contraction step of x @ W.T
  __nv_bfloat16 x[TBM * WG_BK];    // 128 rows of x, 128-byte swizzle (wgmma A)
  int8_t q[TBN][WG_BK];            // 128 q rows (output columns k), as loaded
  float s[TBN];                    // their scales in this step's block
};
struct alignas(1024) WgWeights {   // q of one step as bf16, 128-byte swizzle (wgmma B)
  __nv_bfloat16 w[TBN * WG_BK];
};

// out (M, K) = x (M, N) @ dequant(q (K, N)).T; grid (K tiles, M tiles).
// Two warpgroups, each 64 rows x 128 columns of the tile with wgmma.
__global__ void __launch_bounds__(TC_THREADS, 1)
dmm_tc_tn_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 int M, int K, int N, int block) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  WgStage* st = reinterpret_cast<WgStage*>(smem);
  WgWeights* wt = reinterpret_cast<WgWeights*>(smem + WG_STAGES * sizeof(WgStage));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int m0 = blockIdx.y * TBM, k0 = blockIdx.x * TBN;
  const int nblk = N / block, nk = N / WG_BK, per_block = block / WG_BK;

  auto load = [&](int kt) {
    WgStage& S = st[kt % WG_STAGES];
    const int j0 = kt * WG_BK;
#pragma unroll
    for (int h = 0; h < TBM * 8 / TC_THREADS; ++h) {
      const int i = tid + h * TC_THREADS, r = i / 8, c = i % 8;
      const bool in = m0 + r < M;
      cp_async16(reinterpret_cast<char*>(S.x) + sw128(r, c),
                 in ? x + (size_t)(m0 + r) * N + j0 + c * 8 : x, in);
    }
#pragma unroll
    for (int h = 0; h < TBN * 4 / TC_THREADS; ++h) {
      const int i = tid + h * TC_THREADS, r = i / 4, c = i % 4;
      const bool in = k0 + r < K;
      cp_async16(&S.q[r][c * 16], in ? q + (size_t)(k0 + r) * N + j0 + c * 16 : q, in);
    }
    if (tid < TBN) {
      const bool in = k0 + tid < K;
      cp_async4(&S.s[tid], in ? s + (size_t)(k0 + tid) * nblk + j0 / block : s, in);
    }
  };
  // the raw int8 q of step kt -> bf16 (exact) in wgmma's layout
  auto widen = [&](int kt, WgWeights& W) {
    const WgStage& S = st[kt % WG_STAGES];
#pragma unroll
    for (int h = 0; h < TBN * 8 / TC_THREADS; ++h) {
      const int i = tid + h * TC_THREADS, r = i / 8, c = i % 8;
      const uint2 raw = *reinterpret_cast<const uint2*>(&S.q[r][c * 8]);
      uint4 w;
      i8x4_to_bf16x4(raw.x, w.x, w.y);
      i8x4_to_bf16x4(raw.y, w.z, w.w);
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(W.w) + sw128(r, c)) = w;
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  cp_async_wait<WG_STAGES - 2>();
  __syncthreads();
  widen(0, wt[0]);
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    // step kt: its x has landed and its q is widened, both visible to wgmma
    const WgStage& S = st[kt % WG_STAGES];
    const uint64_t da = sw128_desc(reinterpret_cast<const char*>(S.x) + wg * 64 * 128);
    const uint64_t db = sw128_desc(wt[kt & 1].w);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk, kk > 0 || kt % per_block != 0);
    wgmma_commit();
    // while the tensor cores run: fetch step kt + 3, widen step kt + 1
    if (kt + WG_STAGES - 1 < nk) load(kt + WG_STAGES - 1);
    cp_async_commit();
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // step kt + 1 has landed for every thread
    if (kt + 1 < nk) widen(kt + 1, wt[(kt + 1) & 1]);
    fence_proxy_async();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(part[i]);
    if ((kt + 1) % per_block == 0) {  // the quant block ends: scale and fold
#pragma unroll
      for (int ni = 0; ni < TBN / 8; ++ni) {  // columns ni * 8 + 2t, + 1
        const float2 sc = *reinterpret_cast<const float2*>(&S.s[ni * 8 + 2 * t]);
        acc[4 * ni] = fmaf(part[4 * ni], sc.x, acc[4 * ni]);
        acc[4 * ni + 1] = fmaf(part[4 * ni + 1], sc.y, acc[4 * ni + 1]);
        acc[4 * ni + 2] = fmaf(part[4 * ni + 2], sc.x, acc[4 * ni + 2]);
        acc[4 * ni + 3] = fmaf(part[4 * ni + 3], sc.y, acc[4 * ni + 3]);
      }
    }
    __syncthreads();  // step kt + 1 widened; step kt's buffers free
  }
  cp_async_wait<0>();

  const int row_base = m0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int ni = 0; ni < TBN / 8; ++ni) {
    const int col = k0 + ni * 8 + 2 * t;  // K % 8 == 0: col + 1 < K too
    if (col >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * K + col) =
            pack_bf16(acc[ni * 4 + 2 * h], acc[ni * 4 + 2 * h + 1]);
    }
  }
}

struct alignas(1024) WfStage {     // one contraction step of x @ W
  __nv_bfloat16 x[TBM * WG_BK];    // 128 rows of x, 128-byte swizzle (wgmma B)
  int8_t q[WG_BK][QPAD];           // 64 q rows, 128 output columns (+ pad)
  float s[WG_BK][SC_PAD];          // their scales: s[k][nb0 + c], c < SC_SLOTS
};
constexpr int TERMS = 2;           // bf16 terms of each forward weight: hi, lo

// a pair of f32 weights w -> hi = bf16(w) and lo = bf16(w - hi), as bf16 pairs
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t (&r)[TERMS]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  r[0] = *reinterpret_cast<const uint32_t*>(&h);
  r[1] = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// out (M, N) = x (M, K) @ dequant(q (K, N)), or with part != nullptr the f32
// partial sum of split blockIdx.y into part[split][M][N]; grid (N tiles,
// splits, M tiles). Computed as out.T = dequant(q).T @ x.T: A (output
// columns x K) is dequantized from the raw int8 tile into registers, B is
// the staged x tile. Each warpgroup owns 64 output columns x 128 rows.
__global__ void __launch_bounds__(TC_THREADS, 1)
dmm_tc_nt_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part, int M, int K, int N, int block, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  WfStage* st = reinterpret_cast<WfStage*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.z * TBM;
  const int kbeg = blockIdx.y * chunk, kend = min(K, kbeg + chunk);
  const int nblk = N / block, nb0 = n0 / block;
  const int nk = (kend - kbeg + WG_BK - 1) / WG_BK;
  // A rows g and g + 8 of this warp are output columns nl and nl + 1: the
  // two share a q row's 2 bytes (one load) and, block % 64 == 0, a scale
  const int nl = wg * 64 + (warp % 4) * 16 + 2 * g;
  const int slot = (n0 + nl) / block - nb0;

  auto load = [&](int kt) {
    WfStage& S = st[kt % WG_STAGES];
    const int kc = kbeg + kt * WG_BK;
#pragma unroll
    for (int h = 0; h < TBM * 8 / TC_THREADS; ++h) {
      const int i = tid + h * TC_THREADS, r = i / 8, c = i % 8;
      const bool in = m0 + r < M && kc + c * 8 < kend;
      cp_async16(reinterpret_cast<char*>(S.x) + sw128(r, c),
                 in ? x + (size_t)(m0 + r) * K + kc + c * 8 : x, in);
    }
#pragma unroll
    for (int h = 0; h < WG_BK * 8 / TC_THREADS; ++h) {
      const int i = tid + h * TC_THREADS, r = i / 8, c = i % 8;
      const bool qin = kc + r < kend && n0 + c * 16 < N;
      cp_async16(&S.q[r][c * 16], qin ? q + (size_t)(kc + r) * N + n0 + c * 16 : q, qin);
      const bool sin = kc + r < kend && nb0 + c < nblk;
      cp_async4(&S.s[r][c], sin ? s + (size_t)(kc + r) * nblk + nb0 + c : s, sin);
    }
  };

  // the A fragment of k16 slice kk of step kt: w = q * s in f32 (the
  // reference's value; rows past K and columns past N are 0), split into
  // hi and lo
  auto dequant = [&](int kt, int kk, uint32_t (&A)[TERMS][4]) {
    const WfStage& S = st[kt % WG_STAGES];
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // rows k, k + 1 feed a0, a1 (p = 0) or a2, a3
      const int k = kk * 16 + 2 * t + 8 * p;
      const uint32_t r0 = *reinterpret_cast<const uint16_t*>(&S.q[k][nl]);
      const uint32_t r1 = *reinterpret_cast<const uint16_t*>(&S.q[k + 1][nl]);
      const uint32_t u = (r0 | (r1 << 16)) ^ 0x80808080u;
      const float s0 = S.s[k][slot], s1 = S.s[k + 1][slot];
      // (k, n) (k + 1, n) -> A row g; (k, n + 1) (k + 1, n + 1) -> row g + 8
      uint32_t row_g[TERMS], row_g8[TERMS];
      split_bf16(i8_to_f32<0>(u) * s0, i8_to_f32<2>(u) * s1, row_g);
      split_bf16(i8_to_f32<1>(u) * s0, i8_to_f32<3>(u) * s1, row_g8);
#pragma unroll
      for (int e = 0; e < TERMS; ++e) {
        A[e][2 * p] = row_g[e];
        A[e][2 * p + 1] = row_g8[e];
      }
    }
  };
  auto keep = [&](uint32_t (&A)[TERMS][4]) {
#pragma unroll
    for (int e = 0; e < TERMS; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) keep_operand(A[e][i]);
  };

  float acc[64], step_sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = step_sum[i] = 0.f;

#pragma unroll
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  cp_async_wait<WG_STAGES - 2>();
  fence_proxy_async();
  __syncthreads();
  uint32_t a[2][TERMS][4];  // the fragments of two k16 slices in turn
  if (nk > 0) dequant(0, 0, a[0]);

  // each k16 slice on the tensor cores while the next is dequantized; the
  // step's sum collects in step_sum and is added to acc in f32 after the step
  for (int kt = 0; kt < nk; ++kt) {
    const uint64_t db = sw128_desc(st[kt % WG_STAGES].x);
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < TERMS; ++e)
        wgmma_m64n128k16_rs(step_sum, a[kk & 1][e], db + 2 * kk, kk > 0 || e > 0);
      wgmma_commit();
      wgmma_wait<1>();  // slice kk - 1 is done: its fragment may be rewritten
      keep(a[(kk + 1) & 1]);
      if (kk + 1 < WG_BK / 16) {
        dequant(kt, kk + 1, a[(kk + 1) & 1]);
      } else {
        cp_async_wait<WG_STAGES - 3>();
        fence_proxy_async();
        __syncthreads();  // step kt + 1 landed; every warpgroup is done with step kt - 1
        if (kt + WG_STAGES - 1 < nk) load(kt + WG_STAGES - 1);
        cp_async_commit();
        if (kt + 1 < nk) dequant(kt + 1, 0, a[0]);
      }
    }
    wgmma_wait<0>();
    keep(a[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      fence_operand(step_sum[i]);
      acc[i] += step_sum[i];
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

  const int n = n0 + nl;  // N % 64 == 0: n + 1 < N too
  if (n >= N) return;
#pragma unroll
  for (int ni = 0; ni < TBM / 8; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + ni * 8 + 2 * t + h;
      if (row >= M) continue;
      const float v0 = acc[ni * 4 + h], v1 = acc[ni * 4 + 2 + h];  // columns n, n + 1
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.y * M + row) * N + n) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + n) = pack_bf16(v0, v1);
    }
}

constexpr size_t TN_SMEM = WG_STAGES * sizeof(WgStage) + 2 * sizeof(WgWeights) + 1024;
constexpr size_t NT_SMEM = WG_STAGES * sizeof(WfStage) + 1024;

int launch_tc(const void* x, const void* q, const void* s, void* out, void* work,
              int M, int K, int N, int block, int transpose, cudaStream_t st) {
  const __nv_bfloat16* xt = (const __nv_bfloat16*)x;
  const int8_t* qt = (const int8_t*)q;
  const float* stt = (const float*)s;
  __nv_bfloat16* ot = (__nv_bfloat16*)out;
  const unsigned mtiles = (unsigned)((M + TBM - 1) / TBM);
  if (transpose) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        dmm_tc_tn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TN_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((unsigned)((K + TBN - 1) / TBN), mtiles);
    dmm_tc_tn_kernel<<<grid, TC_THREADS, TN_SMEM, st>>>(xt, qt, stt, ot, M, K, N, block);
    return launch_status();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmm_tc_nt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)NT_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int splits, chunk;
  tc_split(M, K, N, &splits, &chunk);
  float* part = splits > 1 ? (float*)work : nullptr;
  if (splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + TBN - 1) / TBN), (unsigned)splits, mtiles);
  dmm_tc_nt_kernel<<<grid, TC_THREADS, NT_SMEM, st>>>(xt, qt, stt, ot, part, M, K, N,
                                                       block, chunk);
  int rc = launch_status();
  if (rc != 0 || splits == 1) return rc;
  const long long mn = (long long)M * N;
  long long blocks = (mn + THREADS - 1) / THREADS;
  dmm_split_sum_kernel<__nv_bfloat16><<<(unsigned)(blocks < 132 * 8 ? blocks : 132 * 8),
                                        THREADS, 0, st>>>(part, ot, splits, mn);
  return launch_status();
}

template <typename T, int MT>
int launch(const T* x, const int8_t* q, const float* s, T* out, float* work,
           int M, int K, int N, int block, int transpose, cudaStream_t st) {
  const unsigned mtiles = (unsigned)((M + MT - 1) / MT);
  if (transpose) {
    dim3 grid((unsigned)((K + WARPS - 1) / WARPS), mtiles);
    dmm_tn_kernel<T, MT><<<grid, THREADS, 0, st>>>(x, q, s, out, M, K, N, block);
    return launch_status();
  }
  int splits, chunk;
  nt_split(M, K, N, &splits, &chunk);
  dim3 grid((unsigned)((N + NT_COLS - 1) / NT_COLS), (unsigned)splits, mtiles);
  float* part = splits > 1 ? work : nullptr;
  if (splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  dmm_nt_kernel<T, MT><<<grid, THREADS, 0, st>>>(x, q, s, out, part, M, K, N, block,
                                                  chunk);
  int rc = launch_status();
  if (rc != 0 || splits == 1) return rc;
  const long long mn = (long long)M * N;
  long long blocks = (mn + THREADS - 1) / THREADS;
  dmm_split_sum_kernel<T><<<(unsigned)(blocks < 132 * 8 ? blocks : 132 * 8), THREADS, 0,
                            st>>>(work, out, splits, mn);
  return launch_status();
}

template <typename T>
int launch_rows(const void* x, const void* q, const void* s, void* out, void* work,
                int M, int K, int N, int block, int transpose, cudaStream_t st) {
  const T* xt = (const T*)x;
  const int8_t* qt = (const int8_t*)q;
  const float* stt = (const float*)s;
  T* ot = (T*)out;
  float* w = (float*)work;
  switch (row_tile(M)) {
    case 1: return launch<T, 1>(xt, qt, stt, ot, w, M, K, N, block, transpose, st);
    case 2: return launch<T, 2>(xt, qt, stt, ot, w, M, K, N, block, transpose, st);
    case 4: return launch<T, 4>(xt, qt, stt, ot, w, M, K, N, block, transpose, st);
    default: return launch<T, 8>(xt, qt, stt, ot, w, M, K, N, block, transpose, st);
  }
}

// ---------------------------------------------------------------------------
// decode path (x @ W.T, M <= DEC_MAX_M_T)
// ---------------------------------------------------------------------------

// rows of x up to which the decode path takes an x @ W.T call (the
// crossover measured on the card against the other paths: PERF.md)
constexpr int DEC_MAX_M_T = 16;
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TN_MAX_N = 16 * DEC_THREADS;  // one 16-byte chunk of a q row a thread
constexpr int DEC_TN_MAX_MT = 4;     // rows of x a CTA takes (its 16 columns in registers)
constexpr int DEC_TN_ROWS = 8;       // q rows a row group takes from a stage
constexpr int DEC_TN_BATCH = 4;      // rows whose sums a warp reduces at once
constexpr int DEC_TN_STAGES = 3;     // cp.async ring depth: 2 stages in flight

// x @ W.T: log2 of the warps that share a q row, one 16-byte chunk a lane
int dec_tn_warps_log2(int N) {
  int lg = 0;
  while ((32 << lg) < N / 16) ++lg;
  return lg;
}

// x @ W.T: bytes of shared memory: the ring of stages (DEC_TN_ROWS q rows
// for each row group, with their scales) and the warps' row sums
size_t dec_tn_smem(int N, int block) {
  const size_t rows = (size_t)(DEC_WARPS >> dec_tn_warps_log2(N)) * DEC_TN_ROWS;
  return DEC_TN_STAGES * rows * ((size_t)N + (size_t)(N / block) * 4) +
         (size_t)DEC_WARPS * DEC_TN_ROWS * DEC_TN_MAX_MT * 4;
}

// x @ W.T with block % 16 == 0 (a 16-byte chunk of a q row, or a k16
// slice, under one scale): f32 or bf16 up to N = 4,096 (dmm_dec_tn_kernel,
// one chunk a thread), bf16 past it (dmm_dec_tn_wide_kernel)
bool dec_takes(int N, int block, int transpose, int dtype) {
  if (!transpose || block % 16 != 0) return false;
  if (N > DEC_TN_MAX_N) return dtype == DT_BF16;
  return dtype == DT_F32 || dtype == DT_BF16;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// CTAs of `kernel` an SM holds with `smem` bytes of shared memory each
template <typename F>
int dec_ctas_per_sm(F kernel, size_t smem) {
  int n = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, DEC_THREADS, smem);
  return n < 1 ? 1 : n;
}

// the 16 int8 of a 16-byte word as exact f32
__device__ __forceinline__ void i8x16_to_f32(const uint4& w, float (&f)[16]) {
  const uint32_t wd[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                          w.w ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[4 * e] = i8_to_f32<0>(wd[e]);
    f[4 * e + 1] = i8_to_f32<1>(wd[e]);
    f[4 * e + 2] = i8_to_f32<2>(wd[e]);
    f[4 * e + 3] = i8_to_f32<3>(wd[e]);
  }
}

// out (M, K) = x (M, N) @ dequant(q (K, N)).T; grid (persistent CTAs, row
// tiles of MT <= 4). Thread t owns 16-byte chunk c of every q row (2^wl
// warps share a row, so 8 >> wl row groups run side by side) and holds
// those 16 columns of x's MT rows in registers. Each stage of the cp.async
// ring holds a run of consecutive q rows, one contiguous copy, with their
// scales; a row group takes DEC_TN_ROWS of them. A thread's partial sum of
// a row is its chunk's 16 exact products in order, times the chunk's block
// scale; a warp reduces DEC_TN_BATCH rows at once (halving by lane bits 4
// and 3, then an xor tree over bits 2, 1, 0, so lanes 8 i ... 8 i + 7 hold
// row i), and the row group's warps are added in warp order.
template <typename T, int MT>
__global__ void __launch_bounds__(DEC_THREADS, 2)
dmm_dec_tn_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, T* __restrict__ out, int M, int K, int N,
                  int block, int warps_log2) {
  extern __shared__ float4 dec_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wpr = 1 << warps_log2, groups = DEC_WARPS >> warps_log2;
  const int rg = warp >> warps_log2, c = (warp & (wpr - 1)) * 32 + lane;
  const int nch = N / 16, nblk = N / block;
  const bool c_in = c < nch;
  const int rows = groups * DEC_TN_ROWS;  // q rows a stage
  const int stage_bytes = rows * (N + nblk * 4);
  unsigned char* ring = reinterpret_cast<unsigned char*>(dec_smem);
  float* red = reinterpret_cast<float*>(ring + DEC_TN_STAGES * stage_bytes);  // [warp][row][m]
  const int m0 = blockIdx.y * MT;
  const int nrb = (K + rows - 1) / rows;  // runs of rows, taken by the CTAs in turn
  const int nst = blockIdx.x < nrb ? (nrb - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  auto issue = [&](int j) {
    unsigned char* st = ring + (j % DEC_TN_STAGES) * stage_bytes;
    float* ss = reinterpret_cast<float*>(st + rows * N);
    const int r0 = (blockIdx.x + j * gridDim.x) * rows;
    for (int i = tid; i < rows * nch; i += DEC_THREADS) {
      const int r = i / nch, cc = i % nch;
      const bool in = r0 + r < K;
      cp_async16(st + r * N + cc * 16, in ? q + (size_t)(r0 + r) * N + cc * 16 : q, in);
    }
    for (int i = tid; i < rows * nblk; i += DEC_THREADS) {
      const bool in = r0 + i / nblk < K;
      cp_async4(ss + i, in ? s + (size_t)r0 * nblk + i : s, in);
    }
  };
#pragma unroll
  for (int j = 0; j < DEC_TN_STAGES - 1; ++j) {
    if (j < nst) issue(j);
    cp_async_commit();
  }
  float xr[MT][16];  // x[m0 + m][16 c + e]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e)
      xr[m][e] = c_in && m0 + m < M ? to_f32(x[(size_t)(m0 + m) * N + c * 16 + e]) : 0.f;
  const int sblk = c_in ? c * 16 / block : 0;

  for (int j = 0; j < nst; ++j) {
    cp_async_wait<DEC_TN_STAGES - 2>();
    __syncthreads();  // stage j has landed for all; every thread is done with stage j - 1
    if (j + DEC_TN_STAGES - 1 < nst) issue(j + DEC_TN_STAGES - 1);  // stage j - 1's slot
    cp_async_commit();
    const unsigned char* st = ring + (j % DEC_TN_STAGES) * stage_bytes;
    const float* ss = reinterpret_cast<const float*>(st + rows * N);
    const int r0 = (blockIdx.x + j * gridDim.x) * rows;
#pragma unroll
    for (int b = 0; b < DEC_TN_ROWS; b += DEC_TN_BATCH) {
      float p[DEC_TN_BATCH][MT];
#pragma unroll
      for (int i = 0; i < DEC_TN_BATCH; ++i) {
        const int r = (b + i) * groups + rg;  // row of the stage
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        float sv = 0.f;
        if (c_in) {
          w = *reinterpret_cast<const uint4*>(st + r * N + c * 16);
          sv = ss[r * nblk + sblk];
        }
        float f[16];
        i8x16_to_f32(w, f);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) d = fmaf(xr[m][e], f[e], d);
          p[i][m] = d * sv;
        }
      }
      // the batch's rows over the warp: lane bits 4 and 3 pick the row a
      // lane keeps (halving), then an xor tree over bits 2, 1, 0
      const int h4 = (lane >> 4) & 1, h3 = (lane >> 3) & 1;
      float p2[2][MT], p1[MT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float mine = h4 ? p[2 + i][m] : p[i][m];
          const float other = h4 ? p[i][m] : p[2 + i][m];
          p2[i][m] = mine + __shfl_xor_sync(0xffffffffu, other, 16);
        }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float mine = h3 ? p2[1][m] : p2[0][m];
        const float other = h3 ? p2[0][m] : p2[1][m];
        p1[m] = mine + __shfl_xor_sync(0xffffffffu, other, 8);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
#pragma unroll
        for (int m = 0; m < MT; ++m) p1[m] += __shfl_xor_sync(0xffffffffu, p1[m], off);
      if ((lane & 7) == 0) {
        const int i = b + (lane >> 3);  // = b + 2 h4 + h3
        if (wpr == 1) {
          const int k = r0 + i * groups + rg;
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (k < K && m0 + m < M) out[(size_t)(m0 + m) * K + k] = from_f32<T>(p1[m]);
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m) red[(warp * DEC_TN_ROWS + i) * MT + m] = p1[m];
        }
      }
    }
    if (wpr == 1) continue;
    __syncthreads();  // the warps' row sums are in place
    for (int o = tid; o < rows * MT; o += DEC_THREADS) {
      const int r = o / MT, m = o % MT, g = r % groups, i = r / groups;
      float v = red[(g * wpr * DEC_TN_ROWS + i) * MT + m];
      for (int w = 1; w < wpr; ++w) v += red[((g * wpr + w) * DEC_TN_ROWS + i) * MT + m];
      const int k = r0 + r;
      if (k < K && m0 + m < M) out[(size_t)(m0 + m) * K + k] = from_f32<T>(v);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int MT>
int launch_dec_tn(const T* x, const int8_t* q, const float* s, T* out, int M, int K, int N,
                  int block, cudaStream_t st) {
  // a stage holds at most 32 KB of q and 8 KB of scales (block >= 16)
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmm_dec_tn_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 128 * 1024);
  if (attr != cudaSuccess) return (int)attr;
  const int wl = dec_tn_warps_log2(N);
  const size_t smem = dec_tn_smem(N, block);
  const long long rows = (long long)(DEC_WARPS >> wl) * DEC_TN_ROWS;
  long long ctas = (K + rows - 1) / rows;
  const long long most = (long long)sm_count() * dec_ctas_per_sm(dmm_dec_tn_kernel<T, MT>, smem);
  if (ctas > most) ctas = most;
  dim3 grid((unsigned)ctas, (unsigned)((M + MT - 1) / MT));
  dmm_dec_tn_kernel<T, MT><<<grid, DEC_THREADS, smem, st>>>(x, q, s, out, M, K, N, block, wl);
  return launch_status();
}

template <typename T>
int launch_dec_rows(const void* x, const void* q, const void* s, void* out, int M, int K,
                    int N, int block, cudaStream_t st) {
  const T* xt = (const T*)x;
  const int8_t* qt = (const int8_t*)q;
  const float* stt = (const float*)s;
  T* ot = (T*)out;
  if (M <= 1) return launch_dec_tn<T, 1>(xt, qt, stt, ot, M, K, N, block, st);
  if (M <= 2) return launch_dec_tn<T, 2>(xt, qt, stt, ot, M, K, N, block, st);
  return launch_dec_tn<T, DEC_TN_MAX_MT>(xt, qt, stt, ot, M, K, N, block, st);
}

// ---------------------------------------------------------------------------
// decode path, x @ W.T past DEC_TN_MAX_N (bf16): mma.sync on the exact q
// ---------------------------------------------------------------------------

constexpr int DW_THREADS = 128;          // 4 warps, each on its own row tiles
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int DW_ROWS = 16;              // q rows of a warp's row tile: mma's m
constexpr int DW_COLS = 256;             // q columns of a stage: 16 k16 slices
constexpr int DW_SLICES = DW_COLS / 16;
constexpr int DW_PITCH = DW_COLS + 16;   // bytes of a staged q row: ldmatrix's 8 rows on distinct banks
constexpr int DW_SC = DW_SLICES + 1;     // scales of a staged q row: the blocks its columns touch
constexpr int DW_XPITCH = 2 * DW_COLS + 32;  // bytes of a staged x row: 4 rows' B loads on distinct banks
constexpr int DW_STAGES = 2;             // a warp's cp.async ring: one stage in flight
constexpr int DW_MIN_CTAS = 4;           // CTAs an SM holds (__launch_bounds__)
constexpr int DW_QS_BYTES = DW_ROWS * (DW_PITCH + 4 * DW_SC);  // q and scales of a stage

// bytes of a CTA's rings with xr rows of x in each stage
size_t dw_smem(int xr) {
  return (size_t)DW_WARPS * DW_STAGES * (DW_QS_BYTES + (size_t)xr * DW_XPITCH);
}

// out (M, K) = x (M, N) @ dequant(q (K, N)).T, bf16 x and out, N % 16 == 0,
// block % 16 == 0; grid (CTAs, row tiles of 8 NT rows of x), xr = min(M, 8
// NT) rows of x staged. Computed as out.T = q @ x.T on mma.m16n8k16: A is
// 16 q rows (output columns k) x one k16 slice of a q row, widened to bf16
// (exact), B the same slice of NT x 8 rows of x. Within a slice the
// columns run in the order each lane loads them, for A and B alike: lane
// t's A columns 2t, 2t + 1, 2t + 8, 2t + 9 are q columns 4t ... 4t + 3 (one
// 32-bit word of a row, as ldmatrix hands it out), its B rows x's columns
// 4t ... 4t + 3 (one 8-byte load). Each warp takes whole row tiles of 16 q
// rows, the tiles dealt to the grid's warps in turn, and walks each row in
// stages of 256 columns (q, their scales and x's columns) through its own
// cp.async ring in shared memory, with no CTA barrier. The exact products
// of a quant block's slices sum in the mma chain (f32), which is then
// scaled by s[k, b] and added to the row's f32 sum, in block order.
template <int NT>
__global__ void __launch_bounds__(DW_THREADS, DW_MIN_CTAS)
dmm_dec_tn_wide_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M,
                       int K, int N, int block, int xr) {
  extern __shared__ __align__(16) unsigned char dw_smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int stage_bytes = DW_QS_BYTES + xr * DW_XPITCH;
  unsigned char* ring = dw_smem_raw + (size_t)warp * DW_STAGES * stage_bytes;
  const int tiles = (K + DW_ROWS - 1) / DW_ROWS;
  const int nw = gridDim.x * DW_WARPS, gw = blockIdx.x * DW_WARPS + warp;
  const int mine = gw < tiles ? (tiles - gw + nw - 1) / nw : 0;
  const int gpr = (N + DW_COLS - 1) / DW_COLS;  // stages of a row tile
  const int nst = mine * gpr;
  const int nblk = N / block, bs = block / 16;  // slices of a quant block
  const int m0 = blockIdx.y * 8 * NT;

  // the next stage to fetch: the warp's row tile pr, stage pc of its row,
  // the block pb that holds its first column and that block's end pe
  int pr = 0, pc = 0, pb = 0, pe = block;
  auto issue = [&](int slot) {
    unsigned char* st = ring + slot * stage_bytes;
    int8_t(*sq)[DW_PITCH] = reinterpret_cast<int8_t(*)[DW_PITCH]>(st);
    float(*ss)[DW_SC] = reinterpret_cast<float(*)[DW_SC]>(st + DW_ROWS * DW_PITCH);
    const int k0 = (gw + pr * nw) * DW_ROWS, c0 = pc * DW_COLS, c1 = min(N, c0 + DW_COLS);
#pragma unroll
    for (int h = 0; h < DW_ROWS * DW_SLICES / 32; ++h) {
      const int ch = lane + 32 * h, r = ch / DW_SLICES, c = ch % DW_SLICES * 16;
      const bool in = k0 + r < K && c0 + c < N;
      cp_async16(&sq[r][c], in ? q + (size_t)(k0 + r) * N + c0 + c : q, in);
    }
    int nb = 1;  // the blocks the stage's columns touch
    for (int e = pe; e < c1; e += block) ++nb;
    for (int e = lane; e < DW_ROWS * nb; e += 32) {
      const int r = e / nb, j = e % nb;
      const bool in = k0 + r < K;
      cp_async4(&ss[r][j], in ? s + (size_t)(k0 + r) * nblk + pb + j : s, in);
    }
    for (int e = lane; e < xr * (DW_COLS / 8); e += 32) {
      const int m = e / (DW_COLS / 8), c = e % (DW_COLS / 8) * 8;
      const bool in = m0 + m < M && c0 + c < N;
      cp_async16(st + DW_QS_BYTES + m * DW_XPITCH + 2 * c,
                 in ? x + (size_t)(m0 + m) * N + c0 + c : x, in);
    }
    if (++pc == gpr) {
      pc = 0;
      ++pr;
      pb = 0;
      pe = block;
    } else {
      for (; pe <= pc * DW_COLS; pe += block) ++pb;
    }
  };
#pragma unroll
  for (int j = 0; j < DW_STAGES - 1; ++j) {
    if (j < nst) issue(j);
    cp_async_commit();
  }
  // the row this lane points ldmatrix at: matrices 0 and 1 are rows 0-7 and
  // 8-15 of slice 2p, matrices 2 and 3 the same of slice 2p + 1
  const int lr = lane % 8 + 8 * ((lane / 8) & 1), lsl = lane / 16;
  float acc[NT][4], chain[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = chain[nt][e] = 0.f;
  int cr = 0, cc = 0, fold = bs - 1;  // row tile, stage of the row, the slice that ends a block

  for (int i = 0; i < nst; ++i) {
    cp_async_wait<DW_STAGES - 2>();
    __syncwarp();  // stage i has landed for every lane; stage i - 1's slot is free
    if (i + DW_STAGES - 1 < nst) issue((i + DW_STAGES - 1) % DW_STAGES);
    cp_async_commit();
    const unsigned char* st = ring + i % DW_STAGES * stage_bytes;
    const int8_t(*sq)[DW_PITCH] = reinterpret_cast<const int8_t(*)[DW_PITCH]>(st);
    const float(*ss)[DW_SC] = reinterpret_cast<const float(*)[DW_SC]>(st + DW_ROWS * DW_PITCH);
    const int c0 = cc * DW_COLS, nsl = min(DW_COLS, N - c0) / 16;
    uint2 xb[NT][DW_SLICES];  // B of each slice: x's columns c0 + 16 sl + 4t ... + 3
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = 8 * nt + g;
#pragma unroll
      for (int sl = 0; sl < DW_SLICES; ++sl)
        xb[nt][sl] = m < xr ? *reinterpret_cast<const uint2*>(st + DW_QS_BYTES + m * DW_XPITCH +
                                                              32 * sl + 8 * t)
                            : make_uint2(0u, 0u);
    }
    int slot = 0;  // the staged scales' block: the first is the one that holds c0
#pragma unroll
    for (int p = 0; p < DW_SLICES / 2; ++p) {
      if (2 * p >= nsl) break;
      uint32_t r[4];  // rows g and g + 8 of slices 2p and 2p + 1, bytes 4t ... 4t + 3
      ldsm_x4(r, &sq[lr][16 * (2 * p + lsl)]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = 2 * p + h;
        if (sl >= nsl) break;
        uint32_t a[4];  // a0, a2: row g's bytes 0-1, 2-3; a1, a3: row g + 8's
        i8x4_to_bf16x4(r[2 * h], a[0], a[2]);
        i8x4_to_bf16x4(r[2 * h + 1], a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(chain[nt], a, xb[nt][sl].x, xb[nt][sl].y);
        if (c0 / 16 + sl == fold) {  // the quant block ends: scale its sum and fold
          const float sc[2] = {ss[g][slot], ss[g + 8][slot]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // C rows g, g + 8 are q rows; columns x rows
              acc[nt][e] = fmaf(chain[nt][e], sc[e >> 1], acc[nt][e]);
              chain[nt][e] = 0.f;
            }
          ++slot;
          fold += bs;
        }
      }
    }
    if (++cc == gpr) {  // the row tile ends (N % block == 0: its last block folded)
      const int k = (gw + cr * nw) * DW_ROWS + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 8 * nt + 2 * t + (e & 1), kk = k + 8 * (e >> 1);
          if (m < M && kk < K) out[(size_t)m * K + kk] = __float2bfloat16_rn(acc[nt][e]);
          acc[nt][e] = 0.f;
        }
      cc = 0;
      ++cr;
      fold = bs - 1;
    }
  }
  cp_async_wait<0>();
}

// Grid of the wide decode kernel: the row tiles' rounds a warp takes when
// one wave of CTAs holds the call, then the fewest CTAs that take the
// tiles in that many rounds (so every warp takes the same number of tiles,
// but the last few warps)
template <int NT>
int launch_dec_tn_wide(const void* x, const void* q, const void* s, void* out, int M, int K,
                       int N, int block, cudaStream_t st) {
  const int xr = M < 8 * NT ? M : 8 * NT;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmm_dec_tn_wide_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dw_smem(8 * NT));
  if (attr != cudaSuccess) return (int)attr;
  static long long cap[8 * NT + 1] = {};  // CTAs of one wave, by xr
  if (cap[xr] == 0) {
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dmm_dec_tn_wide_kernel<NT>,
                                                  DW_THREADS, dw_smem(xr));
    cap[xr] = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (K + DW_ROWS - 1) / DW_ROWS;
  const long long ytiles = (M + 8 * NT - 1) / (8 * NT);
  const long long rounds = (tiles * ytiles + cap[xr] * DW_WARPS - 1) / (cap[xr] * DW_WARPS);
  const long long ctas = (tiles + rounds * DW_WARPS - 1) / (rounds * DW_WARPS);
  dim3 grid((unsigned)ctas, (unsigned)ytiles);
  dmm_dec_tn_wide_kernel<NT><<<grid, DW_THREADS, dw_smem(xr), st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s, (__nv_bfloat16*)out, M, K,
      N, block, xr);
  return launch_status();
}

// ---------------------------------------------------------------------------
// decode path, x @ W (bf16, M <= DEC_MAX_M): mma.sync with the scale in x
// ---------------------------------------------------------------------------

// rows of x up to which the decode path takes a bf16 x @ W call: two row
// tiles (the crossover measured on the card against the other paths:
// PERF.md)
constexpr int DEC_MAX_M = 8;
constexpr int DNT_THREADS = 128;     // 4 warps
constexpr int DNT_WARPS = DNT_THREADS / 32;
constexpr int DNT_COLS = 64;         // output columns a CTA, under one scale a row (block % 64 == 0)
constexpr int DNT_ROWS = 16 * DNT_WARPS;  // q rows of a split's step: one k16 slice a warp
constexpr int DNT_DEPTH = 3;         // k16 slices a warp keeps in flight in registers
constexpr int DNT_MIN_CTAS = 4;      // CTAs an SM holds (__launch_bounds__)
constexpr int DNT_MT = 4;            // rows of x a CTA: hi and lo of 4 rows fill mma's n = 8
constexpr int DNT_FOLD = 4;          // slices a warp's mma chain runs before its f32 fold
constexpr int DNT_MAX_SPLIT = 8;     // K splits of a column tile: one portable cluster
constexpr int DNT_MIN_STEPS = 2;     // steps of DNT_ROWS rows a split takes at least
constexpr int DNT_TARGET = 264;      // CTAs a call aims at: two an SM

// bf16 x @ W with block % 64 == 0 (64 columns share one scale a row) and
// K % 8 == 0 (every bf16 row of x 16-byte aligned)
bool dec_nt_takes(int K, int block, int dtype) {
  return dtype == DT_BF16 && block % DNT_COLS == 0 && K % 8 == 0;
}

// K split of the decode x @ W: number of splits (a cluster) and rows (whole
// steps of DNT_ROWS) a split. Enough splits for DNT_TARGET CTAs, but no
// more than one wave of `capacity` CTAs holds (a second, partial wave
// would double the call), each of at least DNT_MIN_STEPS steps
void dnt_split(int M, int K, int N, long long capacity, int* splits, int* chunk) {
  const long long natural =
      (long long)((N + DNT_COLS - 1) / DNT_COLS) * ((M + DNT_MT - 1) / DNT_MT);
  const int steps = (K + DNT_ROWS - 1) / DNT_ROWS;
  long long sp = (DNT_TARGET + natural - 1) / natural;
  if (sp > capacity / natural) sp = capacity / natural;
  if (sp > DNT_MAX_SPLIT) sp = DNT_MAX_SPLIT;
  if (sp > steps / DNT_MIN_STEPS) sp = steps / DNT_MIN_STEPS;
  if (sp < 1) sp = 1;
  const int per = (int)((steps + sp - 1) / sp);
  *chunk = per * DNT_ROWS;
  *splits = (steps + per - 1) / per;
}

// two rows' bytes I (xor 0x80) of one column -> a bf16 pair, exact: the f32
// of a small integer ends in 16 zero bits, so its top half is its bf16
template <int I>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t row0, uint32_t row1) {
  return __byte_perm(__float_as_uint(i8_to_f32<I>(row0)),
                     __float_as_uint(i8_to_f32<I>(row1)), 0x7632);
}

// one k16 slice as a lane holds it: q rows k, k + 1, k + 8, k + 9 (k = 16 i
// + 2t) at the tile's columns 8g ... 8g + 7, those rows' scales, and x at
// rows (k, k + 1) and (k + 8, k + 9) of the lane's row g % 4 of x (bf16
// pairs); rows past the split are 0
struct DntSlice {
  uint2 q[4];
  float s[4];
  uint32_t x[2];
};

// the A fragment of strip P (0 ... 3) of a slice: strip P's A row g is
// column 8g + 2P, its row g + 8 column 8g + 2P + 1 (r: the slice's q, xor
// 0x80)
template <int P>
__device__ __forceinline__ void dnt_strip(const uint2 (&r)[4], uint32_t (&a)[4]) {
  constexpr int B = 2 * (P & 1);
  const uint32_t w0 = (P < 2 ? r[0].x : r[0].y), w1 = (P < 2 ? r[1].x : r[1].y);
  const uint32_t w8 = (P < 2 ? r[2].x : r[2].y), w9 = (P < 2 ? r[3].x : r[3].y);
  a[0] = i8_pair_bf16<B>(w0, w1);
  a[1] = i8_pair_bf16<B + 1>(w0, w1);
  a[2] = i8_pair_bf16<B>(w8, w9);
  a[3] = i8_pair_bf16<B + 1>(w8, w9);
}

// out (M, N) = x (M, K) @ dequant(q (K, N)), bf16 x and out; grid (column
// tiles of 64, K splits, row tiles of 4), the K splits of a tile one
// cluster. Computed as out.T = q.T @ xs.T on mma.m16n8k16: A is 16 output
// columns x 16 rows of q, widened to bf16 (exact); B is 16 rows x 8: the
// hi and lo bf16 terms of xs = x * s (f32) for the 4 rows of x. Warp w
// takes k16 slices w, w + 4, ... of its split, loaded straight into a
// ring of DNT_DEPTH slices in registers (no shared memory, no barrier), and
// folds its chain into f32 every DNT_FOLD slices; hi and lo are added at
// the end, then the warps in warp order, then the cluster's splits in
// split order.
__global__ void __launch_bounds__(DNT_THREADS, DNT_MIN_CTAS)
dmm_dec_nt_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M,
                  int K, int N, int block, int chunk) {
  __shared__ float red[DNT_WARPS][DNT_MT * DNT_COLS];  // the warps' sums
  __shared__ float part[DNT_MT * DNT_COLS];            // the CTA's sum
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * DNT_COLS, m0 = blockIdx.z * DNT_MT;
  const int kbeg = blockIdx.y * chunk, kend = min(K, kbeg + chunk);
  const int nsl = (kend - kbeg + 15) / 16;                   // the split's slices
  const int mine = nsl > warp ? (nsl - warp + DNT_WARPS - 1) / DNT_WARPS : 0;
  // this lane's B column: row g % 4 of the tile, its hi (g < 4) or lo term
  const int mb = g & 3;
  const bool lo_term = g >= 4, x_in = m0 + mb < M;
  const int8_t* qc = q + n0 + 8 * g;
  const float* sc = s + n0 / block;
  const __nv_bfloat16* xr = x + (size_t)(x_in ? m0 + mb : 0) * K;
  const int nblk = N / block;

  auto fetch = [&](int i, DntSlice& f) {  // the warp's i-th slice
    const int k = kbeg + (warp + DNT_WARPS * i) * 16 + 2 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kr = k + (r & 1) + 8 * (r >> 1);
      const bool in = kr < kend;
      f.q[r] = in ? __ldcs(reinterpret_cast<const uint2*>(qc + (size_t)kr * N))
                  : make_uint2(0u, 0u);
      f.s[r] = in ? __ldg(sc + (size_t)kr * nblk) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // K % 8 == 0: rows k + 8h and k + 8h + 1 are both in or out
      const int kr = k + 8 * h;
      f.x[h] = x_in && kr < kend ? __ldg(reinterpret_cast<const unsigned int*>(xr + kr)) : 0u;
    }
  };

  float acc[4][4], chain[4][4];  // [strip][C register]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = chain[p][i] = 0.f;
  DntSlice ring[DNT_DEPTH];
#pragma unroll
  for (int j = 0; j < DNT_DEPTH; ++j)
    if (j < mine) fetch(j, ring[j]);

  for (int i0 = 0; i0 < mine; i0 += DNT_DEPTH) {
#pragma unroll
    for (int j = 0; j < DNT_DEPTH; ++j) {
      const int i = i0 + j;
      if (i >= mine) break;
      DntSlice& f = ring[j];
      uint32_t b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // xs at rows k + 8h, + 1 -> this lane's term
        __nv_bfloat162 xb;
        *reinterpret_cast<uint32_t*>(&xb) = f.x[h];
        const float2 xv = __bfloat1622float2(xb);
        const float v0 = xv.x * f.s[2 * h], v1 = xv.y * f.s[2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        b[h] = lo_term ? pack_bf16(v0 - __low2float(hi), v1 - __high2float(hi))
                       : *reinterpret_cast<const uint32_t*>(&hi);
      }
      uint2 r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = make_uint2(f.q[e].x ^ 0x80808080u, f.q[e].y ^ 0x80808080u);
      if (i + DNT_DEPTH < mine) fetch(i + DNT_DEPTH, f);  // the slot is free: refill it
      uint32_t a[4];
      dnt_strip<0>(r, a);
      mma_bf16(chain[0], a, b[0], b[1]);
      dnt_strip<1>(r, a);
      mma_bf16(chain[1], a, b[0], b[1]);
      dnt_strip<2>(r, a);
      mma_bf16(chain[2], a, b[0], b[1]);
      dnt_strip<3>(r, a);
      mma_bf16(chain[3], a, b[0], b[1]);
      if ((i + 1) % DNT_FOLD == 0 || i + 1 == mine) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[p][e] += chain[p][e];
            chain[p][e] = 0.f;
          }
      }
    }
  }

  // C row g / g + 8 of strip P is column 8g + 2P / + 1; C column 2t + e is
  // the hi (t < 2) or lo (t >= 2) term of row 2t + e (mod 4): lanes t and
  // t ^ 2 hold the two terms of one output
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = acc[p][i] + __shfl_xor_sync(0xffffffffu, acc[p][i], 2);
      if (t < 2) red[warp][(2 * t + (i & 1)) * DNT_COLS + 8 * g + 2 * p + (i >> 1)] = v;
    }
  __syncthreads();
  for (int o = tid; o < DNT_MT * DNT_COLS; o += DNT_THREADS) {
    float v = red[0][o];
#pragma unroll
    for (int w = 1; w < DNT_WARPS; ++w) v += red[w][o];
    part[o] = v;
  }
  // the cluster's splits in split order: CTA `rank` writes every
  // splits-th output
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int splits = (int)gridDim.y, rank = (int)blockIdx.y;
  for (int o = rank + splits * tid; o < DNT_MT * DNT_COLS; o += splits * DNT_THREADS) {
    float v = *cl.map_shared_rank(part + o, 0);
    for (int i = 1; i < splits; ++i) v += *cl.map_shared_rank(part + o, i);
    const int m = o / DNT_COLS;
    if (m0 + m < M) out[(size_t)(m0 + m) * N + n0 + o % DNT_COLS] = __float2bfloat16_rn(v);
  }
  cl.sync();  // no CTA leaves while another reads its sums
}

// CTAs of the decode x @ W kernel the card holds at once
long long dnt_capacity() {
  static const long long n = [] {
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dmm_dec_nt_kernel, DNT_THREADS, 0);
    return (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  }();
  return n;
}

int launch_dec_nt(const void* x, const void* q, const void* s, void* out, int M, int K,
                  int N, int block, cudaStream_t st) {
  int splits, chunk;
  dnt_split(M, K, N, dnt_capacity(), &splits, &chunk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + DNT_COLS - 1) / DNT_COLS), (unsigned)splits,
                     (unsigned)((M + DNT_MT - 1) / DNT_MT));
  cfg.blockDim = dim3(DNT_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, dmm_dec_nt_kernel, (const __nv_bfloat16*)x, (const int8_t*)q,
      (const float*)s, (__nv_bfloat16*)out, M, K, N, block, chunk);
  if (rc != cudaSuccess) return (int)rc;
  return launch_status();
}

}  // namespace

// The path a call of this shape and dtype takes: 0 = SIMT, 1 = tensor cores,
// 2 = decode
extern "C" int dequant_matmul_path(int M, int K, int N, int block, int transpose,
                                   int dtype) {
  if (M <= DEC_MAX_M_T && dec_takes(N, block, transpose, dtype)) return PATH_DECODE;
  if (!transpose && M <= DEC_MAX_M && dec_nt_takes(K, block, dtype)) return PATH_DECODE;
  return M >= (transpose ? TC_MIN_M_T : TC_MIN_M) && tc_takes(K, block, dtype) ? PATH_TC
                                                                                  : PATH_SIMT;
}

// 1 when ``path`` takes a call of this shape and dtype (it may not be the
// shape's own path), else 0
extern "C" int dequant_matmul_takes(int M, int K, int N, int block, int transpose, int dtype,
                                    int path) {
  if (M <= 0 || block <= 0 || block % 4 != 0 || N % block != 0) return 0;
  if (path == PATH_DECODE)
    return transpose ? dec_takes(N, block, transpose, dtype) : dec_nt_takes(K, block, dtype);
  if (path == PATH_TC) return tc_takes(K, block, dtype);
  return path == PATH_SIMT && (dtype == DT_F32 || dtype == DT_BF16);
}

// f32 elements of scratch a call on ``path`` needs for its K-split partial
// sums (0: none; the decode path splits K inside a cluster)
extern "C" long long dequant_matmul_workspace(int M, int K, int N, int transpose,
                                              int path) {
  if (transpose || M <= 0 || path == PATH_DECODE) return 0;
  int splits, chunk;
  if (path == PATH_TC)
    tc_split(M, K, N, &splits, &chunk);
  else
    nt_split(M, K, N, &splits, &chunk);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// One call on the given path; fails on a shape, dtype or alignment the path
// does not take (the tensor-core and decode paths want 16-byte aligned x
// and q)
extern "C" int dequant_matmul_on_path(const void* x, const void* q, const void* s,
                                      void* out, void* work, int dtype, int M, int K,
                                      int N, int block, int transpose, int path,
                                      void* stream) {
  if (M <= 0) return 0;
  if (block <= 0 || block % 4 != 0 || N % block != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == PATH_DECODE) {
    if (((uintptr_t)x | (uintptr_t)q) % 16 != 0) return (int)cudaErrorInvalidValue;
    if (!transpose) {
      if (!dec_nt_takes(K, block, dtype)) return (int)cudaErrorInvalidValue;
      return launch_dec_nt(x, q, s, out, M, K, N, block, st);
    }
    if (!dec_takes(N, block, transpose, dtype)) return (int)cudaErrorInvalidValue;
    if (N > DEC_TN_MAX_N)
      return M <= 8 ? launch_dec_tn_wide<1>(x, q, s, out, M, K, N, block, st)
                    : launch_dec_tn_wide<2>(x, q, s, out, M, K, N, block, st);
    if (dtype == DT_F32)
      return launch_dec_rows<float>(x, q, s, out, M, K, N, block, st);
    return launch_dec_rows<__nv_bfloat16>(x, q, s, out, M, K, N, block, st);
  }
  if (path == PATH_TC) {
    if (!tc_takes(K, block, dtype) || ((uintptr_t)x | (uintptr_t)q) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_tc(x, q, s, out, work, M, K, N, block, transpose, st);
  }
  if (path != PATH_SIMT) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch_rows<float>(x, q, s, out, work, M, K, N, block, transpose, st);
  if (dtype == DT_BF16)
    return launch_rows<__nv_bfloat16>(x, q, s, out, work, M, K, N, block, transpose, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dequant_matmul(const void* x, const void* q, const void* s, void* out,
                              void* work, int dtype, int M, int K, int N, int block,
                              int transpose, void* stream) {
  return dequant_matmul_on_path(x, q, s, out, work, dtype, M, K, N, block, transpose,
                                dequant_matmul_path(M, K, N, block, transpose, dtype),
                                stream);
}

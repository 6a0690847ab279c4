// Online-softmax attention, forward only.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (:92).
// q (BH, Sq, D); k, v (BH / n_rep, Sk, D) -> o (BH, Sq, D) in the dtype of q;
// D = 64 (qwen2), 96 (GPT-NeoX-20B), 128 (GPT-NeoX-10B) or 256 (gemma3-1b),
// each a template instance; any other D returns cudaErrorInvalidValue.
// Query row i sits at absolute position q_offset + i, key j at j; causal
// keeps j <= q_pos, window > 0 keeps q_pos - j < window. As in the TPU
// kernel: the softmax scale is 1/sqrt(D), masked scores are NEG_INF = -1e30
// (not -inf), keys past Sk weigh exactly 0, the output is acc / max(l,
// 1e-30), and KV tiles that the mask empties for the whole query tile are
// skipped. GQA reads KV head bh / n_rep instead of materialising the
// repeat, which gives the same numbers.
//
// Bound on the H100 (q, k, v, o moved once; 4*D flops per unmasked (query,
// key) pair at 989 TFLOP/s bf16): qwen2's prefill (14 heads over 2, S =
// 128, D = 64, causal) 0.16 us (bytes); NeoX-20B's prefill (64 heads, S =
// 128, D = 96) 1.9 us (bytes); NeoX-10B's (40 heads, D = 128) 1.6 us
// (bytes); qwen2's training step's forward (B = 2 x 14 heads over 2, S =
// 1,024, causal) 3.8 us (operations); NeoX's (B = 2, S = 1,024) 30 us at
// 64 heads of 96 and 25 us at 40 of 128 (bytes; 26 and 22 us of
// operations); gemma3-1b's prefill (4 heads over 1, S = 640, D = 256,
// causal, window 512 on 22 of its 26 layers) 1.0 us (bytes: q and o 2.6 MB,
// k and v 0.66 MB). The prefills' few CTAs (28, 128, 80, 40) make them a
// latency problem.
//
// Two kernels, by dtype:
//  * bf16 (serving and training): tensor cores in the FlashAttention-2
//    shape. A CTA of 4 warps takes 64 query rows, 16 a warp, with the exact
//    bf16 Q fragment in registers up to D = 128. K and V tiles of TK keys
//    (tc_keys: 64, and 32 at D = 256) are double-buffered in dynamic shared
//    memory by cp.async ((64 + 4 TK) rows of D + 8 bf16: 66,560 bytes at
//    D = 96, 87,040 at D = 128, 101,376 at D = 256, over the 48 KB of
//    static arrays). S = Q K^T and O += P V run
//    on mma.sync.m16n8k16 with f32 accumulation, V through ldmatrix.trans.
//    The scale multiplies the f32 scores: the reference folds it into f32
//    q, and the two differ by f32 rounding (1/sqrt(96) and 1/sqrt(128) are
//    no powers of two,
//    so rounding q * scale to bf16 would put 2^-9 on every logit; at D = 64
//    the two orders give the same bits). The running max and sum stay in
//    registers on the S fragments (f32, expf). P is rounded to bf16 for the
//    P V product (the reference keeps it in f32): an error of at most 2^-8
//    of max|v| per output, within the card check's one bf16 ulp of
//    max|ref|. Query tiles run heaviest (latest) first. Registers (ptxas,
//    sm_90a): 160 at D = 64, 168 at 96, 234 at 128, no spill at any; at
//    128 the O accumulator alone is 64 f32 a lane and the Q fragment 32.
//    At D = 256 the accumulator is 128 f32 a lane and the Q fragment would
//    add 64: so there Q stays in shared memory and each k16 slice is read
//    with ldmatrix inside the S loop (16 more ldmatrix a warp per key
//    tile), and the key tile is 32, which halves the S fragment (16 f32
//    a lane). ptxas at D = 256: 252 registers, no spill; with 64-key tiles
//    the instance spills, and it ran slower on the card.
//  * f32 (the port's first design; no path runs attention in f32, the card
//    checks do): one block of 64 threads per (batch*head, 64-row query
//    tile), one query row per thread with its scaled q row and f32
//    accumulator in registers (at D = 96 and 128 more than the register
//    file holds: they spill). K and V tiles of 64 keys (32 at D = 128) are
//    staged in shared memory as f32 (48 KB at D = 96, 32 KB at 128) and
//    read by every thread at the same address (broadcast, no bank
//    conflicts); the running max / sum update once per 16 keys. ptxas:
//    225 registers and no spill at D = 64; 255 and 272 / 312 bytes of spill
//    stores / loads at 96; 255 and 632 / 860 at 128; at 256 16-key tiles
//    (32 KB), 255 registers and 7,468 / 10,112 bytes of spill stores /
//    loads: this path is for the checks and is far slower than its plain
//    version at 256 (PERF.md).
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block, one per thread
constexpr int SUB = 16;   // keys per online-softmax update

// keys per shared-memory tile: two f32 tiles of BK x D stay within the 48 KB
// of static shared memory (48 KB at D = 96, 32 KB at D = 128 and 256)
template <int D>
__host__ __device__ constexpr int f32_keys() { return D > 128 ? 16 : D > 96 ? 32 : 64; }
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int n_rep, int causal, int window, int q_offset, float scale) {
  constexpr int BK = f32_keys<D>();
  static_assert(BK % SUB == 0 && 2 * BK * D * 4 <= 48 * 1024, "f32 tiles");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool live = row < Sq;
  const int q_pos = q_offset + row;
  const int first_q = q_offset + blockIdx.x * BQ;
  const int last_q = q_offset + min(Sq, (int)(blockIdx.x + 1) * BQ) - 1;

  float qr[D], acc[D];
  const T* qp = q + ((size_t)bh * Sq + (live ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qp[d]) * scale;
    acc[d] = 0.f;
  }
  float m_i = NEG_INF, l_i = 0.f;
  const T* kb = k + (size_t)(bh / n_rep) * Sk * D;
  const T* vb = v + (size_t)(bh / n_rep) * Sk * D;

  for (int t0 = 0; t0 < Sk; t0 += BK) {
    const int last_k = min(Sk, t0 + BK) - 1;
    bool run = true;
    if (causal) run = run && t0 <= last_q;
    if (window) run = run && last_k > first_q - window;
    if (!run) continue;  // the same for every thread of the block
    __syncthreads();     // the previous tile's readers are done
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < Sk;
      ks[r][c] = in ? to_f32(kb[(size_t)(t0 + r) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(vb[(size_t)(t0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
    for (int j0 = 0; j0 < BK && t0 + j0 < Sk; j0 += SUB) {
      float sc[SUB];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int kp = t0 + j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[j0 + jj][d]);
          dot = fmaf(qr[d], k4.x, dot);
          dot = fmaf(qr[d + 1], k4.y, dot);
          dot = fmaf(qr[d + 2], k4.z, dot);
          dot = fmaf(qr[d + 3], k4.w, dot);
        }
        bool keep = true;
        if (causal) keep = keep && q_pos >= kp;
        if (window) keep = keep && q_pos - kp < window;
        // keys past Sk are not part of the input: they get weight exactly 0
        sc[jj] = kp < Sk ? (keep ? dot : NEG_INF) : -__int_as_float(0x7f800000);  // -inf
        mx = fmaxf(mx, sc[jj]);
      }
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        sc[jj] = expf(sc[jj] - m_new);
        psum += sc[jj];
      }
      l_i = l_i * corr + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = sc[jj];
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&vs[j0 + jj][d]);
          acc[d] = fmaf(p, v4.x, acc[d]);
          acc[d + 1] = fmaf(p, v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, v4.w, acc[d + 3]);
        }
      }
      m_i = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l_i, 1e-30f);
  T* op = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] / den);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TQ = 16 * TC_WARPS;  // query rows per CTA

// keys per shared-memory tile: 64, and 32 at D = 256, where the S fragment
// of 64 keys (32 f32 a lane) beside the 128 of the O accumulator spills
template <int HD>
__host__ __device__ constexpr int tc_keys() { return HD > 128 ? 32 : 64; }

// a shared-memory row of HD bf16 plus 16 bytes: 144 bytes at 64, 208 at 96,
// 272 at 128, 528 at 256; each way the 8 rows of an ldmatrix land on 8
// distinct 16-byte bank groups (row * RS * 2 mod 128 takes 8 values), so no
// conflicts
template <int HD>
__host__ __device__ constexpr int tc_row() { return HD + 8; }

// qs[TQ][RS], ks[2][TK][RS], vs[2][TK][RS]
template <int HD>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (TQ + 4 * tc_keys<HD>()) * tc_row<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int Sq, int Sk, int n_rep,
                          int causal, int window, int q_offset, float scale) {
  constexpr int RS = tc_row<HD>();
  constexpr int TK = tc_keys<HD>();
  // the Q fragment stays in registers for the whole key loop (HD / 4 a
  // lane) up to D = 128; at 256 it is read from shared memory for each tile
  constexpr bool QREG = HD <= 128;
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  static_assert(HD % 16 == 0 && TQ * CH % (TC_WARPS * 32) == 0 &&
                TK * CH % (TC_WARPS * 32) == 0, "head dim");
  extern __shared__ __align__(16) unsigned char smem[];
  auto qs = reinterpret_cast<__nv_bfloat16 (*)[RS]>(smem);
  auto ks = reinterpret_cast<__nv_bfloat16 (*)[TK][RS]>(smem + TQ * RS * 2);
  auto vs = reinterpret_cast<__nv_bfloat16 (*)[TK][RS]>(smem + (TQ + 2 * TK) * RS * 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // latest (heaviest) tiles first
  const int first_q = q_offset + q0;
  const int last_q = q_offset + min(Sq, q0 + TQ) - 1;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * HD;
  const __nv_bfloat16* kb = k + (size_t)(bh / n_rep) * Sk * HD;
  const __nv_bfloat16* vb = v + (size_t)(bh / n_rep) * Sk * HD;

  // the key tiles the mask leaves non-empty for some row of this query
  // tile: a prefix (causal) intersected with a suffix (window)
  auto runs = [&](int j) {
    const int t0 = j * TK, last_k = min(Sk, t0 + TK) - 1;
    bool r = true;
    if (causal) r = r && t0 <= last_q;
    if (window) r = r && last_k > first_q - window;
    return r;
  };
  int j_lo = 0, j_hi = (Sk + TK - 1) / TK;
  while (j_hi > j_lo && !runs(j_hi - 1)) --j_hi;
  while (j_lo < j_hi && !runs(j_lo)) ++j_lo;

  auto load_kv = [&](int j, int buf) {
#pragma unroll
    for (int h = 0; h < TK * CH / (TC_WARPS * 32); ++h) {
      const int i = tid + h * TC_WARPS * 32, r = i / CH, c = (i % CH) * 8;
      const int key = j * TK + r;
      const bool in = key < Sk;
      cp_async16(&ks[buf][r][c], in ? kb + (size_t)key * HD + c : kb, in);
      cp_async16(&vs[buf][r][c], in ? vb + (size_t)key * HD + c : vb, in);
    }
  };
#pragma unroll
  for (int h = 0; h < TQ * CH / (TC_WARPS * 32); ++h) {
    const int i = tid + h * TC_WARPS * 32, r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < Sq;
    cp_async16(&qs[r][c], in ? qb + (size_t)(q0 + r) * HD + c : qb, in);
  }
  if (j_lo < j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  const int row0 = q_offset + q0 + warp * 16 + g;  // absolute positions of
  const int row1 = row0 + 8;                       // this thread's two rows
  uint32_t qf[QREG ? HD / 16 : 1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const float minus_inf = -__int_as_float(0x7f800000);

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    if (j + 1 < j_hi) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    if (QREG && j == j_lo) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? HD / 16 : 1); ++kk)
        ldsm_x4(qf[kk], &qs[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
    }
    // S = (q K^T) * scale: 16 rows x TK keys a warp
    float sc[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if constexpr (!QREG)
        ldsm_x4(qf[0], &qs[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
      const uint32_t(&qa)[4] = qf[QREG ? kk : 0];
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, &ks[buf][np * 16 + (lane / 16) * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(sc[2 * np], qa, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa, b[2], b[3]);
      }
    }
    // mask, then the online softmax of each of the thread's two rows
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = j * TK + n * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row1;
        bool keep = true;
        if (causal) keep = keep && qp >= kp;
        if (window) keep = keep && qp - kp < window;
        sc[n][e] = kp < Sk ? (keep ? sc[n][e] * scale : NEG_INF) : minus_inf;
        mx[e / 2] = fmaxf(mx[e / 2], sc[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m_r[e / 2]);
        l_r[e / 2] += sc[n][e];  // this thread's share; the quad adds up at the end
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V, P rounded to bf16: the S fragments of keys 16kk..16kk+15 are
    // the A fragment of this product
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, &vs[buf][kk * 16 + lane % 16][np * 16 + (lane / 16) * 8]);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* op = o + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] / l_r[r], acc[n][2 * r + 1] / l_r[r]);
  }
}

// raises the instance's dynamic shared-memory limit on its first launch
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int Sq, int Sk, int n_rep, int causal, int window, int q_offset,
              float scale, cudaStream_t st) {
  constexpr int bytes = tc_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  dim3 grid((unsigned)((Sq + TQ - 1) / TQ), (unsigned)BH);
  flash_attention_tc_kernel<HD><<<grid, TC_WARPS * 32, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, Sq, Sk, n_rep, causal, window, q_offset, scale);
  return 0;
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Sk, int n_rep, int causal, int window, int q_offset,
                float scale, cudaStream_t st) {
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_attention_kernel<float, D><<<grid, BQ, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
      n_rep, causal, window, q_offset, scale);
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int BH, int Sq, int Sk, int D, int n_rep,
                               int causal, int window, int q_offset, float scale,
                               void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if ((D != 64 && D != 96 && D != 128 && D != 256) || n_rep <= 0 || BH % n_rep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) {
    if (D == 64)
      launch_f32<64>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                     scale, st);
    else if (D == 96)
      launch_f32<96>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                     scale, st);
    else if (D == 128)
      launch_f32<128>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                      scale, st);
    else
      launch_f32<256>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                      scale, st);
  } else if (dtype == DT_BF16) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    int rc;
    if (D == 64)
      rc = launch_tc<64>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                         scale, st);
    else if (D == 96)
      rc = launch_tc<96>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, q_offset,
                         scale, st);
    else if (D == 128)
      rc = launch_tc<128>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window,
                          q_offset, scale, st);
    else
      rc = launch_tc<256>(q, k, v, o, BH, Sq, Sk, n_rep, causal, window,
                          q_offset, scale, st);
    if (rc != 0) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}

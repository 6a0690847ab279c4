// Online-softmax attention, forward only.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (:92).
// q (BH, Sq, D); k, v (BH / n_rep, Sk, D) -> o (BH, Sq, D) in the dtype of q.
// Query row i sits at absolute position q_offset + i, key j at j; causal
// keeps j <= q_pos, window > 0 keeps q_pos - j < window. As in the TPU
// kernel: the softmax scale is folded into q before the dot, masked scores
// are NEG_INF = -1e30 (not -inf), the output is acc / max(l, 1e-30), and KV
// tiles that the mask empties for the whole query tile are skipped.
//
// Bound on the H100: at serving's prefill shapes (D = 64, S <= a few
// thousand) the work is q + k + v + o bytes and 4*D flops per unmasked
// (query, key) pair; for S = 128 both are well under a microsecond, so what
// bounds this kernel in practice is its own latency and parallelism.
//
// Design (simple first; tensor-core tiles come later): one block of 64
// threads per (batch*head, 64-row query tile), one query row per thread with
// its scaled q row and f32 accumulator in registers. K and V tiles of 64
// keys are staged in shared memory as f32 and read by every thread at the
// same address (broadcast, no bank conflicts); the running max / sum update
// once per 16 keys. GQA reads KV head bh / n_rep instead of materialising
// the repeat, which gives the same numbers.
#include "common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block, one per thread
constexpr int BK = 64;    // keys per shared-memory tile
constexpr int SUB = 16;   // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int n_rep, int causal, int window, int q_offset, float scale) {
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

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int dtype, int BH, int Sq, int Sk, int D, int n_rep,
                               int causal, int window, int q_offset, float scale,
                               void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (D != 64 || n_rep <= 0 || BH % n_rep != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    flash_attention_kernel<float, 64><<<grid, BQ, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk, n_rep,
        causal, window, q_offset, scale);
  else if (dtype == DT_BF16)
    flash_attention_kernel<__nv_bfloat16, 64><<<grid, BQ, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, Sq, Sk, n_rep, causal, window, q_offset, scale);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

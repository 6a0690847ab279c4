// Mamba-1 selective scan, forward only.
//
// Replaces src/repro/kernels/selective_scan.py::selective_scan_pallas (:56).
// dt, x (B, S, D); b, c (B, S, N); a (D, N); h0 (B, D, N), all f32 ->
// y (B, S, D) f32, h_last (B, D, N) f32. For every (batch row, channel d,
// state n), in time order t = 0..S-1:
//   h = exp(dt[t,d] * a[d,n]) * h + (dt[t,d] * x[t,d]) * b[t,n]
//   y[t,d] = sum_n h * c[t,n]
// As in the TPU kernel, only dt, x, b, c, a, h0 are read and y, h_last
// written: the discretized (B, S, D, N) tensors never reach device memory.
//
// Bound on the H100: bytes and a serial chain. It must move dt, x and y
// (3 * B*S*D * 4 bytes) plus b and c (2 * B*S*N * 4), a (D*N * 4) and h in
// and out (2 * B*D*N * 4): 14.2 MB at the prefill shape (B=1, S=128,
// D=8192, N=16), 4.2 us at 3.35 TB/s. It evaluates B*S*D*N exps and about
// six other f32 operations each: 16.8 M exps at that shape, well under the
// byte time at 67 TFLOP/s. The recurrence is S dependent steps per state,
// so a channel cannot be split along time.
//
// Design (simple first): a block owns CH = 32 channels of one batch row,
// LANES = 4 lanes per channel, each lane keeping N / LANES = 4 states and
// its a[d, n] in registers (state n = lane + LANES * j). The TPU kernel's
// sequential grid dimension over time becomes a loop over time inside the
// block: chunks of T = 32 steps of dt and x (coalesced across channels) and
// of b and c (shared by every channel of the block) are staged in shared
// memory, the next chunk's loads are issued into registers before the
// current chunk is computed, and y is written back per chunk from shared
// memory, coalesced. The N-sum is each lane's 4 products in order, then two
// xor shuffles: a fixed order. At B=1, D=8192 that is 256 blocks of 128
// threads on 132 SMs. Ragged D and S are masked in the kernel.
//
// Numerics: IEEE expf (no fast math) and the plain version's unfused
// multiply-then-add (__fmul_rn / __fadd_rn), so only exp's last bit and the
// order of the N-sum differ from it.
#include "common.cuh"

namespace {

constexpr int N = 16;                 // d_state the kernel is compiled for
constexpr int LANES = 4;              // lanes per channel
constexpr int PER = N / LANES;        // states per lane
constexpr int CH = 32;                // channels per block
constexpr int T = 32;                 // time steps per staged chunk
constexpr int THREADS = CH * LANES;   // 128
constexpr int LD_DX = T * CH / THREADS;  // dt / x elements each thread stages
constexpr int LD_BC = T * N / THREADS;   // b / c elements each thread stages

__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int S,
                      int D) {
  __shared__ float s_dt[T][CH];
  __shared__ float s_x[T][CH];
  __shared__ float s_y[T][CH];
  __shared__ float s_b[T][N];
  __shared__ float s_c[T][N];
  const int row = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int ch = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int d = d0 + ch;
  const bool live = d < D;

  float av[PER], h[PER];
  const size_t h_base = ((size_t)row * D + (live ? d : 0)) * N;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int n = lane + LANES * j;
    av[j] = live ? a[(size_t)d * N + n] : 0.f;
    h[j] = live ? h0[h_base + n] : 0.f;
  }
  const size_t sd_base = (size_t)row * S * D;   // dt, x, y
  const size_t sn_base = (size_t)row * S * N;   // b, c

  // this thread's share of one chunk, loaded into registers
  float r_dt[LD_DX], r_x[LD_DX], r_b[LD_BC], r_c[LD_BC];
  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < LD_DX; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int t = t0 + i / CH, dd = d0 + i % CH;
      const bool in = t < S && dd < D;
      const size_t off = sd_base + (size_t)t * D + dd;
      r_dt[k] = in ? dt[off] : 0.f;
      r_x[k] = in ? x[off] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < LD_BC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int t = t0 + i / N;
      const bool in = t < S;
      const size_t off = sn_base + (size_t)t * N + i % N;
      r_b[k] = in ? bm[off] : 0.f;
      r_c[k] = in ? cm[off] : 0.f;
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += T) {
    const int steps = min(T, S - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int k = 0; k < LD_DX; ++k) {
      const int i = threadIdx.x + k * THREADS;
      s_dt[i / CH][i % CH] = r_dt[k];
      s_x[i / CH][i % CH] = r_x[k];
    }
#pragma unroll
    for (int k = 0; k < LD_BC; ++k) {
      const int i = threadIdx.x + k * THREADS;
      s_b[i / N][i % N] = r_b[k];
      s_c[i / N][i % N] = r_c[k];
    }
    __syncthreads();
    if (t0 + T < S) load(t0 + T);  // in flight while this chunk computes

    for (int t = 0; t < steps; ++t) {  // the same trip count in every thread
      const float dtv = s_dt[t][ch];
      const float dx = __fmul_rn(dtv, s_x[t][ch]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int n = lane + LANES * j;
        const float da = expf(__fmul_rn(dtv, av[j]));
        h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dx, s_b[t][n]));
        acc = __fadd_rn(acc, __fmul_rn(h[j], s_c[t][n]));
      }
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      if (lane == 0) s_y[t][ch] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * CH; i += THREADS) {
      const int t = i / CH, dd = d0 + i % CH;
      if (dd < D) y[sd_base + (size_t)(t0 + t) * D + dd] = s_y[t][i % CH];
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < PER; ++j) h_last[h_base + lane + LANES * j] = h[j];
}

}  // namespace

// dt, x: (B, S, D); b, c: (B, S, N); a: (D, N); h0: (B, D, N), all f32,
// contiguous -> y: (B, S, D), h_last: (B, D, N) f32. N must be 16.
extern "C" int selective_scan(const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0, void* y,
                              void* h_last, int B, int S, int D, int n_state,
                              void* stream) {
  if (n_state != N || S < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || D <= 0) return 0;
  dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  selective_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dt, (const float*)x, (const float*)b, (const float*)c,
      (const float*)a, (const float*)h0, (float*)y, (float*)h_last, S, D);
  return launch_status();
}

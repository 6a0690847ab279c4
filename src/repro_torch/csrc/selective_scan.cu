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
// Bound on the H100: bytes, the special-function unit (SFU), and the
// instructions each (t, d, n) costs. It must move dt, x and y
// (3 * B*S*D * 4 bytes) plus b and c (2 * B*S*N * 4), a (D*N * 4) and h in
// and out (2 * B*D*N * 4): 14.2 MB at the prefill shape (B=1, S=128,
// D=8192, N=16), 4.23 us at 3.35 TB/s, and 60.6 us at S=2048. Every
// (t, d, n) needs one exponential, and an SM issues 16 SFU results a clock:
// B*S*D*N / (132 * 16 * the SM clock), 4.0 us at S=128 and 64 us at S=2048
// at 1,980 MHz. Around that exponential this kernel spends 13 more
// instructions (expf's 7 besides its ex2, the product dt * a, and the plain
// version's unfused multiplies and adds, which keep its bits) and about 2
// more for loads, the N-sum's exchange and stores, and an SM issues 128 a
// clock: an issue floor about twice the SFU floor. The recurrence is S
// dependent steps per state, so a channel is not split along time.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 0.0131 ms at
// S=128 and 0.176 ms at S=2048, 3.3x and 2.7x the SFU floor (the first,
// 32-channel, one-shuffle-a-step version of this kernel: 0.0241 and 0.360).
// ptxas: 95 registers, 40,960 bytes of shared memory a block.
//
// Design: a channel's N = 16 states are spread over L = 4 lanes of one warp
// (lane j keeps states j, j + 4, j + 8, j + 12 and their a[d, n] in
// registers); a warp holds 8 channels and a block CH = 64 channels of one
// batch row (8 warps; 128 blocks at D = 8192, one a multiprocessor, all
// resident at once; 32-channel blocks, two a multiprocessor, were slower at
// long S). The TPU kernel's sequential grid dimension over time becomes
// a loop over time inside the block: chunks of T = 32 steps of dt and x (256
// bytes a step, 16-byte cp.async copies where D % 4 == 0 and both pointers
// are 16-byte aligned, else 4) and of b and c (shared by every channel of the
// block; 4-byte copies that put lane j's four states side by side, so it
// reads them with one 16-byte load) go through a ring of STAGES = 2 chunks in
// shared memory: one in flight while the other is computed, one barrier a
// chunk. The N-sum is not reduced every step: each lane keeps its partial
// sums of a run of L steps in registers, and an exchange of halves across
// the L lanes (3 shuffles a run) leaves each lane with the whole sum of one
// step of the run. A whole chunk is unrolled with no branch inside, so one
// run's exchange overlaps the next runs' work, and its 8 sums a lane are
// written to y after it. Steps past S and channels past D are zero-filled in
// shared memory: there dt = 0, so the decay is exactly 1 and the increment
// 0, and the state is left exactly as it was. Ragged D and S, B > 1 and
// h0 != 0 need nothing else.
//
// Numerics: the plain version's operations, one for one: da =
// expf(fl(dt * a)) (CUDA's expf, which torch.exp runs on the card too),
// h = fl(fl(da * h) + fl(fl(dt * x) * b)), so h and h_last are the plain
// version's bits. y sums each lane's products h * c unfused in state order,
// then (p0 + p1) + (p2 + p3) across the lanes (another order than the plain
// version's .sum(-1)): the scan's order since it was first ported, so
// falcon-mamba's served prefill keeps its bits. A faster form of the same
// design (the decay as one SFU ex2, fused multiply-adds, another sum order)
// stays within the scan's own tolerances, but moves that 64-layer bf16
// prefill onto another rounding path, and chip_smoke.py's check of it
// against the plain versions (5e-2 of max|ref|, which the bf16 rounding
// noise of 64 layers alone nearly fills) then fails; PERF.md has the
// numbers. tests/test_torch_ssm.py rehearses this order on the CPU against
// the reference.
#include "tensor_core.cuh"

namespace {

constexpr int N = 16;            // d_state the kernel is compiled for
constexpr int L = 4;             // lanes a channel
constexpr int PER = N / L;       // states a lane
constexpr int CPW = 32 / L;      // channels a warp
constexpr int CH = 64;           // channels a block
constexpr int THREADS = CH * L;  // 256
constexpr int T = 32;            // time steps a staged chunk
constexpr int STAGES = 2;        // chunks in the shared-memory ring

struct Stage {
  float dt[T][CH];
  float x[T][CH];
  float b[T][N];   // state n at column (n % L) * PER + n / L
  float c[T][N];
};

// copy chunk [t0, t0 + T) of one batch row into g, V floats a copy of dt and
// x (V = 4: 16-byte copies, D % 4 == 0 and 16-byte aligned rows; V = 1:
// 4-byte), 4 bytes a copy of b and c; steps past S and channels past D are
// zero-filled
template <int V>
__device__ __forceinline__ void stage_chunk(Stage& g, const float* dt, const float* x,
                                            const float* bm, const float* cm,
                                            size_t sd_base, size_t sn_base, int t0,
                                            int d0, int S, int D) {
  constexpr int DXN = T * CH / V, BCN = T * N;  // copies a tensor
  static_assert(DXN % THREADS == 0 && BCN % THREADS == 0, "whole rounds");
#pragma unroll
  for (int k = 0; k < 2 * DXN / THREADS; ++k) {
    const int i = (k * THREADS + threadIdx.x) % DXN;
    const bool is_x = k >= DXN / THREADS;
    const int r = i / (CH / V), cc = V * (i % (CH / V));
    const int t = t0 + r, dd = d0 + cc;
    const bool in = t < S && dd < D;
    const float* src = is_x ? x : dt;
    float* dst = is_x ? &g.x[r][cc] : &g.dt[r][cc];
    src = in ? src + sd_base + (size_t)t * D + dd : src;
    if constexpr (V == 4) cp_async16(dst, src, in);
    else cp_async4(dst, src, in);
  }
#pragma unroll
  for (int k = 0; k < 2 * BCN / THREADS; ++k) {
    const int i = (k * THREADS + threadIdx.x) % BCN;
    const bool is_c = k >= BCN / THREADS;
    const int r = i / N, n = i % N;
    const int t = t0 + r;
    const bool in = t < S;
    const float* src = is_c ? cm : bm;
    float* dst = is_c ? &g.c[r][(n % L) * PER + n / L] : &g.b[r][(n % L) * PER + n / L];
    cp_async4(dst, in ? src + sn_base + (size_t)t * N + n : src, in);
  }
}

// L steps from step r0 of the staged chunk: the lane's states advanced, the
// N-sums of the L steps exchanged across the channel's lanes; returns the
// sum of step r0 + jj (jj: j with its two bits swapped)
__device__ __forceinline__ float run(const Stage& g, int r0, int ch, int j,
                                     const float (&av)[PER], float (&h)[PER]) {
  float p[L];
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const float dtv = g.dt[r0 + r][ch];
    const float dx = __fmul_rn(dtv, g.x[r0 + r][ch]);
    const float4 bv = *reinterpret_cast<const float4*>(&g.b[r0 + r][j * PER]);
    const float4 cv = *reinterpret_cast<const float4*>(&g.c[r0 + r][j * PER]);
    const float b4[PER] = {bv.x, bv.y, bv.z, bv.w};
    const float c4[PER] = {cv.x, cv.y, cv.z, cv.w};
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float da = expf(__fmul_rn(dtv, av[i]));
      h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dx, b4[i]));
      acc = __fadd_rn(acc, __fmul_rn(h[i], c4[i]));
    }
    p[r] = acc;
  }
  // halves exchanged, lanes j ^ 1 first, then j ^ 2: at mask m a lane keeps
  // the upper half of its steps if (j & m), sends the other half to lane
  // j ^ m and adds what that lane sends, so each step's sum is
  // (p0 + p1) + (p2 + p3)
#pragma unroll
  for (int m = 1, len = L; m < L; m <<= 1, len >>= 1) {
    const bool up = (j & m) != 0;
#pragma unroll
    for (int i = 0; i < len / 2; ++i) {
      const float keep = up ? p[i + len / 2] : p[i];
      const float send = up ? p[i] : p[i + len / 2];
      p[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m * CPW));
    }
  }
  return p[0];
}

// at least one block a multiprocessor: ptxas then lets the unrolled chunk
// keep about 95 registers a thread; given no minimum it holds it to about
// 55, and the kernel runs slower
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int S,
                      int D) {
  __shared__ __align__(16) Stage ring[STAGES];

  const int row = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int lane = threadIdx.x % 32;
  const int j = lane / CPW;                        // states j + L * i
  const int jj = ((j & 1) << 1) | (j >> 1);        // the step of a run it writes
  const int ch = (threadIdx.x / 32) * CPW + lane % CPW;
  const int d = d0 + ch;
  const bool live = d < D;

  const size_t sd_base = (size_t)row * S * D;   // dt, x, y
  const size_t sn_base = (size_t)row * S * N;   // b, c
  float av[PER], h[PER];
  const size_t h_base = ((size_t)row * D + (live ? d : 0)) * N + j;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    av[i] = live ? a[(size_t)d * N + j + L * i] : 0.f;
    h[i] = live ? h0[h_base + L * i] : 0.f;
  }
  auto issue = [&](int k) {
    stage_chunk<VEC ? 4 : 1>(ring[k % STAGES], dt, x, bm, cm, sd_base, sn_base,
                             k * T, d0, S, D);
  };
  const int chunks = (S + T - 1) / T;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk k landed
    __syncthreads();              // everyone's; and chunk k - 1's readers done
    if (k + STAGES - 1 < chunks) issue(k + STAGES - 1);  // where k - 1 was
    cp_async_commit();            // (an empty group past the end)

    const Stage& g = ring[k % STAGES];
    const int t0 = k * T;
    float* yt = y + sd_base + (size_t)(t0 + jj) * D + d;  // step t0 + jj
    if (t0 + T <= S) {
      // a whole chunk, unrolled with no branch inside, so one run's exchange
      // overlaps the next runs' work; y written after it
      float yv[T / L];
#pragma unroll
      for (int q = 0; q < T / L; ++q) yv[q] = run(g, q * L, ch, j, av, h);
      if (live) {
#pragma unroll
        for (int q = 0; q < T / L; ++q) yt[(size_t)q * L * D] = yv[q];
      }
    } else {
      for (int r0 = 0; r0 < S - t0; r0 += L) {  // the same trip count everywhere
        const float v = run(g, r0, ch, j, av, h);
        if (live && t0 + r0 + jj < S) yt[(size_t)r0 * D] = v;
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) h_last[h_base + L * i] = h[i];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dt, x: (B, S, D); b, c: (B, S, N); a: (D, N); h0: (B, D, N), all f32,
// contiguous -> y: (B, S, D), h_last: (B, D, N) f32. N must be 16.
extern "C" int selective_scan(const void* dt, const void* x, const void* b,
                              const void* c, const void* a, const void* h0, void* y,
                              void* h_last, int B, int S, int D, int n_state,
                              void* stream) {
  if (n_state != N || S < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || D <= 0) return 0;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  const auto kernel = D % 4 == 0 && aligned16(dt) && aligned16(x)
                          ? selective_scan_kernel<true>
                          : selective_scan_kernel<false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dt, (const float*)x, (const float*)b, (const float*)c,
      (const float*)a, (const float*)h0, (float*)y, (float*)h_last, S, D);
  return launch_status();
}

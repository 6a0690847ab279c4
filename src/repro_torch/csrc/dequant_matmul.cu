// Fused INT8-dequant x matmul on the flat-shard scale layout.
//
// Replaces src/repro/kernels/dequant_matmul.py::dequant_matmul_flat_pallas
// (:113), both orientations:
//   transpose = 0: out (M, N) = x (M, K) @ dequant(q (K, N))
//   transpose = 1: out (M, K) = x (M, N) @ dequant(q (K, N)).T
// The scale of q[k, j] is s[k, j / block] (N % block == 0). Products and sums
// are f32; x and out share the compute dtype (f32 or bf16).
//
// Bound on the H100: bytes. Serving runs M = n_slots (decode), M = 1 (the
// LM head of a prefill) and M = prompt_len (prefill): every INT8 weight byte
// is read once and feeds 2*M flops, far below the ~300 flops per byte at
// which the card stops being memory-bound for M <= 128 on tensor cores.
//
// Design (simple first; wgmma/TMA come later): the weight never leaves
// registers as a dense tile. Each lane loads 4 consecutive INT8 weights with
// one 4-byte load (a warp reads 128 contiguous bytes), scales them in
// registers with their flat-layout block scale, and applies them to MT rows
// of x that the block staged in shared memory as f32, so each weight byte is
// reused MT times from registers.
//  * x @ W: a block owns 128 output columns and a K range; its 8 warps split
//    the K rows and meet in shared memory. When the (column, row-tile) grid
//    is too small to fill 132 SMs, K is also split across blocks, and a
//    second kernel adds the f32 partial sums in split order (deterministic,
//    no atomics).
//  * x @ W.T: the contraction runs along a contiguous q row, so one warp
//    owns one output column k and reduces its lanes with shuffles.
#include "common.cuh"

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

}  // namespace

// f32 elements of scratch the call needs for its K-split partial sums (0: none)
extern "C" long long dequant_matmul_workspace(int M, int K, int N, int transpose) {
  if (transpose || M <= 0) return 0;
  int splits, chunk;
  nt_split(M, K, N, &splits, &chunk);
  return splits > 1 ? (long long)splits * M * N : 0;
}

extern "C" int dequant_matmul(const void* x, const void* q, const void* s, void* out,
                              void* work, int dtype, int M, int K, int N, int block,
                              int transpose, void* stream) {
  if (M <= 0) return 0;
  if (block <= 0 || block % 4 != 0 || N % block != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_rows<float>(x, q, s, out, work, M, K, N, block, transpose, st);
  if (dtype == DT_BF16)
    return launch_rows<__nv_bfloat16>(x, q, s, out, work, M, K, N, block, transpose, st);
  return (int)cudaErrorInvalidValue;
}

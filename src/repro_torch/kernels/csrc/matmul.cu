// matmul for Hopper (sm_90a): C[M, N] = A[M, K] @ B[K, N] in fp32, the
// shrunk backward products of channel-granularity ssProp on a dense layer
// (dX = dY[:, kept] @ W[:, kept]^T and compact dW = X^T @ dY[:, kept]).
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::matmul`
// (Pallas; 128^3 MXU blocks, grid (M/bm, N/bn, K/bk) with the output block
// revisited along the sequential K axis, every operand zero-padded to
// 128 by the wrapper).
//
// What bounds it on this card: at the main path's shapes (qwen2.5-3b,
// M = B*S = 1024 tokens, K kept = 410 / 51 / 2202 channels, outputs up to
// 11008 x 410) a product does 2*M*N*K flops on (M*K + K*N) inputs and M*N
// fp32 outputs: 50-400 flops a byte, far above the ridge of either rate,
// so it is bound by operations. This version runs on the fp32 FMA units
// (67 TFLOP/s), not the tensor cores. The design:
//   * one block per 64x64 output tile, the whole reduction a loop inside
//     the block in panels of 16, so every output element is written once:
//     no split-K, no atomics, a fixed summation order;
//   * each operand comes with its two strides, so the transposed operands
//     the backward hands over (w_k.T and x2.T are views) are read in place
//     with no copy; a panel is loaded with neighbouring threads on the
//     operand's unit-stride axis, so either layout reads coalesced;
//   * bf16 or fp32 operands, widened to fp32 on their way into shared
//     memory; ragged M, N and K (K = 410, 51, 2202) masked in the kernel;
//   * fp32 FMA on 4x4 outputs a thread (tile.cuh); no tensor cores yet.

#include "tile.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::LD;
using tile::THREADS;

// p[k][r] = X(r0 + r, k0 + k) for r < 64, k < BK, where X(r, k) sits at
// x[r * s_r + k * s_k]; zero outside R x K. With r_fast, neighbouring
// threads take neighbouring r (the operand's rows are its unit-stride
// axis), else neighbouring k.
template <typename T>
__device__ __forceinline__ void load_panel(float (*p)[LD], const T* __restrict__ x, long long r0,
                                           int k0, long long R, int K, long long s_r,
                                           long long s_k, bool r_fast, int tid) {
  if (r_fast) {
    const int lr = tid % BM;
    const long long r = r0 + lr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tid / BM + 4 * i;
      const int k = k0 + kk;
      p[kk][lr] = (r < R && k < K) ? tile::to_f32(x[r * s_r + (long long)k * s_k]) : 0.f;
    }
  } else {
    const int lk = tid % BK;
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = tid / BK + 16 * i;
      const long long r = r0 + rr;
      p[lk][rr] = (r < R && k < K) ? tile::to_f32(x[r * s_r + (long long)k * s_k]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out, int M,
              int N, int K, long long sa_m, long long sa_k, long long sb_k, long long sb_n) {
  __shared__ __align__(16) float pa[BK][LD];  // A panel, pa[k][row m]
  __shared__ __align__(16) float pb[BK][LD];  // B panel, pb[k][col n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const bool a_rows = sa_m == 1 && sa_k != 1;
  const bool b_cols = sb_n == 1 && sb_k != 1;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_panel(pa, a, m0, k0, M, K, sa_m, sa_k, a_rows, tid);
    load_panel(pb, b, n0, k0, N, K, sb_n, sb_k, b_cols, tid);
    __syncthreads();
    tile::fma_panels(pa, pb, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx * 4 + j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K, long long sa_m,
           long long sa_k, long long sb_k, long long sb_n, cudaStream_t st) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  matmul_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                             static_cast<float*>(out), M, N, K, sa_m, sa_k, sb_k,
                                             sb_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. a [M, K] with element strides
// (sa_m, sa_k), b [K, N] with strides (sb_k, sb_n), both fp32 (bf16 = 0) or
// both bf16 (bf16 = 1); out [M, N] fp32, contiguous. Returns the launch's
// cudaGetLastError().
extern "C" int matmul_launch(const void* a, const void* b, void* out, int M, int N, int K,
                             long long sa_m, long long sa_k, long long sb_k, long long sb_n,
                             int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, b, out, M, N, K, sa_m, sa_k, sb_k, sb_n, st);
  return launch<float>(a, b, out, M, N, K, sa_m, sa_k, sb_k, sb_n, st);
}

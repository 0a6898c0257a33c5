// dw_gathered for Hopper (sm_90a): the compact weight gradient
// dW[D_in, KB*bs] = X^T @ dY[:, kept] over the kept channel blocks; the
// wrapper scatters it into a zero dW, so dropped blocks stay exactly 0.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::dw_gathered`
// (Pallas; grid (D_in/bm, KB, M/bk_m) with the kept block indices in SMEM by
// scalar prefetch and the output block revisited along the sequential M
// axis).
//
// What bounds it on this card: the reduction is long and the output small.
// At the stem of ResNet-18 (X = the 131072 x 27 im2col patches, one ragged
// kept block of 64 real channels) it does 2*131072*27*64 = 0.45 GFLOP on
// 131072*(27 + 64) inputs: about 9 flops a byte in fp32, below the 20
// flops a byte ridge, so it is bound by bytes; at the 1x1 down convs
// (M = 32768/8192/2048, D_in = 64/128/256) it sits near the ridge. Either
// way one block per output tile would leave most of the 132 SMs idle (the
// stem's output has two 64x64 tiles). The design:
//   * deterministic split-K: the M axis, sequential on the TPU, is cut into
//     S chunks; block (column tile, row tile, s) loops over its chunk in
//     panels of 16 rows and writes its partial tile to a scratch buffer
//     [S, D_in, KB*bs] that the wrapper allocates; a second kernel sums the
//     S partials in a fixed order (no float atomics, so a result repeats
//     exactly from run to run);
//   * the block loads block_idx[j] for each of its columns and addresses
//     that contiguous run of dY's channels; column tiles whose channels all
//     lie past N (the ragged tail's phantoms) write zeros without work;
//   * ragged M, D_in and channels are masked in the kernel;
//   * fp32 FMA on 4x4 outputs a thread; no tensor cores yet.

#include "tile.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::LD;
using tile::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_gathered_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const int* __restrict__ bidx, float* __restrict__ partial, int M, int D,
                   int N, int NC, int bs, int chunk) {
  __shared__ __align__(16) float a[BK][LD];  // X panel,  a[k][row d]
  __shared__ __align__(16) float b[BK][LD];  // dY panel, b[k][col n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int d0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  const long long mbeg = (long long)s * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;
  float* part = partial + (long long)s * D * NC;

  // loader slots: row/column tid % 64, panel steps tid / 64 + 4 i
  const int lc = tid % BM;
  const int lk = tid / BM;
  const int d_ld = d0 + lc;
  const int n_ld = n0 + lc;
  int ch = -1;  // dY channel of this thread's column, -1 if none
  if (n_ld < NC) {
    const int c = bidx[n_ld / bs] * bs + n_ld % bs;
    if (c < N) ch = c;
  }

  float acc[4][4] = {};
  if (__syncthreads_or(ch >= 0)) {
    for (long long m0 = mbeg; m0 < mend; m0 += BK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = lk + 4 * i;
        const long long m = m0 + k;
        const bool mok = m < mend;
        a[k][lc] = (mok && d_ld < D) ? tile::to_f32(x[m * D + d_ld]) : 0.f;
        b[k][lc] = (mok && ch >= 0) ? tile::to_f32(dy[m * N + ch]) : 0.f;
      }
      __syncthreads();
      tile::fma_panels(a, b, acc, tx, ty);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= D) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < NC) part[(long long)d * NC + n] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dy, const void* bidx, void* partial, void* out, int M,
           int D, int N, int KB, int bs, int S, int chunk, cudaStream_t st) {
  const int NC = KB * bs;
  float* dst = S == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const dim3 grid((unsigned)((NC + BN - 1) / BN), (unsigned)((D + BM - 1) / BM), (unsigned)S);
  dw_gathered_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const int*>(bidx), dst,
      M, D, N, NC, bs, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long n = (long long)D * NC;
  tile::reduce_splits<<<tile::reduce_blocks(n), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, D] and dy [M, N] contiguous,
// both fp32 (bf16 = 0) or both bf16 (bf16 = 1); bidx [KB] int32; partial
// [S, D, KB*bs] fp32 scratch (unused when S == 1); out [D, KB*bs] fp32. Rows
// [s*chunk, (s+1)*chunk) form split s. Returns cudaGetLastError() of the
// last launch.
extern "C" int dw_gathered_launch(const void* x, const void* dy, const void* bidx,
                                  void* partial, void* out, int M, int D, int N, int KB,
                                  int bs, int S, int chunk, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, bidx, partial, out, M, D, N, KB, bs, S, chunk, st);
  return launch<float>(x, dy, bidx, partial, out, M, D, N, KB, bs, S, chunk, st);
}

// dx_gathered for Hopper (sm_90a): dX[M, D_in] = sum over kept channel blocks
// of dY[:, blk] @ W[:, blk]^T, the input gradient of the ssProp backward.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::dx_gathered`
// (Pallas; grid (M/bm, D_in/bn, KB) with the kept block indices in SMEM by
// scalar prefetch and the output block revisited along the sequential KB
// axis).
//
// What bounds it on this card: at the main path's shapes (ResNet-18's 1x1
// stride-2 down convs: M = 32768/8192/2048 rows, D_in = 64/128/256, one kept
// 128-channel block) it does 2*M*D_in*K flops on M*K + D_in*K inputs and
// M*D_in outputs, about 21-43 flops a byte in fp32: just above the ridge of
// the 67 TFLOP/s fp32 rate over 3.35 TB/s (20 flops a byte), so it is bound
// by operations, barely. The design:
//   * one block per 64x64 tile of dX; the KB axis, sequential on the TPU,
//     is a loop inside the block over the kept blocks and their channels in
//     panels of 16, so every output element is written once, with no
//     atomics and no second pass;
//   * the block loads block_idx[j] itself and addresses that contiguous run
//     of channels (channels are innermost in dY and W, so a panel row is one
//     contiguous load);
//   * ragged M, D_in and a ragged channel tail (channels past N are zeros)
//     are masked in the kernel: the wrapper pads nothing;
//   * fp32 FMA on 4x4 outputs a thread from shared-memory panels; no tensor
//     cores yet.

#include "tile.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::LD;
using tile::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_gathered_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                   const int* __restrict__ bidx, float* __restrict__ out, int M, int N,
                   int D, int KB, int bs) {
  __shared__ __align__(16) float a[BK][LD];  // dY panel, a[k][row m]
  __shared__ __align__(16) float b[BK][LD];  // W panel,  b[k][col d]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * BN;
  // loader slots: channel step k = tid % BK, rows tid / BK + 16 i
  const int lk = tid % BK;
  const int lr = tid / BK;

  float acc[4][4] = {};
  for (int j = 0; j < KB; ++j) {
    const int base = bidx[j] * bs;
    for (int c0 = 0; c0 < bs && base + c0 < N; c0 += BK) {
      const int ch = base + c0 + lk;
      const bool ok = (c0 + lk < bs) && (ch < N);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lr + 16 * i;
        const long long m = m0 + r;
        const int d = d0 + r;
        a[lk][r] = (ok && m < M) ? tile::to_f32(dy[m * N + ch]) : 0.f;
        b[lk][r] = (ok && d < D) ? tile::to_f32(w[(long long)d * N + ch]) : 0.f;
      }
      __syncthreads();
      tile::fma_panels(a, b, acc, tx, ty);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = d0 + tx * 4 + jj;
      if (d < D) out[m * D + d] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* dy, const void* w, const void* bidx, void* out, int M, int N, int D,
           int KB, int bs, cudaStream_t st) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((D + BN - 1) / BN));
  dx_gathered_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const int*>(bidx),
      static_cast<float*>(out), M, N, D, KB, bs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dy [M, N] and w [D, N] contiguous,
// both fp32 (bf16 = 0) or both bf16 (bf16 = 1); bidx [KB] int32 kept block
// indices; out [M, D] fp32. Returns the launch's cudaGetLastError().
extern "C" int dx_gathered_launch(const void* dy, const void* w, const void* bidx, void* out,
                                  int M, int N, int D, int KB, int bs, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(dy, w, bidx, out, M, N, D, KB, bs, st);
  return launch<float>(dy, w, bidx, out, M, N, D, KB, bs, st);
}

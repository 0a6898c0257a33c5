// Shared pieces of the matmul-shaped kernels. The SIMT tile: a 64x64 fp32
// output tile per block of 256 threads, 4x4 outputs a thread, fed from two
// shared-memory panels of BK reduction steps; dx_gathered.cu and
// matmul.cu's fp32 variant fill the panels with their own addressing (the
// kept-block gather, strided operands), and the multiply-add over a panel
// pair is the same in both. Plain SIMT fp32 FMA: no tensor cores, no TMA,
// no pipelining; operands fp32 or bf16, widened to fp32 on their way into
// shared memory. The tensor-core kernels (conv_dw_fused.cu,
// conv_dx_fused.cu, dw_gathered.cu) take their pieces from mma.cuh. The
// fixed-order reduction of split-K partials is shared by the split
// kernels that sum their partials in series (matmul.cu's bf16 wgmma
// variant, conv_dw_fused.cu; dw_gathered.cu's many splits take its own
// two-level sum).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile {

constexpr int BM = 64;        // tile rows
constexpr int BN = 64;        // tile columns
constexpr int BK = 16;        // reduction steps per panel
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LD = BM + 4;    // padded panel row (floats); keeps float4 reads aligned

static_assert(BM == BN, "the panels share one row length");
static_assert(BM * BK == 4 * THREADS, "each thread loads 4 values of each panel");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][tx*4 + j]
__device__ __forceinline__ void fma_panels(const float (*a)[LD], const float (*b)[LD],
                                           float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// out[i] = sum_{s < S} partial[s * n + i], summed in the order s = 0, 1, ...
// so that a result repeats exactly from run to run.
__global__ void reduce_splits(const float* __restrict__ partial, float* __restrict__ out,
                              long long n, int S) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += partial[k * n + i];
    out[i] = s;
  }
}

inline int reduce_blocks(long long n) {
  const long long b = (n + 255) / 256;
  return (int)(b < 4096 ? b : 4096);
}

}  // namespace tile

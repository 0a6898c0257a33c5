// dx_gathered for Hopper (sm_90a): dX[M, D_in] = sum over kept channel blocks
// of dY[:, blk] @ W[:, blk]^T, the input gradient of the ssProp backward.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::dx_gathered`
// (Pallas; grid (M/bm, D_in/bn, KB) with the kept block indices in SMEM by
// scalar prefetch and the output block revisited along the sequential KB
// axis).
//
// What bounds it on this card: bytes. At the main path's shapes (ResNet-18's
// 1x1 stride-2 down convs: M = 32768/8192/2048 rows, D_in = 64/128/256, one
// kept 128-channel block) the reduction is short (K = 128), so the work is
// 2*M*D_in*128 flops on M*128 + D_in*128 inputs and M*D_in outputs. On the
// tensor cores (three TF32 products at 495 TFLOP/s) block_2/down's 0.54
// GFLOP take 0.0033 ms, while its 16.8 MB of kept dY and 8.4 MB of dX take
// 0.0075 ms at 3.35 TB/s: a streaming kernel, whose time is load latency
// unless many bytes are in flight. The design:
//   * an implicit GEMM with both operands K-contiguous: dY [M, N] is a[m][k]
//     and W [D_in, N] is b[n][k] over the kept channels, the layout of
//     mma.cuh's stage_mma_mk. A block takes a 64x64 tile of dX (four warps
//     of 32x32, mma.sync m16n8k8: fp32 as 3xTF32, bf16 as one bf16
//     product) and reduces over the compact channel axis (kept block j,
//     channel o) in stages of 32 channels;
//   * stages come through a cp.async ring of 16-byte copies, 4 deep where
//     the grid fits one wave at 3 blocks an SM (with K = 128, all four
//     stages of a kept block are in flight at once), else 3 deep, which
//     fits 4 blocks an SM (block_2/down's 512 tiles: one wave). Each
//     copy loads block_idx[j] itself and addresses that contiguous run of
//     dY's and W's channels. Rows whose pitch (N) or blocks whose width is
//     not a multiple of 16 bytes, or unaligned operands, load the same ring
//     element by element, in the same kernel;
//   * ragged M, D_in and the channel tail (channels past N are zeros, by
//     the copy's zero fill) are masked in the kernel; the reduction stops
//     at the last real channel of the last kept block;
//   * the column tiles of one row tile are neighbours in the grid, so dY is
//     read from device memory once and from L2 by the others (D_in = 64
//     has a single column tile); every output element is written once, by
//     one block (no split, no atomics: M alone gives 32-512 row tiles).

#include <stdint.h>

#include "geometry.cuh"
#include "mma.cuh"

namespace {

constexpr int BM = 64;        // output rows (m) a block
constexpr int BN = 64;        // output columns (d) a block
constexpr int BK = 32;        // reduction steps (kept channels) a stage
constexpr int THREADS = 128;  // four warps, 32 x 32 outputs each
static_assert(BM == BN, "a loader pass covers the rows of both operands");

// stage row pitch (elements): 16-byte rows whose fragment reads hit 32
// distinct banks (36 fp32 words; 40 bf16 = 20 words)
template <typename T>
__host__ __device__ constexpr int ldk() {
  return BK + 16 / (int)sizeof(T);
}

// STAGES: the cp.async ring's depth, 4 (3 blocks an SM fit) or 3 (4 fit)
template <typename T, int STAGES>
__global__ void __launch_bounds__(THREADS, STAGES == 4 ? 3 : 4)
dx_gathered_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                   const int* __restrict__ bidx, float* __restrict__ out, int M, int N, int D,
                   int KB, int bs, int col_tiles, int fast) {
  constexpr int LDK = ldk<T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM + BN][LDK]: dY rows, then W rows
  const int tid = threadIdx.x;
  const int d0 = (int)(blockIdx.x % col_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / col_tiles) * BM;
  const int KC = KB * bs;  // compact channels
  // the reduction ends at the last real channel of the last kept block
  const int k_end = KB > 0 ? KC - bs + max(0, min(bs, N - bidx[KB - 1] * bs)) : 0;
  const int nk = (k_end + BK - 1) / BK;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[2][4][4] = {};

  if (nk > 0) {
    // Fast loader: CPR 16-byte copies cover a 32-channel row; thread (lr,
    // cc) takes copy cc of rows lr, lr + RPP, ... of both operands.
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = BK / EPC;
    constexpr int RPP = THREADS / CPR;
    constexpr int PASSES = BM / RPP;
    const int cc = tid % CPR, lr = tid / CPR;

    // channel of compact channel kc (kc < KC), or -1 past N
    auto channel = [&](int kc) {
      const int j = kc / bs;
      const int ch = bidx[j] * bs + (kc - j * bs);
      return ch < N ? ch : -1;
    };

    auto load = [&](int it) {
      T* sa = ring + (it % STAGES) * (BM + BN) * LDK;
      T* sb = sa + BM * LDK;
      const int k0 = it * BK;
      if (fast) {
        const int kc = k0 + cc * EPC;
        const int ch = kc < KC ? channel(kc) : -1;  // a copy lies in one block
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const int row = lr + RPP * i;
          const long long m = m0 + row;
          const bool aok = ch >= 0 && m < M;
          mma::cp_async16(sa + row * LDK + cc * EPC, aok ? dy + m * N + ch : dy, aok);
          const int d = d0 + row;
          const bool bok = ch >= 0 && d < D;
          mma::cp_async16(sb + row * LDK + cc * EPC, bok ? w + (long long)d * N + ch : w, bok);
        }
      } else {
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int row = e / BK, k = e % BK;
          const int kc = k0 + k;
          const int ch = kc < KC ? channel(kc) : -1;
          const long long m = m0 + row;
          const int d = d0 + row;
          sa[row * LDK + k] = ch >= 0 && m < M ? dy[m * N + ch] : T(0.f);
          sb[row * LDK + k] = ch >= 0 && d < D ? w[(long long)d * N + ch] : T(0.f);
        }
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st);
      mma::cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      mma::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage it landed for all; every thread is done with stage it-1
      if (it + STAGES - 1 < nk) load(it + STAGES - 1);
      mma::cp_async_commit();
      const T* sa = ring + (it % STAGES) * (BM + BN) * LDK;
      mma::stage_mma_mk<BK>(sa, sa + BM * LDK, LDK, acc, wm, wn, gq, tq);
    }
    mma::cp_async_wait<0>();
  }

  // acc[mi][ni][2 hq + q]: row wm + 16 mi + gq + 8 hq, column wn + 8 ni +
  // 2 tq + q of the tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const long long m = m0 + wm + 16 * mi + gq + 8 * hq;
      if (m >= M) continue;
      float* row = out + m * D;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int d = d0 + wn + 8 * ni + 2 * tq;
        const float v0 = acc[mi][ni][2 * hq], v1 = acc[mi][ni][2 * hq + 1];
        if (d + 1 < D && D % 2 == 0) {
          *reinterpret_cast<float2*>(row + d) = make_float2(v0, v1);
        } else {
          if (d < D) row[d] = v0;
          if (d + 1 < D) row[d + 1] = v1;
        }
      }
    }
}

template <typename T, int STAGES>
int start(const void* dy, const void* w, const void* bidx, void* out, int M, int N, int D,
          int KB, int bs, int col_tiles, const geometry::Geometry& geo, int fast,
          cudaStream_t st) {
  auto kernel = dx_gathered_kernel<T, STAGES>;
  const int smem = geo.first.smem;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<geo.first.grid, geo.first.block, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const int*>(bidx),
      static_cast<float*>(out), M, N, D, KB, bs, col_tiles, fast);
  return (int)cudaGetLastError();
}

// One block an output tile (row tiles major, column tiles minor); a 4-deep
// ring where the grid fills at most three blocks an SM, else 3 deep.
template <typename T>
int plan(int M, int D, geometry::Geometry& geo) {
  if (M == 0 || D == 0) return 0;
  int sms = 0;
  const int e = geometry::sm_count(&sms);
  if (e != 0) return e;
  const int col_tiles = (D + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * col_tiles;
  geo.stages = tiles <= 3LL * sms ? 4 : 3;
  geo.first.grid = dim3((unsigned)tiles, 1, 1);
  geo.first.block = dim3(THREADS, 1, 1);
  geo.first.smem = geo.stages * (BM + BN) * ldk<T>() * (int)sizeof(T);
  return 0;
}

template <typename T>
int launch(const void* dy, const void* w, const void* bidx, void* out, int M, int N, int D,
           int KB, int bs, cudaStream_t st) {
  geometry::Geometry geo;
  const int e = plan<T>(M, D, geo);
  if (e != 0 || geo.first.grid.x == 0) return e;
  constexpr int EPC = 16 / sizeof(T);
  // 16-byte copies: every row pitch and kept-block start on 16 bytes
  const int fast = N % EPC == 0 && bs % EPC == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int col_tiles = (D + BN - 1) / BN;
  if (geo.stages == 4)
    return start<T, 4>(dy, w, bidx, out, M, N, D, KB, bs, col_tiles, geo, fast, st);
  return start<T, 3>(dy, w, bidx, out, M, N, D, KB, bs, col_tiles, geo, fast, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dy [M, N] and w [D, N] contiguous,
// both fp32 (bf16 = 0) or both bf16 (bf16 = 1); bidx [KB] int32 kept block
// indices; out [M, D] fp32, every element written once. Returns the launch's
// cudaGetLastError().
extern "C" int dx_gathered_launch(const void* dy, const void* w, const void* bidx, void* out,
                                  int M, int N, int D, int KB, int bs, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(dy, w, bidx, out, M, N, D, KB, bs, st);
  return launch<float>(dy, w, bidx, out, M, N, D, KB, bs, st);
}

// The launch geometry of dx_gathered_launch with these arguments
// (geometry.cuh says what out[16] holds).
extern "C" int dx_gathered_geometry(int M, int N, int D, int KB, int bs, int bf16, int* out) {
  (void)N, (void)KB, (void)bs;
  geometry::Geometry geo;
  const int e = bf16 ? plan<__nv_bfloat16>(M, D, geo) : plan<float>(M, D, geo);
  geometry::put(geo, out);
  return e;
}

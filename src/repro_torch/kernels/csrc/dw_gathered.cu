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
// 131072*(27 + 64) inputs, 47.7 MB in fp32: bound by bytes (0.014 ms at
// 3.35 TB/s). At the 1x1 down convs (M = 32768/8192/2048, D_in =
// 64/128/256) it sits near the ridge. Either way one block per output tile
// would leave most of the 132 SMs idle (the stem's output has one 64x64
// tile that does work). The design:
//   * the output is cut in 64x64 tiles, a column tile inside one kept block
//     (four warps of 32x32, mma.sync m16n8k8: fp32 as 3xTF32, bf16 as one
//     bf16 product; the stage products are conv_dw_fused's, mma.cuh);
//   * deterministic split-K: the M axis, sequential on the TPU, is cut into
//     S chunks of whole 32-row stages; block (column tile, row tile, s)
//     loops over its chunk and writes its partial tile to a scratch buffer
//     [S, D_in, KB*bs]. The wrapper's plan (`gathered_matmul.py::dw_plan`)
//     counts only the column tiles that do work: a tile whose channels all
//     lie past N (the ragged tail's phantoms) gets no split work, and its
//     columns are written as zeros once, by the second pass. That pass sums
//     the S partials in a fixed two-level order, parallel over splits as
//     well as elements: 8 threads an element each sum a contiguous run of
//     splits, then one sums their 8 results (no float atomics, so a result
//     repeats exactly from run to run);
//   * stages come through a 3-deep cp.async ring of 16-byte copies. A
//     stage of dY is 32 rows x 64 kept channels, a contiguous run of each
//     row. A stage of X is 32 rows x 64 of its columns when its rows are
//     16-byte multiples (D_in = 64/128/256); else, for D_in under 64 (the
//     stem's 27), it is the stage's rows as one contiguous slab of 32*D_in
//     elements, copied whole (a chunk starts on a multiple of 32 rows, so
//     on 16 bytes) and indexed in shared memory; the warps whose rows lie
//     past D_in skip their products. Unaligned operands load the same ring
//     element by element, in the same kernel;
//   * the block loads block_idx[j] and addresses that contiguous run of
//     dY's channels; ragged M, D_in and channels are masked in the kernel.

#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 64;        // output rows (d) a block
constexpr int BN = 64;        // output columns (kept channels of one block) a block
constexpr int BK = 32;        // rows of X and dY a stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps, 32 x 32 outputs each
constexpr int LDS = BM + 8;   // [k][m] stage row (elements): 16-byte rows, conflict-free fragments
constexpr int RED_LANES = 32, RED_GROUPS = 8;  // the reduce pass: elements x split runs a block

enum XLoad { X_GENERIC = 0, X_ROWS = 1, X_SLAB = 2 };

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
dw_gathered_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const int* __restrict__ bidx, float* __restrict__ dst, int M, int D, int N,
                   int KB, int bs, int S, int chunk, int x_load, int dy_fast) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [STAGES][2][BK][LDS]: X then dY
  const int tid = threadIdx.x;
  const int ctpb = (bs + BN - 1) / BN;  // column tiles per kept block
  const int j = blockIdx.x / ctpb;
  const int o0 = (blockIdx.x % ctpb) * BN;
  const int d0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  const int NC = KB * bs;
  const int ch0 = bidx[j] * bs + o0;
  const int real = min(BN, min(bs - o0, N - ch0));  // real channels of the tile
  if (real <= 0 && S > 1) return;  // phantom: the second pass writes its zeros
  const long long mbeg = (long long)s * chunk;
  const long long mend = mbeg + chunk < M ? mbeg + chunk : M;
  const int nk = real > 0 && mend > mbeg ? (int)((mend - mbeg + BK - 1) / BK) : 0;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane / 4, tq = lane % 4;
  // a warp whose rows all lie past D_in, or whose columns are all phantoms,
  // has nothing to multiply (uniform over the warp)
  const bool warp_works = d0 + wm < D && wn < real;
  const int lda = x_load == X_SLAB ? D : LDS;
  float acc[2][4][4] = {};

  if (nk > 0) {
    // row loads: CPR 16-byte copies cover a 64-wide row; thread (lr, cc)
    // takes copy cc of rows lr, lr + RPP, ...
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = BM / EPC;
    constexpr int RPP = THREADS / CPR;
    constexpr int PASSES = BK / RPP;
    const int cc = tid % CPR, lr = tid / CPR;
    const bool x_col_ok = d0 + cc * EPC < D;
    const bool dy_col_ok = cc * EPC < real;
    const T* xp = x + (mbeg + lr) * D + d0 + cc * EPC;
    const T* dyp = dy + (mbeg + lr) * N + ch0 + cc * EPC;
    long long m_row = mbeg + lr;  // row of this thread's first pass in the next stage

    auto load = [&](int it) {
      T* sa = ring + (it % STAGES) * 2 * BK * LDS;
      T* sb = sa + BK * LDS;
      const long long m0 = mbeg + (long long)it * BK;
      if (x_load == X_SLAB) {  // rows [m0, m0 + BK) of X are one slab of BK*D elements
        const long long e0 = m0 * D, e_end = mend * D;
        for (int q = tid; q < BK * D / EPC; q += THREADS) {
          const long long e = e0 + (long long)q * EPC;
          const long long left = e_end - e;
          const int bytes = left <= 0 ? 0 : left >= EPC ? 16 : (int)left * (int)sizeof(T);
          mma::cp_async16_n(sa + q * EPC, bytes ? x + e : x, bytes);
        }
      }
      if (x_load == X_ROWS || dy_fast) {
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const bool m_ok = m_row + RPP * i < mend;
          const int k = lr + RPP * i;
          if (x_load == X_ROWS) {
            const bool ok = m_ok && x_col_ok;
            mma::cp_async16(sa + k * LDS + cc * EPC, ok ? xp + (long long)RPP * i * D : x, ok);
          }
          if (dy_fast) {
            const bool ok = m_ok && dy_col_ok;
            mma::cp_async16(sb + k * LDS + cc * EPC, ok ? dyp + (long long)RPP * i * N : dy, ok);
          }
        }
        xp += (long long)BK * D;
        dyp += (long long)BK * N;
        m_row += BK;
      }
      if (x_load == X_GENERIC || !dy_fast) {
        for (int e = tid; e < BK * BM; e += THREADS) {
          const int k = e / BM, col = e % BM;
          const long long m = m0 + k;
          if (x_load == X_GENERIC)
            sa[k * LDS + col] =
                m < mend && d0 + col < D ? x[m * D + d0 + col] : T(0.f);
          if (!dy_fast) sb[k * LDS + col] = m < mend && col < real ? dy[m * N + ch0 + col] : T(0.f);
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
      const T* sa = ring + (it % STAGES) * 2 * BK * LDS;
      if (warp_works) mma::stage_mma_km<BK>(sa, lda, sa + BK * LDS, LDS, acc, wm, wn, gq, tq);
    }
    mma::cp_async_wait<0>();
  }

  // acc[mi][ni][2 hq + q] is output row wm + 16 mi + gq + 8 hq, column
  // wn + 8 ni + 2 tq + q of the tile
  float* part = dst + (long long)s * D * NC;
  const bool pairs = bs % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int d = d0 + wm + 16 * mi + gq + 8 * hq;
      if (d >= D) continue;
      float* row = part + (long long)d * NC + j * bs;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = o0 + wn + 8 * ni + 2 * tq;
        const float v0 = acc[mi][ni][2 * hq], v1 = acc[mi][ni][2 * hq + 1];
        if (pairs && o + 1 < bs) {
          *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
        } else {
          if (o < bs) row[o] = v0;
          if (o + 1 < bs) row[o + 1] = v1;
        }
      }
    }
}

// out[i] = the S partials of element i summed in a fixed two-level order:
// thread group r sums splits [r*per, (r+1)*per) in order, then the
// RED_GROUPS results are summed in order. Columns of phantom tiles are 0.
__global__ void __launch_bounds__(RED_LANES* RED_GROUPS)
dw_reduce(const float* __restrict__ partial, float* __restrict__ out,
          const int* __restrict__ bidx, int D, int N, int NC, int bs, int S) {
  __shared__ float sums[RED_GROUPS][RED_LANES];
  const int lane = threadIdx.x, r = threadIdx.y;
  const long long n = (long long)D * NC;
  const long long e = (long long)blockIdx.x * RED_LANES + lane;
  float v = 0.f;
  if (e < n) {
    const int col = (int)(e % NC);
    const int j = col / bs, o = col % bs;
    if (bidx[j] * bs + (o / BN) * BN < N) {
      const int per = (S + RED_GROUPS - 1) / RED_GROUPS;
      const int s_end = min(S, (r + 1) * per);
      for (int s = r * per; s < s_end; ++s) v += partial[s * n + e];
    }
  }
  sums[r][lane] = v;
  __syncthreads();
  if (r == 0 && e < n) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < RED_GROUPS; ++q) t += sums[q][lane];
    out[e] = t;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const void* bidx, void* partial, void* out, int M,
           int D, int N, int KB, int bs, int S, int chunk, cudaStream_t st) {
  const int NC = KB * bs;
  if (D == 0 || NC == 0) return 0;
  constexpr int EPC = 16 / sizeof(T);
  const bool x_al = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // a slab of BK rows starts on 16 bytes when every stage starts on a
  // multiple of EPC rows
  const int x_load = x_al && D % EPC == 0                     ? X_ROWS
                     : x_al && D < BM && chunk % EPC == 0 ? X_SLAB
                                                              : X_GENERIC;
  const int dy_fast =
      reinterpret_cast<uintptr_t>(dy) % 16 == 0 && N % EPC == 0 && bs % EPC == 0;
  const int smem = STAGES * 2 * BK * LDS * (int)sizeof(T);
  auto kernel = dw_gathered_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  float* dst = S == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const int ctpb = (bs + BN - 1) / BN;
  const dim3 grid((unsigned)(KB * ctpb), (unsigned)((D + BM - 1) / BM), (unsigned)S);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                      static_cast<const int*>(bidx), dst, M, D, N, KB, bs, S,
                                      chunk, x_load, dy_fast);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long n = (long long)D * NC;
  dw_reduce<<<(unsigned)((n + RED_LANES - 1) / RED_LANES), dim3(RED_LANES, RED_GROUPS), 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out),
      static_cast<const int*>(bidx), D, N, NC, bs, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, D] and dy [M, N] contiguous,
// both fp32 (bf16 = 0) or both bf16 (bf16 = 1); bidx [KB] int32; partial
// [S, D, KB*bs] fp32 scratch (unused when S == 1); out [D, KB*bs] fp32. Rows
// [s*chunk, (s+1)*chunk) form split s; chunk is a multiple of 32. Returns
// cudaGetLastError() of the last launch.
extern "C" int dw_gathered_launch(const void* x, const void* dy, const void* bidx,
                                  void* partial, void* out, int M, int D, int N, int KB,
                                  int bs, int S, int chunk, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, bidx, partial, out, M, D, N, KB, bs, S, chunk, st);
  return launch<float>(x, dy, bidx, partial, out, M, D, N, KB, bs, S, chunk, st);
}

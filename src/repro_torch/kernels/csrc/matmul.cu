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
// 11008 x 410) a product does 2*M*N*K flops on (M*K + K*N) bf16 inputs and
// M*N fp32 outputs: 25-400 flops a byte, so the large products are bound
// by the bf16 tensor cores (989 TFLOP/s) and the thin ones (K = 51, or
// N = 51) by the fp32 output's bytes. Two kernels sit behind the one C
// entry point, and the operand type alone picks one:
//
// bf16 operands (the main path): `matmul_wgmma_kernel`.
//   * one block per 128x128 output tile: two consumer warpgroups, 64 rows
//     each, run `wgmma.mma_async` m64n128k16 (bf16 x bf16 -> fp32 in
//     registers) out of shared memory; one producer warp keeps a ring of
//     4 stages of 64-deep A and B tiles (16 KB each, one 128-byte swizzle
//     atom of bf16 per row) filled by TMA (`cp.async.bulk.tensor`), each
//     stage completed on an mbarrier ("full") and handed back by the
//     consumers on another ("empty");
//   * operands are read in place through tensor maps built on the host for
//     each call. Either major works for each operand: K-major tiles (dY_k,
//     W_k as rows of kept channels) load as one 64 x 128 box, MN-major
//     tiles (X2^T, dY_k as the B of dW) as two 64 x 64 boxes, one per
//     128-byte atom of the M or N axis, and the descriptor's transpose bit
//     and LBO/SBO fields say which;
//   * ragged M, N and K (K = 51, 410, 2202; N = 51, 410) are TMA's
//     out-of-bounds zero fill; nothing is padded in device memory. TMA
//     needs 16-byte row pitches: the wrapper hands over views whose pitch
//     is a multiple of 8 elements (the backward gathers into such buffers)
//     and repacks, and counts, any other view;
//   * too few output tiles for 132 SMs (dW k/v: 16 tiles, dW q/o: 64)
//     split K deterministically (the plan is `gathered_matmul.py::
//     matmul_plan`): each split writes its fp32 tile to a scratch slice and
//     `tile::reduce_splits` sums the slices in a fixed order. No atomics:
//     a result repeats bit for bit. One 128x128 tile for every shape keeps
//     one code path; it wastes 60 % of the N = 51 tiles, whose products are
//     bound by bytes anyway.
// fp32 operands (the fp32 route check): `matmul_simt_kernel`, the
//   tile.cuh SIMT tile (64x64 outputs a block, 4x4 a thread, fp32 FMA),
//   strided operands read in place. TF32 would not hold the fp32 route's
//   1e-4 gate, and fp32 `wgmma` takes K-major operands only.

#include <cuda.h>  // CUtensorMap and its encoder's types (header only: no -lcuda)
#include <stdint.h>

#include "geometry.cuh"
#include "tile.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------

constexpr int TC_BM = 128;   // output tile rows (two warpgroups of 64)
constexpr int TC_BN = 128;   // output tile columns (the wgmma N)
constexpr int TC_BK = 64;    // reduction depth of a stage: 128 bytes of bf16
constexpr int TC_STAGES = 4;
constexpr int TC_CONSUMER_WARPS = 8;
constexpr int TC_THREADS = TC_CONSUMER_WARPS * 32 + 32;  // + the producer warp
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 2;         // one operand's stage, 16 KB
constexpr int TC_HALF = TC_TILE_BYTES / 2;               // 64 rows, or one 64-wide atom column
constexpr int TC_SMEM = 2 * TC_STAGES * TC_TILE_BYTES + 2 * TC_STAGES * 8 + 1024;
static_assert(TC_BM == TC_BN, "A and B stages share one size");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 2-D tensor map into shared memory, completing on `bar`.
// (c0, c1) are the box's coordinates, the unit-stride axis first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The shared-memory address of k-step `kk` (16 deep) of a 64-row stage
// tile, and its descriptor. K-major (T = 0): rows of 64 k (128 bytes),
// 8-row atoms 1024 bytes apart (SBO); a k-step is 32 bytes into the row
// (LBO unused). MN-major (T = 1): rows of 64 m or n, one per k, in 64-wide
// atom columns 8 KB apart (LBO); 8 k-rows 1024 bytes apart (SBO); a
// k-step is 16 rows, 2048 bytes.
template <int T>
__device__ __forceinline__ uint64_t stage_desc(const uint8_t* tile, int kk) {
  if (T == 0) return sw128_desc(tile + kk * 32, 16, 1024);
  return sw128_desc(tile + kk * 2048, TC_HALF, 1024);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], bf16 in, fp32 accumulators.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// TA / TB: 0 when the operand's K axis has unit stride (K-major), 1 when
// its M (A) or N (B) axis has. Split z sums K in [z*chunk, (z+1)*chunk)
// and writes out + z*M*N.
template <int TA, int TB>
__global__ void __launch_bounds__(TC_THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, float* __restrict__ out, int M,
                    int N, int K, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle wants the tiles 1024-byte aligned in shared memory.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                                     // [stage][128 x 64] bf16
  uint8_t* sb = smem + TC_STAGES * TC_TILE_BYTES;         // [stage][128 x 64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * TC_STAGES * TC_TILE_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(K, kbeg + chunk);
  const int nk = kend > kbeg ? (kend - kbeg + TC_BK - 1) / TC_BK : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrive + the bytes
      mbar_init(&empty[s], TC_CONSUMER_WARPS);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMER_WARPS) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % TC_STAGES;
        if (it >= TC_STAGES) mbar_wait(&empty[s], (it / TC_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TC_TILE_BYTES);
        const int k0 = kbeg + it * TC_BK;
        uint8_t* a = sa + s * TC_TILE_BYTES;
        uint8_t* b = sb + s * TC_TILE_BYTES;
        if (TA == 0) {
          tma_load(a, &map_a, &full[s], k0, m0);  // box {64 k, 128 m}
        } else {
          tma_load(a, &map_a, &full[s], m0, k0);  // box {64 m, 64 k}, per atom column
          tma_load(a + TC_HALF, &map_a, &full[s], m0 + 64, k0);
        }
        if (TB == 0) {
          tma_load(b, &map_b, &full[s], k0, n0);  // box {64 k, 128 n}
        } else {
          tma_load(b, &map_b, &full[s], n0, k0);  // box {64 n, 64 k}, per atom column
          tma_load(b + TC_HALF, &map_b, &full[s], n0 + 64, k0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64*wg .. + 63 of the tile
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % TC_STAGES;
    mbar_wait(&full[s], (it / TC_STAGES) & 1);
    const uint8_t* a = sa + s * TC_TILE_BYTES + wg * TC_HALF;
    const uint8_t* b = sb + s * TC_TILE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      wgmma_m64n128k16<TA, TB>(acc, stage_desc<TA>(a, kk), stage_desc<TB>(b, kk));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % TC_STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // epilogue: accumulator i of thread t sits at row 16*(warp in group) +
  // lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2
  float* dst = out + (size_t)blockIdx.z * M * N;
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = col0 + 8 * (i / 4);
    if (row >= M || col >= N) continue;
    float* p = dst + (size_t)row * N + col;
    if (pairs) {
      *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
    } else {
      p[0] = acc[i];
      if (col + 1 < N) p[1] = acc[i + 1];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 operand as a 2-D tensor map: `inner` elements along its
// unit-stride axis, `outer` rows `pitch` elements apart; boxes of
// 64 x box_outer, 128-byte swizzled, out-of-bounds elements read as 0.
bool make_map(CUtensorMap* map, const void* p, long long inner, long long outer,
              long long pitch, int box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_TENSOR_MAP = -1;  // the encoder is missing or refused the operand

// bf16: one block an output tile and split (a producer warp and two
// consumer warpgroups, a 4-deep TMA ring); with S > 1 tile.cuh's reduce.
geometry::Geometry plan_wgmma(int M, int N, int S) {
  geometry::Geometry geo;
  geo.first.grid = dim3((unsigned)((N + TC_BN - 1) / TC_BN), (unsigned)((M + TC_BM - 1) / TC_BM),
                        (unsigned)S);
  geo.first.block = dim3(TC_THREADS, 1, 1);
  geo.first.smem = TC_SMEM;
  geo.split = S;
  geo.stages = TC_STAGES;
  if (S > 1) {
    geo.second.grid = dim3((unsigned)tile::reduce_blocks((long long)M * N), 1, 1);
    geo.second.block = dim3(256, 1, 1);
  }
  return geo;
}

template <int TA, int TB>
int launch_wgmma(const void* a, const void* b, void* partial, void* out, int M, int N, int K,
                 long long sa_m, long long sa_k, long long sb_k, long long sb_n, int S,
                 int chunk, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  const bool ok_a = TA == 0 ? make_map(&map_a, a, K, M, sa_m, TC_BM)
                            : make_map(&map_a, a, M, K, sa_k, TC_BK);
  const bool ok_b = TB == 0 ? make_map(&map_b, b, K, N, sb_n, TC_BN)
                            : make_map(&map_b, b, N, K, sb_k, TC_BK);
  if (!ok_a || !ok_b) return ERR_TENSOR_MAP;
  auto kernel = matmul_wgmma_kernel<TA, TB>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  float* dst = static_cast<float*>(S == 1 ? out : partial);
  const geometry::Geometry geo = plan_wgmma(M, N, S);
  kernel<<<geo.first.grid, geo.first.block, geo.first.smem, st>>>(map_a, map_b, dst, M, N, K,
                                                                  chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long n = (long long)M * N;
  tile::reduce_splits<<<geo.second.grid, geo.second.block, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, S);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32: the SIMT tile
// ---------------------------------------------------------------------

using tile::BK;
using tile::BM;
using tile::BN;
using tile::LD;
using tile::THREADS;

// p[k][r] = X(r0 + r, k0 + k) for r < 64, k < BK, where X(r, k) sits at
// x[r * s_r + k * s_k]; zero outside R x K. With r_fast, neighbouring
// threads take neighbouring r (the operand's rows are its unit-stride
// axis), else neighbouring k.
__device__ __forceinline__ void load_panel(float (*p)[LD], const float* __restrict__ x,
                                           long long r0, int k0, long long R, int K,
                                           long long s_r, long long s_k, bool r_fast, int tid) {
  if (r_fast) {
    const int lr = tid % BM;
    const long long r = r0 + lr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tid / BM + 4 * i;
      const int k = k0 + kk;
      p[kk][lr] = (r < R && k < K) ? x[r * s_r + (long long)k * s_k] : 0.f;
    }
  } else {
    const int lk = tid % BK;
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = tid / BK + 16 * i;
      const long long r = r0 + rr;
      p[lk][rr] = (r < R && k < K) ? x[r * s_r + (long long)k * s_k] : 0.f;
    }
  }
}

// One block per 64x64 output tile, the whole reduction a loop inside the
// block in panels of 16: every output written once, a fixed order.
__global__ void __launch_bounds__(THREADS)
matmul_simt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int M, int N, int K, long long sa_m, long long sa_k,
                   long long sb_k, long long sb_n) {
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

// fp32: one block a 64x64 output tile, its whole reduction in 16-deep panels.
geometry::Geometry plan_simt(int M, int N) {
  geometry::Geometry geo;
  geo.first.grid = dim3((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM), 1);
  geo.first.block = dim3(THREADS, 1, 1);
  return geo;
}

}  // namespace

// Plain C entry point, loaded with ctypes. a [M, K] with element strides
// (sa_m, sa_k), b [K, N] with strides (sb_k, sb_n); out [M, N] fp32,
// contiguous. bf16 = 1: both operands bf16, through the wgmma kernel; each
// must have one unit stride and the other a multiple of 8 elements, and
// lie 16-byte aligned (A is K-major when sa_k == 1, else M-major; B is
// K-major when sb_k == 1, else N-major). S > 1 splits K in chunks of
// `chunk` (a multiple of 64) into partial [S, M, N] fp32 scratch, summed
// in a fixed order. bf16 = 0: both fp32, any strides, through the SIMT
// kernel (S, chunk and partial unused). Returns cudaGetLastError() of the
// last launch, or -1 if a tensor map could not be made.
extern "C" int matmul_launch(const void* a, const void* b, void* partial, void* out, int M,
                             int N, int K, long long sa_m, long long sa_k, long long sb_k,
                             long long sb_n, int S, int chunk, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    const geometry::Geometry geo = plan_simt(M, N);
    matmul_simt_kernel<<<geo.first.grid, geo.first.block, 0, st>>>(static_cast<const float*>(a),
                                                 static_cast<const float*>(b),
                                                 static_cast<float*>(out), M, N, K, sa_m, sa_k,
                                                 sb_k, sb_n);
    return (int)cudaGetLastError();
  }
  const int ta = sa_k == 1 ? 0 : 1;
  const int tb = sb_k == 1 ? 0 : 1;
  if (ta == 0 && tb == 0)
    return launch_wgmma<0, 0>(a, b, partial, out, M, N, K, sa_m, sa_k, sb_k, sb_n, S, chunk, st);
  if (ta == 0)
    return launch_wgmma<0, 1>(a, b, partial, out, M, N, K, sa_m, sa_k, sb_k, sb_n, S, chunk, st);
  if (tb == 0)
    return launch_wgmma<1, 0>(a, b, partial, out, M, N, K, sa_m, sa_k, sb_k, sb_n, S, chunk, st);
  return launch_wgmma<1, 1>(a, b, partial, out, M, N, K, sa_m, sa_k, sb_k, sb_n, S, chunk, st);
}

// The launch geometry of matmul_launch with these arguments (geometry.cuh
// says what out[16] holds).
extern "C" int matmul_geometry(int M, int N, int K, long long sa_m, long long sa_k,
                               long long sb_k, long long sb_n, int S, int chunk, int bf16,
                               int* out) {
  (void)K, (void)sa_m, (void)sa_k, (void)sb_k, (void)sb_n, (void)chunk;
  geometry::put(bf16 ? plan_wgmma(M, N, S) : plan_simt(M, N), out);
  return 0;
}

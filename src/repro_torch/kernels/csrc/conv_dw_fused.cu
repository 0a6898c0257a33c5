// conv_dw_fused for Hopper (sm_90a): the compact conv weight gradient with
// the im2col patch gather done in the addressing,
//   out[kh, kw, c, j*bs + o] = sum over (b, oh, ow) of
//       xg[b*H_pad + oh*sh + kh*dh, g(j), ow*sw + kw*dw, c]
//       * dy2r[b*H_out + oh, ow, block_idx[j]*bs + o],
// with g(j) = block_idx[j] / (blocks per group) (grouped convs in
// block-diagonal form). No [M, C_in*Kh*Kw] patch buffer exists anywhere.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::conv_dw_fused`
// (Pallas; grid (Kh, KB, B*H_out) whose index map computes the padded image
// row of each tap, with the output block revisited along the sequential
// B*H_out axis).
//
// What bounds it on this card: operations. ResNet-18's block_0 3x3 conv
// (x [128, 64, 32, 32], 64 output channels) is a skinny product, a
// 131072-long reduction onto a 576 x 64 output: 2 * 131072 * 576 * 64 =
// 9.7 GFLOP against about 67 MB of x and dY (0.02 ms at 3.35 TB/s). On the
// fp32 FMA units (67 TFLOP/s) that is 0.144 ms. The kernel runs it on the
// tensor cores instead, and keeps fp32 accuracy with 3xTF32: each fp32
// operand splits as x = big + small, big = tf32(x), small = tf32(x - big)
// (cvt.rna), and the product accumulates small*big + big*small + big*big
// in fp32 (the dropped small*small is below fp32's rounding). Plain TF32
// keeps about 3 decimal digits and would miss the 1e-4 gates over a
// 131072-long reduction. Three TF32 products at 495 TFLOP/s make the
// bound of fp32-accurate work 3 * 9.7 GFLOP / 495 TFLOP/s = 0.059 ms.
// bf16 operands take one bf16 product (fp32 accumulation); the copies,
// the split and the stage products are mma.cuh's. The design:
//   * the output is a [Kh*Kw*Cg, KB*bs] matrix cut in 64x64 tiles; a column
//     tile lies inside one kept block, so its group, and the image columns
//     its rows read, are the same for the whole tile; four warps take
//     32x32 outputs each with mma.sync m16n8k8 (tf32, or bf16);
//   * deterministic split-K over the B*H_out*W_out output positions (the
//     TPU's sequential axis): block (column tile, row tile, s) loops over
//     its chunk of positions in stages of 32, and writes a partial tile to a
//     scratch [S, Kh*Kw*Cg, KB*bs]; a second kernel sums the S partials in
//     a fixed order (no float atomics). The wrapper's plan
//     (`gathered_matmul.py::conv_dw_plan`) fills one wave of 4 blocks an SM
//     with the tiles that do work;
//   * stages come through a 3-deep cp.async ring of 16-byte copies. Where a
//     64-row tile lies inside one tap (Cg a multiple of 64, bs a multiple of
//     64: every 3x3 conv of ResNet-18), each position's A row is 64
//     contiguous channels of xg and its B row 64 contiguous kept channels
//     of dy2r; each thread carries the (oh, ow) of its positions and their
//     32-bit element offsets from stage to stage by constant increments,
//     with no division in the loop, and positions past the chunk are
//     zero-filled by the copy itself.
//     Other geometries (small Cg, rows spanning taps; small bs) load the
//     same ring element by element, in the same kernel;
//   * the block loads block_idx[j] and reads that contiguous run of dy2r's
//     channels (channels innermost, as _dy_rows lays them out); column tiles
//     past the real channel count (the ragged tail's phantoms) write zeros
//     without work.

#include <stdint.h>

#include "mma.cuh"
#include "tile.cuh"

namespace {

constexpr int BM = 64;        // output rows (tap, channel) a block
constexpr int BN = 64;        // output columns (kept channels) a block
constexpr int BK = 32;        // output positions a stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps, 32 x 32 outputs each
constexpr int LDS = BM + 8;   // stage row (elements): 16-byte rows, conflict-free fragments
static_assert(BM == BN, "the two operands' stages share one row length");

struct Geom {
  int B, H_pad, G, W_pad, Cg, H_out, W_out, C_pad, c_valid;
  int Kh, Kw, sh, sw, dh, dw, KB, bs, bpg;
};

using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
conv_dw_fused_kernel(const T* __restrict__ xg, const T* __restrict__ dy2r,
                     const int* __restrict__ bidx, float* __restrict__ partial, Geom g,
                     long long chunk, int fast) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [STAGES][2][BK][LDS]: a then b
  const int tid = threadIdx.x;
  const int ctpb = (g.bs + BN - 1) / BN;  // column tiles per kept block
  const int j = blockIdx.x / ctpb;
  const int o0 = (blockIdx.x % ctpb) * BN;
  const int p0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  const int P = g.Kh * g.Kw * g.Cg;
  const int NC = g.KB * g.bs;
  const long long R = (long long)g.B * g.H_out * g.W_out;
  const long long rbeg = s * chunk;
  const long long rend = rbeg + chunk < R ? rbeg + chunk : R;
  const int blk = bidx[j];
  const int grp = blk / g.bpg;
  float* part = partial + (long long)s * P * NC;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[2][4][4] = {};

  if (blk * g.bs + o0 < g.c_valid) {  // uniform: else every column is a phantom
    const int nk = rend > rbeg ? (int)((rend - rbeg + BK - 1) / BK) : 0;
    // Fast loader: CPR 16-byte copies cover a 64-wide row; thread (lr, cc)
    // takes copy cc of rows lr, lr + RPP, ...
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = BM / EPC;
    constexpr int RPP = THREADS / CPR;
    constexpr int PASSES = BK / RPP;
    const int cc = tid % CPR, lr = tid / CPR;
    const int tap = p0 / g.Cg;  // fast: the whole row tile lies in this tap
    const int kh_off = (tap / g.Kw) * g.dh, kw_off = (tap % g.Kw) * g.dw;
    const T* a_src = xg + grp * g.W_pad * g.Cg + kw_off * g.Cg + (p0 - tap * g.Cg) + cc * EPC;
    const T* b_src = dy2r + blk * g.bs + o0 + cc * EPC;
    // Element offsets into xg (fast: both tensors under 2^31 elements) of
    // the next output column, row and image, and of BK positions = qb
    // images + qh rows + qw columns, with the carries between them.
    const int pix = g.G * g.W_pad * g.Cg;  // one padded image row, all groups
    const int d_w = g.sw * g.Cg, d_h = g.sh * pix, d_b = g.H_pad * pix;
    const int qw = BK % g.W_out, qh = (BK / g.W_out) % g.H_out;
    const int step = qw * d_w + qh * d_h + (BK / (g.W_out * g.H_out)) * d_b;
    const int wrap_w = d_h - g.W_out * d_w, wrap_h = d_b - g.H_out * d_h;
    int rr[PASSES], oh[PASSES], ow[PASSES], a_off[PASSES];
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      rr[i] = (int)rbeg + lr + RPP * i;
      const int row = rr[i] / g.W_out;
      ow[i] = rr[i] - row * g.W_out;
      const int bb = row / g.H_out;
      oh[i] = row - bb * g.H_out;
      a_off[i] = bb * d_b + oh[i] * d_h + kh_off * pix + ow[i] * d_w;
    }
    // Generic loader: thread takes column lc of rows lk, lk + 2, ...
    const int lc = tid % BM, lk = tid / BM;
    const int p = p0 + lc;
    const bool p_ok = p < P;
    const int gtap = p_ok ? p / g.Cg : 0;
    const int gc = p_ok ? p % g.Cg : 0;
    const int gkh = (gtap / g.Kw) * g.dh, gkw = (gtap % g.Kw) * g.dw;
    const int o = o0 + lc;
    const int ch = blk * g.bs + o;
    const bool n_ok = o < g.bs && ch < g.c_valid;

    auto load = [&](int stage_it) {
      T* sa = ring + (stage_it % STAGES) * 2 * BK * LDS;
      T* sb = sa + BK * LDS;
      const long long r0 = rbeg + (long long)stage_it * BK;
      if (fast) {
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const bool ok = rr[i] < rend;
          cp_async16(sa + (lr + RPP * i) * LDS + cc * EPC, ok ? a_src + a_off[i] : xg, ok);
          cp_async16(sb + (lr + RPP * i) * LDS + cc * EPC, ok ? b_src + rr[i] * g.C_pad : dy2r,
                     ok);
          rr[i] += BK;
          a_off[i] += step;
          ow[i] += qw;
          if (ow[i] >= g.W_out) {
            ow[i] -= g.W_out;
            ++oh[i];
            a_off[i] += wrap_w;
          }
          oh[i] += qh;
          if (oh[i] >= g.H_out) {
            oh[i] -= g.H_out;
            a_off[i] += wrap_h;
          }
        }
      } else {
        for (int k = lk; k < BK; k += THREADS / BM) {
          const long long r = r0 + k;
          T av = T(0.f), bv = T(0.f);
          if (r < rend) {
            const long long row = r / g.W_out;
            const int w = (int)(r - row * g.W_out);
            const long long b_ = row / g.H_out;
            const int h = (int)(row - b_ * g.H_out);
            if (p_ok) {
              const long long ih = b_ * g.H_pad + h * g.sh + gkh;
              const long long iw = (long long)w * g.sw + gkw;
              av = xg[((ih * g.G + grp) * g.W_pad + iw) * g.Cg + gc];
            }
            if (n_ok) bv = dy2r[r * g.C_pad + ch];
          }
          sa[k * LDS + lc] = av;
          sb[k * LDS + lc] = bv;
        }
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st);
      cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage it landed for all; every thread is done with stage it-1
      if (it + STAGES - 1 < nk) load(it + STAGES - 1);
      cp_async_commit();
      const T* sa = ring + (it % STAGES) * 2 * BK * LDS;
      // stages hold a[k][m] and b[k][n], k the position
      mma::stage_mma_km<BK>(sa, LDS, sa + BK * LDS, LDS, acc, wm, wn, gq, tq);
    }
    cp_async_wait<0>();
  }

  // acc[mi][ni][2 hq + q] is output row wm + 16 mi + gq + 8 hq, column
  // wn + 8 ni + 2 tq + q of the tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int pp = p0 + wm + 16 * mi + gq + 8 * hq;
      if (pp >= P) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int oo = o0 + wn + 8 * ni + 2 * tq + q;
          if (oo < g.bs) part[(long long)pp * NC + j * g.bs + oo] = acc[mi][ni][2 * hq + q];
        }
    }
}

template <typename T>
int launch(const void* xg, const void* dy2r, const void* bidx, void* partial, void* out,
           const Geom& g, int S, long long chunk, cudaStream_t st) {
  const int P = g.Kh * g.Kw * g.Cg;
  const int ctpb = (g.bs + BN - 1) / BN;
  // every 64-row tile inside one tap, every column tile inside one block,
  // 16-byte aligned rows: the contiguous cp.async loads
  // and both tensors small enough for 32-bit element offsets
  const long long x_elems = (long long)g.B * g.H_pad * g.G * g.W_pad * g.Cg;
  const long long dy_elems = (long long)g.B * g.H_out * g.W_out * g.C_pad;
  const int fast = g.Cg % BM == 0 && g.bs % BN == 0 &&
                   reinterpret_cast<uintptr_t>(xg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy2r) % 16 == 0 && x_elems < (1ll << 31) &&
                   dy_elems < (1ll << 31);
  const int smem = STAGES * 2 * BK * LDS * (int)sizeof(T);
  auto kernel = conv_dw_fused_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  float* dst = S == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const dim3 grid((unsigned)(g.KB * ctpb), (unsigned)((P + BM - 1) / BM), (unsigned)S);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(xg), static_cast<const T*>(dy2r),
                                      static_cast<const int*>(bidx), dst, g, chunk, fast);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long n = (long long)P * g.KB * g.bs;
  tile::reduce_splits<<<tile::reduce_blocks(n), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. xg [B*H_pad, G, W_pad, Cg] and dy2r
// [B*H_out, W_out, C_pad] contiguous, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); channels of dy2r at or past c_valid are zeros and are skipped;
// bidx [KB] int32; partial [S, Kh*Kw*Cg, KB*bs] fp32 scratch (unused when
// S == 1); out [Kh, Kw, Cg, KB*bs] fp32. Output positions [s*chunk,
// (s+1)*chunk) form split s. Returns cudaGetLastError() of the last launch.
extern "C" int conv_dw_fused_launch(const void* xg, const void* dy2r, const void* bidx,
                                    void* partial, void* out, int B, int H_pad, int G,
                                    int W_pad, int Cg, int H_out, int W_out, int C_pad,
                                    int c_valid, int Kh, int Kw, int sh, int sw, int dh,
                                    int dw, int KB, int bs, int S, long long chunk, int bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{B,  H_pad, G,  W_pad, Cg, H_out, W_out, C_pad, c_valid,
               Kh, Kw,    sh, sw,    dh, dw,    KB,    bs,    (C_pad / bs) / G};
  if (bf16) return launch<__nv_bfloat16>(xg, dy2r, bidx, partial, out, g, S, chunk, st);
  return launch<float>(xg, dy2r, bidx, partial, out, g, S, chunk, st);
}

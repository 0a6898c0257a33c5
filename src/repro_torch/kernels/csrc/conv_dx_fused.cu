// conv_dx_fused for Hopper (sm_90a): the conv input gradient on the
// interior of the image (the padding ring is never computed), with the
// col2im scatter turned into a gather,
//   dx[b*H + ih, g, iw, c] = sum over taps (kh, kw) with
//       ih + ph0 = oh*sh + kh*dh, iw + pw0 = ow*sw + kw*dw
//       (0 <= oh < H_out, 0 <= ow < W_out),
//     over kept blocks j of group g and their channels o, of
//       dy2r[b*H_out + oh, ow, block_idx[j]*bs + o] * w2k[kh, kw, c, j*bs + o].
// w2k is the compact filter [Kh, Kw, Cg, KB*bs], gathered by the wrapper;
// (ph0, pw0) are the padding's leading offsets.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::conv_dx_fused`
// (Pallas; grid (B*H_pad, KB, Kh) that adds each tap's contribution into the
// revisited padded-image row, with strided scatters for stride > 1).
//
// What bounds it on this card: operations. ResNet-18's block_0 3x3 conv is
// 2 * 131072 * 576 * 64 = 9.7 GFLOP against about 67 MB of dY and dX (0.02
// ms at 3.35 TB/s): 0.144 ms at the fp32 FMA rate, 0.059 ms as three TF32
// products on the tensor cores. The design, an implicit GEMM:
//   * the output of one group is a [pixels, Cg] matrix. Its rows are the
//     interior pixels in phase-major order: the pixels of one (ih + ph0 mod
//     sh, iw + pw0 mod sw) phase are contiguous, (b, ih, iw) ascending, and
//     each phase's count is padded to a whole number of 64-row tiles. A
//     pixel receives tap (kh, kw) only where ih + ph0 - kh*dh and iw + pw0 -
//     kw*dw are multiples of the stride, so a tile lies inside one phase and
//     loops over that phase's taps only: a quarter of them at stride 2;
//   * a block takes a 64x64 tile (four warps of 32x32, mma.sync m16n8k8:
//     fp32 as 3xTF32, bf16 as one bf16 product; mma.cuh) and reduces over
//     (phase tap, kept block of its group, channel) in stages of 32
//     channels, stopping at the real channel count (the ragged tail's
//     phantom channels cost nothing);
//   * stages come through a 3-deep cp.async ring of 16-byte copies, both
//     operands K-contiguous: a dY stage is 64 pixel rows x 32 channels, a
//     contiguous run of each row of dy2r (a pixel that gets no cotangent
//     for the tap is the copy's zero fill), a W stage 64 columns c x 32
//     kept channels of w2k, contiguous in o (a copy that straddles the
//     ragged tail reads only its real channels and zero-fills the rest,
//     so no channel past c_valid is read). Geometries where 16-byte
//     copies do not apply (bs not a multiple of 16 bytes, unaligned
//     operands) load the same ring element by element, in the same kernel;
//   * every output element is written once, by one block (no float
//     atomics, no second pass). Stage 4 of ResNet-18 (2048 pixels x 512
//     channels) has only 256 tiles, two an SM, yet a two-way split of its
//     reduction measured no faster on the H100.

#include <stdint.h>

#include "geometry.cuh"
#include "mma.cuh"

namespace {

constexpr int BM = 64;        // output rows (interior pixels of one phase) a block
constexpr int BN = 64;        // output columns (channels of one group) a block
constexpr int BK = 32;        // reduction steps (kept channels of one tap) a stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps, 32 x 32 outputs each

// stage row pitch (elements): 16-byte rows whose fragment reads hit 32
// distinct banks (36 fp32 words; 40 bf16 = 20 words)
template <typename T>
__host__ __device__ constexpr int ldk() {
  return BK + 16 / (int)sizeof(T);
}

struct Geom {
  int B, H, W, ph0, pw0, G, Cg, H_out, W_out, C_pad, c_valid;
  int Kh, Kw, sh, sw, dh, dw, KB, bs, bpg;
};

// The interior rows (or columns) of residue r: the first index i0 with
// (i0 + lo) % s == r and their count n below `len`.
__host__ __device__ __forceinline__ void phase_axis(int r, int lo, int s, int len, int& i0,
                                                    int& n) {
  i0 = ((r - lo) % s + s) % s;
  n = i0 < len ? (len - i0 + s - 1) / s : 0;
}

// Taps k in [0, K) with k*d = r (mod s): how many, and the n-th of them.
__device__ __forceinline__ int count_taps(int K, int d, int s, int r) {
  int n = 0;
  for (int k = 0; k < K; ++k) n += (k * d) % s == r;
  return n;
}

__device__ __forceinline__ int nth_tap(int n, int K, int d, int s, int r) {
  for (int k = 0; k < K; ++k)
    if ((k * d) % s == r && n-- == 0) return k;
  return 0;
}

// Row tiles of all phases (the grid's x extent).
__host__ int row_tiles(const Geom& g) {
  int tiles = 0;
  for (int ph = 0; ph < g.sh; ++ph)
    for (int pw = 0; pw < g.sw; ++pw) {
      int ih0, nh, iw0, nw;
      phase_axis(ph, g.ph0, g.sh, g.H, ih0, nh);
      phase_axis(pw, g.pw0, g.sw, g.W, iw0, nw);
      tiles += (g.B * nh * nw + BM - 1) / BM;
    }
  return tiles;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
conv_dx_fused_kernel(const T* __restrict__ dy2r, const T* __restrict__ w2k,
                     const int* __restrict__ bidx, float* __restrict__ out, Geom g, int fast) {
  constexpr int LDK = ldk<T>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM + BN][LDK]: dY rows, then W rows
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * BN;
  const int grp = blockIdx.z;
  const int NC = g.KB * g.bs;

  // this row tile's phase: tiles are numbered phase by phase
  int tile = blockIdx.x, ph = 0, pw = 0, ih0 = 0, nh = 0, iw0 = 0, nw = 0;
  for (;;) {
    phase_axis(ph, g.ph0, g.sh, g.H, ih0, nh);
    phase_axis(pw, g.pw0, g.sw, g.W, iw0, nw);
    const int tiles = (g.B * nh * nw + BM - 1) / BM;
    if (tile < tiles) break;
    tile -= tiles;
    if (++pw == g.sw) {
      pw = 0;
      if (++ph == g.sh) return;  // past the last tile (uniform)
    }
  }
  const int npix = g.B * nh * nw;
  const int u0 = tile * BM;
  // pixel u of the phase -> image b and padded-image row/column
  auto pixel = [&](int u, int& b, int& ihp, int& iwp) {
    const int r = u / nw;
    iwp = iw0 + (u - r * nw) * g.sw + g.pw0;
    b = r / nh;
    ihp = ih0 + (r - b * nh) * g.sh + g.ph0;
  };

  // the reduction: (phase tap, kept block of this group, 32-channel chunk)
  const int nkw = count_taps(g.Kw, g.dw, g.sw, pw);
  const int ntap = count_taps(g.Kh, g.dh, g.sh, ph) * nkw;
  int cpt = 0;  // chunks a tap
  for (int j = 0; j < g.KB; ++j) {
    const int blk = bidx[j];
    const int kv = min(g.bs, g.c_valid - blk * g.bs);
    if (blk / g.bpg == grp && kv > 0) cpt += (kv + BK - 1) / BK;
  }
  const int nk = ntap * cpt;

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
    int pb[PASSES], pih[PASSES], piw[PASSES];  // pb -1: no pixel
    long long a_off[PASSES];                    // dy2r row offset for the tap, -1: none
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int u = u0 + lr + RPP * i;
      pb[i] = -1;
      pih[i] = piw[i] = 0;
      if (u < npix) pixel(u, pb[i], pih[i], piw[i]);
    }
    int cur_tap = -1, kh = 0, kw = 0;

    auto load = [&](int ita, int slot) {
      T* sa = ring + slot * (BM + BN) * LDK;
      T* sb = sa + BM * LDK;
      const int tp = ita / cpt;
      int r = ita - tp * cpt, j = 0, blk = 0, kv = 0, o0 = 0;
      for (; j < g.KB; ++j) {
        blk = bidx[j];
        kv = min(g.bs, g.c_valid - blk * g.bs);
        if (blk / g.bpg != grp || kv <= 0) continue;
        const int nc = (kv + BK - 1) / BK;
        if (r < nc) {
          o0 = r * BK;
          break;
        }
        r -= nc;
      }
      if (tp != cur_tap) {  // a new tap: each pixel's cotangent row
        cur_tap = tp;
        kh = nth_tap(tp / nkw, g.Kh, g.dh, g.sh, ph);
        kw = nth_tap(tp % nkw, g.Kw, g.dw, g.sw, pw);
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const int oh = (pih[i] - kh * g.dh) / g.sh;  // exact: the phase's tap
          const int ow = (piw[i] - kw * g.dw) / g.sw;
          const bool ok = pb[i] >= 0 && pih[i] >= kh * g.dh && piw[i] >= kw * g.dw &&
                          oh < g.H_out && ow < g.W_out;
          a_off[i] = ok ? ((long long)(pb[i] * g.H_out + oh) * g.W_out + ow) * g.C_pad : -1;
        }
      }
      const long long w_tap = (long long)(kh * g.Kw + kw) * g.Cg;
      if (fast) {
        const int oc = o0 + cc * EPC;
        // bytes of real channels in this copy: a copy that straddles the
        // ragged tail (c_valid) zero-fills the phantom channels past it
        const int kb = oc < kv ? min(EPC, kv - oc) * (int)sizeof(T) : 0;
        const T* a_src = dy2r + blk * g.bs + oc;
        const T* b_src = w2k + j * g.bs + oc;
#pragma unroll
        for (int i = 0; i < PASSES; ++i) {
          const int row = lr + RPP * i;
          const bool aok = kb > 0 && a_off[i] >= 0;
          mma::cp_async16_n(sa + row * LDK + cc * EPC, aok ? a_src + a_off[i] : dy2r,
                            aok ? kb : 0);
          const int c = c0 + row;
          const bool bok = kb > 0 && c < g.Cg;
          mma::cp_async16_n(sb + row * LDK + cc * EPC, bok ? b_src + (w_tap + c) * NC : w2k,
                            bok ? kb : 0);
        }
      } else {
        for (int e = tid; e < BM * BK; e += THREADS) {
          const int row = e / BK, k = e % BK;
          const int o = o0 + k;
          T av = T(0.f), bv = T(0.f);
          const int u = u0 + row;
          if (o < kv && u < npix) {
            int b, ihp, iwp;
            pixel(u, b, ihp, iwp);
            const int oh = (ihp - kh * g.dh) / g.sh, ow = (iwp - kw * g.dw) / g.sw;
            if (ihp >= kh * g.dh && iwp >= kw * g.dw && oh < g.H_out && ow < g.W_out)
              av = dy2r[((long long)(b * g.H_out + oh) * g.W_out + ow) * g.C_pad + blk * g.bs +
                        o];
          }
          const int c = c0 + row;
          if (o < kv && c < g.Cg) bv = w2k[(w_tap + c) * NC + j * g.bs + o];
          sa[row * LDK + k] = av;
          sb[row * LDK + k] = bv;
        }
      }
    };

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st, st);
      mma::cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      mma::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage it landed for all; every thread is done with stage it-1
      if (it + STAGES - 1 < nk) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
      mma::cp_async_commit();
      const T* sa = ring + (it % STAGES) * (BM + BN) * LDK;
      mma::stage_mma_mk<BK>(sa, sa + BM * LDK, LDK, acc, wm, wn, gq, tq);
    }
    mma::cp_async_wait<0>();
  }

  // acc[mi][ni][2 hq + q]: pixel row wm + 16 mi + gq + 8 hq, channel
  // column wn + 8 ni + 2 tq + q of the tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int u = u0 + wm + 16 * mi + gq + 8 * hq;
      if (u >= npix) continue;
      int b, ihp, iwp;
      pixel(u, b, ihp, iwp);
      float* row = out + ((((long long)b * g.H + ihp - g.ph0) * g.G + grp) * g.W + iwp - g.pw0) *
                             g.Cg;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = c0 + wn + 8 * ni + 2 * tq;
        const float v0 = acc[mi][ni][2 * hq], v1 = acc[mi][ni][2 * hq + 1];
        if (c + 1 < g.Cg && g.Cg % 2 == 0) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          if (c < g.Cg) row[c] = v0;
          if (c + 1 < g.Cg) row[c + 1] = v1;
        }
      }
    }
}

// Grid (row tiles of every phase, column tiles of Cg, groups), a 3-deep
// ring; nothing where a phase has no interior pixel or Cg or G is 0.
template <typename T>
geometry::Geometry plan(const Geom& g) {
  geometry::Geometry geo;
  const int tiles = row_tiles(g);
  if (tiles == 0 || g.Cg == 0 || g.G == 0) return geo;
  geo.first.grid = dim3((unsigned)tiles, (unsigned)((g.Cg + BN - 1) / BN), (unsigned)g.G);
  geo.first.block = dim3(THREADS, 1, 1);
  geo.first.smem = STAGES * (BM + BN) * ldk<T>() * (int)sizeof(T);
  geo.stages = STAGES;
  return geo;
}

template <typename T>
int launch(const void* dy2r, const void* w2k, const void* bidx, void* out, const Geom& g,
           cudaStream_t st) {
  // 16-byte copies: a kept block's channel runs start on 16 bytes
  const int fast = (g.bs * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy2r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w2k) % 16 == 0;
  const geometry::Geometry geo = plan<T>(g);
  const int smem = STAGES * (BM + BN) * ldk<T>() * (int)sizeof(T);
  auto kernel = conv_dx_fused_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (geo.first.grid.x == 0) return 0;
  kernel<<<geo.first.grid, geo.first.block, geo.first.smem, st>>>(
      static_cast<const T*>(dy2r), static_cast<const T*>(w2k), static_cast<const int*>(bidx),
      static_cast<float*>(out), g, fast);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dy2r [B*H_out, W_out, C_pad] and
// w2k [Kh, Kw, Cg, KB*bs] contiguous, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); channels at or past c_valid are never read; bidx
// [KB] int32, sorted; (ph0, pw0) the padding's leading offsets; out [B*H,
// G, W, Cg] fp32, the interior image, every element written once. Returns
// cudaGetLastError() of the launch.
extern "C" int conv_dx_fused_launch(const void* dy2r, const void* w2k, const void* bidx,
                                    void* out, int B, int H, int W, int ph0, int pw0, int G,
                                    int Cg, int H_out, int W_out, int C_pad, int c_valid, int Kh,
                                    int Kw, int sh, int sw, int dh, int dw, int KB, int bs,
                                    int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{B,  H,  W,  ph0, pw0, G,  Cg,     H_out,           W_out, C_pad, c_valid,
               Kh, Kw, sh, sw,  dh,  dw, KB, bs, (C_pad / bs) / G};
  if (bf16) return launch<__nv_bfloat16>(dy2r, w2k, bidx, out, g, st);
  return launch<float>(dy2r, w2k, bidx, out, g, st);
}

// The launch geometry of conv_dx_fused_launch with these arguments
// (geometry.cuh says what out[16] holds).
extern "C" int conv_dx_fused_geometry(int B, int H, int W, int ph0, int pw0, int G, int Cg,
                                      int H_out, int W_out, int C_pad, int c_valid, int Kh,
                                      int Kw, int sh, int sw, int dh, int dw, int KB, int bs,
                                      int bf16, int* out) {
  const Geom g{B,  H,  W,  ph0, pw0, G,  Cg,     H_out,           W_out, C_pad, c_valid,
               Kh, Kw, sh, sw,  dh,  dw, KB, bs, (C_pad / bs) / G};
  geometry::put(bf16 ? plan<__nv_bfloat16>(g) : plan<float>(g), out);
  return 0;
}

// conv_dx_fused for Hopper (sm_90a): the conv input gradient on the
// zero-padded image, with the col2im scatter turned into a gather,
//   dxp[b*H_pad + ih, g, iw, c] = sum over taps (kh, kw) with
//       ih = oh*sh + kh*dh, iw = ow*sw + kw*dw (0 <= oh < H_out, 0 <= ow < W_out),
//       over kept blocks j of group g and their channels o, of
//       dy2r[b*H_out + oh, ow, block_idx[j]*bs + o] * w2k[kh, kw, c, j*bs + o].
// w2k is the compact filter [Kh, Kw, Cg, KB*bs], gathered by the wrapper; the
// wrapper slices the padding border off.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::conv_dx_fused`
// (Pallas; grid (B*H_pad, KB, Kh) that adds each tap's contribution into the
// revisited padded-image row, with strided scatters for stride > 1).
//
// What bounds it on this card: operations, as conv_dw_fused: ResNet-18's
// block_0 3x3 conv is 2 * 131072 * 576 * 64 = 9.7 GFLOP (0.14 ms at the fp32
// 67 TFLOP/s) against about 67 MB of dY and dX (0.02 ms at 3.35 TB/s).
// The design:
//   * the output of one group is a [B*H_pad*W_pad pixels, Cg] matrix cut in
//     64x64 tiles, one block each; the block loops over the taps, then the
//     kept blocks of its group, then their channels in panels of 16, and
//     writes each output element once: no atomics, no second pass, no
//     scattered +=;
//   * for a tap, each pixel finds its cotangent row by inverting the tap
//     arithmetic (a whole, in-range oh and ow, else it adds nothing); a tap
//     that no pixel of the tile receives is skipped by the whole block.
//     Pixels are taken in phase-major order (decode_pixel), so that at
//     stride 2 a tile's pixels share their taps and the block skips the
//     three quarters of taps that give them nothing;
//   * the block loads block_idx[j] and reads that contiguous run of dy2r's
//     channels; channels past the real count (the ragged tail's phantoms)
//     are skipped;
//   * fp32 FMA on 4x4 outputs a thread; no tensor cores yet.

#include "tile.cuh"

namespace {

using tile::BK;
using tile::BM;
using tile::BN;
using tile::LD;
using tile::THREADS;

struct Geom {
  int B, H_pad, G, W_pad, Cg, H_out, W_out, C_pad, c_valid;
  int Kh, Kw, sh, sw, dh, dw, KB, bs, bpg;
};

// Pixel u of the padded image in phase-major order: the pixels with one
// (ih mod sh, iw mod sw) phase are contiguous, (b, ih, iw) ascending within
// it. A pixel receives tap (kh, kw) only where ih - kh*dh and iw - kw*dw
// are multiples of the stride, so the pixels of one phase receive the same
// taps, and a tile of them skips the others whole. At stride 1 this is
// the plain row-major order. False past the last pixel.
__device__ __forceinline__ bool decode_pixel(long long u, const Geom& g, long long& b,
                                             int& ih, int& iw) {
  for (int ph = 0; ph < g.sh; ++ph) {
    const int nh = (g.H_pad - ph + g.sh - 1) / g.sh;
    for (int pw = 0; pw < g.sw; ++pw) {
      const int nw = (g.W_pad - pw + g.sw - 1) / g.sw;
      const long long n = (long long)g.B * nh * nw;
      if (u < n) {
        const long long row = u / nw;  // b*nh + i
        const int jw = (int)(u - row * nw);
        b = row / nh;
        ih = (int)(row - b * nh) * g.sh + ph;
        iw = jw * g.sw + pw;
        return true;
      }
      u -= n;
    }
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_dx_fused_kernel(const T* __restrict__ dy2r, const T* __restrict__ w2k,
                     const int* __restrict__ bidx, float* __restrict__ out, Geom g) {
  __shared__ __align__(16) float a[BK][LD];  // dY panel,     a[k][row pixel]
  __shared__ __align__(16) float b[BK][LD];  // filter panel, b[k][col c]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long u0 = (long long)blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int grp = blockIdx.z;
  const int NC = g.KB * g.bs;

  // loader slots: channel step k = tid % BK, rows/columns tid / BK + 16 i
  const int lk = tid % BK;
  const int lr = tid / BK;
  long long pb[4];  // image index b of the 4 pixels this thread loads, -1 if none
  int pih[4], piw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pih[i] = piw[i] = 0;
    if (!decode_pixel(u0 + lr + 16 * i, g, pb[i], pih[i], piw[i])) pb[i] = -1;
  }

  float acc[4][4] = {};
  for (int kh = 0; kh < g.Kh; ++kh) {
    for (int kw = 0; kw < g.Kw; ++kw) {
      const int tap = kh * g.Kw + kw;
      long long dyrow[4];  // cotangent row of each pixel for this tap, -1 if none
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dyrow[i] = -1;
        const int ohn = pih[i] - kh * g.dh;
        const int own = piw[i] - kw * g.dw;
        if (pb[i] >= 0 && ohn >= 0 && own >= 0 && ohn % g.sh == 0 && own % g.sw == 0) {
          const int oh = ohn / g.sh, ow = own / g.sw;
          if (oh < g.H_out && ow < g.W_out) {
            dyrow[i] = (pb[i] * g.H_out + oh) * g.W_out + ow;
            any = true;
          }
        }
      }
      if (!__syncthreads_or(any)) continue;  // uniform: no pixel of the tile gets this tap
      for (int j = 0; j < g.KB; ++j) {
        const int blk = bidx[j];
        if (blk / g.bpg != grp) continue;
        const int base = blk * g.bs;
        for (int o0 = 0; o0 < g.bs && base + o0 < g.c_valid; o0 += BK) {
          const int o = o0 + lk;
          const bool ok = o < g.bs && base + o < g.c_valid;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = lr + 16 * i;
            const int c = c0 + r;
            a[lk][r] = (ok && dyrow[i] >= 0)
                           ? tile::to_f32(dy2r[dyrow[i] * g.C_pad + base + o])
                           : 0.f;
            b[lk][r] = (ok && c < g.Cg)
                           ? tile::to_f32(w2k[((long long)tap * g.Cg + c) * NC + j * g.bs + o])
                           : 0.f;
          }
          __syncthreads();
          tile::fma_panels(a, b, acc, tx, ty);
          __syncthreads();
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long bi;
    int ih, iw;
    if (!decode_pixel(u0 + ty * 4 + i, g, bi, ih, iw)) continue;
    float* dst = out + (((bi * g.H_pad + ih) * g.G + grp) * g.W_pad + iw) * g.Cg;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tx * 4 + jj;
      if (c < g.Cg) dst[c] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* dy2r, const void* w2k, const void* bidx, void* out, const Geom& g,
           cudaStream_t st) {
  const long long npix = (long long)g.B * g.H_pad * g.W_pad;
  const dim3 grid((unsigned)((npix + BM - 1) / BM), (unsigned)((g.Cg + BN - 1) / BN),
                  (unsigned)g.G);
  conv_dx_fused_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(dy2r), static_cast<const T*>(w2k), static_cast<const int*>(bidx),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dy2r [B*H_out, W_out, C_pad] and
// w2k [Kh, Kw, Cg, KB*bs] contiguous, both fp32 (bf16 = 0) or both bf16
// (bf16 = 1); channels at or past c_valid are zeros and are skipped; bidx
// [KB] int32, sorted; out [B*H_pad, G, W_pad, Cg] fp32, every element
// written. Returns the launch's cudaGetLastError().
extern "C" int conv_dx_fused_launch(const void* dy2r, const void* w2k, const void* bidx,
                                    void* out, int B, int H_pad, int G, int W_pad, int Cg,
                                    int H_out, int W_out, int C_pad, int c_valid, int Kh,
                                    int Kw, int sh, int sw, int dh, int dw, int KB, int bs,
                                    int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{B,  H_pad, G,  W_pad, Cg, H_out, W_out, C_pad, c_valid,
               Kh, Kw,    sh, sw,    dh, dw,    KB,    bs,    (C_pad / bs) / G};
  if (bf16) return launch<__nv_bfloat16>(dy2r, w2k, bidx, out, g, st);
  return launch<float>(dy2r, w2k, bidx, out, g, st);
}

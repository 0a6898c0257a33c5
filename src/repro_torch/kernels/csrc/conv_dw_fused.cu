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
// (x [128, 64, 32, 32], 64 output channels) is 2 * 131072 * 576 * 64 =
// 9.7 GFLOP, 0.14 ms at the fp32 67 TFLOP/s, against about 67 MB of x and dY
// (0.02 ms at 3.35 TB/s): the patches reuse every image value Kh*Kw times.
// The design:
//   * the output is a [Kh*Kw*Cg, KB*bs] matrix cut in 64x64 tiles; a column
//     tile lies inside one kept block, so its group, and the image columns
//     its rows read, are the same for the whole tile;
//   * deterministic split-K over the B*H_out*W_out output positions (the
//     TPU's sequential axis): block (column tile, row tile, s) loops over
//     its chunk of positions in panels of 16, finds each position's image
//     value for its row's tap by the oh*sh + kh*dh and ow*sw + kw*dw
//     arithmetic (each position's (b, oh, ow) carried from panel to panel,
//     never divided out in the loop), and writes a partial tile to a
//     scratch [S, Kh*Kw*Cg, KB*bs]; a second kernel sums the S partials in
//     a fixed order (no float atomics);
//   * the block loads block_idx[j] and reads that contiguous run of dy2r's
//     channels (channels innermost, as _dy_rows lays them out); column tiles
//     past the real channel count (the ragged tail's phantoms) write zeros
//     without work;
//   * fp32 FMA on 4x4 outputs a thread; no tensor cores yet, so the kernel
//     takes several times the fp32 bound's 0.14 ms.

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_dw_fused_kernel(const T* __restrict__ xg, const T* __restrict__ dy2r,
                     const int* __restrict__ bidx, float* __restrict__ partial, Geom g,
                     long long chunk) {
  __shared__ __align__(16) float a[BK][LD];  // patch panel, a[k][row p]
  __shared__ __align__(16) float b[BK][LD];  // dY panel,    b[k][col n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
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

  // loader slots: row/column tid % 64, panel steps tid / 64 + 4 i
  const int lc = tid % BM;
  const int lk = tid / BM;
  const int p = p0 + lc;
  const bool p_ok = p < P;
  const int tap = p_ok ? p / g.Cg : 0;
  const int c = p_ok ? p % g.Cg : 0;
  const int kh_off = (tap / g.Kw) * g.dh;
  const int kw_off = (tap % g.Kw) * g.dw;
  const int o = o0 + lc;
  const int ch = blk * g.bs + o;
  const bool n_ok = o < g.bs && ch < g.c_valid;

  // The output position r = (bb*H_out + oh)*W_out + ow of each of this
  // thread's 4 panel steps, decoded once here and then carried forward by
  // a panel (16 positions) at a time: no division in the loop.
  long long rr[4], bb[4];
  int oh[4], ow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = rbeg + lk + 4 * i;
    const long long row = rr[i] / g.W_out;
    ow[i] = (int)(rr[i] - row * g.W_out);
    bb[i] = row / g.H_out;
    oh[i] = (int)(row - bb[i] * g.H_out);
  }

  float acc[4][4] = {};
  if (blk * g.bs + o0 < g.c_valid) {  // uniform: else every column is a phantom
    for (long long r0 = rbeg; r0 < rend; r0 += BK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float av = 0.f, bv = 0.f;
        if (rr[i] < rend) {
          if (p_ok) {
            const long long ih = bb[i] * g.H_pad + oh[i] * g.sh + kh_off;
            const long long iw = ow[i] * g.sw + kw_off;
            av = tile::to_f32(xg[((ih * g.G + grp) * g.W_pad + iw) * g.Cg + c]);
          }
          if (n_ok) bv = tile::to_f32(dy2r[rr[i] * g.C_pad + ch]);
        }
        a[lk + 4 * i][lc] = av;
        b[lk + 4 * i][lc] = bv;
        rr[i] += BK;
        ow[i] += BK;
        while (ow[i] >= g.W_out) {
          ow[i] -= g.W_out;
          if (++oh[i] == g.H_out) {
            oh[i] = 0;
            ++bb[i];
          }
        }
      }
      __syncthreads();
      tile::fma_panels(a, b, acc, tx, ty);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = p0 + ty * 4 + i;
    if (pp >= P) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int oo = o0 + tx * 4 + jj;
      if (oo < g.bs) part[(long long)pp * NC + j * g.bs + oo] = acc[i][jj];
    }
  }
}

template <typename T>
int launch(const void* xg, const void* dy2r, const void* bidx, void* partial, void* out,
           const Geom& g, int S, long long chunk, cudaStream_t st) {
  const int P = g.Kh * g.Kw * g.Cg;
  const int ctpb = (g.bs + BN - 1) / BN;
  float* dst = S == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const dim3 grid((unsigned)(g.KB * ctpb), (unsigned)((P + BM - 1) / BM), (unsigned)S);
  conv_dw_fused_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(xg), static_cast<const T*>(dy2r), static_cast<const int*>(bidx),
      dst, g, chunk);
  cudaError_t e = cudaGetLastError();
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

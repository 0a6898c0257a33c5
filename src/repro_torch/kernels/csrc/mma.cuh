// Shared pieces of the tensor-core kernels (conv_dw_fused.cu,
// conv_dx_fused.cu, dw_gathered.cu): 16-byte cp.async copies into a
// shared-memory ring, the cvt.rna TF32 rounding of the 3xTF32 scheme, the
// mma.sync m16n8k8 wrappers (tf32 and bf16), and the products of one
// staged slice of the reduction into a warp's 32x32 accumulators, for the
// two stage layouts the kernels use:
//   * stage_mma_km: a[k][m] and b[k][n], the reduction index outermost
//     (the weight gradients: a stage is BK rows of the long axis);
//   * stage_mma_mk: a[m][k] and b[n][k], the reduction index innermost
//     (conv_dx_fused: a stage is BK channels of each pixel and filter).
// fp32 operands run as 3xTF32: x = big + small with big = tf32(x) and
// small = tf32(x - big) (cvt.rna), accumulating small*big + big*small +
// big*big in fp32; the dropped small*small is below fp32's rounding.
// bf16 operands take one bf16 product. Fragments of m16n8k8 with g =
// lane/4, t = lane%4: tf32 A (m, k) at (g, t), (g+8, t), (g, t+4),
// (g+8, t+4), B (k, n) at (t, g), (t+4, g); bf16 A (m, k) pairs at (g,
// 2t..2t+1), (g+8, 2t..2t+1), B (k, n) pair at (2t..2t+1, g), the lower k
// in the lower half. The warp's 32x32 outputs are acc[mi][ni][2 hq + q]
// at row wm + 16 mi + g + 8 hq, column wn + 8 ni + 2 t + q.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the first `bytes` (0..16)
// come from src, the rest are zeros (src is not read when bytes == 0).
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  cp_async16_n(dst, src, ok ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The three TF32 products of one k8 step, from split fragments.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[2][4][4], const uint32_t (&a_big)[2][4],
                                           const uint32_t (&a_small)[2][4],
                                           const uint32_t (&b_big)[4][2],
                                           const uint32_t (&b_small)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      mma_tf32(acc[mi][ni], a_small[mi], b_big[ni]);
      mma_tf32(acc[mi][ni], a_big[mi], b_small[ni]);
      mma_tf32(acc[mi][ni], a_big[mi], b_big[ni]);
    }
}

// One stage a[k][m] (row pitch lda), b[k][n] (pitch ldb) of BK reduction
// steps into the warp's accumulators at rows wm, columns wn of the tile.
template <int BK>
__device__ __forceinline__ void stage_mma_km(const float* a, int lda, const float* b, int ldb,
                                             float (&acc)[2][4][4], int wm, int wn, int g,
                                             int t) {
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = a + (k8 + t) * lda + wm + 16 * mi + g;
      const float v[4] = {p[0], p[8], p[4 * lda], p[4 * lda + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], a_big[mi][q], a_small[mi][q]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = b + (k8 + t) * ldb + wn + 8 * ni + g;
      const float v[2] = {p[0], p[4 * ldb]};
#pragma unroll
      for (int q = 0; q < 2; ++q) split(v[q], b_big[ni][q], b_small[ni][q]);
    }
    mma_3xtf32(acc, a_big, a_small, b_big, b_small);
  }
}

template <int BK>
__device__ __forceinline__ void stage_mma_km(const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int ldb,
                                             float (&acc)[2][4][4], int wm, int wn, int g,
                                             int t) {
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t af[2][2], bf[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = a + (k8 + 2 * t) * lda + wm + 16 * mi + g;
      af[mi][0] = pack_bf16(p[0], p[lda]);
      af[mi][1] = pack_bf16(p[8], p[lda + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = b + (k8 + 2 * t) * ldb + wn + 8 * ni + g;
      bf[ni] = pack_bf16(p[0], p[ldb]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

// One stage a[m][k], b[n][k] (row pitch ld for both) of BK reduction steps.
template <int BK>
__device__ __forceinline__ void stage_mma_mk(const float* a, const float* b, int ld,
                                             float (&acc)[2][4][4], int wm, int wn, int g,
                                             int t) {
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = a + (wm + 16 * mi + g) * ld + k8 + t;
      const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], a_big[mi][q], a_small[mi][q]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = b + (wn + 8 * ni + g) * ld + k8 + t;
      const float v[2] = {p[0], p[4]};
#pragma unroll
      for (int q = 0; q < 2; ++q) split(v[q], b_big[ni][q], b_small[ni][q]);
    }
    mma_3xtf32(acc, a_big, a_small, b_big, b_small);
  }
}

template <int BK>
__device__ __forceinline__ void stage_mma_mk(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                             int ld, float (&acc)[2][4][4], int wm, int wn,
                                             int g, int t) {
#pragma unroll
  for (int k8 = 0; k8 < BK; k8 += 8) {
    uint32_t af[2][2], bf[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = a + (wm + 16 * mi + g) * ld + k8 + 2 * t;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      bf[ni] = *reinterpret_cast<const uint32_t*>(b + (wn + 8 * ni + g) * ld + k8 + 2 * t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

}  // namespace mma

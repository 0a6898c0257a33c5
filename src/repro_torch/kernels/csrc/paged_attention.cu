// Paged attention for Hopper (sm_90a): causal per-slot attention read
// straight off the K/V page pool through the block table.
//
// Replaces the TPU kernel `repro/kernels/paged_attention.py::paged_attention`
// (Pallas, grid (B, NB) with the block table in SMEM scalar prefetch).
//
// What bounds it on this card: the bytes of the K/V pages it reads. Each
// query row does 4*D flops per visible key (QK and PV) while each key costs
// 2*D*itemsize bytes, so at decode width (S*G rows per KV head, G = H/KV) the
// kernel sits far below the H100's ops-per-byte ridge. The design answers
// that by reading every needed page once per (slot, KV head, row tile), and
// by keeping many of those bytes in flight:
//   * one thread block per (slot b, KV head, tile of ROWS query rows); the GQA
//     group of query heads that share a KV head are rows of the same tile, so
//     a page is staged once in shared memory and reused by all of them;
//   * the block walks its slot's logical keys in chunks of CK keys (several
//     pages; CK*D = 8192 values) in a loop that takes the place of the TPU's
//     sequential grid axis, loading its own block-table entries (clipped to
//     [0, n_pages-1]) and keeping the running max, denominator and
//     accumulator of its rows in registers;
//   * the next chunk's K/V loads are issued into registers before the
//     current chunk is computed, so a chunk's load latency hides behind the
//     previous chunk's arithmetic (at decode the grid has only B*KV blocks,
//     so each block has to keep its own memory pipe busy);
//   * keys past the block's largest qpos are never read: a fully masked key
//     leaves m, l and acc unchanged, so stopping early is exact;
//   * K/V are converted to fp32 on the way into shared memory; all
//     arithmetic is fp32.
// Not done yet: wgmma, TMA, and splitting a slot's keys across blocks
// (flash-decoding), which a batch of a few slots needs to fill 132 SMs.
//
// Semantics (identical to the Pallas kernel): a key at logical position
// t = j*bs + i is visible to query row s iff t <= qpos[b, s]; masked keys
// contribute exactly 0; the output is fp32 [B, S, H, D] = acc / l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;             // query rows (s, g) per block
constexpr int TPR = 16;              // threads cooperating on one row
constexpr int THREADS = ROWS * TPR;  // 256
constexpr float NEG = -1e30f;        // the Pallas kernel's running-max seed

// Four consecutive values as they sit in device memory.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using raw = float4; };
template <> struct Vec4<__nv_bfloat16> { using raw = uint2; };

__device__ __forceinline__ float4 to_f32(float4 v) { return v; }

__device__ __forceinline__ float4 to_f32(uint2 raw) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float row_max(float v) {  // over a row's TPR lanes
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, TPR));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o, TPR);
  return v;
}

template <int D>
struct Tile {
  static constexpr int CK = 8192 / D;             // keys per chunk: 64 at D=128
  static constexpr int DP = D + 4;                // padded smem row (floats)
  static constexpr int D4 = D / 4;                // 4-value vectors per row
  static constexpr int LPT = CK * D4 / THREADS;   // vectors a thread loads, per pool
  static constexpr int KPT = CK / TPR;            // keys a thread scores
  static constexpr int VW = D >= 64 ? 4 : 2;      // PV: floats per shared-memory read
  static constexpr int NV = D / TPR / VW;         // PV: reads per key and thread
  static constexpr int SP = CK + 1;               // padded probability row
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)(ROWS + 2 * CK) * DP + (size_t)ROWS * SP);
  static_assert(CK * D4 % THREADS == 0 && CK % TPR == 0 && D % (TPR * VW) == 0, "tile");
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                  const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ qpos, float* __restrict__ out, int S,
                  int H, int KV, int n_pages, int bs, int NB, float scale) {
  using T = Tile<D>;
  using RawKV = typename Vec4<TKV>::raw;
  using RawQ = typename Vec4<TQ>::raw;
  constexpr int CK = T::CK, DP = T::DP, D4 = T::D4, LPT = T::LPT, KPT = T::KPT;
  constexpr int VW = T::VW, NV = T::NV, SP = T::SP;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [ROWS][DP]
  float* k_s = q_s + ROWS * DP;                  // [CK][DP]
  float* v_s = k_s + CK * DP;                    // [CK][DP]
  float* p_s = v_s + CK * DP;                    // [ROWS][SP]
  __shared__ int maxq_s;

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int row = blockIdx.x * ROWS + r;  // row = s*G + g within (b, kvh)
  const bool live = row < S * G;
  const bool warp_live = blockIdx.x * ROWS + (tid / 32) * (32 / TPR) < S * G;
  const int s_idx = live ? row / G : 0;
  const int h = kvh * G + (live ? row % G : 0);
  const int my_qpos = live ? qpos[b * S + s_idx] : -1;
  const size_t qo_off = ((size_t)(b * S + s_idx) * H + h) * D;
  const int* tbl = tables + (size_t)b * NB;

  for (int c = sub; c < D4; c += TPR) {
    const float4 v = live ? to_f32(*reinterpret_cast<const RawQ*>(q + qo_off + 4 * c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(q_s + r * DP + 4 * c) = v;
  }
  if (tid == 0) maxq_s = -1;
  __syncthreads();
  if (sub == 0 && live) atomicMax(&maxq_s, my_qpos);
  __syncthreads();
  const int maxq = maxq_s;
  // keys the block needs: logical positions [0, n_keys)
  const int n_keys = maxq < 0 ? 0 : min(NB * bs, maxq + 1);
  const int n_chunks = (n_keys + CK - 1) / CK;
  const int last_vis = min(my_qpos, n_keys - 1);  // this row sees keys t <= last_vis

  RawKV kr[LPT], vr[LPT];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int e = tid + THREADS * u;
      const int t = c0 + e / D4;
      kr[u] = RawKV{};
      vr[u] = RawKV{};
      if (t < n_keys) {
        const int page = min(max(tbl[t / bs], 0), n_pages - 1);
        const size_t off = (((size_t)page * bs + t % bs) * KV + kvh) * D + 4 * (e % D4);
        kr[u] = *reinterpret_cast<const RawKV*>(k_pool + off);
        vr[u] = *reinterpret_cast<const RawKV*>(v_pool + off);
      }
    }
  };

  float m = NEG;
  float l = 0.f;
  float acc[NV * VW];
#pragma unroll
  for (int k = 0; k < NV * VW; ++k) acc[k] = 0.f;

  if (n_chunks > 0) fetch(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * CK;
    __syncthreads();  // every row is done with the previous chunk
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int e = tid + THREADS * u;
      const int i = e / D4;
      const int c = e % D4;
      *reinterpret_cast<float4*>(k_s + i * DP + 4 * c) = to_f32(kr[u]);
      *reinterpret_cast<float4*>(v_s + i * DP + 4 * c) = to_f32(vr[u]);
    }
    __syncthreads();
    if (ch + 1 < n_chunks) fetch(c0 + CK);  // in flight while this chunk computes
    if (!warp_live) continue;  // a warp of padding rows only loads (decode: S*G < ROWS)

    // scores of keys sub + TPR*j for this thread's row
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D4; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + r * DP + 4 * c);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(k_s + (sub + TPR * j) * DP + 4 * c);
        sc[j] += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
    }
    // online softmax over the chunk; every lane of a row ends with the same m, l
    float cmax = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      sc[j] *= scale;
      if (c0 + sub + TPR * j <= last_vis) cmax = fmaxf(cmax, sc[j]);
    }
    const float m_new = fmaxf(m, row_max(cmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      const float p = c0 + kk <= last_vis ? expf(sc[j] - m_new) : 0.f;  // masked: exactly 0
      p_s[r * SP + kk] = p;
      psum += p;
    }
    l = l * alpha + row_sum(psum);
    m = m_new;
#pragma unroll
    for (int k = 0; k < NV * VW; ++k) acc[k] *= alpha;
    __syncwarp();  // a row's probabilities come from its own warp

    const int nk = min(CK, n_keys - c0);
    for (int i = 0; i < nk; ++i) {
      const float p = p_s[r * SP + i];
      const float* vrow = v_s + i * DP;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = VW * (sub + TPR * n);
        if constexpr (VW == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + col);
          acc[4 * n] += p * vv.x; acc[4 * n + 1] += p * vv.y;
          acc[4 * n + 2] += p * vv.z; acc[4 * n + 3] += p * vv.w;
        } else {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + col);
          acc[2 * n] += p * vv.x; acc[2 * n + 1] += p * vv.y;
        }
      }
    }
  }

  if (live) {
    float* o = out + qo_off;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = VW * (sub + TPR * n);
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(o + col) = make_float4(
            acc[4 * n] / l, acc[4 * n + 1] / l, acc[4 * n + 2] / l, acc[4 * n + 3] / l);
      } else {
        *reinterpret_cast<float2*>(o + col) = make_float2(acc[2 * n] / l, acc[2 * n + 1] / l);
      }
    }
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* qpos, void* out, int B, int S, int H, int KV, int n_pages,
           int bs, int NB, float scale, cudaStream_t stream) {
  const size_t smem = Tile<D>::smem_bytes;
  auto kern = paged_attn_kernel<TQ, TKV, D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S * (H / KV) + ROWS - 1) / ROWS, KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<float*>(out), S, H, KV, n_pages, bs,
      NB, scale);
  return (int)cudaGetLastError();
}

// Head dims of the ported configs: qwen2.5-3b (128) and its reduced twin (32).
template <typename TQ, typename TKV>
int launch_d(int D, const void* q, const void* k, const void* v, const void* t,
             const void* p, void* o, int B, int S, int H, int KV, int n_pages, int bs,
             int NB, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(q, k, v, t, p, o, B, S, H, KV, n_pages, bs, NB, scale, st);
    case 128: return launch<TQ, TKV, 128>(q, k, v, t, p, o, B, S, H, KV, n_pages, bs, NB, scale, st);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. q: [B,S,H,D] fp32 or bf16; pools:
// [n_pages,bs,KV,D] fp32 or bf16; tables [B,NB] and qpos [B,S] int32; out:
// [B,S,H,D] fp32. All contiguous, 16-byte aligned. Returns the launch's
// cudaGetLastError() (0 on success), or -1 for a head_dim it was not built for.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* qpos, void* out, int B,
                                      int S, int H, int KV, int D, int n_pages, int bs,
                                      int NB, int q_bf16, int kv_bf16, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k_pool, v_pool, tables, qpos, out, B,
                                                  S, H, KV, n_pages, bs, NB, scale, st);
  if (q_bf16)
    return launch_d<__nv_bfloat16, float>(D, q, k_pool, v_pool, tables, qpos, out, B, S, H,
                                          KV, n_pages, bs, NB, scale, st);
  if (kv_bf16)
    return launch_d<float, __nv_bfloat16>(D, q, k_pool, v_pool, tables, qpos, out, B, S, H,
                                          KV, n_pages, bs, NB, scale, st);
  return launch_d<float, float>(D, q, k_pool, v_pool, tables, qpos, out, B, S, H, KV, n_pages,
                                bs, NB, scale, st);
}

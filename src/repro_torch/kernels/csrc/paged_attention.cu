// Paged attention for Hopper (sm_90a): causal per-slot attention read
// straight off the K/V page pool through the block table.
//
// Replaces the TPU kernel `repro/kernels/paged_attention.py::paged_attention`
// (Pallas, grid (B, NB) with the block table in SMEM scalar prefetch and
// the running max, denominator and accumulator carried in VMEM scratch
// along the sequential NB axis).
//
// What bounds it on this card: the bytes of the K/V pages it reads. Each
// query row does 4*D flops per visible key (QK and PV) while each key costs
// 2*D*itemsize bytes, so at decode (S*G = 8 rows per KV head at
// qwen2.5-3b) the kernel sits far below the H100's ops-per-byte ridge, and
// at the main path's 160-token slots its whole input is a few hundred KB:
// the time is load latency and how many SMs issue loads. A prefill chunk
// (S*G = 256 rows a KV head) does 256x the flops on the same bytes, which
// fp32 SIMT arithmetic makes the limit. The design:
//   * split-KV (flash-decoding): block (split sp, row tile, slot b, KV
//     head) takes the chunks [sp*C/P, (sp+1)*C/P) of its slot's C chunks
//     of CK keys, P splits in all (`paged_attention.py::paged_split_plan`
//     picks P from the grid the rest gives, in whole chunks; C comes from
//     the slot's largest qpos, loaded in the kernel, so keys past the
//     slot's horizon are never read). A split writes fp32 partials (m, l,
//     acc[D]) of its rows; a second kernel combines them in split order,
//     out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i, skipping a
//     split that saw no visible key (its l is 0, its m the -1e30 seed,
//     whose exp must not count as 1). P = 1 writes the output directly;
//   * row tiles sized to the rows (query rows (s, g), the GQA group of
//     query heads that share a KV head being rows of one tile, so a page
//     is staged once in shared memory for all of them): 8 rows a block
//     where S*G <= 8 (decode at G = 8), 64 where S*G >= 64, 16 between;
//   * pages come through a 2-deep cp.async ring of 16-byte copies, the
//     page address taken from the block-table entry (clipped to [0,
//     n_pages-1]) that each copy loads; keys past the split's end are the
//     copy's zero fill. K/V stay in the pool's type in shared memory;
//   * 8- and 16-row tiles (SIMT): online softmax in fp32 registers, 16
//     threads a row, each scoring CK/16 keys of a chunk, then holding
//     D/16 columns of the accumulator;
//   * 64-row tiles (tensor cores): each of four warps owns 16 rows, so the
//     online softmax stays inside the warp. QK^T and PV run on mma.sync
//     m16n8k8 in TF32 with fp32 accumulation, each fp32 operand split as
//     big + small (mma.cuh): a bf16 q or bf16 pool value is exact in TF32,
//     its small part zero and its product skipped, so QK^T takes two
//     products over fp32 pools with a bf16 q (three with an fp32 q) and
//     PV three (two over bf16 pools). P stays in registers: the score
//     accumulator of an 8-key tile is the A operand of PV under the key
//     order (2t, 2t+1) -> (t, t+4), which V's fragments follow too.
//     At D=256 a thread holds 32 x 4 fp32 accumulators and a chunk is
//     16 keys (two key tiles); the q rows are staged in batches of at
//     most 16 vector loads a thread so that the prologue needs no more
//     registers than the main loop;
//   * whisper's heads (H = KV = 20, D=64) leave one live row in an 8-row
//     decode tile (G = 1); paligemma's (8 heads on one KV head, D=256)
//     fill it, and its grid of B blocks splits by the plan.
// Masked keys contribute exactly 0 everywhere.
//
// Semantics (identical to the Pallas kernel): a key at logical position
// t = j*bs + i is visible to query row s iff t <= qpos[b, s]; masked keys
// contribute exactly 0; the output is fp32 [B, S, H, D] = acc / l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "geometry.cuh"
#include "mma.cuh"

namespace {

constexpr int TPR = 16;             // SIMT: threads cooperating on one row
constexpr int STAGES = 2;           // cp.async ring depth
constexpr int CHUNK_VALUES = 4096;  // CK * pad_dim(D): keys a chunk times the tiled head dim
constexpr int MMA_ROWS = 64;        // tensor-core row tile: four warps of 16 rows
constexpr float NEG = -1e30f;       // the Pallas kernel's running-max seed

// The width a head dim is tiled at in shared memory and registers: the
// next power of two (112 -> 128; 32 and 128 as they are). Loads, stores
// and the QK/PV loops cover the real D; the lanes past it are never read
// into a result. Chunks hold CHUNK_VALUES / pad_dim(D) keys at every D.
constexpr int pad_dim(int d) {
  int p = 1;
  while (p < d) p *= 2;
  return p;
}

struct Geom {
  int B, S, H, KV, n_pages, bs, bs_shift, NB, P;  // bs_shift: log2(bs), or -1
  float scale;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load1(float v) { return v; }
__device__ __forceinline__ float load1(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int W>
__device__ __forceinline__ float lanes_max(float v) {  // over W neighbouring lanes
#pragma unroll
  for (int o = W / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, W));
  return v;
}

template <int W>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o, W);
  return v;
}

// The chunk range [c_lo, c_hi) of split sp and the key its keys end at,
// from the slot's largest qpos (reduced over the block; red has a slot a
// warp). Every thread gets the same values.
template <int THREADS>
__device__ __forceinline__ void split_range(const int* qpos_b, const Geom& g, int CK,
                                            int* red, int& c_lo, int& c_hi, int& k_hi) {
  const int tid = threadIdx.x;
  int mq = -1;
  for (int i = tid; i < g.S; i += THREADS) mq = max(mq, qpos_b[i]);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mq = max(mq, __shfl_xor_sync(0xffffffffu, mq, o));
  if (tid % 32 == 0) red[tid / 32] = mq;
  __syncthreads();
  mq = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) mq = max(mq, red[i]);
  const int n_keys = mq < 0 ? 0 : min(g.NB * g.bs, mq + 1);  // logical keys [0, n_keys)
  const int n_chunks = (n_keys + CK - 1) / CK;
  const int sp = blockIdx.x;
  c_lo = (int)((long long)sp * n_chunks / g.P);
  c_hi = (int)((long long)(sp + 1) * n_chunks / g.P);
  k_hi = min(c_hi * CK, n_keys);
}

// Chunk c0 / CK of K and V (keys [c0, c0 + CK), those at or past k_hi as
// zeros) into ks[CK][DK] and vs[CK][DK], 16-byte copies of the real D
// spread over the block's THREADS.
template <typename TKV, int D, int CK, int DK, int THREADS>
__device__ __forceinline__ void load_chunk(TKV* ks, TKV* vs, const TKV* k_pool,
                                           const TKV* v_pool, const int* tbl, int c0,
                                           int k_hi, int kvh, const Geom& g) {
  constexpr int EPC = 16 / sizeof(TKV);
  constexpr int CPK = D / EPC;  // copies a key row
  constexpr int COPIES = (CK * CPK + THREADS - 1) / THREADS;
  static_assert(D * sizeof(TKV) % 16 == 0, "a key row is whole 16-byte copies");
#pragma unroll
  for (int u = 0; u < COPIES; ++u) {
    const int e = threadIdx.x + THREADS * u;
    if (CK * CPK % THREADS != 0 && e >= CK * CPK) break;
    const int i = e / CPK, piece = e % CPK;
    const int t = c0 + i;
    const bool ok = t < k_hi;
    size_t off = 0;
    if (ok) {
      const int j = g.bs_shift >= 0 ? t >> g.bs_shift : t / g.bs;
      const int page = min(max(tbl[j], 0), g.n_pages - 1);
      off = (((size_t)page * g.bs + (t - j * g.bs)) * g.KV + kvh) * D + piece * EPC;
    }
    mma::cp_async16(ks + i * DK + piece * EPC, k_pool + off, ok);
    mma::cp_async16(vs + i * DK + piece * EPC, v_pool + off, ok);
  }
}

template <typename TKV, int D, int ROWS>
struct Tile {
  static constexpr bool MMA = ROWS == MMA_ROWS;
  static constexpr int THREADS = MMA ? 128 : ROWS * TPR;
  static constexpr int DP = pad_dim(D);          // the tiled width: 128 at D=112
  static constexpr int CK = CHUNK_VALUES / DP;  // keys a chunk: 64 at D=64, 32 at 112 and 128, 16 at 256
  static constexpr int DK = DP + 16 / (int)sizeof(TKV);  // K/V smem row: 16-byte multiple
  static constexpr int DQ = DP + 4;                       // q smem row (fp32)
  static constexpr int SP = CK + 1;                      // SIMT: padded probability row
  static constexpr size_t kv_bytes = sizeof(TKV) * (size_t)STAGES * 2 * CK * DK;
  static constexpr size_t smem_bytes =
      kv_bytes + sizeof(float) * ((size_t)ROWS * DQ + (MMA ? 0 : (size_t)ROWS * SP));
};

// A split's partials of one row: acc[D], then m and l, in a row of PART
// floats (a 16-byte pitch, so acc takes vector stores).
template <int D>
constexpr int PART = D + 4;

// The row's output (P == 1: acc / l) or its split's partials.
template <int D>
__device__ __forceinline__ float* row_dst(float* out, float* part, size_t row_id,
                                          const Geom& g, float m, float l, bool write_ml) {
  if (g.P == 1) return out + row_id * D;
  float* pr = part + ((size_t)blockIdx.x * g.B * g.S * g.H + row_id) * PART<D>;
  if (write_ml) *reinterpret_cast<float2*>(pr + D) = make_float2(m, l);
  return pr;
}

// 8- or 16-row tiles: SIMT fp32, 16 threads a row.
template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(Tile<TKV, D, ROWS>::THREADS)
paged_attn_simt(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                const int* __restrict__ qpos, float* __restrict__ out,
                float* __restrict__ part, Geom g) {
  using T = Tile<TKV, D, ROWS>;
  constexpr int THREADS = T::THREADS, CK = T::CK, DK = T::DK, DQ = T::DQ, SP = T::SP;
  constexpr int DP = T::DP;
  constexpr int KPT = CK / TPR;         // keys a thread scores
  constexpr int VW = DP >= 64 ? 4 : 2;  // PV: values per shared-memory read
  constexpr int NV = DP / TPR / VW;     // PV: reads per key and thread (columns past D unused)
  static_assert(CK % TPR == 0 && DP % (TPR * VW) == 0 && D % VW == 0, "tile");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  TKV* kv_s = reinterpret_cast<TKV*>(smem_raw);  // [STAGES][2][CK][DK]: K then V
  float* q_s = reinterpret_cast<float*>(smem_raw + T::kv_bytes);  // [ROWS][DQ]
  float* p_s = q_s + ROWS * DQ;                                    // [ROWS][SP]
  __shared__ int red[THREADS / 32];

  const int b = blockIdx.z / g.KV;
  const int kvh = blockIdx.z % g.KV;
  const int G = g.H / g.KV;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int row = blockIdx.y * ROWS + r;  // row = s*G + g within (b, kvh)
  const bool live = row < g.S * G;
  const int s_idx = live ? row / G : 0;
  const int my_qpos = live ? qpos[b * g.S + s_idx] : -1;
  const size_t row_id = (size_t)(b * g.S + s_idx) * g.H + kvh * G + (live ? row % G : 0);
  const int* tbl = tables + (size_t)b * g.NB;

  {  // this row's q, all loads in flight at once
    constexpr int QV = (D / 4 + TPR - 1) / TPR;
    float4 v[QV];
#pragma unroll
    for (int u = 0; u < QV; ++u) {
      const int c = sub + TPR * u;
      v[u] = live && c < D / 4 ? load4(q + row_id * D + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < QV; ++u)
      if (sub + TPR * u < D / 4) *reinterpret_cast<float4*>(q_s + r * DQ + 4 * (sub + TPR * u)) = v[u];
  }
  int c_lo, c_hi, k_hi;
  split_range<THREADS>(qpos + b * g.S, g, CK, red, c_lo, c_hi, k_hi);
  const int last_vis = min(my_qpos, k_hi - 1);  // this row sees keys t <= last_vis

  float m = NEG;
  float l = 0.f;
  float acc[NV * VW];
#pragma unroll
  for (int k = 0; k < NV * VW; ++k) acc[k] = 0.f;

  auto stage = [&](int ch) { return kv_s + (ch % STAGES) * 2 * CK * DK; };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (c_lo + st < c_hi)
      load_chunk<TKV, D, CK, DK, THREADS>(stage(c_lo + st), stage(c_lo + st) + CK * DK, k_pool,
                                          v_pool, tbl, (c_lo + st) * CK, k_hi, kvh, g);
    mma::cp_async_commit();
  }
  for (int ch = c_lo; ch < c_hi; ++ch) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch landed for all; every row is done with chunk ch-1
    const int nx = ch + STAGES - 1;
    if (nx < c_hi)
      load_chunk<TKV, D, CK, DK, THREADS>(stage(nx), stage(nx) + CK * DK, k_pool, v_pool, tbl,
                                          nx * CK, k_hi, kvh, g);
    mma::cp_async_commit();
    const TKV* ks = stage(ch);
    const TKV* vs = ks + CK * DK;
    const int c0 = ch * CK;

    // scores of keys sub + TPR*j for this thread's row
    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + r * DQ + 4 * c);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kk = load4(ks + (sub + TPR * j) * DK + 4 * c);
        sc[j] += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
    }
    // online softmax over the chunk; every lane of a row ends with the same m, l
    float cmax = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      sc[j] *= g.scale;
      if (c0 + sub + TPR * j <= last_vis) cmax = fmaxf(cmax, sc[j]);
    }
    const float m_new = fmaxf(m, lanes_max<TPR>(cmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = sub + TPR * j;
      const float p = c0 + kk <= last_vis ? expf(sc[j] - m_new) : 0.f;  // masked: exactly 0
      p_s[r * SP + kk] = p;
      psum += p;
    }
    l = l * alpha + lanes_sum<TPR>(psum);
    m = m_new;
#pragma unroll
    for (int k = 0; k < NV * VW; ++k) acc[k] *= alpha;
    __syncwarp();  // a row's probabilities come from its own warp

    // every key of the chunk: past k_hi V is the copy's zero fill and p is 0
#pragma unroll 8
    for (int i = 0; i < CK; ++i) {
      const float p = p_s[r * SP + i];
      const TKV* vrow = vs + i * DK;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = VW * (sub + TPR * n);
        if constexpr (VW == 4) {
          const float4 vv = load4(vrow + col);
          acc[4 * n] += p * vv.x; acc[4 * n + 1] += p * vv.y;
          acc[4 * n + 2] += p * vv.z; acc[4 * n + 3] += p * vv.w;
        } else {
          const float2 vv = load2(vrow + col);
          acc[2 * n] += p * vv.x; acc[2 * n + 1] += p * vv.y;
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  if (!live) return;
  const float inv = g.P == 1 ? 1.f / l : 1.f;
  float* o = row_dst<D>(out, part, row_id, g, m, l, sub == 0);
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = VW * (sub + TPR * n);
    if (D != DP && col >= D) continue;  // a padded column
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(o + col) = make_float4(
          acc[4 * n] * inv, acc[4 * n + 1] * inv, acc[4 * n + 2] * inv, acc[4 * n + 3] * inv);
    } else {
      *reinterpret_cast<float2*>(o + col) = make_float2(acc[2 * n] * inv, acc[2 * n + 1] * inv);
    }
  }
}

// x as TF32 operand parts: big + small, or, for a value that is already a
// TF32 value (a widened bf16), big = x exactly and no small part.
template <bool SMALL>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& big, uint32_t& small) {
  if constexpr (SMALL) {
    mma::split(x, big, small);
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// 64-row tiles: QK^T and PV on the tensor cores; warp w owns rows 16w ..
// 16w + 15 of the tile. Fragments of m16n8k8 (g = lane/4, t = lane%4): A
// (m, k) at (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (k, n) at (t, g),
// (t+4, g); C (m, n) at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(128)
paged_attn_mma(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
               const TKV* __restrict__ v_pool, const int* __restrict__ tables,
               const int* __restrict__ qpos, float* __restrict__ out,
               float* __restrict__ part, Geom g) {
  using T = Tile<TKV, D, MMA_ROWS>;
  constexpr int THREADS = T::THREADS, CK = T::CK, DK = T::DK, DQ = T::DQ;
  constexpr int NT = CK / 8;  // 8-key tiles of a chunk
  constexpr int DT = D / 8;   // 8-column tiles of the output (the real D)
  static_assert(D % 8 == 0, "8-column tiles");
  constexpr bool Q_SMALL = std::is_same<TQ, float>::value;    // q has a small part
  constexpr bool KV_SMALL = std::is_same<TKV, float>::value;  // K, V have one

  extern __shared__ __align__(16) uint8_t smem_raw[];
  TKV* kv_s = reinterpret_cast<TKV*>(smem_raw);  // [STAGES][2][CK][DK]: K then V
  float* q_s = reinterpret_cast<float*>(smem_raw + T::kv_bytes);  // [64][DQ]
  __shared__ int red[THREADS / 32];

  const int b = blockIdx.z / g.KV;
  const int kvh = blockIdx.z % g.KV;
  const int G = g.H / g.KV;
  const int SG = g.S * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.y * MMA_ROWS;  // rows s*G + g within (b, kvh)
  const int* tbl = tables + (size_t)b * g.NB;

  {  // q rows into shared memory, fp32 (dead rows zero), up to 16 loads in flight at once
    constexpr int C4 = D / 4;                    // float4s a row
    constexpr int QV = MMA_ROWS * C4 / THREADS;  // float4s a thread
    constexpr int QB = QV < 16 ? QV : 16;        // a batch: 64 registers at most (D=256: 2)
    static_assert(MMA_ROWS * C4 % THREADS == 0 && QV % QB == 0, "q loader");
#pragma unroll
    for (int u0 = 0; u0 < QV; u0 += QB) {
      float4 v[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = tid + THREADS * (u0 + u);
        const int row = row0 + e / C4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < SG) {
          const size_t id = (size_t)(b * g.S + row / G) * g.H + kvh * G + row % G;
          v[u] = load4(q + id * D + 4 * (e % C4));
        }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int e = tid + THREADS * (u0 + u);
        *reinterpret_cast<float4*>(q_s + (e / C4) * DQ + 4 * (e % C4)) = v[u];
      }
    }
  }
  int c_lo, c_hi, k_hi;
  split_range<THREADS>(qpos + b * g.S, g, CK, red, c_lo, c_hi, k_hi);

  // this thread's two rows: wr + gq (h = 0) and wr + gq + 8 (h = 1)
  const int wr = warp * 16;
  int last[2];
  size_t row_id[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wr + gq + 8 * h;
    live[h] = row < SG;
    const int s_idx = live[h] ? row / G : 0;
    row_id[h] = (size_t)(b * g.S + s_idx) * g.H + kvh * G + (live[h] ? row % G : 0);
    last[h] = min(live[h] ? qpos[b * g.S + s_idx] : -1, k_hi - 1);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[dn][k] = 0.f;

  auto stage = [&](int ch) { return kv_s + (ch % STAGES) * 2 * CK * DK; };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (c_lo + st < c_hi)
      load_chunk<TKV, D, CK, DK, THREADS>(stage(c_lo + st), stage(c_lo + st) + CK * DK, k_pool,
                                          v_pool, tbl, (c_lo + st) * CK, k_hi, kvh, g);
    mma::cp_async_commit();
  }
  for (int ch = c_lo; ch < c_hi; ++ch) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch landed for all; every warp is done with chunk ch-1
    const int nx = ch + STAGES - 1;
    if (nx < c_hi)
      load_chunk<TKV, D, CK, DK, THREADS>(stage(nx), stage(nx) + CK * DK, k_pool, v_pool, tbl,
                                          nx * CK, k_hi, kvh, g);
    mma::cp_async_commit();
    const TKV* ks = stage(ch);
    const TKV* vs = ks + CK * DK;
    const int c0 = ch * CK;

    // S = Q K^T over D in steps of 8: sc[nt] is the 16 x 8 tile of keys 8 nt ..
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[nt][k] = 0.f;
#pragma unroll 2
    for (int k8 = 0; k8 < D; k8 += 8) {
      uint32_t a_big[4], a_small[4];
      const float* qp = q_s + (wr + gq) * DQ + k8 + tq;
      const float av[4] = {qp[0], qp[8 * DQ], qp[4], qp[8 * DQ + 4]};
#pragma unroll
      for (int k = 0; k < 4; ++k) tf32_parts<Q_SMALL>(av[k], a_big[k], a_small[k]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const TKV* kp = ks + (8 * nt + gq) * DK + k8 + tq;
        uint32_t b_big[2], b_small[2];
        tf32_parts<KV_SMALL>(load1(kp[0]), b_big[0], b_small[0]);
        tf32_parts<KV_SMALL>(load1(kp[4]), b_big[1], b_small[1]);
        if constexpr (Q_SMALL) mma::mma_tf32(sc[nt], a_small, b_big);
        if constexpr (KV_SMALL) mma::mma_tf32(sc[nt], a_big, b_small);
        mma::mma_tf32(sc[nt], a_big, b_big);
      }
    }

    // online softmax of the warp's rows: a row's 4 threads share it
    float cmax[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sc[nt][k] *= g.scale;
        if (c0 + 8 * nt + 2 * tq + (k & 1) <= last[k >> 1])
          cmax[k >> 1] = fmaxf(cmax[k >> 1], sc[nt][k]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], lanes_max<4>(cmax[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = k >> 1;
        const bool vis = c0 + 8 * nt + 2 * tq + (k & 1) <= last[h];
        sc[nt][k] = vis ? expf(sc[nt][k] - m[h]) : 0.f;  // masked: exactly 0
        psum[h] += sc[nt][k];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + lanes_sum<4>(psum[h]);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= alpha[0]; acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1]; acc[dn][3] *= alpha[1];
    }

    // O += P V: key tile nt is one k8 step, its keys 2t, 2t+1 taken as the
    // fragment's k = t, t + 4
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t a_big[4], a_small[4];
      const float pv[4] = {sc[nt][0], sc[nt][2], sc[nt][1], sc[nt][3]};
#pragma unroll
      for (int k = 0; k < 4; ++k) mma::split(pv[k], a_big[k], a_small[k]);
      const TKV* vp = vs + (8 * nt + 2 * tq) * DK + gq;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        uint32_t b_big[2], b_small[2];
        tf32_parts<KV_SMALL>(load1(vp[8 * dn]), b_big[0], b_small[0]);
        tf32_parts<KV_SMALL>(load1(vp[DK + 8 * dn]), b_big[1], b_small[1]);
        mma::mma_tf32(acc[dn], a_small, b_big);
        if constexpr (KV_SMALL) mma::mma_tf32(acc[dn], a_big, b_small);
        mma::mma_tf32(acc[dn], a_big, b_big);
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const float inv = g.P == 1 ? 1.f / l[h] : 1.f;
    float* o = row_dst<D>(out, part, row_id[h], g, m[h], l[h], tq == 0);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(o + 8 * dn + 2 * tq) =
          make_float2(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
  }
}

// out[row, d] from the P splits' partials of the row, summed in split
// order; a split with l == 0 saw no visible key and is skipped. One block
// of D threads a row: the (m, l) of all splits are loaded at once into
// shared memory, then each thread's column in runs of 8 splits.
constexpr int COMBINE_MAX_P = 1024;

template <int D>
__global__ void __launch_bounds__(D)
paged_combine(const float* __restrict__ part, float* __restrict__ out, int rows_total, int P) {
  __shared__ float w_s[COMBINE_MAX_P];  // each split's weight e^(m_i - M), 0 if it saw nothing
  __shared__ float l_s[COMBINE_MAX_P];
  __shared__ float mx_s;
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  const size_t step = (size_t)rows_total * PART<D>;  // from one split's row to the next's
  const float* pr = part + (size_t)row * PART<D>;
  for (int i = d; i < P; i += D) {
    const float2 ml = *reinterpret_cast<const float2*>(pr + i * step + D);
    w_s[i] = ml.x;
    l_s[i] = ml.y;
  }
  __syncthreads();
  if (d == 0) {
    float mx = NEG;
    for (int i = 0; i < P; ++i)
      if (l_s[i] > 0.f) mx = fmaxf(mx, w_s[i]);
    mx_s = mx;
  }
  __syncthreads();
  for (int i = d; i < P; i += D) w_s[i] = l_s[i] > 0.f ? expf(w_s[i] - mx_s) : 0.f;
  __syncthreads();
  float num = 0.f, den = 0.f;
  for (int i0 = 0; i0 < P; i0 += 8) {
    float a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = i0 + k < P && l_s[i0 + k] > 0.f ? pr[(i0 + k) * step + d] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k < P && l_s[i0 + k] > 0.f) {
        num += w_s[i0 + k] * a[k];
        den += w_s[i0 + k] * l_s[i0 + k];
      }
  }
  out[(size_t)row * D + d] = num / den;
}

template <typename TQ, typename TKV, typename Kern>
cudaError_t start(Kern kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  const void* q, const void* k_pool, const void* v_pool, const void* tables,
                  const void* qpos, void* out, void* part, const Geom& g) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<float*>(out), static_cast<float*>(part), g);
  return cudaGetLastError();
}

// Grid (splits, row tiles, slots x KV heads); with P > 1 the combine pass,
// a block of D threads a row.
template <typename TKV, int D, int ROWS>
geometry::Geometry plan(const Geom& g) {
  using T = Tile<TKV, D, ROWS>;
  geometry::Geometry geo;
  const int row_tiles = (g.S * (g.H / g.KV) + ROWS - 1) / ROWS;
  geo.first.grid = dim3(g.P, row_tiles, g.B * g.KV);
  geo.first.block = dim3(T::THREADS, 1, 1);
  geo.first.smem = (int)T::smem_bytes;
  geo.split = g.P;
  geo.stages = STAGES;
  if (g.P > 1) {
    geo.second.grid = dim3(g.B * g.S * g.H, 1, 1);
    geo.second.block = dim3(D, 1, 1);
  }
  return geo;
}

template <typename TQ, typename TKV, int D, int ROWS>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* qpos, void* out, void* part, const Geom& g,
           cudaStream_t stream) {
  using T = Tile<TKV, D, ROWS>;
  const geometry::Geometry geo = plan<TKV, D, ROWS>(g);
  cudaError_t e;
  if constexpr (T::MMA)
    e = start<TQ, TKV>(paged_attn_mma<TQ, TKV, D>, geo.first.grid, geo.first.block.x,
                       geo.first.smem, stream, q, k_pool, v_pool, tables, qpos, out, part, g);
  else
    e = start<TQ, TKV>(paged_attn_simt<TQ, TKV, D, ROWS>, geo.first.grid, geo.first.block.x,
                       geo.first.smem, stream, q, k_pool, v_pool, tables, qpos, out, part, g);
  if (e != cudaSuccess || g.P == 1) return (int)e;
  const int rows_total = g.B * g.S * g.H;
  paged_combine<D><<<geo.second.grid, geo.second.block, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), rows_total, g.P);
  return (int)cudaGetLastError();
}

// The geometry of launch<TQ, TKV, D, rows> (TQ does not change it).
template <typename TKV>
int geometry_d(int D, int rows, const Geom& g, geometry::Geometry& geo) {
#define PAGED_PLAN(DD, RR) \
  if (D == DD && rows == RR) { geo = plan<TKV, DD, RR>(g); return 0; }
  PAGED_PLAN(32, 8)
  PAGED_PLAN(32, 16)
  PAGED_PLAN(32, 64)
  PAGED_PLAN(64, 8)
  PAGED_PLAN(64, 16)
  PAGED_PLAN(64, 64)
  PAGED_PLAN(112, 8)
  PAGED_PLAN(112, 16)
  PAGED_PLAN(112, 64)
  PAGED_PLAN(128, 8)
  PAGED_PLAN(128, 16)
  PAGED_PLAN(128, 64)
  PAGED_PLAN(256, 8)
  PAGED_PLAN(256, 16)
  PAGED_PLAN(256, 64)
#undef PAGED_PLAN
  return -1;
}

// Head dims of the ported configs: qwen2.5-3b and the dense and MoE archs
// (128), kimi-k2 (112, tiled at 128), whisper (64), paligemma (256) and
// the reduced configs (32); row tiles of 8 (decode), 16 or 64 (tensor
// cores) query rows.
template <typename TQ, typename TKV>
int launch_d(int D, int rows, const void* q, const void* k, const void* v, const void* t,
             const void* p, void* o, void* part, const Geom& g, cudaStream_t st) {
#define PAGED_LAUNCH(DD, RR) \
  if (D == DD && rows == RR) return launch<TQ, TKV, DD, RR>(q, k, v, t, p, o, part, g, st);
  PAGED_LAUNCH(32, 8)
  PAGED_LAUNCH(32, 16)
  PAGED_LAUNCH(32, 64)
  PAGED_LAUNCH(64, 8)
  PAGED_LAUNCH(64, 16)
  PAGED_LAUNCH(64, 64)
  PAGED_LAUNCH(112, 8)
  PAGED_LAUNCH(112, 16)
  PAGED_LAUNCH(112, 64)
  PAGED_LAUNCH(128, 8)
  PAGED_LAUNCH(128, 16)
  PAGED_LAUNCH(128, 64)
  PAGED_LAUNCH(256, 8)
  PAGED_LAUNCH(256, 16)
  PAGED_LAUNCH(256, 64)
#undef PAGED_LAUNCH
  return -1;
}

}  // namespace

// Plain C entry point, loaded with ctypes. q: [B,S,H,D] fp32 or bf16; pools:
// [n_pages,bs,KV,D] fp32 or bf16; tables [B,NB] and qpos [B,S] int32; out:
// [B,S,H,D] fp32. All contiguous, 16-byte aligned. rows: the row tile (8,
// 16, or 64 for the tensor cores); chunk: keys a chunk, which must be
// CHUNK_VALUES / pad_dim(D); P: the splits, at most COMBINE_MAX_P; part [P, B*S*H,
// D + 4] fp32 is the partials' scratch (unused when P == 1). Returns
// cudaGetLastError() of the last launch (0 on success), or -1 for a head
// dim, row tile, chunk or split count it was not built for.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* qpos, void* out,
                                      void* part, int B, int S, int H, int KV, int D,
                                      int n_pages, int bs, int NB, int rows, int chunk, int P,
                                      int q_bf16, int kv_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || chunk != CHUNK_VALUES / pad_dim(D) || P < 1 || P > COMBINE_MAX_P || bs <= 0) return -1;
  const int shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  const Geom g{B, S, H, KV, n_pages, bs, shift, NB, P, scale};
  if (q_bf16 && kv_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, rows, q, k_pool, v_pool, tables, qpos,
                                                  out, part, g, st);
  if (q_bf16)
    return launch_d<__nv_bfloat16, float>(D, rows, q, k_pool, v_pool, tables, qpos, out, part,
                                          g, st);
  if (kv_bf16)
    return launch_d<float, __nv_bfloat16>(D, rows, q, k_pool, v_pool, tables, qpos, out, part,
                                          g, st);
  return launch_d<float, float>(D, rows, q, k_pool, v_pool, tables, qpos, out, part, g, st);
}

// The launch geometry of paged_attention_launch with these arguments
// (geometry.cuh says what out[16] holds); -1 where the launch refuses them.
extern "C" int paged_attention_geometry(int B, int S, int H, int KV, int D, int n_pages, int bs,
                                        int NB, int rows, int chunk, int P, int q_bf16,
                                        int kv_bf16, int* out) {
  (void)q_bf16;
  if (D <= 0 || chunk != CHUNK_VALUES / pad_dim(D) || P < 1 || P > COMBINE_MAX_P || bs <= 0)
    return -1;
  const Geom g{B, S, H, KV, n_pages, bs, 0, NB, P, 1.f};
  geometry::Geometry geo;
  const int e = kv_bf16 ? geometry_d<__nv_bfloat16>(D, rows, g, geo)
                        : geometry_d<float>(D, rows, g, geo);
  geometry::put(geo, out);
  return e;
}

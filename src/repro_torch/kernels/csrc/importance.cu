// importance for Hopper (sm_90a): imp[N] = mean over rows of |dY[M, N]|, in
// fp32, the per-channel importance ssProp ranks output channels by.
//
// Replaces the TPU kernel `repro/kernels/gathered_matmul.py::importance`
// (Pallas; grid (N/128, M/256) with a [1, 128] output block revisited
// along the sequential row axis; the wrapper pads M to 256 and N to 128
// and rescales the mean to the true M). Here nothing is padded: the sum is
// divided by the true M once, at the end.
//
// What bounds it on this card: it reads M*N values once and does one add
// a value, so it is bound by bytes (at [1024, 11008] bf16, 22.5 MB, about
// 6.7 us at 3.35 TB/s). The design:
//   * a block of 8 warps takes 32 neighbouring channels, so each warp reads
//     one 32-channel run of a row (coalesced); warp w sums rows w, w+8, ...
//     of the block's row chunk in order, and the 8 warp sums are added in
//     warp order;
//   * when the channels alone give too few blocks to fill the card, the
//     rows are cut into S chunks (S a function of the shape only), each
//     chunk's sums land in partial[s, :], and a second kernel adds them in
//     the order s = 0, 1, ... and divides by M: the result repeats exactly
//     from run to run, with no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;  // channels a block takes
constexpr int WARPS = 8;  // warps a block has, each over a share of the rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// dst[blockIdx.y, n] = sum of |dy[r, n]| over the block's row chunk; divided
// by M when there is one chunk (then dst is the output).
template <typename T>
__global__ void __launch_bounds__(COLS* WARPS)
importance_kernel(const T* __restrict__ dy, float* __restrict__ dst, int M, int N, int chunk,
                  int divide) {
  __shared__ float part[WARPS][COLS];
  const int lane = threadIdx.x % COLS, w = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + lane;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(M, r0 + chunk);
  float s = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int r = r0 + w; r < r1; r += WARPS) s += fabsf(to_f32(dy[(long long)r * N + n]));
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t += part[i][lane];
    dst[(long long)blockIdx.y * N + n] = divide ? t / (float)M : t;
  }
}

// out[n] = (sum over s < S of partial[s, n], in order) / M
__global__ void finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int M,
                              int N, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += partial[(long long)s * N + n];
  out[n] = t / (float)M;
}

template <typename T>
int launch(const void* dy, void* partial, void* out, int M, int N, int S, int chunk,
           cudaStream_t st) {
  const dim3 grid((unsigned)((N + COLS - 1) / COLS), (unsigned)S);
  if (S == 1) {
    importance_kernel<T><<<grid, COLS * WARPS, 0, st>>>(static_cast<const T*>(dy),
                                                        static_cast<float*>(out), M, N, chunk, 1);
    return (int)cudaGetLastError();
  }
  importance_kernel<T><<<grid, COLS * WARPS, 0, st>>>(static_cast<const T*>(dy),
                                                      static_cast<float*>(partial), M, N, chunk,
                                                      0);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  finish_kernel<<<(N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                 static_cast<float*>(out), M, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dy [M, N] contiguous, fp32
// (bf16 = 0) or bf16 (bf16 = 1); out [N] fp32; partial [S, N] fp32 scratch
// when S > 1 (rows cut into chunks of `chunk`). Returns the last launch's
// cudaGetLastError().
extern "C" int importance_launch(const void* dy, void* partial, void* out, int M, int N, int S,
                                 int chunk, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(dy, partial, out, M, N, S, chunk, st);
  return launch<float>(dy, partial, out, M, N, S, chunk, st);
}

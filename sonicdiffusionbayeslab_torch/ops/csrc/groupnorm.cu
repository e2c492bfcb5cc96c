// GroupNorm (+ optional SiLU) forward for Hopper (sm_90a) on channels-last
// [B, N, C] activations.
//
// Replaces the TPU kernel sonicdiffusionbayeslab_tpu/ops/groupnorm.py
// ::_kernel (launched by _gn_pallas_impl).  That kernel carries per-group
// sums in scratch memory from one step of the TPU's sequential grid to the
// next.  Hopper blocks run in parallel and in no order, so the sequential
// axis becomes a split reduction in two launches:
//   1. gn_stats: grid (S chunks of rows, B).  Each block reads its chunk
//      of rows (all C channels, coalesced along C) twice: once for the
//      per-channel mean, once for the per-channel sum of squared deviations
//      (the second read mostly hits L2).  It folds channels into groups with
//      Chan's formula and writes (mean, M2) per (b, chunk, group).
//   2. gn_apply: grid (S, B).  Each block merges the S partial statistics of
//      its groups (Chan's formula again, in a fixed order, so the result is
//      deterministic), then writes (x - mean) * rstd * gamma + beta, with
//      y * sigmoid(y) on top when SiLU is asked for.
// The variance is thus a two-pass variance per chunk merged exactly, as the
// reference's default GroupNorm computes it (mean of squared deviations),
// not E[x^2] - mean^2.  Statistics are fp32; the output is in x's type.
//
// What bounds it: bytes.  It must read x once and write y once (plus gamma
// and beta), a few flops per element, far below the ridge point; the bound
// is 2 * x.nbytes / 3.35 TB/s.  The design reads x about twice from device
// memory (stats pass 1 and the apply pass), so its floor is ~1.5x that bound.
// Splitting rows into chunks fills the 132 SMs even where B * G is small
// (the VAE's C=128 level at 512x512 has B*G = 64 groups in all).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Threads are laid out as RL row lanes x C channels ("lanes" = RL * C):
// lane e reads channel e % C of rows e / C, e / C + RL, ...  Consecutive
// lanes read consecutive channels of one row, so every warp load is
// coalesced, and a lane's channel (and group) stays fixed.

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ ws,
                                int N, int C, int G, int R, int RL) {
  extern __shared__ float sm[];
  float* part = sm;               // [RL * C]
  float* mean_c = part + RL * C;  // [C]
  float* m2_c = mean_c + C;       // [C]
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int r0 = s * R, rows = min(R, N - r0);
  const T* xb = x + (static_cast<int64_t>(b) * N + r0) * C;
  const int lanes = RL * C;

  for (int e = threadIdx.x; e < lanes; e += blockDim.x) {
    const int rl = e / C, c = e - rl * C;
    float acc = 0.f;
#pragma unroll 4
    for (int r = rl; r < rows; r += RL) acc += to_f(xb[static_cast<int64_t>(r) * C + c]);
    part[e] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int rl = 0; rl < RL; ++rl) t += part[rl * C + c];
    mean_c[c] = t / rows;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < lanes; e += blockDim.x) {
    const int rl = e / C, c = e - rl * C;
    const float mu = mean_c[c];
    float acc = 0.f;
#pragma unroll 4
    for (int r = rl; r < rows; r += RL) {
      const float d = to_f(xb[static_cast<int64_t>(r) * C + c]) - mu;
      acc = fmaf(d, d, acc);
    }
    part[e] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int rl = 0; rl < RL; ++rl) t += part[rl * C + c];
    m2_c[c] = t;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float mu = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) mu += mean_c[c];
    mu /= gs;
    float m2 = 0.f;
    for (int c = g * gs; c < (g + 1) * gs; ++c) {
      const float d = mean_c[c] - mu;
      m2 += m2_c[c] + rows * d * d;
    }
    float* w = ws + ((static_cast<int64_t>(b) * S + s) * G + g) * 2;
    w[0] = mu;
    w[1] = m2;
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                                const T* __restrict__ beta, const float* __restrict__ ws,
                                T* __restrict__ y, int N, int C, int G, int R, int RL,
                                float eps, int silu) {
  extern __shared__ float sm[];
  float* mean_g = sm;      // [G]
  float* rstd_g = sm + G;  // [G]
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int gs = C / G;
  // One warp per group: each lane merges every 32nd chunk, then the lanes
  // merge pairwise across the warp (fixed order, so deterministic).
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = threadIdx.x >> 5; g < G; g += nwarps) {
    float n = 0.f, mu = 0.f, m2 = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float nb = static_cast<float>(min(R, N - t * R)) * gs;
      const float* w = ws + ((static_cast<int64_t>(b) * S + t) * G + g) * 2;
      const float d = w[0] - mu, nn = n + nb;
      mu += d * (nb / nn);
      m2 += w[1] + d * d * (n * nb / nn);
      n = nn;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
      const float mb = __shfl_xor_sync(0xffffffffu, mu, off);
      const float qb = __shfl_xor_sync(0xffffffffu, m2, off);
      const float nn = n + nb;
      if (nn > 0.f) {
        const float d = mb - mu;
        mu += d * (nb / nn);
        m2 += qb + d * d * (n * nb / nn);
        n = nn;
      }
    }
    if (lane == 0) {
      mean_g[g] = mu;
      rstd_g[g] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();

  const int r0 = s * R, rows = min(R, N - r0);
  const int64_t base = (static_cast<int64_t>(b) * N + r0) * C;
  const T* xb = x + base;
  T* yb = y + base;
  const int lanes = RL * C;
  for (int e = threadIdx.x; e < lanes; e += blockDim.x) {
    const int rl = e / C, c = e - rl * C, g = c / gs;
    const float mu = mean_g[g], rs = rstd_g[g];
    const float ga = to_f(gamma[c]), be = to_f(beta[c]);
#pragma unroll 4
    for (int r = rl; r < rows; r += RL) {
      const int64_t i = static_cast<int64_t>(r) * C + c;
      float v = (to_f(xb[i]) - mu) * rs;
      v = v * ga + be;
      if (silu) v = v / (1.f + __expf(-v));
      yb[i] = from_f<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, float* ws,
                   int B, int N, int C, int G, int S, int R, float eps, int silu,
                   cudaStream_t stream) {
  const int RL = C < 256 ? 256 / C : 1;
  const int lanes = RL * C;
  int threads = lanes;
  while (threads > 1024) threads = (threads + 1) / 2;
  threads = (threads + 31) / 32 * 32;  // whole warps: the merge shuffles across lanes
  const dim3 grid(S, B);
  const size_t smem_stats = sizeof(float) * (lanes + 2 * C);
  gn_stats_kernel<T><<<grid, threads, smem_stats, stream>>>(
      static_cast<const T*>(x), ws, N, C, G, R, RL);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, threads, sizeof(float) * 2 * G, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      ws, static_cast<T*>(y), N, C, G, R, RL, eps, silu);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous [B, N, C]; gamma, beta: [C] of x's type; ws: float32
// workspace of B * S * G * 2 elements, where the N rows are cut into S
// chunks of R rows (the last may be shorter, none empty).  C <= 4096 keeps
// the stats kernel's shared memory under 48 KB.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launches (0 on success).
extern "C" int sdbl_groupnorm_fwd(const void* x, const void* gamma, const void* beta,
                                  void* y, void* ws, int B, int N, int C, int G, int S,
                                  int R, float eps, int silu, int dtype, void* stream) {
  if (C <= 0 || C > 4096 || G <= 0 || C % G != 0 || S <= 0 || R <= 0 ||
      (S - 1) * R >= N || S * R < N)
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, beta, y, w, B, N, C, G, S, R, eps, silu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, w, B, N, C, G, S, R, eps, silu, st);
  return cudaErrorInvalidValue;
}

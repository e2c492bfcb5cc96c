// GroupNorm (+ optional SiLU) forward for Hopper (sm_90a) on channels-last
// [B, N, C] activations, in one launch per call.
//
// Replaces the TPU kernel sonicdiffusionbayeslab_tpu/ops/groupnorm.py
// ::_kernel (launched by _gn_pallas_impl).  That kernel carries per-group
// sums in scratch memory from one step of the TPU's sequential grid to the
// next.  Hopper blocks run in parallel and in no order, so the statistics of
// a group are merged across blocks inside one thread-block cluster:
//
//   * A cluster owns one batch item and a range of whole groups (a multiple
//     of the 16-byte vector in channels), and all N rows of that slab; its K
//     blocks (K <= 16; above 8 only where the card holds such a cluster)
//     split the rows.  The plan (ops/groupnorm.py::plan) picks the range and
//     K so that ~128 blocks are in flight where the shape has the work for
//     it, and only layouts whose clusters the card holds all at once
//     (cudaOccupancyMaxActiveClusters): a second wave doubles the time.  At
//     the UNet's 8x8 and 16x16 levels K is 1: no cluster barrier, nothing
//     merged across blocks.
//   * Each thread reads 16 bytes a row (8 bf16 or 4 fp32 channels;
//     neighbouring threads read neighbouring channels of one row), two rows
//     in flight, and keeps a Welford (mean, M2) per channel over the rows it
//     walks.  The block merges its threads' partials with Chan's formula in
//     a fixed tree over row lanes, then folds channels into groups (equal
//     counts: the group mean is the mean of channel means, M2 adds
//     n * (mean_c - mean_g)^2).  gamma and beta are read into shared memory
//     while the rows load.
//   * cluster.sync(); every block reads the per-group partials of all K
//     blocks through distributed shared memory (map_shared_rank) and merges
//     them in rank order, so every block of a cluster gets the same bits,
//     and two runs give the same bits.  It then arrives on the cluster
//     barrier, applies (x - mean) * rsqrt(var + eps) * gamma + beta (and
//     y * sigmoid(y), through tanh.approx in bf16) to its rows, and waits on
//     the barrier before it exits, so its shared memory lives until every
//     peer has read it.
// The variance is the mean of squared deviations, as the reference's
// default GroupNorm computes it, never E[x^2] - mean^2.  Statistics are
// fp32; the output is in x's type.  No workspace in device memory.
//
// What bounds it: bytes.  It must read x once and write y once (plus gamma
// and beta), a few flops per element, far below the ridge point; the bound
// is 2 * x.nbytes / 3.35 TB/s.  Where a block's rows fit 96 KB of shared
// memory (ops/groupnorm.py::CACHE_BYTES: every UNet call but 4x4096x640 and
// 4x4096x960, and the VAE's 2x4096x512), the statistics pass keeps them
// there and x is read from device memory once.  Elsewhere the apply pass
// reads the rows again: from L2 for those two UNet calls (21-31.5 MB), from
// device memory for the VAE's 33-268 MB calls.  What holds it back on the
// card (PERF.md): a channel range is only 64-240 bytes of each row, so every
// warp access spans several rows and cache lines; the special-function
// units (the SiLU); and a fixed ~5 us chain of load, merges and barriers
// that the small calls cannot hide.
//
// Split across ranks (ops/groupnorm.py::group_norm_silu_split: the rows of
// the map split over the mesh's seq axis), the statistics of a group span
// every rank, so one launch cannot finish the job.  The TPU kernel's grid
// has a pass axis (pass 0 sums, pass 1 applies); here they are two launches
// with a collective between them:
//   * sdbl_groupnorm_partials: gn_cluster_kernel<T, V, kPartials>, the same
//     plan, loads, Welford and Chan merges, stopped after step 4: block 0
//     of each cluster writes every group's fp32 (count, mean, M2) of this
//     rank's rows to stats[B][G][3], and nothing is applied (no row cache);
//   * the ranks' partials are gathered and merged in rank order by torch
//     ops on the host side of the wrapper (a [B, G] tensor);
//   * sdbl_groupnorm_apply: gn_apply_kernel, a grid-stride pass over 16-byte
//     vectors of x that applies the given (mean, rstd), gamma and beta (and
//     the SiLU) with the fused kernel's arithmetic; each block first puts
//     every channel's mean, scale and shift into shared memory.
// The pair reads x twice and writes y once: its byte bound is 3 * x.nbytes
// / 3.35 TB/s, against the fused kernel's 2 * x.nbytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kBatch = 2;  // rows a thread has in flight: all loads first, then the math
constexpr int kMaxCluster = 16;  // 8 is portable; 16 needs the non-portable attribute
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may have

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

// One access of V elements: a 16-byte uint4 for the vector path, T itself
// for the scalar one.
template <typename T, int V> struct Raw { using type = T; };
template <> struct Raw<float, 4> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };

__device__ __forceinline__ uint4 ldg(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) { return __ldg(p); }

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename Raw<T, V>::type& r, float (&f)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type pack(const float (&f)[V]) {
  typename Raw<T, V>::type r;
  if constexpr (V == 8) {  // bf16: two elements a conversion
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) e[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  } else {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(f[j]);
  }
  return r;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// y * sigmoid(y).  bf16: sigmoid as 0.5 * tanh(y / 2) + 0.5, one
// special-function op an element (their rate bounds the apply pass), with
// an error well under bf16's spacing; fp32 keeps exp and a fast division.
template <typename T>
__device__ __forceinline__ float silu_f(float v) {
  if constexpr (sizeof(T) == 2) return v * fmaf(0.5f, tanh_approx(0.5f * v), 0.5f);
  return __fdividef(v, 1.f + __expf(-v));  // -> 0 where exp(-v) overflows
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same bits in every lane: each step adds the same two values
}

// Rows r < rows with r % 2^b == l.
__device__ __forceinline__ float lane_rows(int rows, int l, int b) {
  return l < rows ? static_cast<float>(((rows - l - 1) >> b) + 1) : 0.f;
}

// Chan's merge of (nb, mb, qb) into (na, ma, qa); q is M2, the sum of
// squared deviations from the mean.  An empty side changes nothing.
__device__ __forceinline__ void chan(float na, float& ma, float& qa, float nb, float mb,
                                     float qb) {
  if (nb == 0.f) return;
  const float n = na + nb, d = mb - ma, rn = __frcp_rn(n);
  ma = fmaf(d, nb * rn, ma);
  qa += fmaf(d * d, na * nb * rn, qb);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kFused = 0;     // statistics and apply, one launch
constexpr int kPartials = 1;  // statistics only, written to global memory

// Grid (ranges * K, B), clusters of (K, 1, 1).  A block's threads are
// `lanes` row lanes (a power of two) by `slots` vectors of a row.  Shared
// memory: the cached rows [rows_per][slots] of Raw (when cache), then
// floats: mean and M2 [lanes][CR], gamma and beta [CR], part[gpr][2] (this
// block's group mean, M2), stat[gpr][2] (the merged mean, rstd).  MODE
// kPartials writes (count, mean, M2) of each group to stats[B][G][3] in
// place of the apply; gamma, beta and y are then unused.
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, float* __restrict__ stats,
                  int N, int C, int gs, int gpr, int rows_per, int lanes, int cache, float eps,
                  int silu) {
  using R = typename Raw<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int range = blockIdx.x / K, b = blockIdx.y;
  const int CR = gpr * gs, slots = CR / V, work = lanes * slots;
  const int rows = max(0, min(rows_per, N - rank * rows_per));
  const size_t cached = cache ? (static_cast<size_t>(rows_per) * CR * sizeof(T) + 15) / 16 * 16 : 0;
  R* xs = reinterpret_cast<R*>(smem);
  float* s_mean = reinterpret_cast<float*>(smem + cached);
  float* s_m2 = s_mean + lanes * CR;
  float* s_gamma = s_m2 + lanes * CR;
  float* s_beta = s_gamma + CR;
  float* part = s_beta + CR;
  float* stat = part + 2 * gpr;
  const int c0 = range * CR;
  const int64_t base = (static_cast<int64_t>(b) * N + static_cast<int64_t>(rank) * rows_per) * C + c0;
  const int64_t step = static_cast<int64_t>(lanes) * C / V;  // in accesses of V elements

  if constexpr (MODE == kFused) {
    for (int c = threadIdx.x; c < CR; c += blockDim.x) {  // read while the rows load
      s_gamma[c] = to_f(gamma[c0 + c]);
      s_beta[c] = to_f(beta[c0 + c]);
    }
  }

  // 1. Per-channel Welford over this thread's rows (lane, lane + lanes, ...).
  for (int e = threadIdx.x; e < work; e += blockDim.x) {
    const int lane = e / slots, slot = e - lane * slots;
    float mean[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
    const R* p = reinterpret_cast<const R*>(x + base + static_cast<int64_t>(lane) * C + slot * V);
    int n = 0;
    for (int r0 = lane; r0 < rows; r0 += kBatch * lanes, p += kBatch * step) {
      R raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r0 + u * lanes < rows) raw[u] = ldg(p + u * step);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u * lanes >= rows) break;
        if (cache) xs[(r0 + u * lanes) * slots + slot] = raw[u];
        float f[V];
        unpack<T, V>(raw[u], f);
        const float rn = __fdividef(1.f, static_cast<float>(++n));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = f[j] - mean[j];
          mean[j] = fmaf(d, rn, mean[j]);
          m2[j] = fmaf(d, f[j] - mean[j], m2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s_mean[lane * CR + slot * V + j] = mean[j];
      s_m2[lane * CR + slot * V + j] = m2[j];
    }
  }
  __syncthreads();

  // 2. Merge row lanes per channel: a fixed tree, lane l takes lane l + s.
  for (int b = __ffs(lanes) - 2; b >= 0; --b) {
    const int s = 1 << b;
    for (int e = threadIdx.x; e < s * CR; e += blockDim.x) {
      float ma = s_mean[e], qa = s_m2[e];
      chan(lane_rows(rows, e / CR, b + 1), ma, qa, lane_rows(rows, e / CR + s, b + 1),
           s_mean[e + s * CR], s_m2[e + s * CR]);
      s_mean[e] = ma;
      s_m2[e] = qa;
    }
    __syncthreads();
  }

  // 3. Channels into groups, one warp a group: every channel counts `rows`.
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = wid; g < gpr; g += nwarps) {
    float sum = 0.f;
    for (int c = g * gs + lid; c < (g + 1) * gs; c += 32) sum += s_mean[c];
    const float mu = warp_sum(sum) / gs;
    float q = 0.f;
    for (int c = g * gs + lid; c < (g + 1) * gs; c += 32) {
      const float d = s_mean[c] - mu;
      q += fmaf(static_cast<float>(rows) * d, d, s_m2[c]);
    }
    q = warp_sum(q);
    if (lid == 0) {
      part[2 * g] = mu;
      part[2 * g + 1] = q;
    }
  }
  if (K > 1) cluster.sync(); else __syncthreads();

  // 4. Every block merges all K blocks' partials, in rank order.
  for (int g = threadIdx.x; g < gpr; g += blockDim.x) {
    float n = 0.f, mu = 0.f, q = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* pk = cluster.map_shared_rank(part, k);
      const float nk = static_cast<float>(max(0, min(rows_per, N - k * rows_per))) * gs;
      chan(n, mu, q, nk, pk[2 * g], pk[2 * g + 1]);
      n += nk;
    }
    if constexpr (MODE == kPartials) {
      if (rank == 0) {
        float* out = stats + (static_cast<int64_t>(b) * (C / gs) + range * gpr + g) * 3;
        out[0] = n;
        out[1] = mu;
        out[2] = q;
      }
    } else {
      stat[2 * g] = mu;
      stat[2 * g + 1] = rsqrtf(q / n + eps);
    }
  }
  if (K > 1) cluster_arrive();  // done reading the peers; wait for them before exiting
  if constexpr (MODE == kPartials) {
    if (K > 1) cluster_wait();
    return;
  }
  __syncthreads();

  // 5. Normalise, affine, SiLU: per-channel constants once, outside the rows.
  for (int e = threadIdx.x; e < work; e += blockDim.x) {
    const int lane = e / slots, slot = e - lane * slots;
    float mu[V], sc[V], sh[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = slot * V + j, g = c / gs;
      mu[j] = stat[2 * g];
      sc[j] = stat[2 * g + 1] * s_gamma[c];
      sh[j] = s_beta[c];
    }
    const int64_t off = base + static_cast<int64_t>(lane) * C + slot * V;
    const R* p = reinterpret_cast<const R*>(x + off);
    R* q = reinterpret_cast<R*>(y + off);
    for (int r0 = lane; r0 < rows; r0 += kBatch * lanes, p += kBatch * step, q += kBatch * step) {
      R raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r0 + u * lanes < rows)
          raw[u] = cache ? xs[(r0 + u * lanes) * slots + slot] : ldg(p + u * step);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u * lanes >= rows) break;
        float f[V];
        unpack<T, V>(raw[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = fmaf(f[j] - mu[j], sc[j], sh[j]);
          if (silu) v = silu_f<T>(v);
          f[j] = v;
        }
        q[u * step] = pack<T, V>(f);
      }
    }
  }
  if (K > 1) cluster_wait();  // peers may still be reading this block's `part`
}

// Grid (blocks, B) of kApplyThreads threads; a grid-stride loop over the
// N * C / V vectors of batch item blockIdx.y.  Shared memory: mean, scale
// (rstd * gamma) and shift (beta) of each of the C channels, so a vector's
// constants are C / V apart and never recomputed.
constexpr int kApplyThreads = 256;
constexpr int kApplyBlocks = 1056;  // 8 blocks of 256 threads an SM, all batch items together

template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ y,
                int N, int C, int G, int silu) {
  using R = typename Raw<T, V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_mu = reinterpret_cast<float*>(smem);
  float* s_sc = s_mu + C;
  float* s_sh = s_sc + C;
  const int b = blockIdx.y, gs = C / G, slots = C / V;
  const float* st = stats + static_cast<int64_t>(b) * G * 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / gs;
    s_mu[c] = st[2 * g];
    s_sc[c] = st[2 * g + 1] * to_f(gamma[c]);
    s_sh[c] = to_f(beta[c]);
  }
  __syncthreads();
  const int64_t total = static_cast<int64_t>(N) * slots;
  const R* p = reinterpret_cast<const R*>(x + static_cast<int64_t>(b) * N * C);
  R* q = reinterpret_cast<R*>(y + static_cast<int64_t>(b) * N * C);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(e % slots) * V;
    float f[V];
    unpack<T, V>(ldg(p + e), f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = fmaf(f[j] - s_mu[c0 + j], s_sc[c0 + j], s_sh[c0 + j]);
      if (silu) v = silu_f<T>(v);
      f[j] = v;
    }
    q[e] = pack<T, V>(f);
  }
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const float* stats, const void* gamma, const void* beta,
                         void* y, int B, int N, int C, int G, int silu, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_apply_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(C);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int64_t vecs = static_cast<int64_t>(N) * (C / V);
  const int64_t want = (vecs + kApplyThreads - 1) / kApplyThreads;
  const int blocks = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(want, std::max(1, kApplyBlocks / B))));
  gn_apply_kernel<T, V><<<dim3(blocks, B, 1), kApplyThreads, smem, stream>>>(
      static_cast<const T*>(x), stats, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), N, C, G, silu);
  return cudaGetLastError();
}

size_t smem_bytes(int rows_per, int CR, int lanes, int gpr, int cache, size_t elem) {
  const size_t cached = cache ? (static_cast<size_t>(rows_per) * CR * elem + 15) / 16 * 16 : 0;
  return cached + sizeof(float) * (2 * static_cast<size_t>(lanes) * CR + 2 * CR + 4 * gpr);
}

template <typename T, int V, int MODE = kFused>
cudaError_t allow_smem() {  // once per process and instantiation
  static const cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_cluster_kernel<T, V, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gn_cluster_kernel<T, V, MODE>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

cudaLaunchConfig_t config(int ranges, int B, int K, int threads, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * K, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int V, int MODE = kFused>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, float* stats,
                   int B, int N, int C, int G, int gpr, int K, int threads, int lanes, int cache,
                   float eps, int silu, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, V, MODE>();
  if (err != cudaSuccess) return err;
  const int gs = C / G, rows_per = (N + K - 1) / K;
  const size_t smem = smem_bytes(rows_per, gpr * gs, lanes, gpr, cache, sizeof(T));
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(G / gpr, B, K, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, V, MODE>, static_cast<const T*>(x),
                           static_cast<const T*>(gamma), static_cast<const T*>(beta),
                           static_cast<T*>(y), stats, N, C, gs, gpr, rows_per, lanes, cache,
                           eps, silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t active_clusters(int K, int threads, int smem, int* out) {
  cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, 1, K, threads, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, gn_cluster_kernel<T, V, kFused>, &cfg);
}

bool valid(int B, int N, int C, int G, int vec, int gpr, int K, int threads, int lanes,
           size_t elem, const void* x) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || C % G || gpr <= 0 || G % gpr)
    return false;
  if (vec != 1 && (vec * elem != 16 || C % vec || (gpr * (C / G)) % vec ||
                   reinterpret_cast<uintptr_t>(x) % 16))
    return false;
  const int slots = gpr * (C / G) / vec;
  if (K < 1 || K > kMaxCluster || threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (lanes < 1 || (lanes & (lanes - 1)) || (lanes > 1 && lanes * slots > threads)) return false;
  return static_cast<int64_t>(G / gpr) * K <= 0x7fffffff;
}

}  // namespace

// x, y: contiguous [B, N, C]; gamma, beta: [C] of x's type.  G groups, cut
// into ranges of gpr groups; K blocks a cluster split the N rows; each
// block runs `threads` threads as `lanes` row lanes (a power of two) by
// gpr * (C / G) / vec slots of vec elements (vec: 1, or 16 bytes' worth
// with x 16-byte aligned).  cache: keep a block's rows in shared memory.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int sdbl_groupnorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  int B, int N, int C, int G, int vec, int gpr, int K,
                                  int threads, int lanes, int cache, float eps, int silu,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if ((dtype != 0 && dtype != 1) || !valid(B, N, C, G, vec, gpr, K, threads, lanes, elem, x))
    return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, gamma, beta, y, nullptr, B, N, C, G, gpr, K, threads, lanes,
                            cache, eps, silu, st);
  if (dtype == 0)
    return launch<float, 1>(x, gamma, beta, y, nullptr, B, N, C, G, gpr, K, threads, lanes,
                            cache, eps, silu, st);
  if (vec == 8)
    return launch<__nv_bfloat16, 8>(x, gamma, beta, y, nullptr, B, N, C, G, gpr, K, threads,
                                    lanes, cache, eps, silu, st);
  return launch<__nv_bfloat16, 1>(x, gamma, beta, y, nullptr, B, N, C, G, gpr, K, threads, lanes,
                                  cache, eps, silu, st);
}

// Pass 0 of a GroupNorm split across ranks: stats[B][G][3] (fp32 count,
// mean, M2 of each group over x's N rows), with the fused kernel's plan
// (vec, gpr, K, threads, lanes as for sdbl_groupnorm_fwd) and no row cache.
extern "C" int sdbl_groupnorm_partials(const void* x, float* stats, int B, int N, int C, int G,
                                       int vec, int gpr, int K, int threads, int lanes,
                                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if ((dtype != 0 && dtype != 1) || !valid(B, N, C, G, vec, gpr, K, threads, lanes, elem, x))
    return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return launch<float, 4, kPartials>(x, nullptr, nullptr, nullptr, stats, B, N, C, G, gpr, K,
                                       threads, lanes, 0, 0.f, 0, st);
  if (dtype == 0)
    return launch<float, 1, kPartials>(x, nullptr, nullptr, nullptr, stats, B, N, C, G, gpr, K,
                                       threads, lanes, 0, 0.f, 0, st);
  if (vec == 8)
    return launch<__nv_bfloat16, 8, kPartials>(x, nullptr, nullptr, nullptr, stats, B, N, C, G,
                                               gpr, K, threads, lanes, 0, 0.f, 0, st);
  return launch<__nv_bfloat16, 1, kPartials>(x, nullptr, nullptr, nullptr, stats, B, N, C, G,
                                             gpr, K, threads, lanes, 0, 0.f, 0, st);
}

// Pass 1: y = (x - mean) * rstd * gamma + beta (then y * sigmoid(y) when
// silu) with stats[B][G][2] = (mean, rstd) in fp32; x, y contiguous
// [B, N, C]; vec 16 bytes' worth of elements (C a multiple, x and y 16-byte
// aligned) or 1.
extern "C" int sdbl_groupnorm_apply(const void* x, const float* stats, const void* gamma,
                                    const void* beta, void* y, int B, int N, int C, int G,
                                    int vec, int silu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if ((dtype != 0 && dtype != 1) || B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || C % G)
    return cudaErrorInvalidValue;
  if (vec != 1 && (vec * elem != 16 || C % vec || reinterpret_cast<uintptr_t>(x) % 16 ||
                   reinterpret_cast<uintptr_t>(y) % 16))
    return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return launch_apply<float, 4>(x, stats, gamma, beta, y, B, N, C, G, silu, st);
  if (dtype == 0)
    return launch_apply<float, 1>(x, stats, gamma, beta, y, B, N, C, G, silu, st);
  if (vec == 8)
    return launch_apply<__nv_bfloat16, 8>(x, stats, gamma, beta, y, B, N, C, G, silu, st);
  return launch_apply<__nv_bfloat16, 1>(x, stats, gamma, beta, y, B, N, C, G, silu, st);
}

// How many clusters of K blocks of `threads` threads and `smem` bytes of
// dynamic shared memory the card can hold at once (cudaOccupancyMaxActiveClusters).
extern "C" int sdbl_groupnorm_active_clusters(int dtype, int vec, int K, int threads, int smem,
                                              int* out) {
  if (dtype == 0 && vec == 4) return active_clusters<float, 4>(K, threads, smem, out);
  if (dtype == 0 && vec == 1) return active_clusters<float, 1>(K, threads, smem, out);
  if (dtype == 1 && vec == 8) return active_clusters<__nv_bfloat16, 8>(K, threads, smem, out);
  if (dtype == 1 && vec == 1) return active_clusters<__nv_bfloat16, 1>(K, threads, smem, out);
  return cudaErrorInvalidValue;
}

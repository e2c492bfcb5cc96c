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
// has a pass axis (pass 0 sums, pass 1 applies); here they are two kernels
// of their own with an all-gather of the partials between them, and no
// other op.  The pair reads x twice and writes y once; each kernel is
// bound by bytes: the partials by x.nbytes / 3.35 TB/s, the apply by twice
// that.  A seq rank's shapes are small (0.3-16 MB at 32-2048 rows), so a
// fixed chain of latency and barriers, not the bytes, sets most launches'
// time; the design shortens that chain.
//   * sdbl_groupnorm_partials, gn_partials_kernel: every group's fp32
//     (count, mean, M2) over this rank's rows, to stats[B][G][3].  Its own
//     plan (ops/groupnorm.py::partials_plan: residency asked of this
//     kernel at its own shared memory, one wave) cuts channel ranges of at
//     least 128 bytes of a row where C allows, so a warp reads whole lines,
//     and splits a range's rows over K blocks where it holds over 128 KB.
//     A thread keeps kLoads 16-byte loads in flight and sums x - shift and
//     its square a channel in registers (no divide a row; the shift is the
//     channel's value in the slab's row 0, common to the K blocks, so every
//     partial is a plain sum).  One shared-memory stage adds a block's row
//     lanes in order.  Without clusters: measured on the card, a cluster
//     barrier and its distributed shared memory cost more than the bytes
//     at these sizes, so the K blocks of a slab write their sums to a small
//     workspace and the last to arrive (an atomic counter it sets back to
//     0) adds them in block order, then folds channels into groups a warp a
//     group by shuffles.  Every launch gives the same bits for the same
//     input, graph replays included.
//   * sdbl_groupnorm_apply, gn_apply_kernel: takes the gathered partials
//     [S][B][G][3] and merges them in its prologue with Chan's formula in
//     merge_group_stats's order, in rank order, so every rank gets the same
//     bits.  A block owns a batch item and a tile of rows sized so the grid
//     fills one wave (ops/groupnorm.py::apply_plan).  While a thread's first
//     rows load, the block merges each group once (a thread a group) into a
//     table of G (mean, rstd); a thread owns fixed channel slots and takes
//     their mean, scale and shift once into registers, then walks rows with
//     kLoads loads in flight and the fused kernel's arithmetic: no table of
//     channels, no modulo a vector.  Block 0 of each batch item can write
//     the merged (mean, rstd).

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

// Grid (ranges * K, B), clusters of (K, 1, 1).  A block's threads are
// `lanes` row lanes (a power of two) by `slots` vectors of a row.  Shared
// memory: the cached rows [rows_per][slots] of Raw (when cache), then
// floats: mean and M2 [lanes][CR], gamma and beta [CR], part[gpr][2] (this
// block's group mean, M2), stat[gpr][2] (the merged mean, rstd).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, int N, int C, int gs, int gpr,
                  int rows_per, int lanes, int cache, float eps, int silu) {
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

  for (int c = threadIdx.x; c < CR; c += blockDim.x) {  // read while the rows load
    s_gamma[c] = to_f(gamma[c0 + c]);
    s_beta[c] = to_f(beta[c0 + c]);
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
    stat[2 * g] = mu;
    stat[2 * g + 1] = rsqrtf(q / n + eps);
  }
  if (K > 1) cluster_arrive();  // done reading the peers; wait for them before exiting
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

// ---------------------------------------------------------------------------
// The split pair (ops/groupnorm.py::group_norm_silu_split).

constexpr int kLoads = 4;  // 16-byte loads a thread has in flight in both kernels of the pair

// Pass 0.  Grid (ranges * K, B), no clusters: the K blocks (range, k, b)
// of a slab (a batch item's range of gpr whole groups, CR channels) own
// rows [k * rows_per, (k + 1) * rows_per).  A block runs `lanes` row lanes
// by CR / V vector slots (item e: lane e / slots, slot e % slots; a
// thread takes items e, e + blockDim.x, ...).  Each item sums d = x -
// shift and d * d a channel in registers over rows lane, lane + lanes,
// ..., kLoads rows in flight; the shift of a channel is its value in the
// slab's row 0, the same for every block of the slab, so every partial
// below is a plain sum.  With K > 1 each block writes its sums to
// work[B][ranges][K][2][CR] and counts itself in arrivals[B][ranges]; the
// last block of the slab to arrive adds the K blocks' sums in block order
// (the same bits whichever block is last) and sets the count back to 0, so
// the next launch, or a graph's replay, starts from 0.  Shared memory
// (floats): s1, s2 [lanes][CR] (each item's sums), part [2][CR] (the
// block's sums a channel, then each channel's mean and M2).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers
gn_partials_kernel(const T* __restrict__ x, float* __restrict__ stats, float* __restrict__ work,
                   unsigned* __restrict__ arrivals, int N, int C, int gs, int gpr, int K,
                   int rows_per, int lanes) {
  using R = typename Raw<T, V>::type;
  extern __shared__ __align__(16) float fsm[];  // no static shared memory: 227 KB stay dynamic
  const int range = blockIdx.x / K, k = blockIdx.x - range * K, b = blockIdx.y;
  const int CR = gpr * gs, slots = CR / V, work_items = lanes * slots, ranges = C / CR;
  const int rows = max(0, min(rows_per, N - k * rows_per));
  float* s1 = fsm;
  float* s2 = s1 + lanes * CR;
  float* part = s2 + lanes * CR;
  const T* x0 = x + static_cast<int64_t>(b) * N * C + range * CR;  // the slab's row 0
  const int64_t step = static_cast<int64_t>(lanes) * C / V;          // in accesses of V elements

  // 1. Shifted sums a channel over this item's rows, in registers.
  for (int e = threadIdx.x; e < work_items; e += blockDim.x) {
    const int lane = e / slots, slot = e - lane * slots;
    const R* p = reinterpret_cast<const R*>(
        x0 + (static_cast<int64_t>(k) * rows_per + lane) * C + slot * V);
    R raw[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (lane + u * lanes < rows) raw[u] = ldg(p + u * step);
    float sh[V], a1[V], a2[V];
    unpack<T, V>(ldg(reinterpret_cast<const R*>(x0 + slot * V)), sh);
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    for (int r0 = lane;;) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (r0 + u * lanes >= rows) break;
        float f[V];
        unpack<T, V>(raw[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = f[j] - sh[j];
          a1[j] += d;
          a2[j] = fmaf(d, d, a2[j]);
        }
      }
      r0 += kLoads * lanes;
      p += kLoads * step;
      if (r0 >= rows) break;
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (r0 + u * lanes < rows) raw[u] = ldg(p + u * step);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[lane * CR + slot * V + j] = a1[j];
      s2[lane * CR + slot * V + j] = a2[j];
    }
  }
  __syncthreads();

  // 2. The block's sums a channel: its lanes in order, one shared-memory stage.
  const int64_t slab = static_cast<int64_t>(b) * ranges + range;
  float* mine = work + (slab * K + k) * 2 * CR;
  for (int c = threadIdx.x; c < CR; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t1 += s1[l * CR + c];
      t2 += s2[l * CR + c];
    }
    part[c] = t1;
    part[CR + c] = t2;
    if (K > 1) {
      mine[c] = t1;
      mine[CR + c] = t2;
    }
  }

  // 3. With K > 1, the last block of the slab to arrive takes over: the K
  // blocks' sums, in block order.
  if (K > 1) {
    __threadfence();  // this block's sums are visible before it counts itself
    __syncthreads();
    int last = 0;
    if (threadIdx.x == 0) {
      last = atomicAdd(arrivals + slab, 1u) == static_cast<unsigned>(K - 1);
      if (last) arrivals[slab] = 0;  // every block has counted itself
    }
    if (!__syncthreads_or(last)) return;
    __threadfence();
    const float* all = work + slab * K * 2 * CR;
    for (int c = threadIdx.x; c < CR; c += blockDim.x) {
      float t1 = 0.f, t2 = 0.f;
      for (int j = 0; j < K; ++j) {
        t1 += __ldcg(all + j * 2 * CR + c);
        t2 += __ldcg(all + j * 2 * CR + CR + c);
      }
      part[c] = t1;
      part[CR + c] = t2;
    }
  }
  __syncthreads();

  // 4. Each channel's mean and M2 over the slab's N rows.
  const float n = static_cast<float>(N);
  for (int c = threadIdx.x; c < CR; c += blockDim.x) {
    const float t1 = part[c], t2 = part[CR + c], m = t1 / n;
    part[c] = to_f(x0[c]) + m;
    part[CR + c] = fmaxf(0.f, fmaf(-t1, m, t2));
  }
  __syncthreads();

  // 5. Channels into groups, a warp a group, as the fused kernel's step 3.
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = wid; g < gpr; g += nwarps) {
    float sum = 0.f;
    for (int c = g * gs + lid; c < (g + 1) * gs; c += 32) sum += part[c];
    const float mu = warp_sum(sum) / gs;
    float q = 0.f;
    for (int c = g * gs + lid; c < (g + 1) * gs; c += 32) {
      const float d = part[c] - mu;
      q += fmaf(n * d, d, part[CR + c]);
    }
    q = warp_sum(q);
    if (lid == 0) {
      float* out = stats + (static_cast<int64_t>(b) * (C / gs) + range * gpr + g) * 3;
      out[0] = n * gs;
      out[1] = mu;
      out[2] = q;
    }
  }
}

// Chan's merge of S ranks' (count, mean, M2) of one group (rank s at p + s
// * stride), in rank order and in merge_group_stats's order of operations,
// each rounded on its own (no contraction), then rstd.
__device__ __forceinline__ void merge_parts(const float* p, int64_t stride, int S, float eps,
                                            float& mean, float& rstd) {
  float n = p[0], m2 = p[2];
  mean = p[1];
  for (int s = 1; s < S; ++s) {
    const float* q = p + s * stride;
    const float nb = q[0], mb = q[1], qb = q[2];
    const float tot = __fadd_rn(n, nb), d = __fsub_rn(mb, mean);
    mean = __fadd_rn(mean, __fmul_rn(d, __fdiv_rn(nb, tot)));
    m2 = __fadd_rn(m2, __fadd_rn(qb, __fmul_rn(__fmul_rn(d, d), __fdiv_rn(__fmul_rn(n, nb), tot))));
    n = tot;
  }
  rstd = rsqrtf(__fadd_rn(__fdiv_rn(m2, n), eps));
}

// Pass 1.  Grid (tiles, B): block (t, b) owns rows [t * tile_rows, (t + 1)
// * tile_rows) of batch item b, as `lanes` row lanes by C / V slots (item
// e: lane e / slots, slot e % slots; a thread takes items e, e +
// blockDim.x, ...).  While a thread's first kLoads rows load, the block
// merges the S ranks' partials of each group (a thread a group) into a
// table of G (mean, rstd) in shared memory; block 0 of each batch item
// also writes it to stats[B][G][2] when stats is not null.  An item then
// reads its slot's groups from the table and gamma and beta once, into
// registers (mean, scale = rstd * gamma, shift = beta a channel), and
// walks rows lane, lane + lanes, ... with the fused kernel's arithmetic.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)  // <= 64 registers
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ parts,
                const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ y,
                float* __restrict__ stats, int S, int N, int C, int G, int lanes, int tile_rows,
                float eps, int silu) {
  using R = typename Raw<T, V>::type;
  extern __shared__ __align__(16) float table[];  // [G][2] (mean, rstd)
  const int b = blockIdx.y, gs = C / G, slots = C / V, work = lanes * slots;
  const int row0 = blockIdx.x * tile_rows, rows = min(tile_rows, N - row0);
  const int64_t step = static_cast<int64_t>(lanes) * slots;  // in accesses of V elements
  const int64_t tile = (static_cast<int64_t>(b) * N + row0) * slots;
  R raw[kLoads];
  int e = threadIdx.x;
  if (e < work) {  // the first item's first rows load while the table is made
    const int lane = e / slots;
    const R* p = reinterpret_cast<const R*>(x) + tile + static_cast<int64_t>(lane) * slots +
                 (e - lane * slots);
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (lane + u * lanes < rows) raw[u] = ldg(p + u * step);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.y) * G * 3;  // one rank's partials
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float mu, rs;
    merge_parts(parts + (static_cast<int64_t>(b) * G + g) * 3, stride, S, eps, mu, rs);
    table[2 * g] = mu;
    table[2 * g + 1] = rs;
    if (stats != nullptr && blockIdx.x == 0) {
      stats[(static_cast<int64_t>(b) * G + g) * 2] = mu;
      stats[(static_cast<int64_t>(b) * G + g) * 2 + 1] = rs;
    }
  }
  __syncthreads();
  for (bool first = true; e < work; e += blockDim.x, first = false) {
    const int lane = e / slots, slot = e - lane * slots;
    const int64_t off = tile + static_cast<int64_t>(lane) * slots + slot;
    const R* p = reinterpret_cast<const R*>(x) + off;
    R* q = reinterpret_cast<R*>(y) + off;
    if (!first) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (lane + u * lanes < rows) raw[u] = ldg(p + u * step);
    }
    float mu[V], sc[V], sh[V];
    {
      const int c0 = slot * V;
      int g = c0 / gs, end = (g + 1) * gs;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (c0 + j >= end) {  // the vector crosses into the next group
          ++g;
          end += gs;
        }
        mu[j] = table[2 * g];
        sc[j] = table[2 * g + 1] * to_f(ldg(gamma + c0 + j));
        sh[j] = to_f(ldg(beta + c0 + j));
      }
    }
    for (int r0 = lane;;) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
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
      r0 += kLoads * lanes;
      p += kLoads * step;
      q += kLoads * step;
      if (r0 >= rows) break;
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (r0 + u * lanes < rows) raw[u] = ldg(p + u * step);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.

size_t smem_bytes(int rows_per, int CR, int lanes, int gpr, int cache, size_t elem) {
  const size_t cached = cache ? (static_cast<size_t>(rows_per) * CR * elem + 15) / 16 * 16 : 0;
  return cached + sizeof(float) * (2 * static_cast<size_t>(lanes) * CR + 2 * CR + 4 * gpr);
}

size_t partials_smem_bytes(int CR, int lanes) {
  return sizeof(float) * (2 * static_cast<size_t>(lanes) * CR + 2 * CR);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Once per process and instantiation.
template <typename T, int V>
cudaError_t allow_fused() {
  static const cudaError_t err = allow_smem(gn_cluster_kernel<T, V>);
  return err;
}
template <typename T, int V>
cudaError_t allow_partials() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gn_partials_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
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

template <typename T, int V>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, int B, int N,
                   int C, int G, int gpr, int K, int threads, int lanes, int cache, float eps,
                   int silu, cudaStream_t stream) {
  cudaError_t err = allow_fused<T, V>();
  if (err != cudaSuccess) return err;
  const int gs = C / G, rows_per = (N + K - 1) / K;
  const size_t smem = smem_bytes(rows_per, gpr * gs, lanes, gpr, cache, sizeof(T));
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(G / gpr, B, K, threads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, V>, static_cast<const T*>(x),
                           static_cast<const T*>(gamma), static_cast<const T*>(beta),
                           static_cast<T*>(y), N, C, gs, gpr, rows_per, lanes, cache, eps, silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_partials(const void* x, float* stats, float* work, unsigned* arrivals, int B,
                            int N, int C, int G, int gpr, int K, int threads, int lanes,
                            cudaStream_t stream) {
  cudaError_t err = allow_partials<T, V>();
  if (err != cudaSuccess) return err;
  const int gs = C / G, rows_per = (N + K - 1) / K;
  const size_t smem = partials_smem_bytes(gpr * gs, lanes);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  gn_partials_kernel<T, V><<<dim3((G / gpr) * K, B, 1), threads, smem, stream>>>(
      static_cast<const T*>(x), stats, work, arrivals, N, C, gs, gpr, K, rows_per, lanes);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const float* parts, const void* gamma, const void* beta,
                         void* y, float* stats, int S, int B, int N, int C, int G, int threads,
                         int lanes, int tile_rows, float eps, int silu, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_apply_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(G);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int tiles = (N + tile_rows - 1) / tile_rows;
  gn_apply_kernel<T, V><<<dim3(tiles, B, 1), threads, smem, stream>>>(
      static_cast<const T*>(x), parts, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), stats, S, N, C, G, lanes, tile_rows, eps,
      silu);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t active_blocks(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = per_sm * sms;
  return err;
}

template <typename Kernel>
cudaError_t active_clusters(Kernel kernel, int K, int threads, int smem, int* out) {
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, 1, K, threads, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// The shape and the vector path: C in G groups, vec 1 or 16 bytes' worth
// of elements (C and a range of gpr groups multiples of it, x 16-byte
// aligned).
bool valid_shape(int B, int N, int C, int G, int vec, int gpr, size_t elem, const void* x) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || G <= 0 || C % G || gpr <= 0 || G % gpr)
    return false;
  return vec == 1 || (vec * elem == 16 && C % vec == 0 && (gpr * (C / G)) % vec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

bool valid(int B, int N, int C, int G, int vec, int gpr, int K, int threads, int lanes,
           size_t elem, const void* x) {
  if (!valid_shape(B, N, C, G, vec, gpr, elem, x)) return false;
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
    return launch<float, 4>(x, gamma, beta, y, B, N, C, G, gpr, K, threads, lanes, cache, eps,
                            silu, st);
  if (dtype == 0)
    return launch<float, 1>(x, gamma, beta, y, B, N, C, G, gpr, K, threads, lanes, cache, eps,
                            silu, st);
  if (vec == 8)
    return launch<__nv_bfloat16, 8>(x, gamma, beta, y, B, N, C, G, gpr, K, threads, lanes, cache,
                                    eps, silu, st);
  return launch<__nv_bfloat16, 1>(x, gamma, beta, y, B, N, C, G, gpr, K, threads, lanes, cache,
                                  eps, silu, st);
}

// Pass 0 of a GroupNorm split across ranks: stats[B][G][3], the fp32
// count, mean and M2 of each group over x's N rows.  Ranges of gpr groups,
// K blocks a range splitting the rows, blocks of `threads` threads as
// `lanes` row lanes (any count) by gpr * (C / G) / vec slots
// (ops/groupnorm.py::partials_plan).  With K > 1: work, 2 * K * B * C
// floats of scratch, and arrivals, B * G / gpr counters that are 0 at the
// launch (and are 0 again after it).
extern "C" int sdbl_groupnorm_partials(const void* x, float* stats, float* work,
                                       unsigned* arrivals, int B, int N, int C, int G, int vec,
                                       int gpr, int K, int threads, int lanes, int dtype,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if ((dtype != 0 && dtype != 1) || !valid_shape(B, N, C, G, vec, gpr, elem, x))
    return cudaErrorInvalidValue;
  if (K < 1 || (K - 1) * ((N + K - 1) / K) >= N || threads < 32 || threads > kMaxThreads ||
      threads % 32 || lanes < 1 || static_cast<int64_t>(G / gpr) * K > 0x7fffffff ||
      (K > 1 && (work == nullptr || arrivals == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return launch_partials<float, 4>(x, stats, work, arrivals, B, N, C, G, gpr, K, threads,
                                     lanes, st);
  if (dtype == 0)
    return launch_partials<float, 1>(x, stats, work, arrivals, B, N, C, G, gpr, K, threads,
                                     lanes, st);
  if (vec == 8)
    return launch_partials<__nv_bfloat16, 8>(x, stats, work, arrivals, B, N, C, G, gpr, K,
                                             threads, lanes, st);
  return launch_partials<__nv_bfloat16, 1>(x, stats, work, arrivals, B, N, C, G, gpr, K, threads,
                                           lanes, st);
}

// Pass 1: y = (x - mean) * rstd * gamma + beta (then y * sigmoid(y) when
// silu), mean and rstd merged from parts[S][B][G][3] (every rank's count,
// mean, M2, in rank order) with eps; the merged [B][G][2] (mean, rstd)
// also into stats unless it is null.  x, y contiguous [B, N, C]; vec 16
// bytes' worth of elements (C a multiple, x and y 16-byte aligned) or 1;
// blocks of `threads` threads as `lanes` row lanes by C / vec slots over
// tiles of tile_rows rows (ops/groupnorm.py::apply_plan).
extern "C" int sdbl_groupnorm_apply(const void* x, const float* parts, const void* gamma,
                                    const void* beta, void* y, float* stats, int S, int B, int N,
                                    int C, int G, int vec, int threads, int lanes, int tile_rows,
                                    float eps, int silu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  if ((dtype != 0 && dtype != 1) || S < 1 || !valid_shape(B, N, C, G, vec, G, elem, x))
    return cudaErrorInvalidValue;
  if (vec != 1 && reinterpret_cast<uintptr_t>(y) % 16) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || lanes < 1 || tile_rows < 1 ||
      (N + static_cast<int64_t>(tile_rows) - 1) / tile_rows > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return launch_apply<float, 4>(x, parts, gamma, beta, y, stats, S, B, N, C, G, threads, lanes,
                                  tile_rows, eps, silu, st);
  if (dtype == 0)
    return launch_apply<float, 1>(x, parts, gamma, beta, y, stats, S, B, N, C, G, threads, lanes,
                                  tile_rows, eps, silu, st);
  if (vec == 8)
    return launch_apply<__nv_bfloat16, 8>(x, parts, gamma, beta, y, stats, S, B, N, C, G, threads,
                                          lanes, tile_rows, eps, silu, st);
  return launch_apply<__nv_bfloat16, 1>(x, parts, gamma, beta, y, stats, S, B, N, C, G, threads,
                                        lanes, tile_rows, eps, silu, st);
}

// How many clusters of K blocks of `threads` threads and `smem` bytes of
// dynamic shared memory the card can hold at once (cudaOccupancyMaxActiveClusters).
extern "C" int sdbl_groupnorm_active_clusters(int dtype, int vec, int K, int threads, int smem,
                                              int* out) {
  if (dtype == 0 && vec == 4)
    return active_clusters(gn_cluster_kernel<float, 4>, K, threads, smem, out);
  if (dtype == 0 && vec == 1)
    return active_clusters(gn_cluster_kernel<float, 1>, K, threads, smem, out);
  if (dtype == 1 && vec == 8)
    return active_clusters(gn_cluster_kernel<__nv_bfloat16, 8>, K, threads, smem, out);
  if (dtype == 1 && vec == 1)
    return active_clusters(gn_cluster_kernel<__nv_bfloat16, 1>, K, threads, smem, out);
  return cudaErrorInvalidValue;
}

// How many blocks of gn_partials_kernel of `threads` threads and `smem`
// bytes of dynamic shared memory the card can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs).
extern "C" int sdbl_groupnorm_partials_active_blocks(int dtype, int vec, int threads, int smem,
                                                     int* out) {
  if (dtype == 0 && vec == 4)
    return active_blocks(gn_partials_kernel<float, 4>, threads, smem, out);
  if (dtype == 0 && vec == 1)
    return active_blocks(gn_partials_kernel<float, 1>, threads, smem, out);
  if (dtype == 1 && vec == 8)
    return active_blocks(gn_partials_kernel<__nv_bfloat16, 8>, threads, smem, out);
  if (dtype == 1 && vec == 1)
    return active_blocks(gn_partials_kernel<__nv_bfloat16, 1>, threads, smem, out);
  return cudaErrorInvalidValue;
}

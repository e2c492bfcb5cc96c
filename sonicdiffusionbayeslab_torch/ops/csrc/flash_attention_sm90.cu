// bf16 softmax attention forward for Hopper (sm_90a): wgmma tensor cores,
// TMA loads, a warp-specialised K/V pipeline.  [B, N, H, D] in and out.
//
// Replaces the TPU kernels sonicdiffusionbayeslab_tpu/ops/flash_attention.py
// ::_attn_kernel (launched by _flash_bh) and _attn_kernel_native (launched
// by _flash_native) for bf16 inputs; flash_attention.cu keeps fp32.
//
// What bounds it: 4*B*H*N*M*D flops of two products and B*H*N*M
// exponentials against (q+k+v+o) bytes.  At the UNet's self-attention
// shapes the products are far above the card's ridge point, and at D=40
// the exponentials (special-function units, ~3.9e12/s on an H100 SXM) take
// longer than the products on the bf16 tensor cores.  So:
//   * both products run on the tensor cores through wgmma.mma_async:
//     S = Q.K^T as m64n{BK}k16 with Q and K read from shared memory
//     (K-major), O += P.V as m64n{DN}k16 with P in registers (the S
//     accumulator's layout is the A fragment's, so the bf16 conversion
//     happens in place) and V from shared memory read MN-major (the
//     descriptor's transpose bit);
//   * the softmax folds log2(e) into the scale and uses ex2.approx, and
//     keeps each thread's partial row sums until the end;
//   * each warpgroup issues tile t's Q.K^T together with tile t-1's P.V, and
//     runs the softmax of tile t while that P.V is in flight, so the tensor
//     cores and the special-function units work at the same time;
//   * one producer thread issues TMA loads (cp.async.bulk.tensor) from
//     tensor maps encoded on the host from the tensors' own strides, so
//     strided views of a fused projection go in without a copy; the Q tile
//     is loaded once per block and K/V tiles go through a three-stage ring in
//     shared memory with full/empty mbarriers, so the next tile's copy
//     overlaps this tile's math;
//   * one or two consumer warpgroups each own 64 query rows (the wrapper
//     picks 128 rows a block where the grid still fills the 132 SMs).
// head_dim is padded only in shared memory: the tensor map carries the true
// D, its box is 64 wide (one 128-byte swizzle atom), and TMA's
// out-of-bounds fill writes the zero columns.  Ragged N is zero-filled on
// load and clipped on store; ragged M (77-token context) gets -inf logits
// on the last K/V tile.
// Numerics follow the reference: fp32 logits scaled by D^-0.5, fp32
// softmax statistics, P rounded to bf16 before P.V, fp32 accumulation,
// bf16 output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int STAGES = 3;      // K/V ring depth
constexpr int ATOM = 64;       // bf16 columns of one 128-byte swizzle atom
constexpr int ROW_BYTES = 128;
constexpr int WG_ROWS = 64;    // query rows of one consumer warpgroup
constexpr int MAX_CONSUMERS = 2;

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box {64 columns, rows, 1, 1} of a 4-d tensor map at (d, n, h, b).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int n, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(n), "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  Offsets in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K/V rows a tile: the fp32 O accumulator grows with D, the S accumulator
// and the bf16 P fragment with this; all three are live at once.
constexpr int kv_rows(int dc) { return dc > 5 ? 64 : 128; }

// --------------------------------------------------------------- kernel
// DC = ceil(D / 16): the k16 steps of Q.K^T and the width DN = 16*DC of
// O += P.V.  KA = 64-column atoms per row.  BK = K/V rows per tile.
template <int DC>
struct Cfg {
  static constexpr int DN = 16 * DC;
  static constexpr int KA = (DC + 3) / 4;
  static constexpr int BK = kv_rows(DC);
  static constexpr int Q_SLAB = WG_ROWS * ROW_BYTES;           // one atom of one warpgroup's Q
  static constexpr int KV_SLAB = BK * ROW_BYTES;               // one atom of a K or V tile
  static constexpr int Q_BYTES = MAX_CONSUMERS * KA * Q_SLAB;
  static constexpr int STAGE_BYTES = 2 * KA * KV_SLAB;         // K then V
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;  // + alignment slack
};

template <int DC>
__global__ void __launch_bounds__(128 * (1 + MAX_CONSUMERS), 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int N, int M, int D,
    int64_t osb, int64_t osn, int64_t osh, float scale_log2) {
  using C = Cfg<DC>;
  constexpr int BK = C::BK, KA = C::KA, DN = C::DN;
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full[STAGES], empty[STAGES]
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + C::Q_BYTES;
  const uint32_t q_bar = smem_addr(&bars[0]);
  auto full_bar = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto empty_bar = [&](int s) { return smem_addr(&bars[1 + STAGES + s]); };
  auto k_slab = [&](int s, int a) { return kv_smem + s * C::STAGE_BYTES + a * C::KV_SLAB; };
  auto v_slab = [&](int s, int a) { return k_slab(s, a) + KA * C::KV_SLAB; };

  const int consumers = blockDim.x / 128 - 1;
  const int n0 = blockIdx.x * WG_ROWS * consumers, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (M + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4 * consumers);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, consumers * KA * C::Q_SLAB);
      for (int w = 0; w < consumers; ++w)
        for (int a = 0; a < KA; ++a)
          tma_load(q_smem + (w * KA + a) * C::Q_SLAB, &tq, q_bar, a * ATOM, n0 + w * WG_ROWS, h, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty_bar(s), ((t / STAGES) - 1) & 1);
        mbar_expect_tx(full_bar(s), C::STAGE_BYTES);
        for (int a = 0; a < KA; ++a) {
          tma_load(k_slab(s, a), &tk, full_bar(s), a * ATOM, t * BK, h, b);
          tma_load(v_slab(s, a), &tv, full_bar(s), a * ATOM, t * BK, h, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows n0 + 64w ... + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int quad_col = 2 * (lane % 4);
  const uint32_t q_wg = q_smem + w * KA * C::Q_SLAB;

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // S = Q K^T of tile t: DC k16 steps, the k-th 32 bytes into atom k/4.
  float sc[BK / 2];
  auto issue_qk = [&](int t) {
    const int s = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < DC; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      Wgmma<BK>::ss(sc, desc(q_wg + (kk / 4) * C::Q_SLAB + off, 16, 1024),
                    desc(k_slab(s, kk / 4) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t: BK/16 k16 steps, 16 rows (2048 bytes) of V apiece;
  // the next 64 columns of V are the next atom, KV_SLAB bytes on.
  uint32_t pa[BK / 16][4];
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DN>::rs(acc, pa[kk],
                    desc(v_slab(t % STAGES, 0) + kk * 16 * ROW_BYTES, C::KV_SLAB, 1024), 1);
    wgmma_commit();
  };
  // Online softmax of tile t's scores, in place: sc becomes the unnormalised
  // probabilities; corr rescales O.  Accumulator layout: sc[4j + e] is row
  // 16*warp + lane/4 (+8 for e >= 2), column 8j + 2*(lane%4) + (e&1).
  float corr[2];
  auto softmax = [&](int t) {
    if ((t + 1) * BK > M) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * BK + 8 * j + quad_col + (e & 1) >= M) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile has a valid key
      corr[r] = ex2((m_run[r] - m_new) * scale_log2);
      m_run[r] = m_new;
      mc[r] = m_new * scale_log2;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += sc[i];
    }
  };
  // P rounded to bf16, in the A-fragment layout of wgmma (that of sc).
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(t % STAGES));
  };
  auto wait_full = [&](int t) { mbar_wait(full_bar(t % STAGES), (t / STAGES) & 1); };

  // Tile t's scores are computed while the softmax units are idle (P V of
  // tile t-1 runs beside them), and each wait ends the stage whose
  // registers the next instructions touch: no register of a product in
  // flight is written, so the products stay asynchronous.
  mbar_wait(q_bar, 0);
  wait_full(0);
  fence_regs(sc);
  wgmma_fence();
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  pack();
  for (int t = 1; t < tiles; ++t) {
    wait_full(t);
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_qk(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // the scores of tile t
    fence_regs(sc);
    softmax(t);
    wgmma_wait<0>();  // O += P V of tile t-1
    fence_regs(acc);
    release(t - 1);
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    pack();
  }
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
  issue_pv(tiles - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  release(tiles - 1);

  // Epilogue: finish the row sums across the quad, normalise, store.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const int row0 = n0 + w * WG_ROWS + 16 * warp + lane / 4;
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = 8 * j + quad_col;
    if (8 * j >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = row0 + 8 * r;
      if (n < N)
        *reinterpret_cast<__nv_bfloat162*>(ob + n * osn + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ----------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver entry point: taken from the driver
// library that the CUDA runtime has already loaded, so the build links no
// libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A [B, L, H, D] bf16 view with element strides (sb, sl, sh) and a
// contiguous head_dim, cut into boxes of {64 columns, rows}.  Columns >= D
// and rows >= L read as zeros.
CUresult encode(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
                int64_t sb, int64_t sl, int64_t sh, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {ATOM, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  int B, N, M, H, D;
  int64_t os[3];
  float scale_log2;
  int consumers;
  cudaStream_t stream;
};

template <int DC>
cudaError_t launch(const Args& a) {
  auto kern = flash_fwd_sm90_kernel<DC>;
  static bool configured = false;  // once per instantiation in this process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<DC>::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int q_rows = WG_ROWS * a.consumers;
  const dim3 grid((a.N + q_rows - 1) / q_rows, a.H, a.B);
  kern<<<grid, 128 * (1 + a.consumers), Cfg<DC>::SMEM, a.stream>>>(
      a.tq, a.tk, a.tv, a.o, a.N, a.M, a.D, a.os[0], a.os[1], a.os[2], a.scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a) {
  switch ((a.D + 15) / 16) {
    case 1: return launch<1>(a);
    case 2: return launch<2>(a);
    case 3: return launch<3>(a);
    case 4: return launch<4>(a);
    case 5: return launch<5>(a);
    case 6: return launch<6>(a);
    case 7: return launch<7>(a);
    case 8: return launch<8>(a);
    case 9: return launch<9>(a);
    case 10: return launch<10>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 only.  Strides are in elements, for the batch, sequence and head
// axes; head_dim must be contiguous, D a multiple of 8 and at most 160,
// pointers 16-byte aligned and strides multiples of 8 elements (TMA's
// rules; the wrapper checks them).  q_rows: query rows a block, 64 or 128.
// Returns 0, a cudaError_t of the launch, or -CUresult when a tensor map
// cannot be encoded.
extern "C" int sdbl_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int B, int N, int M, int H, int D,
    int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn, int64_t ksh,
    int64_t vsb, int64_t vsn, int64_t vsh, int64_t osb, int64_t osn, int64_t osh,
    float scale, int q_rows, void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || N <= 0 || M <= 0 || B <= 0 || H <= 0 ||
      (q_rows != 64 && q_rows != 128))
    return cudaErrorInvalidValue;
  Args a{};
  const int rows_kv = kv_rows((D + 15) / 16);
  CUresult r;
  if ((r = encode(&a.tq, q, B, N, H, D, qsb, qsn, qsh, WG_ROWS)) != CUDA_SUCCESS) return -int(r);
  if ((r = encode(&a.tk, k, B, M, H, D, ksb, ksn, ksh, rows_kv)) != CUDA_SUCCESS) return -int(r);
  if ((r = encode(&a.tv, v, B, M, H, D, vsb, vsn, vsh, rows_kv)) != CUDA_SUCCESS) return -int(r);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.B = B, a.N = N, a.M = M, a.H = H, a.D = D;
  a.os[0] = osb, a.os[1] = osn, a.os[2] = osh;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.consumers = q_rows / WG_ROWS;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(a);
}

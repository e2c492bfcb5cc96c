// fp32 softmax attention forward for Hopper (sm_90a), [B, N, H, D] in and
// out, with both products on the tensor cores as split TF32 (3xTF32).
// bf16 inputs go to flash_attention_sm90.cu instead.
//
// Replaces the TPU kernel sonicdiffusionbayeslab_tpu/ops/flash_attention.py
// ::_attn_kernel (launched by _flash_bh) and its all-heads twin
// _attn_kernel_native (launched by _flash_native), in fp32.  The TPU kernel
// holds all of K/V for one (batch*head, 256-row query block) in VMEM and
// does a single softmax pass.  A block here has at most 227 KB of shared
// memory, so this kernel is an online-softmax (flash) loop over 64-key K/V
// tiles instead.
//
// What bounds it: the products.  4*B*H*N*M*D flops against (q+k+v+o)
// bytes is far above the card's ridge point at the UNet's shapes.  Plain
// fp32 FMA peaks at 67 TFLOP/s; TF32 on the tensor cores at 495, but a TF32
// operand keeps 10 mantissa bits (relative error ~4.9e-4), which fails the
// fp32 checks' 2e-5 + 1e-4|ref|.  Split TF32 takes each operand x as
// hi = tf32(x) and lo = x - hi and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (the two small terms first, as CUTLASS's 3xTF32 does), dropping only
// a_lo.b_lo, ~2^-22 relative: near fp32, at up to 495/3 = 165 TFLOP/s.  At
// D=40 each score feeds only 80 flops of products, so the per-score softmax
// (scale, max, exp2, sum, split of P) weighs more here than in bf16.
//
// The split.  hi is x rounded to nearest, ties away from zero, to TF32 (what
// cvt.rna.tf32.f32 gives for finite x) in two integer operations: cvt.rna
// compiles to four, with a check for special values.  lo = x - hi is exact
// in fp32 and goes to the mma as it is: the tensor core ignores a TF32
// operand's low 13 bits, so lo is truncated to TF32 there, within 2^-21 of
// x.  Splitting is a large share of the instructions (every K and V element
// once a warp, every P element once), and this ran faster than cvt.rna
// twice on an H100, at the same error.
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands from shared memory
// only K-major.  In O += P.V the B operand is V, which arrives [keys, D]
// with D contiguous (MN-major), so every V tile would need a transpose in
// shared memory (TMA cannot make the key axis innermost), and each of K and
// V its hi and lo copies in wgmma's swizzled layout.  Warp-level
// mma.sync.m16n8k8 takes its fragments from registers, loaded from shared
// memory in any layout and split into hi/lo in registers.
//
// Design.  One block per (64 MT query rows, head, batch): four warps, each
// owning MT m16 tiles of query rows; MT = 2 for D <= 40, so that each K/V
// fragment loaded and split feeds two products, else 1.  K/V tiles of 64
// keys go through a two-stage cp.async ring (16-byte copies, zero-filled
// past N and M), the next tile's copy in flight during this tile's
// products; Q is copied once.  Shared-memory rows are padded so that each
// warp's fragment loads hit 32 different banks.  Per tile and warp:
//   * S = Q.K^T: 8 n-tiles of 8 keys x D/8 k-steps x 3 mma an m-tile.
//     Q's hi/lo fragments stay in registers where MT = 1 and D <= 80, and
//     are split again from shared memory each tile otherwise.  Column n of
//     n-tile j is key 8j + n/2 + 4(n%2), so a thread's accumulator holds
//     keys 8j + t and 8j + t + 4 of its two rows: exactly its A fragment of
//     P for P.V, which therefore needs no shuffle and no staging in shared
//     memory.
//   * online softmax in base 2 (log2(e) D^-1/2 folded into one multiply),
//     row max across the four threads of a quad; each thread keeps its own
//     partial row sum, reduced once at the end;
//   * O = O corr + P.V: 8 k-steps x D/8 n-tiles x 3 mma an m-tile, V's B
//     fragments read straight from the [keys, D] tile.  The tensor cores
//     round their fp32 sums toward zero, so a chain of mma into one
//     accumulator drifts with its length (on an H100, 8e-5 off at
//     M = 4096, D = 40 when all of O's 1536 ran into it); each tile's P.V
//     is summed in fresh fragments (24 mma) and added to O in ordinary
//     fp32 arithmetic.
// The epilogue divides by the row sum and stores 8 bytes a thread, masked
// to N.  q, k and v are read through their strides (16-byte aligned rows,
// strides multiples of 4 elements; the wrapper checks).  No atomics: the
// same inputs give the same bits, strided or contiguous.
// Numerics follow the reference: logits scaled after the dot product, fp32
// softmax statistics, fp32 accumulation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // keys a K/V tile
constexpr int NT = 128;         // four warps
constexpr float LOG2E = 1.4426950408889634f;

// m16 tiles of query rows a warp.
__host__ __device__ constexpr int m_tiles(int D) { return D <= 40 ? 2 : 1; }
__host__ __device__ constexpr int block_rows(int D) { return 64 * m_tiles(D); }
// Row strides in shared memory, in floats.  Q and K fragments read 8 rows
// x 4 columns a warp, so their stride is 4 x an odd number; V fragments
// read 4 rows x 8 columns, so its stride is 8 modulo 16.  Both keep rows
// 16-byte aligned for cp.async.
__host__ __device__ constexpr int ldk(int D) { return D + 4; }
__host__ __device__ constexpr int ldv(int D) { return D % 16 == 8 ? D : D + 8; }
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(block_rows(D)) * ldk(D) + 2 * size_t(BK) * (ldk(D) + ldv(D)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ROWS rows from r0 of a [L, D] matrix with row stride sn (elements) into
// shared memory with row stride ld; rows at or past L are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int64_t sn,
                                          int r0, int L) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * C; i += NT) {
    const int r = i / C, c = i - r * C, n = r0 + r;
    const bool ok = n < L;
    cp_async16(dst + r * ld + c * 4, src + (ok ? n : 0) * sn + c * 4, ok);
  }
}

// hi: x rounded to nearest TF32, ties away from zero; lo = x - hi, whose
// low 13 bits the tensor core ignores.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (8 x 8) of a split operand: b0 = (hi, lo) of row t, b1 of
// row t+4.
struct BFrag {
  uint32_t h0, l0, h1, l1;
  __device__ __forceinline__ BFrag(float b0, float b1) {
    split(b0, h0, l0);
    split(b1, h1, l1);
  }
};

// c += a.b as split TF32: the two small cross terms, then hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const BFrag& b) {
  mma(c, al, b.h0, b.h1);
  mma(c, ah, b.l0, b.l1);
  mma(c, ah, b.h0, b.h1);
}

// The A fragment (16 rows x 8 columns) at column k0 of a row-major tile,
// split: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
__device__ __forceinline__ void load_a(const float* tile, int ld, int k0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = tile + g * ld + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int N, int M,
    int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn, int64_t ksh,
    int64_t vsb, int64_t vsn, int64_t vsh, int64_t osb, int64_t osn, int64_t osh,
    float scale_log2) {
  constexpr int KD = D / 8;  // k-steps of Q.K^T; n-tiles of P.V
  constexpr int MT = m_tiles(D), BQ = block_rows(D);
  constexpr int LDK = ldk(D), LDV = ldv(D);
  constexpr bool Q_IN_REGS = MT == 1 && D <= 80;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BQ][LDK]
  float* Ks = Qs + BQ * LDK;       // [2][BK][LDK]
  float* Vs = Ks + 2 * BK * LDK;   // [2][BK][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  const float* Qw = Qs + warp * MT * 16 * LDK;  // this warp's query rows
  const int tiles = (M + BK - 1) / BK;

  load_rows<D, BQ>(Qs, LDK, qb, qsn, q0, N);
  load_rows<D, BK>(Ks, LDK, kb, ksn, 0, M);
  load_rows<D, BK>(Vs, LDV, vb, vsn, 0, M);
  cp_async_commit();

  uint32_t qh[Q_IN_REGS ? KD : 1][4], ql[Q_IN_REGS ? KD : 1][4];
  float acc[MT][KD][4];
  float m_r[MT][2], l_r[MT][2];  // running max (base 2) of rows g, g+8; this thread's part of their sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m_r[mt][0] = m_r[mt][1] = -INFINITY;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  const int krow = (g >> 1) + 4 * (g & 1);  // key of S column g in an n-tile

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {  // tile j+1 into the stage that tile j-1 left
      const int st = (j + 1) & 1;
      load_rows<D, BK>(Ks + st * BK * LDK, LDK, kb, ksn, (j + 1) * BK, M);
      load_rows<D, BK>(Vs + st * BK * LDV, LDV, vb, vsn, (j + 1) * BK, M);
    }
    cp_async_commit();  // possibly empty: one group an iteration
    cp_async_wait_all_but_one();  // tile j (and Q) have landed
    __syncthreads();
    const float* Kt = Ks + (j & 1) * BK * LDK;
    const float* Vt = Vs + (j & 1) * BK * LDV;
    if constexpr (Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) load_a(Qw, LDK, kk * 8, g, t, qh[kk], ql[kk]);
      }
    }

    // S = Q.K^T on this warp's rows x 64 keys.
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[mt][e] = qh[kk][e], al[mt][e] = ql[kk][e];
        } else {
          load_a(Qw + mt * 16 * LDK, LDK, kk * 8, g, t, ah[mt], al[mt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = Kt + (nt * 8 + krow) * LDK + kk * 8 + t;
        const BFrag bf(kr[0], kr[4]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(s[mt][nt], ah[mt], al[mt], bf);
      }
    }

    // Online softmax.  s[mt][nt][e] is row g (e < 2) or g+8 of m-tile mt,
    // key j*BK + 8nt + t + 4(e&1).  Every tile starts at a valid key
    // (j*BK < M), and each row holds that key, so each row's max is finite.
    const bool ragged = (j + 1) * BK > M;
    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m_r[mt][0], m_r[mt][1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][nt][e] * scale_log2;
          if (ragged && j * BK + nt * 8 + t + 4 * (e & 1) >= M) x = -INFINITY;
          s[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[mt][r] = exp2f(m_r[mt][r] - mx[r]);  // 0 on the first tile
        m_r[mt][r] = mx[r];
        l_r[mt][r] *= corr[mt][r];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[mt][nt][e] - m_r[mt][e >> 1]);
          l_r[mt][e >> 1] += p;
          s[mt][nt][e] = p;
        }
    }

    // O = O corr + P.V: k-step nt takes keys 8nt .. 8nt+7 of the tile,
    // whose P fragment is S's n-tile nt as it lies in the accumulator.  The
    // tile's product is summed in fresh fragments (see the header).
    float pv[MT][KD][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(s[mt][nt][0], ph[mt][0], pl[mt][0]);  // row g,   key t
        split(s[mt][nt][2], ph[mt][1], pl[mt][1]);  // row g+8, key t
        split(s[mt][nt][1], ph[mt][2], pl[mt][2]);  // row g,   key t+4
        split(s[mt][nt][3], ph[mt][3], pl[mt][3]);  // row g+8, key t+4
      }
      const float* vr = Vt + (nt * 8 + t) * LDV + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        const BFrag bf(vr[n * 8], vr[4 * LDV + n * 8]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(pv[mt][n], ph[mt], pl[mt], bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][n][e] = fmaf(acc[mt][n][e], corr[mt][e >> 1], pv[mt][n][e]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int n = q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (n >= N) continue;
      float* orow = ob + n * osn + 2 * t;
#pragma unroll
      for (int c = 0; c < KD; ++c)
        *reinterpret_cast<float2*>(orow + c * 8) =
            make_float2(acc[mt][c][2 * r] * inv, acc[mt][c][2 * r + 1] * inv);
    }
}

struct Args {
  const float *q, *k, *v;
  float* o;
  int B, N, M, H;
  int64_t qs[3], ks[3], vs[3], os[3];
  float scale_log2;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes(D);
  auto kern = flash_fwd_tf32x3_kernel<D>;
  // Raise the dynamic shared memory limit once per instantiation in this
  // process (one device), so that later launches, and CUDA graph captures,
  // are kernel launches only.
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.N + block_rows(D) - 1) / block_rows(D), a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(a.q, a.k, a.v, a.o, a.N, a.M,
                                     a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
                                     a.vs[0], a.vs[1], a.vs[2], a.os[0], a.os[1], a.os[2],
                                     a.scale_log2);
  return cudaGetLastError();
}

static_assert(smem_bytes(160) <= 232448, "D=160 must fit one block's shared memory");

cudaError_t dispatch(const Args& a, int D) {
  switch (D / 8) {
#define SDBL_CASE(n) case n: return launch<8 * n>(a);
    SDBL_CASE(1) SDBL_CASE(2) SDBL_CASE(3) SDBL_CASE(4) SDBL_CASE(5)
    SDBL_CASE(6) SDBL_CASE(7) SDBL_CASE(8) SDBL_CASE(9) SDBL_CASE(10)
    SDBL_CASE(11) SDBL_CASE(12) SDBL_CASE(13) SDBL_CASE(14) SDBL_CASE(15)
    SDBL_CASE(16) SDBL_CASE(17) SDBL_CASE(18) SDBL_CASE(19) SDBL_CASE(20)
#undef SDBL_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 only.  Strides are in elements, for the batch, sequence and head
// axes; the head_dim axis must be contiguous, pointers 16-byte aligned and
// strides multiples of 4 elements.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int sdbl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int N, int M, int H, int D,
    int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn, int64_t ksh,
    int64_t vsb, int64_t vsn, int64_t vsh, int64_t osb, int64_t osn, int64_t osh,
    float scale, void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<float*>(o), B, N, M, H,
         {qsb, qsn, qsh}, {ksb, ksn, ksh}, {vsb, vsn, vsh}, {osb, osn, osh},
         scale * LOG2E, static_cast<cudaStream_t>(stream)};
  return dispatch(a, D);
}

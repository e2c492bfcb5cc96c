// fp32 softmax attention forward for Hopper (sm_90a), [B, N, H, D] in and
// out.  bf16 inputs go to flash_attention_sm90.cu instead.
//
// Replaces the TPU kernel sonicdiffusionbayeslab_tpu/ops/flash_attention.py
// ::_attn_kernel (launched by _flash_bh) and its all-heads twin
// _attn_kernel_native (launched by _flash_native), in fp32.  The TPU kernel
// holds all of K/V for one (batch*head, 256-row query block) in VMEM and
// does a single softmax pass.  On an H100 a block has at most 227 KB of shared memory,
// while K+V at N=4096, D=40 are 640 KB in bf16, so this kernel is an
// online-softmax (flash) loop over 64-row K/V tiles instead.
//
// What bounds it: the work is 4*B*H*N*M*D flops against (q+k+v+o) bytes,
// far above the H100's ridge point at the UNet's shapes.  The products run
// as plain fp32 FMA on register micro-tiles (each of 256 threads owns a 4x4
// block of the 64x64 score tile and a 4 x ceil(D/16) block of the output),
// at most 67 TFLOP/s: the fp32 checks' tolerances would not survive TF32
// tensor cores.  What the design gets right:
//   * q, k, v are read in place through their strides (no transposed or
//     padded copy in device memory); head_dim is padded only in shared memory;
//   * each input element is read from device memory once per query tile and
//     the fp32 score tile never leaves the SM;
//   * ragged N is masked on load/store and ragged M (77-token context) by
//     -inf logits on the last K/V tile.
// Numerics follow the reference: fp32 logits scaled after the dot product,
// fp32 softmax statistics, fp32 accumulation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key/value rows per tile
constexpr int NT = 256;        // threads per block: 16 x 16
constexpr int LDT = BQ + 4;    // row stride of the transposed Q/K/P tiles

// DC = output columns per thread = ceil(D / 16).
template <int DC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int N, int M, int D,
    int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn, int64_t ksh,
    int64_t vsb, int64_t vsn, int64_t vsh, int64_t osb, int64_t osn, int64_t osh,
    float scale) {
  constexpr int DV = DC * 16;  // padded V row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [D][LDT]  Q tile, transposed
  float* Ks = Qs + D * LDT;     // [D][LDT]  K tile, transposed
  float* Vs = Ks + D * LDT;     // [BK][DV]  V tile
  float* Ps = Vs + BK * DV;     // [BK][LDT] probabilities, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  float* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D, n = q0 + r;
    Qs[d * LDT + r] = n < N ? qb[n * qsn + d] : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D, n = k0 + r;
      Ks[d * LDT + r] = n < M ? kb[n * ksn + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int r = i / DV, d = i - r * DV, n = k0 + r;
      Vs[i] = (n < M && d < D) ? vb[n * vsn + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T on this thread's 4 rows x 4 columns.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // Online softmax.  Every tile starts at a valid key (k0 < M), so each
    // row's max over the tile is finite.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        s[i][j] = col < M ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = __expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V on this thread's 4 rows x DC columns (tx, tx+16, ...).
    const int kv = min(BK, M - k0);
    for (int r = 0; r < kv; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[r * LDT + ty * 4]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[r * DV + tx + 16 * c];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[n * osn + col] = acc[i][c] * inv;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, N, M, H, D;
  int64_t qs[3], ks[3], vs[3], os[3];
  float scale;
  cudaStream_t stream;
};

template <int DC>
cudaError_t launch(const Args& a) {
  constexpr int DV = DC * 16;
  const size_t smem = sizeof(float) * (2 * a.D * LDT + BK * DV + BK * LDT);
  auto kern = flash_fwd_kernel<DC>;
  // Raise the dynamic shared memory limit once per instantiation in this
  // process (one device), to what its largest head_dim (DV) needs, so that
  // later launches, and CUDA graph captures, are kernel launches only.
  static bool configured = false;
  if (!configured) {
    const size_t smem_max = sizeof(float) * (2 * DV * LDT + BK * DV + BK * LDT);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_max));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.N + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.N, a.M, a.D,
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
      a.vs[0], a.vs[1], a.vs[2], a.os[0], a.os[1], a.os[2], a.scale);
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

// float32 only.  Strides are in elements, for the batch, sequence and head
// axes; the head_dim axis must be contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sdbl_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int N, int M, int H, int D,
    int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn, int64_t ksh,
    int64_t vsb, int64_t vsn, int64_t vsh, int64_t osb, int64_t osn, int64_t osh,
    float scale, void* stream) {
  if (D <= 0 || D > 160 || D % 8 != 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, B, N, M, H, D,
         {qsb, qsn, qsh}, {ksb, ksn, ksh}, {vsb, vsn, vsh}, {osb, osn, osh},
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a);
}

// K2: flash self-attention backward over [BH, N, D] bf16.
//
// Replaces guided_attention_tpu/ops/flash_attention.py `_self_bwd` /
// `_self_bwd_kernel` (custom VJP `_flash_bh_bwd`). The TPU kernel summed dK
// and dV in fp32 across SEQUENTIAL q-block grid steps into one output block.
// CUDA blocks run in parallel and in no order, so there is no such carry;
// the work is split into three passes, none with atomics (results do not
// change from run to run):
//   1. delta = rowsum(dO * O), which equals rowsum(dP * P);
//   2. a key-tile parallel pass: each block owns 64 keys, keeps their dK and
//      dV in fp32 WMMA accumulators, and loops over every query tile,
//      recomputing P^T = exp(K Q^T * scale - lse) from K1's saved logsumexp;
//   3. a query-tile parallel pass for dQ, recomputing P the same way.
// With dS = P * (dP - delta) * scale: dV = P^T dO, dK = dS^T Q, dQ = dS K.
//
// Bound on the H100: 10*N^2*D operations per (b, h) on the bf16 tensor cores
// (S, dP, dV, dK, dQ); passes 2 and 3 each recompute S and dP, 14*N^2*D in
// all, traded for having no cross-block reduction. All products run on the
// tensor cores; P and dS are rounded to bf16 for their products, as in
// FlashAttention-2.
#include "common.cuh"

using namespace nvcuda;

namespace ga {
namespace {

constexpr int BT = 64;      // rows per tile (keys in pass 2, queries in pass 3)
constexpr int WARPS = 4;    // each warp owns 16 rows of the block's tile
constexpr int SP = BT + 4;  // fp32 scratch row stride
constexpr int PP = BT + 8;  // bf16 scratch row stride

__global__ void delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
                             int rows, int d) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const bf16* a = o + (size_t)r * d;
  const bf16* b = dout + (size_t)r * d;
  float s = 0.f;
  for (int c = 0; c < d; ++c) s += __bfloat162float(a[c]) * __bfloat162float(b[c]);
  delta[r] = s;
}

template <int DP>
struct BwdSmem {
  static constexpr int own0 = 0;  // the block's own rows (K or Q)
  static constexpr int own1 = own0 + align128(BT * DP * 2);  // (V or dO)
  static constexpr int oth0 = own1 + align128(BT * DP * 2);  // streamed tile (Q or K)
  static constexpr int oth1 = oth0 + align128(BT * DP * 2);  // (dO or V)
  static constexpr int s_off = oth1 + align128(BT * DP * 2);  // fp32 [WARPS][16][SP]
  static constexpr int dp_off = s_off + align128(WARPS * 16 * SP * 4);
  static constexpr int p_off = dp_off + align128(WARPS * 16 * SP * 4);  // bf16 [WARPS][16][PP]
  static constexpr int ds_off = p_off + align128(WARPS * 16 * PP * 2);
  static constexpr int row_off = ds_off + align128(WARPS * 16 * PP * 2);  // fp32 lse[BT], delta[BT]
  static constexpr int bytes = row_off + align128(2 * BT * 4);
  static_assert(DP + 4 <= SP, "a warp's 16 x (DP+4) accumulator staging must fit its score scratch");
};

// C[16 x BT] = A[16 x DP] (row-major, lda) * B^T where B is [BT x DP] row-major
template <int DP>
__device__ __forceinline__ void mm_abt(float* c, const bf16* a, int lda, const bf16* b, int ldb) {
#pragma unroll
  for (int nt = 0; nt < BT / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + nt * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, SP, wmma::mem_row_major);
  }
}

// acc[dt] += A[16 x BT] (bf16, row stride PP) * B[BT x DP] (row-major, ldb)
template <int DP>
__device__ __forceinline__ void mm_acc(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[DP / 16],
                                       const bf16* a, const bf16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, PP);
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + dt * 16, ldb);
      wmma::mma_sync(acc[dt], fa, fb, acc[dt]);
    }
  }
}

// Write a warp's 16 x DP fp32 accumulators as bf16 rows [row0, row0+16) of out.
template <int DP>
__device__ __forceinline__ void store_rows(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[DP / 16],
                                           float* stage, bf16* out, int row0, int n, int d, int lane) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) wmma::store_matrix_sync(stage + dt * 16, acc[dt], LD, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * d; idx += 32) {
    const int r = idx / d;
    const int c = idx - r * d;
    if (row0 + r < n) out[(size_t)(row0 + r) * d + c] = __float2bfloat16(stage[r * LD + c]);
  }
}

// Pass 2: dK, dV for one 64-key tile.
template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
    dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int d, float scale, float scale_log2) {
  using L = BwdSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::own0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::own1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::oth0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::oth1);
  float* lse_s = reinterpret_cast<float*>(smem + L::row_off);
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * d;
  float* St = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * SP;
  float* dPt = reinterpret_cast<float*>(smem + L::dp_off) + warp * 16 * SP;
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::p_off) + warp * 16 * PP;
  bf16* dSt = reinterpret_cast<bf16*>(smem + L::ds_off) + warp * 16 * PP;

  zero_smem(smem, L::s_off);
  __syncthreads();
  load_rows(Ks, DP, k + base, k0, BT, n, d);
  load_rows(Vs, DP, v + base, k0, BT, n, d);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[DP / 16], acc_dv[DP / 16];
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) {
    wmma::fill_fragment(acc_dk[dt], 0.f);
    wmma::fill_fragment(acc_dv[dt], 0.f);
  }

  const int r_local = lane / 2;
  const int half = lane & 1;
  for (int q0 = 0; q0 < n; q0 += BT) {
    __syncthreads();
    load_rows(Qs, DP, q + base, q0, BT, n, d);
    load_rows(dOs, DP, dout + base, q0, BT, n, d);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const bool ok = q0 + i < n;
      // a padded query row gets lse = +inf, so its P (and dS) are exactly 0
      lse_s[i] = ok ? lse[(size_t)bh * n + q0 + i] * kLog2e : INFINITY;
      delta_s[i] = ok ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    __syncthreads();

    mm_abt<DP>(St, Ks + warp * 16 * DP, DP, Qs, DP);    // S^T  = K_w Q^T
    mm_abt<DP>(dPt, Vs + warp * 16 * DP, DP, dOs, DP);  // dP^T = V_w dO^T
    __syncwarp();
    {
      const int cbase = half * (BT / 2);
#pragma unroll 8
      for (int c = 0; c < BT / 2; ++c) {
        const int j = cbase + c;
        const float p = exp2f(St[r_local * SP + j] * scale_log2 - lse_s[j]);
        const float ds = p * (dPt[r_local * SP + j] - delta_s[j]) * scale;
        Pt[r_local * PP + j] = __float2bfloat16(p);
        dSt[r_local * PP + j] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_acc<DP>(acc_dv, Pt, dOs, DP);  // dV_w += P^T dO
    mm_acc<DP>(acc_dk, dSt, Qs, DP);  // dK_w += dS^T Q
  }

  // stage through this warp's fp32 scratch (16 x (DP+4) fits in 16 x SP)
  store_rows<DP>(acc_dk, St, dk + base, k0 + warp * 16, n, d, lane);
  __syncwarp();
  store_rows<DP>(acc_dv, St, dv + base, k0 + warp * 16, n, d, lane);
}

// Pass 3: dQ for one 64-query tile.
template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int n, int d, float scale, float scale_log2) {
  using L = BwdSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::own0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::own1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::oth0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::oth1);
  float* lse_s = reinterpret_cast<float*>(smem + L::row_off);
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * d;
  float* S = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * SP;
  float* dP = reinterpret_cast<float*>(smem + L::dp_off) + warp * 16 * SP;
  bf16* dS = reinterpret_cast<bf16*>(smem + L::ds_off) + warp * 16 * PP;

  zero_smem(smem, L::s_off);
  __syncthreads();
  load_rows(Qs, DP, q + base, q0, BT, n, d);
  load_rows(dOs, DP, dout + base, q0, BT, n, d);
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    const bool ok = q0 + i < n;
    lse_s[i] = ok ? lse[(size_t)bh * n + q0 + i] * kLog2e : INFINITY;
    delta_s[i] = ok ? delta[(size_t)bh * n + q0 + i] : 0.f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dq[DP / 16];
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) wmma::fill_fragment(acc_dq[dt], 0.f);

  const int r_local = lane / 2;
  const int half = lane & 1;
  const int row = warp * 16 + r_local;
  for (int k0 = 0; k0 < n; k0 += BT) {
    __syncthreads();
    load_rows(Ks, DP, k + base, k0, BT, n, d);
    load_rows(Vs, DP, v + base, k0, BT, n, d);
    __syncthreads();

    mm_abt<DP>(S, Qs + warp * 16 * DP, DP, Ks, DP);    // S  = Q_w K^T
    mm_abt<DP>(dP, dOs + warp * 16 * DP, DP, Vs, DP);  // dP = dO_w V^T
    __syncwarp();
    {
      const float l2 = lse_s[row];
      const float dl = delta_s[row];
      const int cbase = half * (BT / 2);
#pragma unroll 8
      for (int c = 0; c < BT / 2; ++c) {
        const int j = cbase + c;
        const float p = (k0 + j < n) ? exp2f(S[r_local * SP + j] * scale_log2 - l2) : 0.f;
        dS[r_local * PP + j] = __float2bfloat16(p * (dP[r_local * SP + j] - dl) * scale);
      }
    }
    __syncwarp();
    mm_acc<DP>(acc_dq, dS, Ks, DP);  // dQ_w += dS K
  }
  store_rows<DP>(acc_dq, S, dq + base, q0 + warp * 16, n, d, lane);
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout, const float* lse,
                   float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int d, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = BwdSmem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = bh * n;
  delta_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(o, dout, delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((n + BT - 1) / BT, bh);
  const float scale_log2 = scale * kLog2e;
  dkdv_kernel<DP><<<grid, WARPS * 32, bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv, n, d, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<grid, WARPS * 32, bytes, stream>>>(q, k, v, dout, lse, delta, dq, n, d, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ga

extern "C" int ga_flash_self_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int n, int d,
                                 float scale, void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto args = [&](auto launch_fn) {
    return launch_fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                     static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                     static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), bh, n, d, scale, static_cast<cudaStream_t>(stream));
  };
  // the presets' head dims: 40 (SD1.5, padded to 48) and 64 (SD2.1)
  switch (d) {
    case 40: return (int)args(ga::launch<48>);
    case 64: return (int)args(ga::launch<64>);
    default: return (int)cudaErrorInvalidValue;
  }
}

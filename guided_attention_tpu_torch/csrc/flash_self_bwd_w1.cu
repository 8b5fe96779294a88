// W1: self-attention backward from (q, k, v, dO) alone, [BH, N, 40] bf16.
//
// Replaces scripts/perf_attn_kernel.py `bwd_w1` / `_bwd_kernel_w1`, a
// microbench variant of K2 that takes no saved output or logsumexp: it
// recomputes the row maximum and sum itself, takes delta = rowsum(dP * P)
// with dP = dO V^T from bf16 operands, rounds P and dS = P (dP - delta) scale
// to bf16 for the three gradient products, and returns dQ in bf16 and dK,
// dV in fp32.
//
// The TPU kernel ran a grid of query blocks in order and summed dK/dV in
// fp32 into one output block across those sequential steps. CUDA blocks run
// in parallel and in no order. This kernel keeps the TPU's query-tile grid
// and adds each block's dK/dV contributions into the fp32 outputs with
// reductions in L2 (atomicAdd on float4: one 16-byte reduction on sm_90):
// one launch, no second pass over the keys for dK/dV and no scratch, at the
// price of a summation order that changes from run to run (W1 is a
// microbench kernel, not on the generation path; K2 stays deterministic).
// Each block owns 64 query rows and walks the keys twice:
//   1. row statistics: S = Q K^T and dP = dO V^T per 64-key tile, with an
//      online maximum m, sum l = sum exp(s - m) and u = sum exp(s - m) dP,
//      so delta = u / l at the end, all in fp32;
//   2. gradients: S and dP again, P = exp(s - m) / l, dS; dQ += dS K stays
//      in WMMA accumulators; the tile's dV = P^T dO and dK = dS^T Q (each
//      warp 16 keys) are added to the outputs.
//
// Bound on the H100: 10*N^2*D operations per (b, h) on the bf16 tensor cores
// (S, dP, dV, dK, dQ); the statistics pass recomputes S and dP, 14*N^2*D in
// all, as in K2's three passes. The reductions add 2*N^2*D/64 fp32 values per
// (b, h) into L2.
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace ga {
namespace {

constexpr int D = 40;   // the only head dim
constexpr int DP = 48;  // D padded to a multiple of 16
constexpr int BT = 64;  // queries per block, keys per tile
constexpr int WARPS = 4;
constexpr int SP = BT + 4;  // fp32 scratch row stride
constexpr int PP = BT + 8;  // bf16 scratch row stride
constexpr int LD = DP + 4;  // fp32 staging row stride of a 16 x DP accumulator

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct W1Smem {
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + align128(BT * DP * 2);
  static constexpr int k_off = do_off + align128(BT * DP * 2);
  static constexpr int v_off = k_off + align128(BT * DP * 2);
  static constexpr int s_off = v_off + align128(BT * DP * 2);  // fp32 [WARPS][16][SP]
  static constexpr int dp_off = s_off + align128(BT * SP * 4);
  static constexpr int p_off = dp_off + align128(BT * SP * 4);  // bf16 [BT][PP], whole block
  static constexpr int ds_off = p_off + align128(BT * PP * 2);
  static constexpr int bytes = ds_off + align128(BT * PP * 2);
  static_assert(LD <= SP, "a warp's 16 x LD staging must fit its 16 x SP score scratch");
};

// C[16 x BT] (row stride SP) = A[16 x DP] * B^T, A and B row-major with stride DP
__device__ __forceinline__ void mm_abt(float* c, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < BT / 16; ++nt) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, DP);
      wmma::load_matrix_sync(fb, b + nt * 16 * DP + kk * 16, DP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, SP, wmma::mem_row_major);
  }
}

// acc[dt] += A * B[BT x DP] (row-major, stride DP), A 16 x BT in bf16: the
// rows of a row-major [BT][PP] matrix (A_T false) or the transpose of 16 of
// its columns (A_T true; a points at the first column)
template <bool A_T>
__device__ __forceinline__ void mm_acc(Acc (&acc)[DP / 16], const bf16* a, const bf16* b) {
  using Layout = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout> fa;
    wmma::load_matrix_sync(fa, A_T ? a + kk * 16 * PP : a + kk * 16, PP);
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * DP + dt * 16, DP);
      wmma::mma_sync(acc[dt], fa, fb, acc[dt]);
    }
  }
}

__device__ __forceinline__ void stage(Acc (&acc)[DP / 16], float* st) {
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) wmma::store_matrix_sync(st + dt * 16, acc[dt], LD, wmma::mem_row_major);
}

// out rows [row0, row0 + 16) (fp32, stride D) += st[16 x D] (stride LD)
__device__ __forceinline__ void add_rows(float* __restrict__ out, const float* st, int row0, int n, int lane) {
  constexpr int V = D / 4;  // float4 per row
  for (int idx = lane; idx < 16 * V; idx += 32) {
    const int r = idx / V;
    const int c = (idx - r * V) * 4;
    if (row0 + r < n) {
      const float* s = st + r * LD + c;
      // 16-byte aligned: D % 4 == 0 and c % 4 == 0
      atomicAdd(reinterpret_cast<float4*>(out + (size_t)(row0 + r) * D + c), make_float4(s[0], s[1], s[2], s[3]));
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    flash_self_bwd_w1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, int n, float scale, float scale_log2) {
  using L = W1Smem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * D;
  float* S = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * SP;
  float* dP = reinterpret_cast<float*>(smem + L::dp_off) + warp * 16 * SP;

  zero_smem(smem, L::s_off);  // the padding columns of Q, dO, K, V
  __syncthreads();
  load_rows(Qs, DP, q + base, q0, BT, n, D);
  load_rows(dOs, DP, dout + base, q0, BT, n, D);

  // row state: lanes 2r and 2r+1 of a warp own query row 16*warp + r, each
  // half of the tile's columns
  const int r_local = lane / 2;
  const int half = lane & 1;
  const int row = warp * 16 + r_local;
  const int cbase = half * (BT / 2);
  const bool row_ok = q0 + row < n;

  // ---- 1. row statistics (base-2 exponent, scale applied to the fp32 score)
  float m_run = -INFINITY, l_run = 0.f, u_run = 0.f;
  for (int k0 = 0; k0 < n; k0 += BT) {
    __syncthreads();
    load_rows(Ks, DP, k + base, k0, BT, n, D);
    load_rows(Vs, DP, v + base, k0, BT, n, D);
    __syncthreads();
    mm_abt(S, Qs + warp * 16 * DP, Ks);    // S  = Q_w K^T
    mm_abt(dP, dOs + warp * 16 * DP, Vs);  // dP = dO_w V^T
    __syncwarp();
    const float* srow = S + r_local * SP + cbase;
    const float* dprow = dP + r_local * SP + cbase;
    const int kbase = k0 + cbase;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < BT / 2; ++c) {
      if (kbase + c < n) mx = fmaxf(mx, srow[c] * scale_log2);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f, usum = 0.f;
#pragma unroll 8
    for (int c = 0; c < BT / 2; ++c) {
      const float e = (kbase + c < n) ? exp2f(srow[c] * scale_log2 - m_new) : 0.f;
      sum += e;
      usum += e * dprow[c];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    usum += __shfl_xor_sync(0xffffffffu, usum, 1);
    const float alpha = exp2f(m_run - m_new);
    l_run = l_run * alpha + sum;
    u_run = u_run * alpha + usum;
    m_run = m_new;
  }
  const float inv_l = 1.f / l_run;
  const float delta = u_run * inv_l;

  // ---- 2. gradients
  Acc acc_dq[DP / 16], acc_dk[DP / 16], acc_dv[DP / 16];
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) wmma::fill_fragment(acc_dq[dt], 0.f);

  for (int k0 = 0; k0 < n; k0 += BT) {
    __syncthreads();  // the previous tile's P, dS, K and V fully consumed
    load_rows(Ks, DP, k + base, k0, BT, n, D);
    load_rows(Vs, DP, v + base, k0, BT, n, D);
    __syncthreads();
    mm_abt(S, Qs + warp * 16 * DP, Ks);
    mm_abt(dP, dOs + warp * 16 * DP, Vs);
    __syncwarp();
    {
      const float* srow = S + r_local * SP + cbase;
      const float* dprow = dP + r_local * SP + cbase;
      const int kbase = k0 + cbase;
#pragma unroll 8
      for (int c = 0; c < BT / 2; ++c) {
        const float p = (row_ok && kbase + c < n) ? exp2f(srow[c] * scale_log2 - m_run) * inv_l : 0.f;
        Ps[row * PP + cbase + c] = __float2bfloat16(p);
        dSs[row * PP + cbase + c] = __float2bfloat16(p * (dprow[c] - delta) * scale);
      }
    }
    __syncthreads();  // P and dS of all 64 query rows in place

    mm_acc<false>(acc_dq, dSs + warp * 16 * PP, Ks);  // dQ_w += dS_w K
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fill_fragment(acc_dv[dt], 0.f);
      wmma::fill_fragment(acc_dk[dt], 0.f);
    }
    mm_acc<true>(acc_dv, Ps + warp * 16, dOs);  // dV[keys of warp w] = P^T dO
    mm_acc<true>(acc_dk, dSs + warp * 16, Qs);  // dK[keys of warp w] = dS^T Q
    // this warp's S and dP scratch is free until the next tile: stage there
    stage(acc_dv, S);
    stage(acc_dk, dP);
    __syncwarp();
    const int key0 = k0 + warp * 16;
    add_rows(dv + base, S, key0, n, lane);
    add_rows(dk + base, dP, key0, n, lane);
  }

  __syncwarp();
  stage(acc_dq, S);
  __syncwarp();
  const int qrow0 = q0 + warp * 16;
  for (int idx = lane; idx < 16 * D; idx += 32) {
    const int r = idx / D;
    const int c = idx - r * D;
    if (qrow0 + r < n) dq[base + (size_t)(qrow0 + r) * D + c] = __float2bfloat16(S[r * LD + c]);
  }
}

}  // namespace
}  // namespace ga

// dk and dv must hold zeros: the kernel adds into them.
extern "C" int ga_flash_self_bwd_w1(const void* q, const void* k, const void* v, const void* dout, void* dq,
                                    void* dk, void* dv, int bh, int n, int d, float scale, void* stream) {
  using ga::bf16;
  if (d != ga::D) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || n <= 0) return 0;
  constexpr int bytes = ga::W1Smem::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(ga::flash_self_bwd_w1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + ga::BT - 1) / ga::BT, bh);
  ga::flash_self_bwd_w1_kernel<<<grid, ga::WARPS * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), n,
      scale, scale * ga::kLog2e);
  return (int)cudaGetLastError();
}

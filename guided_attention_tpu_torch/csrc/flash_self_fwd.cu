// K1: flash self-attention forward over [BH, N, D] bf16.
//
// Replaces guided_attention_tpu/ops/flash_attention.py `_self_fwd` /
// `_self_fwd_kernel`, which held the whole K/V of one (b, h) in VMEM for a
// single softmax pass. At N = 4096, D = 40 one K alone is 320 KB, more than
// the 227 KB of shared memory a block may use, so this kernel tiles the keys
// with an online softmax (running max and sum in fp32).
//
// Bound on the H100: 4*N^2*D operations per (b, h), on the bf16 tensor cores;
// at head_dim 40 the N^2 exponentials weigh about as much. Both products run
// on the tensor cores (WMMA 16x16x16 bf16 fragments, fp32 accumulation), and
// the scores, probabilities and output accumulator stay in shared memory:
// nothing of size N^2 reaches device memory.
//
// Block: 64 queries of one (b, h), 4 warps, each warp owning 16 query rows.
// Per 64-key tile: S = Q K^T (fp32) -> online softmax -> P (bf16) -> O += P V.
// D is padded with zeros to DP, a multiple of 16 (D = 40 -> 48).
// Writes O (bf16) and the natural-log logsumexp of the scaled scores (fp32)
// per row, which the backward (K2) uses to recompute P.
#include "common.cuh"

using namespace nvcuda;

namespace ga {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int SP = BK + 4;  // fp32 score row stride (padded against bank conflicts)
constexpr int PP = BK + 8;  // bf16 probability row stride

template <int DP>
struct FwdSmem {
  static constexpr int OP = DP + 4;  // fp32 output-accumulator row stride
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + align128(BQ * DP * 2);
  static constexpr int v_off = k_off + align128(BK * DP * 2);
  static constexpr int s_off = v_off + align128(BK * DP * 2);
  static constexpr int p_off = s_off + align128(BQ * SP * 4);
  static constexpr int o_off = p_off + align128(BQ * PP * 2);
  static constexpr int bytes = o_off + align128(BQ * OP * 4);
};

template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
    flash_self_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ o, float* __restrict__ lse, int n, int d, float scale_log2) {
  using L = FwdSmem<DP>;
  constexpr int OP = L::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * d;

  // zero padding columns and the accumulator once; tile loads never touch them
  zero_smem(smem, L::s_off);
  zero_smem(smem + L::o_off, BQ * OP * 4);
  __syncthreads();
  load_rows(Qs, DP, q + base, q0, BQ, n, d);

  // row state: lanes 2r and 2r+1 of a warp own row 16*warp + r
  const int r_local = lane / 2;
  const int half = lane & 1;
  const int row = warp * 16 + r_local;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_rows(Ks, DP, k + base, k0, BK, n, d);
    load_rows(Vs, DP, v + base, k0, BK, n, d);
    __syncthreads();

    // S_w = Q_w K^T  [16 x BK]
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(b, Ks + nt * 16 * DP + kk * 16, DP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * SP + nt * 16, acc, SP, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this warp's rows (base-2 exponent, scale folded in)
    const float* srow = Ss + row * SP + half * (BK / 2);
    bf16* prow = Ps + row * PP + half * (BK / 2);
    const int kbase = k0 + half * (BK / 2);
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      if (kbase + c < n) mx = fmaxf(mx, srow[c] * scale_log2);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      const float p = (kbase + c < n) ? exp2f(srow[c] * scale_log2 - m_new) : 0.f;
      prow[c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* orow = Os + row * OP + half * (DP / 2);
#pragma unroll
    for (int c = 0; c < DP / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O_w += P_w V  [16 x DP]
#pragma unroll
    for (int dt = 0; dt < DP / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + warp * 16 * OP + dt * 16, OP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + warp * 16 * PP + kk * 16, PP);
        wmma::load_matrix_sync(b, Vs + kk * 16 * DP + dt * 16, DP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * OP + dt * 16, acc, OP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qrow = q0 + row;
  if (qrow < n) {
    const float inv_l = 1.f / l_run;
    const float* orow = Os + row * OP;
    bf16* out = o + base + (size_t)qrow * d;
    for (int c = half; c < d; c += 2) out[c] = __float2bfloat16(orow[c] * inv_l);
    if (half == 0) lse[(size_t)bh * n + qrow] = (m_run + log2f(l_run)) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = FwdSmem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_self_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_self_fwd_kernel<DP><<<grid, WARPS * 32, bytes, stream>>>(q, k, v, o, lse, n, d, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ga

extern "C" int ga_flash_self_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
                                 int d, float scale, void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  // the presets' head dims: 40 (SD1.5, padded to 48) and 64 (SD2.1)
  switch (d) {
    case 40: return ga::launch<48>(qp, kp, vp, op, lp, bh, n, d, scale, s);
    case 64: return ga::launch<64>(qp, kp, vp, op, lp, bh, n, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

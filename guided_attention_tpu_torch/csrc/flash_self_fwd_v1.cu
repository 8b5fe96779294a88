// V1: self-attention forward with the ones-column denominator, [BH, N, 40] bf16.
//
// Replaces scripts/perf_attn_kernel.py `fwd_v1` / `_fwd_kernel_v1`, a
// microbench variant of K1: s = (q k^T) * scale in fp32, P~ = exp(s - max),
// and o = (P~ V) / (P~ 1), the denominator read from a ones column appended
// to V, so one product yields numerator and denominator from the same P~.
// With BF16_P, P~ is rounded to bf16 before the product (the TPU's V2); else
// it keeps fp32 precision through the product (the TPU's V1).
//
// The TPU kernel held the whole K/V row of one (b, h) in VMEM; at N = 4096
// one K is 320 KB, more than a block's 227 KB of shared memory, so this
// kernel tiles the keys by 64 with an online maximum, as K1 does. The ones
// column lives in the zero padding that WMMA's multiple-of-16 width already
// gives D = 40 (padded to DP = 48): column 40 of every V tile is 1, so the
// P~ V product accumulates the running denominator in column 40 of O, and
// the rescale by alpha = exp(m_old - m_new) rescales it with O. K1's scalar
// per-row sum is gone; the row maximum stays a scalar loop.
//
// fp32 P~ on tensor cores, which take no fp32 operand: P~ = hi + lo with
// hi = bf16(P~) and lo = bf16(P~ - hi), and O += hi V + lo V (two bf16
// products, fp32 accumulation). |P~ - hi - lo| <= 2^-9 |P~ - hi| <= 2^-18 P~,
// far below the bf16 rounding of the output (2^-9).
//
// Bound on the H100: 4*N^2*D operations per (b, h) on the bf16 tensor cores
// (the lo product adds N^2*DP more without BF16_P). Block: 64 queries of one
// (b, h), 4 warps of 16 query rows; S, P~ and O stay in shared memory.
#include "common.cuh"

using namespace nvcuda;

namespace ga {
namespace {

constexpr int D = 40;   // the only head dim: its pad column holds the ones
constexpr int DP = 48;  // D padded to a multiple of 16
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int SP = BK + 4;  // fp32 score row stride (padded against bank conflicts)
constexpr int PP = BK + 8;  // bf16 probability row stride
constexpr int OP = DP + 4;  // fp32 output-accumulator row stride

template <bool BF16_P>
struct V1Smem {
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + align128(BQ * DP * 2);
  static constexpr int v_off = k_off + align128(BK * DP * 2);
  static constexpr int s_off = v_off + align128(BK * DP * 2);
  static constexpr int p_off = s_off + align128(BQ * SP * 4);
  static constexpr int lo_off = p_off + align128(BQ * PP * 2);
  static constexpr int o_off = lo_off + (BF16_P ? 0 : align128(BQ * PP * 2));
  static constexpr int bytes = o_off + align128(BQ * OP * 4);
};

// acc (16 x DP of O, row stride OP) += P[16 x BK] (row stride PP) * V[BK x DP]
__device__ __forceinline__ void pv(float* o, const bf16* p, const bf16* vs) {
#pragma unroll
  for (int dt = 0; dt < DP / 16; ++dt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o + dt * 16, OP, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + kk * 16, PP);
      wmma::load_matrix_sync(b, vs + kk * 16 * DP + dt * 16, DP);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o + dt * 16, acc, OP, wmma::mem_row_major);
  }
}

template <bool BF16_P>
__global__ void __launch_bounds__(WARPS * 32)
    flash_self_fwd_v1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                             bf16* __restrict__ o, int n, float scale_log2) {
  using L = V1Smem<BF16_P>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* Plo = reinterpret_cast<bf16*>(smem + L::lo_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * D;

  // zero the padding columns and the accumulator once; tile loads never
  // touch columns >= D, so the ones column written here stays for every tile
  zero_smem(smem, L::s_off);
  zero_smem(smem + L::o_off, BQ * OP * 4);
  __syncthreads();
  for (int r = threadIdx.x; r < BK; r += blockDim.x) Vs[r * DP + D] = __float2bfloat16(1.f);
  load_rows(Qs, DP, q + base, q0, BQ, n, D);

  // row state: lanes 2r and 2r+1 of a warp own row 16*warp + r
  const int r_local = lane / 2;
  const int half = lane & 1;
  const int row = warp * 16 + r_local;
  float m_run = -INFINITY;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_rows(Ks, DP, k + base, k0, BK, n, D);
    load_rows(Vs, DP, v + base, k0, BK, n, D);
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

    // online maximum (base-2 exponent, scale applied to the fp32 score)
    const float* srow = Ss + row * SP + half * (BK / 2);
    const int cbase = half * (BK / 2);
    const int kbase = k0 + cbase;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      if (kbase + c < n) mx = fmaxf(mx, srow[c] * scale_log2);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
#pragma unroll 8
    for (int c = 0; c < BK / 2; ++c) {
      const float p = (kbase + c < n) ? exp2f(srow[c] * scale_log2 - m_new) : 0.f;
      const bf16 hi = __float2bfloat16(p);
      Ps[row * PP + cbase + c] = hi;
      if constexpr (!BF16_P) Plo[row * PP + cbase + c] = __float2bfloat16(p - __bfloat162float(hi));
    }
    // rescale O and, in its column D, the running denominator
    float* orow = Os + row * OP + half * (DP / 2);
#pragma unroll
    for (int c = 0; c < DP / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O_w += P~_w [V | 1]  [16 x DP]
    pv(Os + warp * 16 * OP, Ps + warp * 16 * PP, Vs);
    if constexpr (!BF16_P) {
      __syncwarp();
      pv(Os + warp * 16 * OP, Plo + warp * 16 * PP, Vs);
    }
    __syncwarp();
  }

  const int qrow = q0 + row;
  if (qrow < n) {
    const float* orow = Os + row * OP;
    const float l = orow[D];
    bf16* out = o + base + (size_t)qrow * D;
    for (int c = half; c < D; c += 2) out[c] = __float2bfloat16(orow[c] / l);
  }
}

template <bool BF16_P>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int n, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = V1Smem<BF16_P>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_self_fwd_v1_kernel<BF16_P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_self_fwd_v1_kernel<BF16_P><<<grid, WARPS * 32, bytes, stream>>>(q, k, v, o, n, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ga

extern "C" int ga_flash_self_fwd_v1(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                                    float scale, int bf16_p, void* stream) {
  using ga::bf16;
  if (d != ga::D) return (int)cudaErrorInvalidValue;
  if (bh <= 0 || n <= 0) return 0;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16_p ? (int)ga::launch<true>(qp, kp, vp, op, bh, n, scale, s)
                : (int)ga::launch<false>(qp, kp, vp, op, bh, n, scale, s);
}

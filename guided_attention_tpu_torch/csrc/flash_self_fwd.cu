// K1: flash self-attention forward over [BH, N, D] bf16, for Hopper (sm_90a).
//
// Replaces guided_attention_tpu/ops/flash_attention.py `_self_fwd` /
// `_self_fwd_kernel`, which held the whole K/V of one (b, h) in VMEM for a
// single softmax pass. At N = 4096, D = 40 one K alone is 320 KB, more than
// the 227 KB of shared memory a block may use, so this kernel tiles the keys
// with an online softmax (running max and sum in fp32). Outputs: O (bf16)
// and the natural-log logsumexp of the scaled scores (fp32) per row, which
// the backward (K2) reads to recompute P.
//
// What bounds it on the H100. Per (q, k) pair: 4*D tensor-core operations
// (QK^T and PV) and one exponential. The special-function units give 16
// exp2 per SM per clock, about 3.9e12/s over the card, and the bf16 tensor
// cores 989e12 operations/s, so at D = 40 the N^2 exponentials (0.069 ms at
// [16, 4096, 40]) weigh more than the products (0.043 ms): the kernel can
// only approach its bound if the exponentials of one tile run while the
// tensor cores work on another, and if nothing else (shared-memory round
// trips, synchronous loads, a serial softmax) sits between them.
//
// Design, per block of BQ = 64*CW queries of one (b, h):
// - Both products on `wgmma` with fp32 accumulators in registers. Each of
//   the CW consumer warpgroups owns 64 query rows. S = Q K^T is
//   m64n{BK}k16 with Q and K K-major in shared memory; O += P V is
//   m64n64k16 with P as the register A operand (the S accumulator converted
//   to bf16 pairs in place: its layout is the A layout) and V MN-major in
//   shared memory. S, P and O never touch shared memory; O stays in
//   registers for the whole key loop.
// - Online softmax in registers: each row's scores sit in the 4 threads of
//   one quad, so a row max is two __shfl_xor_sync after four independent
//   in-thread chains; exp2 with the scale folded in (scale_log2); each
//   thread keeps its share of the row sum and the quad adds them once at
//   the end; O is rescaled by alpha in registers; keys >= n are set to
//   -inf only on a ragged last tile.
// - K/V by TMA into a ring of STAGES shared-memory stages guarded by
//   mbarriers, K and V with barriers of their own: a K stage is released as
//   soon as S is done, a V stage after P V, and the producer keeps K one
//   tile ahead of V, so a load never waits for the product that follows
//   it. One producer warp issues every load; Q is loaded once per block.
//   The tensor maps are 3-D [BH, N, D], so a ragged last tile zero-fills
//   inside its own head.
// - Overlap of the exponentials with the tensor cores, inside each
//   warpgroup: S_{j+1} = Q K_{j+1}^T and O += P_j V_j are issued together,
//   and the softmax of S_{j+1} runs while P_j V_j is still in flight; the
//   two consumer warpgroups of a block interleave on the SM besides (an
//   explicit ping-pong of their products over named barriers, as in
//   FlashAttention-3, measured no faster here and is not kept).
// - Head dim 40 against the tensor-core shapes (hopper.cuh): tiles are 64
//   columns wide (128-byte swizzle rows) and TMA fills columns D..63 with
//   zeros. QK^T runs over ceil(D/16) k16 slices (48 columns at D = 40,
//   +20% over 40); PV runs n = 64 (+60% at D = 40), since V's N dim is one
//   128-byte swizzle atom. Padded tensor time at [16, 4096, 40] is 0.061 ms,
//   under the exponentials' 0.069 ms.
//
// Tile shapes are template parameters: (queries, keys, stages) of the three
// configurations below. The main path's entry point runs kMainConfig, the
// one the microbench measured fastest: 128 queries (two consumer
// warpgroups and the producer warp, 288 threads), 128-key tiles, 3 stages,
// 113 KB of shared memory, 1 block per SM. A second block fits neither in
// registers nor in shared memory, so the eval call's 256 blocks take two
// waves on 132 SMs, the second 94% full. The others are reached only
// through ga_flash_self_fwd_config.
// Non-causal and deterministic: every block owns its rows and nothing is
// reduced across blocks.
#include "common.cuh"
#include "hopper.cuh"

namespace ga {
namespace {

using namespace hopper;

// the configuration ga_flash_self_fwd runs (see launch_config)
constexpr int kMainConfig = 0;

template <int CW, int BK, int STAGES>
struct FwdSmem {
  static constexpr int BQ = 64 * CW;
  static constexpr int q_bytes = BQ * kSwizzleRowBytes;
  static constexpr int kv_bytes = BK * kSwizzleRowBytes;  // one K or V tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int bar_off = v_off + STAGES * kv_bytes;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int bytes = bar_off + (1 + 4 * STAGES) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base to the 1024-byte swizzle atom
};

// S = Q K^T over DK k16 slices (Q rows of this warpgroup, one K tile)
template <int BK, int DK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    wgmma_ss<BK>(s, desc_sw128(q_addr + 32 * kk, 16, 1024), desc_sw128(k_addr + 32 * kk, 16, 1024), kk > 0);
  }
}

// O += P V over the BK keys of one V tile, 16 keys (2048 bytes) per slice
template <int BK>
__device__ __forceinline__ void pv_product(float (&o)[32], const uint32_t (&p)[BK / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs_n64_mn(o, p[kk], desc_sw128(v_addr + 16 * kSwizzleRowBytes * kk, BK * kSwizzleRowBytes, 1024));
  }
}

// Online softmax of one score tile, in place: s becomes exp2(s*scale_log2 -
// m_new) per row; m (running max, scaled log2 units) and l (this thread's
// share of the running sum) move on; alpha = exp2(m_old - m_new) rescales O.
// With MASK, columns at or past `valid` (keys >= n) count as -inf. Max and
// sum run as four independent chains per row, so that their latency hides
// behind each other.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int valid, int quad) {
  constexpr int C = BK / 8;  // 8-column chunks; each thread holds 2 columns of each per row
  if (MASK) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * c + 2 * quad + e >= valid) {
          s[4 * c + e] = -INFINITY;
          s[4 * c + 2 + e] = -INFINITY;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float pair = fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]);
      mx[c % 4] = c < 4 ? pair : fmaxf(mx[c % 4], pair);
    }
    float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m[i], row_max * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * c + 2 * i + e], scale_log2, -m_new));
        s[4 * c + 2 * i + e] = p;
        sum[(2 * c + e) % 4] += p;
      }
    l[i] = l[i] * alpha[i] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

// the probabilities as the A operand of P V: slice kk is columns 16kk..16kk+15
template <int BK>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    o[4 * c + 0] *= alpha[0];
    o[4 * c + 1] *= alpha[0];
    o[4 * c + 2] *= alpha[1];
    o[4 * c + 3] *= alpha[1];
  }
}

template <int CW, int BK, int STAGES, int MINB, int DK>
__global__ void __launch_bounds__(CW * 128 + 32, MINB)
    flash_self_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
                          int n, int d, float scale_log2) {
  using L = FwdSmem<CW, BK, STAGES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::BQ;
  const int n_tiles = (n + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * CW);  // lane 0 of every consumer warp
      mbar_init(&v_empty[s], 4 * CW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * CW) {
    // producer warp: one lane keeps the ring full, K one tile ahead of V
    // (a K stage frees when S is done, a V stage only when P V is)
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, L::q_bytes);
      tma_load_3d(smem + L::q_off, &tm_q, q_full, 0, q0, bh);
      for (int j = 0; j <= n_tiles; ++j) {
        if (j < n_tiles) {
          const int s = j % STAGES;
          if (j >= STAGES) mbar_wait(&k_empty[s], ((j / STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&k_full[s], L::kv_bytes);
          tma_load_3d(smem + L::k_off + s * L::kv_bytes, &tm_k, &k_full[s], 0, j * BK, bh);
        }
        if (j > 0) {
          const int jv = j - 1;
          const int s = jv % STAGES;
          if (jv >= STAGES) mbar_wait(&v_empty[s], ((jv / STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&v_full[s], L::kv_bytes);
          tma_load_3d(smem + L::v_off + s * L::kv_bytes, &tm_v, &v_full[s], 0, jv * BK, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns block rows [64 wg, 64 wg + 64); this thread
  // holds rows r and r + 8 of them (accumulator layout, hopper.cuh)
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
  const uint32_t q_addr = smem_u32(smem + L::q_off) + wg * 64 * kSwizzleRowBytes;
  const uint32_t k_base = smem_u32(smem + L::k_off);
  const uint32_t v_base = smem_u32(smem + L::v_off);
  const bool ragged = n % BK != 0;

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float s_acc[BK / 2];
  uint32_t p_frag[BK / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float alpha[2];

  // tile 0: S_0, its softmax, P_0
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
  qk_product<BK, DK>(s_acc, q_addr, k_base);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  if (lane == 0) mbar_arrive(&k_empty[0]);
  if (ragged && n_tiles == 1) {
    softmax_tile<BK, true>(s_acc, m_run, l_run, alpha, scale_log2, n, quad);
  } else {
    softmax_tile<BK, false>(s_acc, m_run, l_run, alpha, scale_log2, n, quad);
  }
  to_a_fragments<BK>(s_acc, p_frag);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int sp = (j - 1) % STAGES;
    // issue S_j = Q K_j^T, rescale O by the last alpha, issue O += P_{j-1} V_{j-1}
    mbar_wait(&k_full[s], (j / STAGES) & 1);
    wgmma_fence();
    qk_product<BK, DK>(s_acc, q_addr, k_base + s * L::kv_bytes);
    wgmma_commit();
    rescale(o_acc, alpha);
    mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
    wgmma_fence();
    pv_product<BK>(o_acc, p_frag, v_base + sp * L::kv_bytes);
    wgmma_commit();
    // softmax of S_j while P_{j-1} V_{j-1} runs
    wgmma_wait<1>();
    fence_regs(s_acc);
    if (lane == 0) mbar_arrive(&k_empty[s]);
    if (ragged && j == n_tiles - 1) {
      softmax_tile<BK, true>(s_acc, m_run, l_run, alpha, scale_log2, n - j * BK, quad);
    } else {
      softmax_tile<BK, false>(s_acc, m_run, l_run, alpha, scale_log2, n - j * BK, quad);
    }
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(p_frag);
    if (lane == 0) mbar_arrive(&v_empty[sp]);
    to_a_fragments<BK>(s_acc, p_frag);
  }

  // the last P V
  const int last = (n_tiles - 1) % STAGES;
  rescale(o_acc, alpha);
  mbar_wait(&v_full[last], ((n_tiles - 1) / STAGES) & 1);
  wgmma_fence();
  pv_product<BK>(o_acc, p_frag, v_base + last * L::kv_bytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);

  // O / l and the logsumexp, once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + r + 8 * i;
    if (row < n) {
      const float inv_l = 1.f / l;
      bf16* out = o + ((size_t)bh * n + row) * d;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * quad;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 2 * i] * inv_l, o_acc[4 * c + 2 * i + 1] * inv_l);
        }
      }
      if (quad == 0) lse[(size_t)bh * n + row] = (m_run[i] + log2f(l)) * kLn2;
    }
  }
}

template <int CW, int BK, int STAGES, int MINB, int DK>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  using L = FwdSmem<CW, BK, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tile_map_3d(&tm_q, q, bh, n, d, L::BQ);
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_k, k, bh, n, d, BK);
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_v, v, bh, n, d, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_self_fwd_kernel<CW, BK, STAGES, MINB, DK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  dim3 grid((n + L::BQ - 1) / L::BQ, bh);
  kernel<<<grid, CW * 128 + 32, L::alloc, stream>>>(tm_q, tm_k, tm_v, o, lse, n, d, scale * kLog2e);
  return cudaGetLastError();
}

// configuration index -> (consumer warpgroups, key tile, stages, blocks per SM):
// 0: 128 queries x 128 keys, 3 stages, 1 block per SM (113 KB shared, 288 threads)
// 1: 128 queries x 64 keys, 3 stages, 1 block per SM (65 KB)
// 2: 64 queries x 128 keys, 2 stages, 2 blocks per SM (73 KB each, 160 threads)
template <int DK, int CONFIG>
cudaError_t launch_config(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int bh, int n, int d,
                          float scale, cudaStream_t stream) {
  if constexpr (CONFIG == 0) return launch<2, 128, 3, 1, DK>(q, k, v, o, lse, bh, n, d, scale, stream);
  else if constexpr (CONFIG == 1) return launch<2, 64, 3, 1, DK>(q, k, v, o, lse, bh, n, d, scale, stream);
  else return launch<1, 128, 2, 2, DK>(q, k, v, o, lse, bh, n, d, scale, stream);
}

}  // namespace
}  // namespace ga

// Any of the tile configurations at head dim 40; only kMainConfig at 64.
extern "C" int ga_flash_self_fwd_config(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                                        int n, int d, float scale, int config, void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  // the presets' head dims: 40 (SD1.5, three k16 slices) and 64 (SD2.1, four)
  if (d == 40) {
    switch (config) {
      case 0: return ga::launch_config<3, 0>(qp, kp, vp, op, lp, bh, n, d, scale, s);
      case 1: return ga::launch_config<3, 1>(qp, kp, vp, op, lp, bh, n, d, scale, s);
      case 2: return ga::launch_config<3, 2>(qp, kp, vp, op, lp, bh, n, d, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 64 && config == ga::kMainConfig) {
    return ga::launch_config<4, ga::kMainConfig>(qp, kp, vp, op, lp, bh, n, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ga_flash_self_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
                                 int d, float scale, void* stream) {
  return ga_flash_self_fwd_config(q, k, v, o, lse, bh, n, d, scale, ga::kMainConfig, stream);
}

// W1: self-attention backward from (q, k, v, dO) alone, over [BH, N, D]
// bf16, D = 40 or 64, for Hopper (sm_90a).
//
// Replaces scripts/perf_attn_kernel.py `bwd_w1` / `_bwd_kernel_w1`, a
// microbench variant of K2 that takes no saved output or logsumexp: P =
// softmax(s) with its own row max and sum, dP = dO V^T, delta =
// rowsum(dP * P) (not rowsum(dO * O)), dS = P (dP - delta) scale rounded to
// bf16, P rounded to bf16 for dV; dQ in bf16, dK and dV in fp32.
//
// The TPU ran a grid of query blocks in order and summed dK/dV in fp32
// over those sequential steps. CUDA blocks run in parallel and in no
// order, so dK/dV need either reductions across blocks or a pass that owns
// them. Counted at [8, 4096, 40] before choosing, for the same padded
// products:
//   (a) query tiles, as the TPU: every 128-query block adds a 4096 x 40 dK
//       and dV in fp32, 32 blocks x 8 heads x 4096 x 40 x 2 x 4 B = 335 MB
//       of L2 reductions, and P and dS go through shared memory transposed
//       (MN-major A operands) for dV and dK;
//   (b) key tiles, as FlashAttention-3's backward: a statistics pass, then
//       a key-tile pass owning dK/dV that adds dQ into fp32 scratch: 168 MB
//       of reductions, dS through shared memory for dQ, and a cast kernel;
//   (c) this kernel: a query-tile kernel that owns its rows' statistics and
//       dQ, then a key-tile pass that owns dK/dV (K2's two passes, with
//       the statistics computed instead of read). No reductions and no
//       transposes: every output element is written by one block, so the
//       gradients are bitwise the same from run to run. The price is one
//       more sweep of S and dP and one more exponential per (query, key)
//       pair: 18*N^2*D tensor operations per (b, h) in place of (a)'s and
//       (b)'s 14*N^2*D, 960 padded operations per pair at D = 40 (0.130
//       ms at [8, 4096, 40]) and three exponentials (0.103 ms) that can
//       run under them.
// (c) costs 0.026 ms more tensor time than (b) and saves its reductions,
// its transposes and its cast. A version of (b) was built in a
// compile-and-check call on the H100 (dS^T of each consumer warpgroup
// written swizzled to shared memory, dQ_j = dS_j K as an m64n64k16 `wgmma`
// with both operands MN-major, float2 atomics into fp32 scratch, a cast
// kernel after): right at all three checked shapes, within the register
// budget (168, no spill), and slower than (c) in the same call, with the
// shared-memory round trip, the dQ product and its atomics in every key
// tile's critical path. So W1 is (c); (a) was counted, not built.
//
// The two launches, on one stream:
//   1. statistics and dQ over query tiles: each consumer warpgroup owns 64
//      queries and streams every K/V tile twice. Sweep one: S = Q K^T,
//      dP = dO V^T, an online max m, sum l = sum exp(s - m) and u = sum
//      exp(s - m) dP in registers, so delta = u / l; it writes -log2 of the
//      row's sum of exponentials (scaled log2 units) and delta * scale for
//      pass 2. Sweep two: S and dP again, P = exp2(s * scale_log2 - lse2),
//      dS = P (dP scale - delta scale) in registers, dQ += dS K.
//   2. dK and dV over key tiles: each consumer warpgroup owns 64 keys and
//      streams every query tile with its statistics: S^T = K Q^T, dP^T =
//      V dO^T, P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q.
//
// Building blocks are csrc/hopper.cuh's and K2's (csrc/flash_self_bwd.cu;
// the pieces below are that kernel's, repeated here so that K2's source
// stays as it is): every product on `wgmma` with fp32 accumulators in
// registers, score products m64n64k16 from shared memory, gradient
// products with P or dS as the register A operand; streamed tiles by TMA
// into rings of STAGES stages with full and empty mbarriers, issued by the
// first warp of a producer warpgroup that hands its registers to the two
// consumer warpgroups (setmaxnreg); 64-column TMA boxes that read columns
// D..63 as zeros; 3-D tensor maps that zero-fill a ragged last tile inside
// its head, a ragged key tile masked to P = 0 in pass 1 and padded query
// statistics of -inf and 0 in pass 2 (P = dS = 0); rows >= N not written.
// dS is rounded to bf16 after the scale, as the plain version rounds it.
//
// Tile shapes are template parameters, K2's three configurations: (keys
// per block, queries per tile, stages) of pass 2 and (queries per block,
// keys per tile, stages) of pass 1, in launch_config. The entry point runs
// kMainConfig; ga_flash_self_bwd_w1_config reaches any of them, at head
// dim 40 and 64.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace ga {
namespace {

using namespace hopper;

// the configuration ga_flash_self_bwd_w1 runs (see launch_config)
constexpr int kMainConfig = 0;

// One pass's tiles: CW consumer warpgroups of 64 own rows each, streamed
// tiles of BT rows, STAGES ring stages, MINB blocks per SM, and the
// registers a thread of each role gets (setmaxnreg; see K2).
template <int CW_, int BT_, int STAGES_, int MINB_>
struct Tiles {
  static constexpr int CW = CW_, BT = BT_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int OWN = 64 * CW;  // own rows per block
  static constexpr int own_bytes = OWN * kSwizzleRowBytes;  // one own tile
  static constexpr int t_bytes = BT * kSwizzleRowBytes;     // one streamed tile
  static constexpr int threads = CW * 128 + 128;
  static constexpr int base_regs = 65536 / (MINB * threads) / 8 * 8;
  static constexpr int producer_regs = 24;
  static constexpr int consumer_regs = (base_regs * threads - producer_regs * 128) / (CW * 128) / 8 * 8;
  static_assert(consumer_regs <= 256, "setmaxnreg takes at most 256");
  static_assert(BT == 64, "one m64n64 score product per streamed tile, one column pair per producer lane");
};

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Shared memory of either pass: two own tiles, two streamed tiles per
// stage, `STAT_BYTES` of row statistics, then the mbarriers own_full,
// full[STAGES], empty[STAGES].
template <class T, int STAT_BYTES>
struct Smem {
  static constexpr int own0 = 0;
  static constexpr int own1 = own0 + T::own_bytes;
  static constexpr int t0 = own1 + T::own_bytes;
  static constexpr int t1 = t0 + T::STAGES * T::t_bytes;
  static constexpr int stat_off = t1 + T::STAGES * T::t_bytes;
  static constexpr int bar_off = stat_off + STAT_BYTES;
  static constexpr int bytes = bar_off + (1 + 2 * T::STAGES) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base to the 1024-byte swizzle atom
};

// pass 2: per stage, one float4 per pair of query columns (see grads_cols)
template <class T>
using Smem2 = Smem<T, T::STAGES * T::BT / 2 * 16>;
// pass 1: no statistics in shared memory
template <class T>
using Smem1 = Smem<T, 0>;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// D = A B^T over DK k16 slices: the 64 A rows and the N B rows are both
// K-major 64-column swizzled tiles (Q K^T, dO V^T, K Q^T, V dO^T)
template <int N, int DK>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    wgmma_ss<N>(acc, desc_sw128(a_addr + 32 * kk, 16, 1024), desc_sw128(b_addr + 32 * kk, 16, 1024), kk > 0);
  }
}

// D += A B over rows [16 K0, 16 K1) of a streamed BT-row tile: A [64 x BT]
// in registers, B the tile read MN-major (16 rows, 2048 bytes, per k16 slice)
template <int BT, int K0, int K1>
__device__ __forceinline__ void rs_product(float (&acc)[32], const uint32_t (&a)[BT / 16][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    wgmma_rs_n64_mn(acc, a[kk], desc_sw128(b_addr + 16 * kSwizzleRowBytes * kk, BT * kSwizzleRowBytes, 1024));
  }
}

// k16 slices [K0, K1) of an m64 x BT accumulator as the A operand
template <int BT, int K0, int K1>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BT / 2], uint32_t (&a)[BT / 16][4]) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Pass 1, sweep one, one tile: the online statistics of this thread's two
// rows. m is the running max (scaled log2 units); l and u are this
// thread's shares of sum exp2(s * scale_log2 - m) and of the same weighted
// by dP, rescaled as m moves. With MASK, columns at or past `valid` (keys
// >= n) count as -inf (their dP is 0: V's padded rows read as zeros).
template <int BT, bool MASK>
__device__ __forceinline__ void stats_tile(float (&s)[BT / 2], const float (&dp)[BT / 2], float (&m)[2],
                                           float (&l)[2], float (&u)[2], float scale_log2, int valid, int quad) {
  constexpr int C = BT / 8;
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
    const float alpha = ex2(m[i] - m_new);
    m[i] = m_new;
    float sum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * i + e;
        const float p = ex2(fmaf(s[x], scale_log2, -m_new));
        sum[e] += p;
        usum[e] = fmaf(p, dp[x], usum[e]);
      }
    l[i] = fmaf(l[i], alpha, sum[0] + sum[1]);
    u[i] = fmaf(u[i], alpha, usum[0] + usum[1]);
  }
}

// Pass 1, sweep two, one tile in place: dp = dP becomes dS = P (dP scale -
// delta scale), P = exp2(s * scale_log2 - lse2) with this thread's two
// rows' -lse2 in nl and delta * scale in dl. With MASK, columns at or past
// `valid` (keys >= n) get P = 0.
template <int BT, bool MASK>
__device__ __forceinline__ void grads_rows(const float (&s)[BT / 2], float (&dp)[BT / 2], const float (&nl)[2],
                                           const float (&dl)[2], float scale, float scale_log2, int valid,
                                           int quad) {
#pragma unroll
  for (int c = 0; c < BT / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * i + e;
        float p = ex2(fmaf(s[x], scale_log2, nl[i]));
        if (MASK && 8 * c + 2 * quad + e >= valid) p = 0.f;
        dp[x] = p * fmaf(dp[x], scale, -dl[i]);
      }
}

// Pass 2, 8-column chunks [C0, C1) of one tile in place: s = S^T (rows
// keys, columns queries) becomes P^T = exp2(s * scale_log2 - lse2[col]) and
// dp = dP^T becomes dS^T = P^T (dP^T scale - delta[col] scale). A thread
// holds columns 8c + 2*quad + {0, 1}; stats[m] = {-lse2[2m], -lse2[2m+1],
// (delta scale)[2m], (delta scale)[2m+1]}.
template <int BT, int C0, int C1>
__device__ __forceinline__ void grads_cols(float (&s)[BT / 2], float (&dp)[BT / 2], const float4* stats,
                                           float scale, float scale_log2, int quad) {
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    const float4 st = stats[4 * c + quad];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = 4 * c + 2 * i;
      const float p0 = ex2(fmaf(s[x], scale_log2, st.x));
      const float p1 = ex2(fmaf(s[x + 1], scale_log2, st.y));
      s[x] = p0;
      s[x + 1] = p1;
      dp[x] = p0 * fmaf(dp[x], scale, -st.z);
      dp[x + 1] = p1 * fmaf(dp[x + 1], scale, -st.w);
    }
  }
}

// rows r and r + 8 of a warpgroup's m64n64 accumulator, the first d
// columns, to rows row0 + r (+ 8) of a [n, d] matrix in bf16 or fp32
template <class Out>
__device__ __forceinline__ void store_rows(const float (&acc)[32], Out* __restrict__ out, int row0, int n, int d,
                                           int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= n) continue;
    Out* dst = out + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      if (col < d) {
        if constexpr (std::is_same<Out, float>::value) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: statistics and dQ for the 64 * CW queries of one block
// ---------------------------------------------------------------------------

template <class T, int DK>
__global__ void __launch_bounds__(T::threads, T::MINB)
    stats_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    float* __restrict__ nlse2, float* __restrict__ dscaled, bf16* __restrict__ dq, int n, int d,
                    float scale, float scale_log2) {
  using L = Smem1<T>;
  constexpr int BT = T::BT, STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * T::OWN;
  const int n_tiles = (n + BT - 1) / BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * T::CW);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * T::CW) {
    // producer: lane 0 loads Q and dO once, then every K and V tile twice
    setmaxnreg_dec<T::producer_regs>();
    if (warp == 4 * T::CW && lane == 0) {
      mbar_arrive_expect_tx(own_full, 2 * T::own_bytes);
      tma_load_3d(smem + L::own0, &tm_q, own_full, 0, q0, bh);
      tma_load_3d(smem + L::own1, &tm_do, own_full, 0, q0, bh);
      for (int j = 0; j < 2 * n_tiles; ++j) {
        const int s = j % STAGES;
        const int tile = j < n_tiles ? j : j - n_tiles;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::t_bytes);
        tma_load_3d(smem + L::t0 + s * T::t_bytes, &tm_k, &full[s], 0, tile * BT, bh);
        tma_load_3d(smem + L::t1 + s * T::t_bytes, &tm_v, &full[s], 0, tile * BT, bh);
      }
    }
  } else {
    setmaxnreg_inc<T::consumer_regs>();
    // consumer warpgroup `wg` owns block rows [64 wg, 64 wg + 64); this
    // thread holds rows r and r + 8 of them (accumulator layout, hopper.cuh)
    const int wg = warp / 4;
    const int quad = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
    const uint32_t q_addr = smem_u32(smem + L::own0) + wg * 64 * kSwizzleRowBytes;
    const uint32_t do_addr = smem_u32(smem + L::own1) + wg * 64 * kSwizzleRowBytes;
    const uint32_t k_base = smem_u32(smem + L::t0);
    const uint32_t v_base = smem_u32(smem + L::t1);
    const bool ragged = n % BT != 0;

    float s_acc[BT / 2], dp_acc[BT / 2];
    mbar_wait(own_full, 0);

    // sweep one: m, l, u
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      ss_product<BT, DK>(s_acc, q_addr, k_base + s * T::t_bytes);
      ss_product<BT, DK>(dp_acc, do_addr, v_base + s * T::t_bytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (lane == 0) mbar_arrive(&empty[s]);
      if (ragged && j == n_tiles - 1) {
        stats_tile<BT, true>(s_acc, dp_acc, m, l, u, scale_log2, n - j * BT, quad);
      } else {
        stats_tile<BT, false>(s_acc, dp_acc, m, l, u, scale_log2, n - j * BT, quad);
      }
    }
    float nl[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i], ui = u[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      ui += __shfl_xor_sync(0xffffffffu, ui, 1);
      ui += __shfl_xor_sync(0xffffffffu, ui, 2);
      nl[i] = -(m[i] + log2f(li));
      dl[i] = ui / li * scale;
      const int row = q0 + r + 8 * i;
      if (quad == 0 && row < n) {
        nlse2[(size_t)bh * n + row] = nl[i];
        dscaled[(size_t)bh * n + row] = dl[i];
      }
    }

    // sweep two: dQ += dS K
    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    uint32_t ds_frag[BT / 16][4];
    for (int j = n_tiles; j < 2 * n_tiles; ++j) {
      const int s = j % STAGES;
      const int tile = j - n_tiles;
      const uint32_t k_addr = k_base + s * T::t_bytes;
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      ss_product<BT, DK>(s_acc, q_addr, k_addr);
      ss_product<BT, DK>(dp_acc, do_addr, v_base + s * T::t_bytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      if (ragged && tile == n_tiles - 1) {
        grads_rows<BT, true>(s_acc, dp_acc, nl, dl, scale, scale_log2, n - tile * BT, quad);
      } else {
        grads_rows<BT, false>(s_acc, dp_acc, nl, dl, scale, scale_log2, n - tile * BT, quad);
      }
      to_a_fragments<BT, 0, BT / 16>(dp_acc, ds_frag);
      wgmma_fence();
      rs_product<BT, 0, BT / 16>(dq_acc, ds_frag, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(ds_frag);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_rows(dq_acc, dq + (size_t)bh * n * d, q0 + r, n, d, quad);
  }
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV for the 64 * CW keys of one block
// ---------------------------------------------------------------------------

template <class T, int DK>
__global__ void __launch_bounds__(T::threads, T::MINB)
    dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ nlse2, const float* __restrict__ dscaled, float* __restrict__ dk,
                float* __restrict__ dv, int n, int d, float scale, float scale_log2) {
  using L = Smem2<T>;
  constexpr int BT = T::BT, STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float4* stats = reinterpret_cast<float4*>(smem + L::stat_off);  // [STAGES][BT / 2]
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * T::OWN;
  const int n_tiles = (n + BT - 1) / BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane: its statistics, lane 0 also the loads
      mbar_init(&empty[s], 4 * T::CW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * T::CW) {
    // producer: the first warp loads K and V once, then Q, dO and their
    // statistics tile by tile
    setmaxnreg_dec<T::producer_regs>();
    if (warp == 4 * T::CW) {
      if (lane == 0) {
        mbar_arrive_expect_tx(own_full, 2 * T::own_bytes);
        tma_load_3d(smem + L::own0, &tm_k, own_full, 0, k0, bh);
        tma_load_3d(smem + L::own1, &tm_v, own_full, 0, k0, bh);
      }
      const float* nl_bh = nlse2 + (size_t)bh * n;
      const float* dl_bh = dscaled + (size_t)bh * n;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // this lane's column pair; a query row >= n gets -lse2 = -inf and
        // delta = 0: P = dS = 0
        const int col = j * BT + 2 * lane;
        float4 st;
        st.x = col < n ? nl_bh[col] : -INFINITY;
        st.y = col + 1 < n ? nl_bh[col + 1] : -INFINITY;
        st.z = col < n ? dl_bh[col] : 0.f;
        st.w = col + 1 < n ? dl_bh[col + 1] : 0.f;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        stats[s * (BT / 2) + lane] = st;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * T::t_bytes);
          tma_load_3d(smem + L::t0 + s * T::t_bytes, &tm_q, &full[s], 0, j * BT, bh);
          tma_load_3d(smem + L::t1 + s * T::t_bytes, &tm_do, &full[s], 0, j * BT, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<T::consumer_regs>();
    const int wg = warp / 4;
    const int quad = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
    const uint32_t k_addr = smem_u32(smem + L::own0) + wg * 64 * kSwizzleRowBytes;
    const uint32_t v_addr = smem_u32(smem + L::own1) + wg * 64 * kSwizzleRowBytes;
    const uint32_t q_base = smem_u32(smem + L::t0);
    const uint32_t do_base = smem_u32(smem + L::t1);

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    float s_acc[BT / 2], dp_acc[BT / 2];
    uint32_t p_frag[BT / 16][4], ds_frag[BT / 16][4];
    mbar_wait(own_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t q_addr = q_base + s * T::t_bytes;
      const uint32_t do_addr = do_base + s * T::t_bytes;
      // S^T_j = K Q_j^T and dP^T_j = V dO_j^T
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      ss_product<BT, DK>(s_acc, k_addr, q_addr);
      ss_product<BT, DK>(dp_acc, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      // P^T_j and dS^T_j half by half (32 query columns each), each half's
      // share of dV += P^T_j dO_j and dK += dS^T_j Q_j issued as soon as
      // its exponentials are done
      auto half = [&](auto h) {
        constexpr int C0 = decltype(h)::value * BT / 16, C1 = C0 + BT / 16;  // 8-column chunks
        grads_cols<BT, C0, C1>(s_acc, dp_acc, stats + s * (BT / 2), scale, scale_log2, quad);
        to_a_fragments<BT, C0 / 2, C1 / 2>(s_acc, p_frag);
        to_a_fragments<BT, C0 / 2, C1 / 2>(dp_acc, ds_frag);
        wgmma_fence();
        rs_product<BT, C0 / 2, C1 / 2>(dv_acc, p_frag, do_addr);
        rs_product<BT, C0 / 2, C1 / 2>(dk_acc, ds_frag, q_addr);
        wgmma_commit();
      };
      half(std::integral_constant<int, 0>{});
      half(std::integral_constant<int, 1>{});
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(p_frag);
      fence_regs(ds_frag);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t base = (size_t)bh * n * d;
    store_rows(dk_acc, dk + base, k0 + r, n, d, quad);
    store_rows(dv_acc, dv + base, k0 + r, n, d, quad);
  }
}

template <class T>
dim3 grid_of(int bh, int n) {
  return dim3((n + T::OWN - 1) / T::OWN, bh);
}

// setmaxnreg.inc waits until the block's pool holds the registers it asks
// for, so a kernel built with fewer registers a thread than Tiles counts
// on would hang: refuse to launch it instead.
template <class T, class K>
cudaError_t check_registers(K kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const bool enough = attr.numRegs * T::threads >= T::consumer_regs * T::CW * 128 + T::producer_regs * 128;
  return enough ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Pass 1, then pass 2 (which reads the statistics pass 1 writes), on one
// stream. `stats` is fp32 scratch [2, bh, n].
template <class A, class B, int DK>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, float* stats, bf16* dq, float* dk,
                   float* dv, int bh, int n, int d, float scale, cudaStream_t stream) {
  using LA = Smem2<A>;
  using LB = Smem1<B>;
  CUtensorMap bq, bdo, bk, bv, ak, av, aq, ado;
  cudaError_t err = make_tile_map_3d(&bq, q, bh, n, d, B::OWN);
  if (err == cudaSuccess) err = make_tile_map_3d(&bdo, dout, bh, n, d, B::OWN);
  if (err == cudaSuccess) err = make_tile_map_3d(&bk, k, bh, n, d, B::BT);
  if (err == cudaSuccess) err = make_tile_map_3d(&bv, v, bh, n, d, B::BT);
  if (err == cudaSuccess) err = make_tile_map_3d(&ak, k, bh, n, d, A::OWN);
  if (err == cudaSuccess) err = make_tile_map_3d(&av, v, bh, n, d, A::OWN);
  if (err == cudaSuccess) err = make_tile_map_3d(&aq, q, bh, n, d, A::BT);
  if (err == cudaSuccess) err = make_tile_map_3d(&ado, dout, bh, n, d, A::BT);
  if (err != cudaSuccess) return err;
  auto kb = stats_dq_kernel<B, DK>;
  auto ka = dkdv_kernel<A, DK>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, LB::alloc);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, LA::alloc);
  if (err == cudaSuccess) err = check_registers<B>(kb);
  if (err == cudaSuccess) err = check_registers<A>(ka);
  if (err != cudaSuccess) return err;
  float* nlse2 = stats;
  float* dscaled = stats + (size_t)bh * n;
  const float scale_log2 = scale * kLog2e;
  kb<<<grid_of<B>(bh, n), B::threads, LB::alloc, stream>>>(bq, bdo, bk, bv, nlse2, dscaled, dq, n, d, scale,
                                                            scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ka<<<grid_of<A>(bh, n), A::threads, LA::alloc, stream>>>(ak, av, aq, ado, nlse2, dscaled, dk, dv, n, d, scale,
                                                            scale_log2);
  return cudaGetLastError();
}

// configuration index -> Tiles<consumer warpgroups, streamed tile, stages,
// blocks per SM> of pass 2 (keys per block = 64 x warpgroups, query tiles),
// then of pass 1 (queries per block, key tiles):
// 0: 128 own rows x 64-row tiles, 4 stages, 1 block per SM (384 threads)
// 1: the same with 2 stages
// 2: 64 own rows (one consumer warpgroup, 256 threads), 4 stages, 2 blocks
//    per SM: 128 registers a thread, under what pass 2 holds (ptxas spills)
template <int DK, int CONFIG>
cudaError_t launch_config(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, float* stats, bf16* dq,
                          float* dk, float* dv, int bh, int n, int d, float scale, cudaStream_t stream) {
  auto run = [&](auto launch_fn) { return launch_fn(q, k, v, dout, stats, dq, dk, dv, bh, n, d, scale, stream); };
  if constexpr (CONFIG == 0) return run(launch<Tiles<2, 64, 4, 1>, Tiles<2, 64, 4, 1>, DK>);
  else if constexpr (CONFIG == 1) return run(launch<Tiles<2, 64, 2, 1>, Tiles<2, 64, 2, 1>, DK>);
  else return run(launch<Tiles<1, 64, 4, 2>, Tiles<1, 64, 4, 2>, DK>);
}

}  // namespace
}  // namespace ga

// Any of the tile configurations, at head dim 40 (three k16 slices in the
// score products) and 64 (four). `stats` is fp32 scratch of 2 * bh * n.
extern "C" int ga_flash_self_bwd_w1_config(const void* q, const void* k, const void* v, const void* dout, void* stats,
                                           void* dq, void* dk, void* dv, int bh, int n, int d, float scale, int config,
                                           void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto args = [&](auto launch_fn) {
    return (int)launch_fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(dout), static_cast<float*>(stats), static_cast<bf16*>(dq),
                          static_cast<float*>(dk), static_cast<float*>(dv), bh, n, d, scale,
                          static_cast<cudaStream_t>(stream));
  };
  if (d == 40) {
    switch (config) {
      case 0: return args(ga::launch_config<3, 0>);
      case 1: return args(ga::launch_config<3, 1>);
      case 2: return args(ga::launch_config<3, 2>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 64) {
    switch (config) {
      case 0: return args(ga::launch_config<4, 0>);
      case 1: return args(ga::launch_config<4, 1>);
      case 2: return args(ga::launch_config<4, 2>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ga_flash_self_bwd_w1(const void* q, const void* k, const void* v, const void* dout, void* stats,
                                    void* dq, void* dk, void* dv, int bh, int n, int d, float scale, void* stream) {
  return ga_flash_self_bwd_w1_config(q, k, v, dout, stats, dq, dk, dv, bh, n, d, scale, ga::kMainConfig, stream);
}

// K2: flash self-attention backward over [BH, N, D] bf16, for Hopper (sm_90a).
//
// Replaces guided_attention_tpu/ops/flash_attention.py `_self_bwd` /
// `_self_bwd_kernel` (custom VJP `_flash_bh_bwd`). With P the softmax of
// the scaled scores, delta = rowsum(dO * O) (= rowsum(dP * P)) and
// dS = P * (dP - delta) * scale: dV = P^T dO, dK = dS^T Q, dQ = dS K.
// The TPU kernel held one (b, h)'s whole K and V in VMEM, took P from a row
// max over all N, and carried dK and dV in fp32 across SEQUENTIAL q-block
// grid steps. A block here holds neither all N keys nor a carry: P is
// recomputed from K1's saved logsumexp, and the work is two passes, each
// owning its outputs, with no atomics and no cross-block sum, so every
// output element is written by one block and results are bitwise the same
// from run to run (the guidance loop's update gate compares losses between
// evals):
//   B. dQ over query tiles (launched first): each consumer warpgroup owns 64
//      queries, computes their delta = rowsum(dO * O) in its prologue (and
//      writes it out for pass A), and streams every key tile:
//      S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
//   A. dK and dV over key tiles: each consumer warpgroup owns 64 keys and
//      streams every query tile with its lse and delta:
//      S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers,
//      dV += P^T dO, dK += dS^T Q.
//
// What bounds it on the H100. The algorithm needs 10*N^2*D tensor-core
// operations per (b, h) (S, dP, dV, dK, dQ) and one exponential per
// (query, key) pair. The two passes recompute S and dP each, 14*N^2*D and
// two exponentials: the price of having no cross-block reduction. At
// D = 40 the tile shapes pad further (below): each pair costs 768 tensor
// operations, 0.104 ms at [8, 4096, 40], and the exponentials (16 exp2 per
// SM per clock) 0.069 ms, which can run while the tensor cores work.
//
// Design, shared by both passes (the building blocks are csrc/hopper.cuh's):
// - Every product on `wgmma` with fp32 accumulators in registers. The two
//   score products of a tile (S and dP, or S^T and dP^T) are m64n64k16 with
//   both operands K-major in shared memory. The gradient products take A
//   from registers: the S/dP accumulator, turned into P and dS in place and
//   converted to bf16 pairs (the accumulator layout is the A layout), and B
//   is the same swizzled Q, dO or K tile read MN-major (m64n64k16, D padded
//   to 64). S, dP, P and dS never touch shared memory; dQ, dK and dV stay in
//   registers for the whole loop and are written once. P and dS are rounded
//   to bf16 only as product operands, as in FlashAttention-2; the scale of
//   dS is applied to dK and dQ once, at the end.
// - Streamed tiles arrive by TMA into a ring of STAGES shared-memory stages
//   guarded by mbarriers (full: the producer's loads landed; empty: every
//   consumer warp is done with the stage). The first warp of a producer
//   warpgroup issues every load; the block's own tiles (K and V, or Q and
//   dO) are loaded once. The
//   tensor maps are 3-D [BH, N, D], so a ragged last tile zero-fills inside
//   its own head. In pass A the producer's lanes also put each query
//   tile's -lse*log2(e) and delta into the stage, with -inf and 0 for the
//   rows >= N, so that a padded query's P and dS are exactly 0 (a
//   zero-filled Q row gives S = 0, and exp(0 - lse) is not 0). In pass B a
//   ragged last key tile's P is masked to 0. delta comes from pass B's
//   prologue: pass B owns those rows, and it saves the launch of a delta
//   kernel, which measured slower on the H100.
// - Registers bound the schedule. Pass A keeps dK and dV (two m64n64 fp32
//   accumulators, 64 registers a thread) beside S^T and dP^T (64 more) and
//   their bf16 operands. Holding a second tile's scores to overlap one
//   tile's exponentials with the previous tile's gradient products (K1's
//   schedule) made ptxas spill and serialize the wgmma (C7512) even with
//   the producer's registers handed over, and ran slower. So each
//   consumer runs its tile in order, scores, exponentials, gradient
//   products, and overlap comes from elsewhere: the two consumer
//   warpgroups of a block interleave on the SM (one's exponentials under
//   the other's products), and pass A issues a tile's gradient products
//   in two halves, each as soon as the exponentials of its 32 columns are
//   done, so the tensor cores start on the first while the second is
//   computed. The producer warpgroup keeps 24 registers a thread and hands
//   the rest to the consumers (setmaxnreg); with it, ptxas gives the
//   consumers the launch bound's full 168 registers.
// - Head dim 40 against the tensor-core shapes: 64-column TMA boxes read
//   columns D..63 as zeros, the score products run over ceil(D/16) k16
//   slices (48 deep at D = 40) and the gradient products 64 wide.
//
// Tile shapes are template parameters: (keys per block, queries per tile,
// stages) of pass A and (queries per block, keys per tile, stages) of pass
// B, in the configurations of launch_config below. The main path's entry
// point runs kMainConfig, 128 own rows per block in both passes (256
// blocks at [8, 4096, 40]: two waves on 132 SMs, the second 94% full);
// the others are reached only through ga_flash_self_bwd_config.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace ga {
namespace {

using namespace hopper;

// the configuration ga_flash_self_bwd runs (see launch_config)
constexpr int kMainConfig = 0;

// One pass's tiles: CW consumer warpgroups of 64 own rows each, streamed
// tiles of BT rows, STAGES ring stages, MINB blocks per SM. The block is
// the consumers and one producer warpgroup, whose first warp issues the
// loads and which hands the rest of its registers to the consumers
// (setmaxnreg): every thread starts with base_regs (from
// __launch_bounds__), the producer keeps producer_regs and the consumers
// grow to consumer_regs.
template <int CW_, int BT_, int STAGES_, int MINB_>
struct Tiles {
  static constexpr int CW = CW_, BT = BT_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int OWN = 64 * CW;  // own rows per block
  static constexpr int own_bytes = OWN * kSwizzleRowBytes;  // one own tile (K or V; Q or dO)
  static constexpr int t_bytes = BT * kSwizzleRowBytes;     // one streamed tile
  static constexpr int threads = CW * 128 + 128;
  static constexpr int base_regs = 65536 / (MINB * threads) / 8 * 8;
  static constexpr int producer_regs = 24;
  static constexpr int consumer_regs = (base_regs * threads - producer_regs * 128) / (CW * 128) / 8 * 8;
  static_assert(consumer_regs <= 256, "setmaxnreg takes at most 256");
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
// stage, `stat_bytes` of row statistics per stage (pass A) or per block
// (pass B), then the mbarriers own_full, full[STAGES], empty[STAGES].
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

// pass A: per stage, one float4 per pair of query columns (see grads_cols)
template <class T>
using SmemA = Smem<T, T::STAGES * T::BT / 2 * 16>;
// pass B: the block's delta, one float per own row
template <class T>
using SmemB = Smem<T, T::OWN * 4>;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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

// k16 slices [K0, K1) of an m64 x BT accumulator as the A operand: slice kk
// is columns 16kk..16kk+15
template <int BT, int K0, int K1>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BT / 2], uint32_t (&a)[BT / 16][4]) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Pass A, 8-column chunks [C0, C1) of one tile in place: s = S^T (rows
// keys, columns queries) becomes P^T = exp2(s * scale_log2 - lse2[col]) and
// dp = dP^T becomes P^T * (dP^T - delta[col]) (dS^T / scale). A thread
// holds columns 8c + 2*quad + {0, 1}; stats[m] = {-lse2[2m], -lse2[2m+1],
// delta[2m], delta[2m+1]}, so one 16-byte read serves a column pair in
// both rows.
template <int BT, int C0, int C1>
__device__ __forceinline__ void grads_cols(float (&s)[BT / 2], float (&dp)[BT / 2], const float4* stats,
                                           float scale_log2, int quad) {
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
      dp[x] = p0 * (dp[x] - st.z);
      dp[x + 1] = p1 * (dp[x + 1] - st.w);
    }
  }
}

// Pass B, one tile in place: dp = dP becomes P * (dP - delta) (dS / scale),
// P = exp2(s * scale_log2 - lse2) with this thread's two rows' -lse2 in
// nl and delta in dl. With MASK, columns at or past `valid` (keys >= n)
// get P = 0.
template <int BT, bool MASK>
__device__ __forceinline__ void grads_rows(const float (&s)[BT / 2], float (&dp)[BT / 2], const float (&nl)[2],
                                           const float (&dl)[2], float scale_log2, int valid, int quad) {
#pragma unroll
  for (int c = 0; c < BT / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * i + e;
        float p = ex2(fmaf(s[x], scale_log2, nl[i]));
        if (MASK && 8 * c + 2 * quad + e >= valid) p = 0.f;
        dp[x] = p * (dp[x] - dl[i]);
      }
}

// rows r and r + 8 of a warpgroup's m64n64 accumulator (times `mul`), the
// first d columns, to bf16 rows row0 + r (+ 8) of a [n, d] matrix
__device__ __forceinline__ void store_rows(const float (&acc)[32], float mul, bf16* __restrict__ out, int row0,
                                           int n, int d, int quad) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= n) continue;
    bf16* dst = out + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * mul, acc[4 * c + 2 * i + 1] * mul);
      }
    }
  }
}

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t xa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t xb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb[i]));
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// pass B: dQ (and delta) for the 64 * CW queries of one block
// ---------------------------------------------------------------------------

template <class T, int DK>
__global__ void __launch_bounds__(T::threads, T::MINB)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int n, int d, float scale, float scale_log2) {
  using L = SmemB<T>;
  constexpr int BT = T::BT, STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* delta_s = reinterpret_cast<float*>(smem + L::stat_off);
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
    // producer: lane 0 loads Q and dO once, then K and V tile by tile
    setmaxnreg_dec<T::producer_regs>();
    if (warp == 4 * T::CW && lane == 0) {
      mbar_arrive_expect_tx(own_full, 2 * T::own_bytes);
      tma_load_3d(smem + L::own0, &tm_q, own_full, 0, q0, bh);
      tma_load_3d(smem + L::own1, &tm_do, own_full, 0, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::t_bytes);
        tma_load_3d(smem + L::t0 + s * T::t_bytes, &tm_k, &full[s], 0, j * BT, bh);
        tma_load_3d(smem + L::t1 + s * T::t_bytes, &tm_v, &full[s], 0, j * BT, bh);
      }
    }
  } else {
    setmaxnreg_inc<T::consumer_regs>();
    // consumer warpgroup `wg` owns block rows [64 wg, 64 wg + 64); this
    // thread holds rows r and r + 8 of them (accumulator layout, hopper.cuh)
    const int wg = warp / 4;
    const int quad = lane % 4;
    const int r = 64 * wg + 16 * (warp % 4) + lane / 4;

    // delta = rowsum(dO * O) of the warpgroup's rows, two threads a row,
    // while the first tiles load; written out for pass A
    {
      const int t = threadIdx.x % 128;
      const int row_l = 64 * wg + t / 2;
      const int row = q0 + row_l;
      float acc = 0.f;
      if (row < n) {
        const uint4* a = reinterpret_cast<const uint4*>(o + ((size_t)bh * n + row) * d);
        const uint4* b = reinterpret_cast<const uint4*>(dout + ((size_t)bh * n + row) * d);
        for (int c = t % 2; c < d / 8; c += 2) acc += dot8(a[c], b[c]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (t % 2 == 0) {
        delta_s[row_l] = acc;
        if (row < n) delta[(size_t)bh * n + row] = acc;
      }
      warpgroup_sync(wg);
    }
    float nl[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r + 8 * i;
      nl[i] = row < n ? -lse[(size_t)bh * n + row] * kLog2e : -INFINITY;
      dl[i] = delta_s[r + 8 * i];
    }

    const uint32_t q_addr = smem_u32(smem + L::own0) + wg * 64 * kSwizzleRowBytes;
    const uint32_t do_addr = smem_u32(smem + L::own1) + wg * 64 * kSwizzleRowBytes;
    const uint32_t k_base = smem_u32(smem + L::t0);
    const uint32_t v_base = smem_u32(smem + L::t1);
    const bool ragged = n % BT != 0;

    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    float s_acc[BT / 2], dp_acc[BT / 2];
    uint32_t ds_frag[BT / 16][4];
    mbar_wait(own_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t k_addr = k_base + s * T::t_bytes;
      // S_j = Q K_j^T and dP_j = dO V_j^T
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      ss_product<BT, DK>(s_acc, q_addr, k_addr);
      ss_product<BT, DK>(dp_acc, do_addr, v_base + s * T::t_bytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp_acc);
      // dS_j, then dQ += dS_j K_j
      if (ragged && j == n_tiles - 1) {
        grads_rows<BT, true>(s_acc, dp_acc, nl, dl, scale_log2, n - j * BT, quad);
      } else {
        grads_rows<BT, false>(s_acc, dp_acc, nl, dl, scale_log2, n - j * BT, quad);
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

    store_rows(dq_acc, scale, dq + (size_t)bh * n * d, q0 + r, n, d, quad);
  }
}

// ---------------------------------------------------------------------------
// pass A: dK and dV for the 64 * CW keys of one block
// ---------------------------------------------------------------------------

template <class T, int DK>
__global__ void __launch_bounds__(T::threads, T::MINB)
    dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n, int d, float scale, float scale_log2) {
  using L = SmemA<T>;
  constexpr int BT = T::BT, STAGES = T::STAGES;
  static_assert(BT == 64, "one column pair of statistics per producer lane");
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
      const float* lse_bh = lse + (size_t)bh * n;
      const float* delta_bh = delta + (size_t)bh * n;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // this lane's column pair, read before the wait so that the loads
        // overlap it; a query row >= n gets -lse2 = -inf and delta = 0: P = dS = 0
        const int col = j * BT + 2 * lane;
        float4 st;
        st.x = col < n ? -lse_bh[col] * kLog2e : -INFINITY;
        st.y = col + 1 < n ? -lse_bh[col + 1] * kLog2e : -INFINITY;
        st.z = col < n ? delta_bh[col] : 0.f;
        st.w = col + 1 < n ? delta_bh[col + 1] : 0.f;
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
        grads_cols<BT, C0, C1>(s_acc, dp_acc, stats + s * (BT / 2), scale_log2, quad);
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
    store_rows(dk_acc, scale, dk + base, k0 + r, n, d, quad);
    store_rows(dv_acc, 1.f, dv + base, k0 + r, n, d, quad);
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

// Pass B, then pass A (which reads the delta pass B writes), on one stream.
template <class A, class B, int DK>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout, const float* lse,
                   float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int d, float scale,
                   cudaStream_t stream) {
  using LA = SmemA<A>;
  using LB = SmemB<B>;
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
  auto kb = dq_kernel<B, DK>;
  auto ka = dkdv_kernel<A, DK>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, LB::alloc);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, LA::alloc);
  if (err == cudaSuccess) err = check_registers<B>(kb);
  if (err == cudaSuccess) err = check_registers<A>(ka);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  kb<<<grid_of<B>(bh, n), B::threads, LB::alloc, stream>>>(bq, bdo, bk, bv, o, dout, lse, delta, dq, n, d, scale,
                                                            scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ka<<<grid_of<A>(bh, n), A::threads, LA::alloc, stream>>>(ak, av, aq, ado, lse, delta, dk, dv, n, d, scale,
                                                            scale_log2);
  return cudaGetLastError();
}

// configuration index -> Tiles<consumer warpgroups, streamed tile, stages,
// blocks per SM> of pass A (keys per block = 64 x warpgroups, query tiles),
// then of pass B (queries per block, key tiles):
// 0: A 128 keys x 64-query tiles, B 128 queries x 64-key tiles, 4 stages;
//    1 block per SM (384 threads, 99 KB shared)
// 1: the same with 2 stages (66 KB)
// 2: 64 own rows (one consumer warpgroup, 256 threads), 4 stages, 2 blocks
//    per SM (83 KB each): twice the blocks for the wave fill, but 128
//    registers a thread, under what pass A holds (ptxas spills)
template <int DK, int CONFIG>
cudaError_t launch_config(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                          const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int bh, int n, int d,
                          float scale, cudaStream_t stream) {
  auto run = [&](auto launch_fn) {
    return launch_fn(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, n, d, scale, stream);
  };
  if constexpr (CONFIG == 0) return run(launch<Tiles<2, 64, 4, 1>, Tiles<2, 64, 4, 1>, DK>);
  else if constexpr (CONFIG == 1) return run(launch<Tiles<2, 64, 2, 1>, Tiles<2, 64, 2, 1>, DK>);
  else return run(launch<Tiles<1, 64, 4, 2>, Tiles<1, 64, 4, 2>, DK>);
}

}  // namespace
}  // namespace ga

// Any of the tile configurations at head dim 40; only kMainConfig at 64.
extern "C" int ga_flash_self_bwd_config(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                                        int bh, int n, int d, float scale, int config, void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto args = [&](auto launch_fn) {
    return (int)launch_fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                          static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                          static_cast<bf16*>(dv), bh, n, d, scale, static_cast<cudaStream_t>(stream));
  };
  // the presets' head dims: 40 (SD1.5, three k16 slices) and 64 (SD2.1, four)
  if (d == 40) {
    switch (config) {
      case 0: return args(ga::launch_config<3, 0>);
      case 1: return args(ga::launch_config<3, 1>);
      case 2: return args(ga::launch_config<3, 2>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 64 && config == ga::kMainConfig) return args(ga::launch_config<4, ga::kMainConfig>);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ga_flash_self_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int n, int d,
                                 float scale, void* stream) {
  return ga_flash_self_bwd_config(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, n, d, scale, ga::kMainConfig,
                                  stream);
}

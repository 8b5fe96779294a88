// V1: self-attention forward with the ones-column denominator, over
// [BH, N, D] bf16, D = 40 or 64, for Hopper (sm_90a).
//
// Replaces scripts/perf_attn_kernel.py `fwd_v1` / `_fwd_kernel_v1`, a
// microbench variant of K1: s = (q k^T) * scale in fp32, P~ = exp(s - max),
// and o = (P~ V) / (P~ 1), numerator and denominator from the same P~
// operand on the matrix unit (the TPU appended a ones column to V). With
// BF16_P, P~ is rounded to bf16 before both products (the TPU's V2); else
// it keeps fp32 precision through them (the TPU's V1). No logsumexp.
//
// What bounds it on the H100: as K1, the N^2 exponentials (0.069 ms at
// [16, 4096, 40], 16 exp2 per SM per clock) over the 4*N^2*D tensor-core
// operations (0.043 ms); the padded products of this design (below) take
// 0.061 ms with BF16_P and about twice that without it.
//
// Design: K1's machinery (csrc/flash_self_fwd.cu, on csrc/hopper.cuh), per
// block of BQ = 64*CW queries of one (b, h):
// - Consumer warpgroups of 64 query rows with S, P~ and O in registers:
//   S = Q K^T is m64n{BK}k16 with Q and K K-major in shared memory; O += P~ V
//   is m64n64k16 with P~ as the register A operand and V MN-major in
//   shared memory.
// - The denominator. The TPU's ones column lived in V's lane padding; here
//   a zero pad exists only at D = 40, and TMA rewrites it with zeros on
//   every stage. So the ones are a constant all-ones B tile [16 x 8] in
//   shared memory, written once per block: each k16 slice of P~ V is
//   followed by one m64n8k16 `wgmma` with the same register A operand and
//   that tile, which accumulates the row sums of P~ (eight equal columns)
//   in 4 fp32 registers a thread. Every entry is 1, so the tile needs a
//   valid descriptor (no swizzle, K-major) and no particular layout. It is
//   rescaled by alpha with O and divides O once at the end.
// - K and V by TMA into a ring of STAGES stages with separate K and V
//   mbarriers and one producer warp (K one tile ahead of V); an online max
//   in registers (one row per quad of threads, two shuffles) with the
//   rescale by alpha = exp2(m_old - m_new), `exp2` with the scale folded
//   in; the next tile's Q K^T issued together with this tile's P~ V, so the
//   exponentials of one tile run under the products of the other.
// - Without BF16_P the tensor cores, which take no fp32 operand, see P~ as
//   hi = bf16(P~) and lo = bf16(P~ - hi): O += hi V + lo V and l += hi 1 +
//   lo 1, fp32 accumulation. |P~ - hi - lo| <= 2^-9 |P~ - hi| <= 2^-18 P~,
//   far below the bf16 rounding of the output. The split costs a subtract
//   and a convert per element, twice the PV and denominator products, and
//   BK/2 more registers a thread for the lo fragments (32 at BK = 128,
//   about 200 in all). ptxas holds the 288-thread block to 168 registers
//   a thread, so 128-key tiles spill 192 bytes and serialize the wgmma
//   (C7512). A producer warpgroup handing its registers to the consumers
//   (setmaxnreg, as K2 does) did not lift that: ptxas kept the launch
//   bound's 168 (128 at 2 blocks per SM) and spilled more. So without
//   BF16_P the entry point runs 64-key tiles (config 1: 156 registers, no
//   spill), which also measured faster; with BF16_P, 128-key tiles (160
//   registers). chip_smoke.py prints ptxas's counts.
// - Head dim 40 against the tensor-core shapes (hopper.cuh): 64-column TMA
//   boxes read columns D..63 as zeros, Q K^T runs over ceil(D/16) k16
//   slices, P~ V 64 wide. Head dim 64 fills the boxes.
// - Ragged N: 3-D tensor maps zero-fill inside the head; keys >= n are -inf
//   on the last tile only (P~ = 0 there, in both products); rows >= n are
//   not written.
//
// Tile shapes are template parameters: (queries, keys, stages) of the
// configurations of launch_config, K1's three. The entry point runs
// kMainConfig[bf16_p]; ga_flash_self_fwd_v1_config reaches any of them, at
// head dim 40 and 64, for the microbench. Non-causal and deterministic: every block
// owns its rows.
#include "common.cuh"
#include "hopper.cuh"

namespace ga {
namespace {

using namespace hopper;

// the configuration ga_flash_self_fwd_v1 runs (see launch_config), by
// bf16_p: 64-key tiles without it, 128-key tiles with it
constexpr int kMainConfig[2] = {1, 0};

// the all-ones B tile of the denominator product: 8 columns x 16 keys of
// bf16 is 256 bytes; the descriptor below reads inside the first 256
constexpr int kOnesBytes = 512;
constexpr uint32_t kBf16OnePair = 0x3F803F80u;  // two bf16 1.0

template <int CW, int BK, int STAGES>
struct V1Smem {
  static constexpr int BQ = 64 * CW;
  static constexpr int q_bytes = BQ * kSwizzleRowBytes;
  static constexpr int kv_bytes = BK * kSwizzleRowBytes;  // one K or V tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + q_bytes;
  static constexpr int v_off = k_off + STAGES * kv_bytes;
  static constexpr int ones_off = v_off + STAGES * kv_bytes;
  static constexpr int bar_off = ones_off + kOnesBytes;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int bytes = bar_off + (1 + 4 * STAGES) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base to the 1024-byte swizzle atom
};

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (the wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of an unswizzled K-major tile: core matrices of 8 rows x 16
// bytes, `lbo` bytes apart along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D += A B with A [64 x 16] in registers and B [16 x 8] K-major in shared
// memory: d[2*i + e] holds row 16*warp + lane/4 + 8*i, column 2*(lane%4) + e
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q K^T over DK k16 slices (Q rows of this warpgroup, one K tile)
template <int BK, int DK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    wgmma_ss<BK>(s, desc_sw128(q_addr + 32 * kk, 16, 1024), desc_sw128(k_addr + 32 * kk, 16, 1024), kk > 0);
  }
}

// O += P V and l += P 1 over the BK keys of one V tile, 16 keys (2048
// bytes of V) per slice
template <int BK>
__device__ __forceinline__ void pv_product(float (&o)[32], float (&l)[4], const uint32_t (&p)[BK / 16][4],
                                           uint32_t v_addr, uint64_t ones) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs_n64_mn(o, p[kk], desc_sw128(v_addr + 16 * kSwizzleRowBytes * kk, BK * kSwizzleRowBytes, 1024));
    wgmma_rs_n8(l, p[kk], ones);
  }
}

// Online max of one score tile, in place: s becomes exp2(s*scale_log2 -
// m_new) per row; m (running max, scaled log2 units) moves on and alpha =
// exp2(m_old - m_new) rescales O and l. With MASK, columns at or past
// `valid` (keys >= n) count as -inf. The max runs as four independent
// chains per row.
template <int BK, bool MASK>
__device__ __forceinline__ void exp_tile(float (&s)[BK / 2], float (&m)[2], float (&alpha)[2], float scale_log2,
                                         int valid, int quad) {
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
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * c + 2 * i + e] = ex2(fmaf(s[4 * c + 2 * i + e], scale_log2, -m_new));
  }
}

// P~ as the A operand of the products: slice kk is columns 16kk..16kk+15;
// with SPLIT also the residual lo = bf16(P~ - hi)
template <int BK, bool SPLIT>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BK / 2], uint32_t (&hi)[BK / 16][4],
                                               uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16x2(a, b);
      hi[kk][r] = h;
      if (SPLIT) lo[kk][r] = pack_bf16x2(a - __uint_as_float(h << 16), b - __uint_as_float(h & 0xffff0000u));
    }
}

__device__ __forceinline__ void rescale(float (&o)[32], float (&l)[4], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    o[4 * c + 0] *= alpha[0];
    o[4 * c + 1] *= alpha[0];
    o[4 * c + 2] *= alpha[1];
    o[4 * c + 3] *= alpha[1];
  }
  l[0] *= alpha[0];
  l[1] *= alpha[0];
  l[2] *= alpha[1];
  l[3] *= alpha[1];
}

template <int CW, int BK, int STAGES, int MINB, int DK, bool BF16_P>
__global__ void __launch_bounds__(CW * 128 + 32, MINB)
    flash_self_fwd_v1_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int n, int d,
                             float scale_log2) {
  using L = V1Smem<CW, BK, STAGES>;
  constexpr bool SPLIT = !BF16_P;
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

  if (threadIdx.x < kOnesBytes / 4) {
    reinterpret_cast<uint32_t*>(smem + L::ones_off)[threadIdx.x] = kBf16OnePair;
    fence_proxy_async_smem();
  }
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
  // 16 keys x 8 columns, K-major: two 128-byte core matrices along K
  const uint64_t ones = desc_plain(smem_u32(smem + L::ones_off), 128, 256);
  const bool ragged = n % BK != 0;

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float s_acc[BK / 2];
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY};
  float alpha[2];

  // tile 0: S_0, its exponentials, P~_0
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
  qk_product<BK, DK>(s_acc, q_addr, k_base);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s_acc);
  if (lane == 0) mbar_arrive(&k_empty[0]);
  if (ragged && n_tiles == 1) {
    exp_tile<BK, true>(s_acc, m_run, alpha, scale_log2, n, quad);
  } else {
    exp_tile<BK, false>(s_acc, m_run, alpha, scale_log2, n, quad);
  }
  to_a_fragments<BK, SPLIT>(s_acc, p_hi, p_lo);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int sp = (j - 1) % STAGES;
    // issue S_j = Q K_j^T, rescale O and l by the last alpha, issue
    // O += P~_{j-1} V_{j-1} and l += P~_{j-1} 1 (hi, then lo)
    mbar_wait(&k_full[s], (j / STAGES) & 1);
    wgmma_fence();
    qk_product<BK, DK>(s_acc, q_addr, k_base + s * L::kv_bytes);
    wgmma_commit();
    rescale(o_acc, l_acc, alpha);
    mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
    wgmma_fence();
    pv_product<BK>(o_acc, l_acc, p_hi, v_base + sp * L::kv_bytes, ones);
    if constexpr (SPLIT) pv_product<BK>(o_acc, l_acc, p_lo, v_base + sp * L::kv_bytes, ones);
    wgmma_commit();
    // exponentials of S_j while P~_{j-1} V_{j-1} runs
    wgmma_wait<1>();
    fence_regs(s_acc);
    if (lane == 0) mbar_arrive(&k_empty[s]);
    if (ragged && j == n_tiles - 1) {
      exp_tile<BK, true>(s_acc, m_run, alpha, scale_log2, n - j * BK, quad);
    } else {
      exp_tile<BK, false>(s_acc, m_run, alpha, scale_log2, n - j * BK, quad);
    }
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(l_acc);
    fence_regs(p_hi);
    if constexpr (SPLIT) fence_regs(p_lo);
    if (lane == 0) mbar_arrive(&v_empty[sp]);
    to_a_fragments<BK, SPLIT>(s_acc, p_hi, p_lo);
  }

  // the last P~ V
  const int last = (n_tiles - 1) % STAGES;
  rescale(o_acc, l_acc, alpha);
  mbar_wait(&v_full[last], ((n_tiles - 1) / STAGES) & 1);
  wgmma_fence();
  pv_product<BK>(o_acc, l_acc, p_hi, v_base + last * L::kv_bytes, ones);
  if constexpr (SPLIT) pv_product<BK>(o_acc, l_acc, p_lo, v_base + last * L::kv_bytes, ones);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);
  fence_regs(l_acc);

  // O / l, once; every column of l holds the row's sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r + 8 * i;
    if (row < n) {
      const float inv_l = 1.f / l_acc[2 * i];
      bf16* out = o + ((size_t)bh * n + row) * d;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * quad;
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(o_acc[4 * c + 2 * i] * inv_l, o_acc[4 * c + 2 * i + 1] * inv_l);
        }
      }
    }
  }
}

template <int CW, int BK, int STAGES, int MINB, int DK, bool BF16_P>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int n, int d, float scale,
                   cudaStream_t stream) {
  using L = V1Smem<CW, BK, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tile_map_3d(&tm_q, q, bh, n, d, L::BQ);
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_k, k, bh, n, d, BK);
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_v, v, bh, n, d, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_self_fwd_v1_kernel<CW, BK, STAGES, MINB, DK, BF16_P>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  dim3 grid((n + L::BQ - 1) / L::BQ, bh);
  kernel<<<grid, CW * 128 + 32, L::alloc, stream>>>(tm_q, tm_k, tm_v, o, n, d, scale * kLog2e);
  return cudaGetLastError();
}

// configuration index -> (consumer warpgroups, key tile, stages, blocks per SM):
// 0: 128 queries x 128 keys, 3 stages, 1 block per SM (113 KB shared, 288
//    threads); without BF16_P it spills (see the header)
// 1: 128 queries x 64 keys, 3 stages, 1 block per SM (65 KB; half the
//    score and lo registers)
// 2: 64 queries x 128 keys, 2 stages, 2 blocks per SM (73 KB each, 160
//    threads); spills without BF16_P
template <int DK, int CONFIG, bool BF16_P>
cudaError_t launch_config(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int n, int d, float scale,
                          cudaStream_t stream) {
  if constexpr (CONFIG == 0) return launch<2, 128, 3, 1, DK, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
  else if constexpr (CONFIG == 1) return launch<2, 64, 3, 1, DK, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
  else return launch<1, 128, 2, 2, DK, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
}

template <int DK, bool BF16_P>
int launch_index(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int n, int d, float scale, int config,
                 cudaStream_t stream) {
  switch (config) {
    case 0: return (int)launch_config<DK, 0, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
    case 1: return (int)launch_config<DK, 1, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
    case 2: return (int)launch_config<DK, 2, BF16_P>(q, k, v, o, bh, n, d, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ga

// Any of the tile configurations, at the presets' head dims: 40 (SD1.5,
// three k16 slices in Q K^T) and 64 (SD2.1, four).
extern "C" int ga_flash_self_fwd_v1_config(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                                           float scale, int bf16_p, int config, void* stream) {
  using ga::bf16;
  if (bh <= 0 || n <= 0) return 0;
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 40) {
    return bf16_p ? ga::launch_index<3, true>(qp, kp, vp, op, bh, n, d, scale, config, s)
                  : ga::launch_index<3, false>(qp, kp, vp, op, bh, n, d, scale, config, s);
  }
  if (d == 64) {
    return bf16_p ? ga::launch_index<4, true>(qp, kp, vp, op, bh, n, d, scale, config, s)
                  : ga::launch_index<4, false>(qp, kp, vp, op, bh, n, d, scale, config, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ga_flash_self_fwd_v1(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                                    float scale, int bf16_p, void* stream) {
  const int config = ga::kMainConfig[bf16_p ? 1 : 0];
  return ga_flash_self_fwd_v1_config(q, k, v, o, bh, n, d, scale, bf16_p, config, stream);
}

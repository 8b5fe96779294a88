// K3: cross-attention with the head-mean probability map, forward, for Hopper.
//
// Replaces guided_attention_tpu/ops/flash_attention.py
// `_cross_attention_fwd_impl` / `_cross_fwd_kernel` (:241, kernel :213). The
// TPU kernel padded the 77 text keys to a 128-lane tile, masked them at
// kv_len, and summed the map over an innermost sequential head grid axis
// into one output block. CUDA blocks run in parallel and in no order, so
// here the heads are split over the blocks of a thread-block cluster and the
// map is summed across the cluster through distributed shared memory.
//
// Bound on the H100: at the main path's shapes (q [1, 8, 256, 160], k/v
// [1, 8, 77, 160]) the work is 0.1 GFLOP and 1.8 MB, under a microsecond of
// either, so latency bounds it: the launch of a clustered grid, one round
// trip of the loads, and the chain of dependent instructions each warp runs
// per head. The design keeps that chain short and spreads it over many
// blocks and warps:
// - one block per (batch row, tile of ROWS queries, group of heads); the
//   groups of one query tile form a cluster of at most 8 blocks (8 blocks of
//   one head at SD1.5's 8 heads, 7 blocks of 3 or 2 heads at SD2.1's 20), so
//   the main shape runs 128 blocks;
// - four warps per 16 query rows: they split the 16-key slices of Q K^T and
//   the softmax (each row's max and sum: two quad shuffles in the
//   accumulator layout, then one exchange through shared memory), and the
//   16-column slices of P V. A single warp per 16 rows, with the whole
//   softmax of its rows in its own registers, was several times slower;
// - Q K^T and P V on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   sums); keys padded to a multiple of 16 and masked to -inf before the row
//   max, the head dim read in 64-column boxes whose columns past D are zeros
//   (D = 40 computes over 48);
// - P stays fp32 for the map and is rounded to bf16 only as the A operand
//   of P V (the TPU kernel's p.astype(v.dtype)); V's B fragments come
//   through ldmatrix.trans from the swizzled boxes;
// - Q, K and V arrive by TMA as 64-column boxes of 128-byte swizzled rows
//   (3 requests per tensor at D = 160), rows past nq or nk and columns past
//   D filled with zeros by the copy itself (one bulk copy per row was slower:
//   each request costs the TMA unit time). K and V are loaded once per block
//   and head; with several heads per block the next head's Q and K load
//   under this head's softmax and P V, its V under the next Q K^T;
// - each block sums P over its heads in shared memory (each element owned
//   by one thread); after a cluster barrier each block sums one slice of the
//   tile's rows over the cluster's blocks, in rank order, scales by 1/H and
//   writes it once. No atomics: out and map are bitwise the same from run
//   to run.
//
// q [B, H, Nq, D], k/v [B, H, NK, D] bf16, D % 8 == 0, D <= 256, NK <= 128;
// out [B, H, Nq, D] bf16 and map [B, Nq, NK] fp32 = mean over heads of
// softmax(q k^T * scale). The launch geometry (heads per block, cluster
// size) comes from the caller: ops/flash_attention.py's cross_map_geometry.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ga {
namespace {

namespace cg = cooperative_groups;
using hopper::fence_barrier_init;
using hopper::kSwizzleRowBytes;
using hopper::kSwizzleRowCols;
using hopper::make_tile_map_3d;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::pack_bf16x2;
using hopper::smem_u32;
using hopper::tma_load_3d;

constexpr int kMaxKeys = 128;
constexpr int kMaxDim = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kTileWarps = 4;   // warps per 16 query rows
constexpr int kKeyPairs = kMaxKeys / 16 / kTileWarps;  // 16-key slices of S per warp
constexpr int kColPairs = kMaxDim / 16 / kTileWarps;   // 16-column slices of O per warp

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int boxes(int d) { return (d + kSwizzleRowCols - 1) / kSwizzleRowCols; }

// Shared memory, from a 1024-byte aligned base (the swizzle atom):
//   Q  boxes(d) x [ROWS][64] bf16, 128-byte swizzled rows (TMA)
//   K  boxes(d) x [nkp][64], V the same
//   P  [ROWS][nkp + 8] bf16 (an odd number of 16-byte units per row, so
//      ldmatrix's eight rows hit eight bank groups)
//   M  [ROWS][nkp] fp32, the block's sum of P over its heads
//   the row statistics exchanged between a tile's warps [2][ROWS / 16][4][16] fp32
//   two mbarriers (Q and K, V)
struct Smem {
  int q, k, v, p, m, stat, bar, bytes;
  __host__ __device__ Smem(int rows, int nk, int d) {
    const int nkp = pad16(nk);
    q = 0;
    k = q + boxes(d) * rows * kSwizzleRowBytes;
    v = k + boxes(d) * nkp * kSwizzleRowBytes;
    p = v + boxes(d) * nkp * kSwizzleRowBytes;
    m = p + rows * (nkp + 8) * 2;
    stat = m + rows * nkp * 4;
    bar = stat + 2 * rows * kTileWarps * 4;
    bytes = bar + 16 + 1024;  // room to align the base
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared address of the 16 bytes at (row, col) of a tile stored as 64-column
// boxes of `rows_per_box` 128-byte swizzled rows (chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(uint32_t base, int rows_per_box, int row, int col) {
  return base + (col / kSwizzleRowCols) * rows_per_box * kSwizzleRowBytes + row * kSwizzleRowBytes +
         ((((col % kSwizzleRowCols) / 8) ^ (row % 8)) * 16);
}

// grid (groups, query tiles, B), cluster (groups, 1, 1): cluster rank =
// head group. 4 warps per 16 query rows: they split the keys of Q K^T and
// the softmax, and the output columns of P V.
template <int ROWS>
__global__ void __launch_bounds__(ROWS * 2 * kTileWarps)
    cross_map_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ pmap,
                     int heads, int heads_per_block, int nq, int nk, int d, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int group = (int)cluster.block_rank();
  const int groups = (int)cluster.num_blocks();
  const int q0 = blockIdx.y * ROWS;
  const int b = blockIdx.z;
  const int h0 = group * heads_per_block;
  const int nh = min(heads_per_block, heads - h0);
  const int rows = min(ROWS, nq - q0);  // the tile's real query rows
  const int nkp = pad16(nk);
  const int nbox = boxes(d);
  const int pld = nkp + 8;  // P's row stride

  const Smem L(ROWS, nk, d);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem + L.q);
  const uint32_t k_s = smem_u32(smem + L.k);
  const uint32_t v_s = smem_u32(smem + L.v);
  const uint32_t p_s = smem_u32(smem + L.p);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* stat_max = reinterpret_cast<float*>(smem + L.stat);  // [ROWS / 16][4][16]
  float* stat_sum = stat_max + ROWS * kTileWarps;
  uint64_t* bar_qk = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* bar_v = bar_qk + 1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = warp / kTileWarps;  // 16-row tile of the block
  const int tw = warp % kTileWarps;    // warp within the tile
  const int g = lane / 4;              // accumulator rows g and g + 8 of the tile
  const int t = lane % 4;              // accumulator columns 2t, 2t + 1 of each n8 tile
  const int r0 = tile * 16 + g;        // block rows of this thread: r0, r0 + 8

  // One thread issues a head's loads as 64-column boxes; rows past nq or nk
  // and columns past d arrive as zeros. Each barrier completes one phase per
  // head; the next head's loads start once every warp is done with the rows
  // they overwrite.
  auto issue_qk = [&](int h) {
    const int bh = b * heads + h;
    mbar_arrive_expect_tx(bar_qk, nbox * (ROWS + nkp) * kSwizzleRowBytes);
    for (int c = 0; c < nbox; ++c) {
      tma_load_3d(smem + L.q + c * ROWS * kSwizzleRowBytes, &tm_q, bar_qk, c * kSwizzleRowCols, q0, bh);
      tma_load_3d(smem + L.k + c * nkp * kSwizzleRowBytes, &tm_k, bar_qk, c * kSwizzleRowCols, 0, bh);
    }
  };
  auto issue_v = [&](int h) {
    const int bh = b * heads + h;
    mbar_arrive_expect_tx(bar_v, nbox * nkp * kSwizzleRowBytes);
    for (int c = 0; c < nbox; ++c) {
      tma_load_3d(smem + L.v + c * nkp * kSwizzleRowBytes, &tm_v, bar_v, c * kSwizzleRowCols, 0, bh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    fence_barrier_init();
    if (nh > 0) {  // the first head's loads fly while the block zeroes its map sum
      issue_qk(h0);
      issue_v(h0);
    }
  }
  float4* m4 = reinterpret_cast<float4*>(Ms);
  for (int i = threadIdx.x; i < ROWS * nkp / 4; i += blockDim.x) m4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // barriers initialized, map sum zeroed

  const int key_pairs = nkp / 16;
  const int col_pairs = pad16(d) / 16;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    mbar_wait(bar_qk, j & 1);  // Q and K of head h

    // S = Q K^T: this warp's 16-key slices tw, tw + 4 of the tile's 16 rows
    float s[kKeyPairs][2][4];
#pragma unroll
    for (int i = 0; i < kKeyPairs; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][0][e] = s[i][1][e] = 0.f;
    }
    for (int kk = 0; kk < d; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, swz(q_s, ROWS, tile * 16 + lane % 16, kk + (lane / 16) * 8));
#pragma unroll
      for (int i = 0; i < kKeyPairs; ++i) {
        const int np = tw + kTileWarps * i;
        if (np < key_pairs) {
          uint32_t kb[4];
          ldmatrix_x4(kb, swz(k_s, nkp, np * 16 + lane % 8 + (lane / 16) * 8, kk + ((lane / 8) % 2) * 8));
          mma_bf16(s[i][0], a, kb[0], kb[1]);
          mma_bf16(s[i][1], a, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with Q and K
    if (j + 1 < nh && threadIdx.x == 0) issue_qk(h + 1);

    // softmax of rows r0 and r0 + 8 (s[.][.][0..1] and s[.][.][2..3]) over
    // the tile's four warps; keys past nk masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKeyPairs; ++i) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (tw + kTileWarps * i) * 16 + n * 8 + 2 * t + (e & 1);
          const float x = col < nk ? s[i][n][e] * scale : -INFINITY;
          s[i][n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) stat_max[(tile * kTileWarps + tw) * 16 + g + 8 * r] = mx[r];
    }
    __syncthreads();
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) mx[r] = fmaxf(mx[r], stat_max[(tile * kTileWarps + w) * 16 + g + 8 * r]);
    }
#pragma unroll
    for (int i = 0; i < kKeyPairs; ++i) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[i][n][e] - mx[e / 2]);
          s[i][n][e] = p;
          sum[e / 2] += p;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      if (t == 0) stat_sum[(tile * kTileWarps + tw) * 16 + g + 8 * r] = sum[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) total += stat_sum[(tile * kTileWarps + w) * 16 + g + 8 * r];
      sum[r] = 1.f / total;
    }

    // fp32 P into the block's map sum (each element owned by this thread);
    // bf16 P into shared memory as the A operand of P V
#pragma unroll
    for (int i = 0; i < kKeyPairs; ++i) {
      const int np = tw + kTileWarps * i;
      if (np < key_pairs) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = np * 16 + n * 8 + 2 * t;
          const float p0 = s[i][n][0] * sum[0], p1 = s[i][n][1] * sum[0];
          const float p2 = s[i][n][2] * sum[1], p3 = s[i][n][3] * sum[1];
          float2* m0 = reinterpret_cast<float2*>(Ms + r0 * nkp + col);
          float2* m1 = reinterpret_cast<float2*>(Ms + (r0 + 8) * nkp + col);
          const float2 a0 = *m0, a1 = *m1;
          *m0 = make_float2(a0.x + p0, a0.y + p1);
          *m1 = make_float2(a1.x + p2, a1.y + p3);
          *reinterpret_cast<uint32_t*>(Ps + r0 * pld + col) = pack_bf16x2(p0, p1);
          *reinterpret_cast<uint32_t*>(Ps + (r0 + 8) * pld + col) = pack_bf16x2(p2, p3);
        }
      }
    }
    mbar_wait(bar_v, j & 1);  // V of head h
    __syncthreads();          // P of the tile complete

    // O = P V: this warp's 16-column slices tw, tw + 4, ... of the tile's 16 rows
    float acc[kColPairs][2][4];
#pragma unroll
    for (int i = 0; i < kColPairs; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][0][e] = acc[i][1][e] = 0.f;
    }
    for (int js = 0; js < key_pairs; ++js) {
      uint32_t a[4];
      ldmatrix_x4(a, p_s + ((tile * 16 + lane % 16) * pld + js * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int i = 0; i < kColPairs; ++i) {
        const int cp = tw + kTileWarps * i;
        if (cp < col_pairs) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, swz(v_s, nkp, js * 16 + lane % 8 + ((lane / 8) % 2) * 8, cp * 16 + (lane / 16) * 8));
          mma_bf16(acc[i][0], a, vb[0], vb[1]);
          mma_bf16(acc[i][1], a, vb[2], vb[3]);
        }
      }
    }
    const size_t orow = ((size_t)b * heads + h) * nq + q0 + r0;
#pragma unroll
    for (int i = 0; i < kColPairs; ++i) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = (tw + kTileWarps * i) * 16 + n * 8 + 2 * t;
        if (col < d) {
          if (r0 < rows)
            *reinterpret_cast<__nv_bfloat162*>(o + orow * d + col) = __floats2bfloat162_rn(acc[i][n][0], acc[i][n][1]);
          if (r0 + 8 < rows)
            *reinterpret_cast<__nv_bfloat162*>(o + (orow + 8) * d + col) =
                __floats2bfloat162_rn(acc[i][n][2], acc[i][n][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with V and P
    if (j + 1 < nh && threadIdx.x == 0) issue_v(h + 1);
  }

  // the head mean: each block sums a slice of the tile's rows over the
  // cluster's blocks in rank order, through distributed shared memory
  cluster.sync();
  const float* remote[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) remote[r] = r < groups ? cluster.map_shared_rank(Ms, r) : nullptr;
  const int slice = (ROWS + groups - 1) / groups;
  const int r_begin = group * slice;
  const int r_end = min(rows, r_begin + slice);
  const int cw = nkp / 4;  // float4 columns of a padded map row
  const float inv_heads = 1.f / (float)heads;
  for (int i = threadIdx.x; i < (r_end - r_begin) * cw; i += blockDim.x) {
    const int r = r_begin + i / cw;
    const int c = (i % cw) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rank = 0; rank < kMaxCluster; ++rank) {
      if (rank < groups) {
        const float4 x = *reinterpret_cast<const float4*>(remote[rank] + r * nkp + c);
        acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
      }
    }
    float* out = pmap + ((size_t)b * nq + q0 + r) * nk + c;
    const float sums[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < nk) out[e] = sums[e] * inv_heads;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int ROWS>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* pmap, int b, int heads, int nq,
                   int nk, int d, float scale, int heads_per_block, cudaStream_t stream) {
  // the dynamic shared-memory limit, once per configuration, for the largest shape
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      cross_map_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem(ROWS, kMaxKeys, kMaxDim).bytes);
  if (attr_err != cudaSuccess) return attr_err;
  const int groups = (heads + heads_per_block - 1) / heads_per_block;
  if (groups > kMaxCluster) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_tile_map_3d(&tm_q, q, b * heads, nq, d, ROWS);
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_k, k, b * heads, nk, d, pad16(nk));
  if (err == cudaSuccess) err = make_tile_map_3d(&tm_v, v, b * heads, nk, d, pad16(nk));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, (nq + ROWS - 1) / ROWS, b);
  cfg.blockDim = dim3(ROWS * 2 * kTileWarps);
  cfg.dynamicSmemBytes = Smem(ROWS, nk, d).bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = groups;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cross_map_kernel<ROWS>, tm_q, tm_k, tm_v, o, pmap, heads, heads_per_block, nq, nk,
                           d, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace ga

// configuration index -> query rows per block (the heads per block are the
// caller's, from K3_TILE_CONFIGS' second entry and the cluster limit of 8):
// 0: 16 rows, 4 warps (at least one head per block)
// 1: 32 rows, 8 warps (at least one head)
// 2: 64 rows, 16 warps (at least one head)
// 3: 16 rows, 4 warps (at least two heads, the next head's loads under this one's products)
extern "C" int ga_cross_attention_map_fwd(const void* q, const void* k, const void* v, void* o, void* pmap, int b,
                                          int heads, int nq, int nk, int d, float scale, int config,
                                          int heads_per_block, void* stream) {
  using ga::bf16;
  if (b <= 0 || heads <= 0 || nq <= 0) return 0;
  if (nk < 1 || nk > ga::kMaxKeys || d < 8 || d % 8 != 0 || d > ga::kMaxDim || heads_per_block < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto* qp = static_cast<const bf16*>(q);
  auto* kp = static_cast<const bf16*>(k);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* mp = static_cast<float*>(pmap);
  auto s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return (int)ga::launch<16>(qp, kp, vp, op, mp, b, heads, nq, nk, d, scale, heads_per_block, s);
    case 1: return (int)ga::launch<32>(qp, kp, vp, op, mp, b, heads, nq, nk, d, scale, heads_per_block, s);
    case 2: return (int)ga::launch<64>(qp, kp, vp, op, mp, b, heads, nq, nk, d, scale, heads_per_block, s);
    case 3: return (int)ga::launch<16>(qp, kp, vp, op, mp, b, heads, nq, nk, d, scale, heads_per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

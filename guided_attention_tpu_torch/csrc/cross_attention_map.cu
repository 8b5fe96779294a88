// K3: cross-attention with the head-mean probability map, forward.
//
// Replaces guided_attention_tpu/ops/flash_attention.py
// `_cross_attention_fwd_impl` / `_cross_fwd_kernel`. The TPU kernel padded
// the 77 text keys to a 128-lane tile and masked them, and summed the map
// over an innermost sequential head grid axis. Here the keys are not padded
// (loops stop at the ragged edge), and one block owns a tile of queries of
// one batch row and loops over all heads itself, so the head-mean map
// accumulates in shared memory and is written once, with no cross-block sum.
//
// Bound on the H100: at the main path's shapes (q [1, 8, 256, 160], k/v
// [1, 8, 77, 160]) the work is about 0.1 GFLOP and 1.8 MB, under a
// microsecond of either, so at best launch latency bounds it. This first
// version is plain fp32 FMA on the CUDA cores: one warp per query row, lanes
// splitting the head dimension for q.k (then a five-step warp sum per key)
// and for p.v. Those serial per-key sums on 32 blocks, not the launch, set
// its time; spreading the keys over the lanes is the next step.
//
// q [B, H, Nq, D], k/v [B, H, NK, D] bf16, D % 8 == 0, D <= 256, NK <= 128;
// out [B, H, Nq, D] bf16 and map [B, Nq, NK] fp32 = mean over heads of
// softmax(q k^T * scale).
#include "common.cuh"

namespace ga {
namespace {

constexpr int WARPS = 8;  // = query rows per block
constexpr int MAX_D_PER_LANE = 8;  // D <= 256
constexpr int MAX_NK = 128;

__global__ void __launch_bounds__(WARPS * 32)
    cross_map_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, float* __restrict__ pmap, int heads, int nq, int nk, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * d;
  float* P = reinterpret_cast<float*>(smem + align128(2 * nk * d * 2));  // [WARPS][MAX_NK]
  float* M = P + WARPS * MAX_NK;                                          // [WARPS][MAX_NK]

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qrow = blockIdx.x * WARPS + warp;
  const bool valid = qrow < nq;
  float* prow = P + warp * MAX_NK;
  float* mrow = M + warp * MAX_NK;
  for (int j = lane; j < nk; j += 32) mrow[j] = 0.f;
  const float inv_heads = 1.f / (float)heads;

  for (int h = 0; h < heads; ++h) {
    const size_t kv_base = ((size_t)b * heads + h) * nk * d;
    __syncthreads();  // previous head's K/V fully consumed
    load_rows(Ks, d, k + kv_base, 0, nk, nk, d);
    load_rows(Vs, d, v + kv_base, 0, nk, nk, d);
    __syncthreads();
    if (!valid) continue;

    const bf16* qp = q + (((size_t)b * heads + h) * nq + qrow) * d;
    float qr[MAX_D_PER_LANE];
#pragma unroll
    for (int i = 0; i < MAX_D_PER_LANE; ++i) {
      const int c = lane + 32 * i;
      qr[i] = c < d ? __bfloat162float(qp[c]) : 0.f;
    }

    // scores, then softmax over the nk keys of this row
    float mx = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const bf16* kr = Ks + j * d;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D_PER_LANE; ++i) {
        const int c = lane + 32 * i;
        if (c < d) s += qr[i] * __bfloat162float(kr[c]);
      }
      s = warp_sum(s) * scale;
      if (lane == 0) prow[j] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    const float inv_sum = 1.f / warp_sum(sum);
    for (int j = lane; j < nk; j += 32) {
      const float p = prow[j] * inv_sum;
      prow[j] = p;
      mrow[j] += p * inv_heads;
    }
    __syncwarp();

    // out = p v
    float acc[MAX_D_PER_LANE];
#pragma unroll
    for (int i = 0; i < MAX_D_PER_LANE; ++i) acc[i] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = prow[j];
      const bf16* vr = Vs + j * d;
#pragma unroll
      for (int i = 0; i < MAX_D_PER_LANE; ++i) {
        const int c = lane + 32 * i;
        if (c < d) acc[i] += p * __bfloat162float(vr[c]);
      }
    }
    bf16* op = o + (((size_t)b * heads + h) * nq + qrow) * d;
#pragma unroll
    for (int i = 0; i < MAX_D_PER_LANE; ++i) {
      const int c = lane + 32 * i;
      if (c < d) op[c] = __float2bfloat16(acc[i]);
    }
    __syncwarp();
  }
  if (valid) {
    float* mp = pmap + ((size_t)b * nq + qrow) * nk;
    for (int j = lane; j < nk; j += 32) mp[j] = mrow[j];
  }
}

}  // namespace
}  // namespace ga

extern "C" int ga_cross_attention_map_fwd(const void* q, const void* k, const void* v, void* o, void* pmap, int b,
                                          int heads, int nq, int nk, int d, float scale, void* stream) {
  using ga::bf16;
  if (b <= 0 || heads <= 0 || nq <= 0) return 0;
  if (nk < 1 || nk > ga::MAX_NK || d % 8 != 0 || d > 32 * ga::MAX_D_PER_LANE) return (int)cudaErrorInvalidValue;
  const int bytes = ga::align128(2 * nk * d * 2) + 2 * ga::WARPS * ga::MAX_NK * 4;
  cudaError_t err =
      cudaFuncSetAttribute(ga::cross_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + ga::WARPS - 1) / ga::WARPS, b);
  ga::cross_map_kernel<<<grid, ga::WARPS * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(pmap), heads, nq, nk, d, scale);
  return (int)cudaGetLastError();
}

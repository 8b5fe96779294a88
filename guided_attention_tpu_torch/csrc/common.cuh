// Shared helpers of the attention kernels (sm_90a, bf16 in, fp32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ga {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + rows) of a row-major [n, d] bf16 matrix into
// shared memory with row stride `ld` elements, 16 bytes per thread-step.
// Rows at or past n are written as zeros; columns [d, ld) are not touched.
// Requires d % 8 == 0 and 16-byte aligned rows.
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, int ld, const bf16* __restrict__ src, int row0,
                                          int rows, int n, int d) {
  const int vec_per_row = d / 8;
  const int total = rows * vec_per_row;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / vec_per_row;
    const int c = (idx - r * vec_per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) q[i] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace ga

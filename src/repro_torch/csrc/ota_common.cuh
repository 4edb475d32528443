// Pieces shared by the channel and receive kernels: the guarded CMS
// transform and the pilot-statistics epilogue.
//
// cms() is repro.core.channel.cms_transform written out op for op:
//   xi = sin(a u) / cos(u)^{1/a} * (cos((1-a) u) / e)^{(1-a)/a}
// with u clipped into (-CMS_U_BOUND, CMS_U_BOUND) and e floored at
// CMS_E_FLOOR. The constants 1/a, 1-a and (1-a)/a come from the host,
// computed in double and passed as float, as the plain version's Python
// floats are.
//
// stats_block_reduce() reduces each thread's [count, sum log|r|,
// sum log^2|r|] over the block, with warp shuffles and one shared-memory
// pass, and writes the block's row of a (blocks, 3) buffer that the
// wrapper sums: no atomics, so the statistics do not vary from run to
// run. Every thread of the block must call it.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace ota {

constexpr int kMaxWarps = 32;

struct Cms {
  float alpha, inv_alpha, one_minus_alpha, exponent, u_bound, e_floor;
};

__device__ __forceinline__ float cms(float u, float e, const Cms& c) {
  u = fminf(fmaxf(u, -c.u_bound), c.u_bound);
  e = fmaxf(e, c.e_floor);
  return sinf(c.alpha * u) / powf(cosf(u), c.inv_alpha) *
         powf(cosf(c.one_minus_alpha * u) / e, c.exponent);
}

// One residual entry r = scale * xi into a thread's running statistics;
// zero entries (padding, a disabled channel) are not counted.
__device__ __forceinline__ void stats_add(float r, float& cnt, float& s1,
                                          float& s2) {
  r = fabsf(r);
  if (r > 0.f) {
    const float lr = logf(fmaxf(r, FLT_MIN));
    cnt += 1.f;
    s1 += lr;
    s2 += lr * lr;
  }
}

__device__ __forceinline__ void stats_block_reduce(float cnt, float s1,
                                                   float s2,
                                                   float* __restrict__ rows) {
  __shared__ float red[3][kMaxWarps];
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = (blockDim.x + 31) / 32;
  if (lane == 0) {
    red[0][warp] = cnt;
    red[1][warp] = s1;
    red[2][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < n_warps ? red[0][lane] : 0.f;
    s1 = lane < n_warps ? red[1][lane] : 0.f;
    s2 = lane < n_warps ? red[2][lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      rows[3 * (int64_t)blockIdx.x + 0] = cnt;
      rows[3 * (int64_t)blockIdx.x + 1] = s1;
      rows[3 * (int64_t)blockIdx.x + 2] = s2;
    }
  }
}

}  // namespace ota

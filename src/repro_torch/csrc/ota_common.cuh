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
// pass, and writes the block's row of a (blocks, 3) buffer.
// stats_fold_last() then folds those rows in the same launch: the block
// that finishes last adds them in a fixed order into the (3,) result.
// No float atomics, so the statistics do not vary from run to run. Every
// thread of the block must call each.

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

// Sums each thread's (cnt, s1, s2) over the block into thread 0's: a
// shuffle tree in each warp (lane 0 += lane 16, ... += lane 1), then the
// warps' sums in warp order by the same tree in warp 0. A fixed order.
__device__ __forceinline__ void stats_block_sum(float& cnt, float& s1,
                                                float& s2) {
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
  }
}

// The block's row of `rows`, written by thread 0.
__device__ __forceinline__ void stats_block_reduce(float cnt, float s1,
                                                   float s2,
                                                   float* __restrict__ rows) {
  stats_block_sum(cnt, s1, s2);
  if (threadIdx.x == 0) {
    rows[3 * (int64_t)blockIdx.x + 0] = cnt;
    rows[3 * (int64_t)blockIdx.x + 1] = s1;
    rows[3 * (int64_t)blockIdx.x + 2] = s2;
  }
}

constexpr int kFoldBatch = 4;

// After stats_block_reduce, in the same launch (a 1-D grid): thread 0
// takes a ticket from `counter` (an acquire-release add; its own row is
// ordered before it), and the block that draws the last one folds the
// gridDim.x rows into out[0..2] and puts the counter back to 0 for the
// next launch. The fold's order is fixed: thread t adds rows t, t + T,
// t + 2T, ... in that order (T threads a block), then stats_block_sum.
// The rows come from L2 (ld.global.cg: this SM never cached the others),
// kFoldBatch a thread in flight at once.
__device__ __forceinline__ void stats_fold_last(const float* rows,
                                                unsigned* counter,
                                                float* __restrict__ out) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(ticket)
                 : "l"(reinterpret_cast<uint64_t>(counter))
                 : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float cnt = 0.f, s1 = 0.f, s2 = 0.f;
  const int64_t stride = blockDim.x;
  for (int64_t b0 = threadIdx.x; b0 < gridDim.x; b0 += kFoldBatch * stride) {
    float v[kFoldBatch][3];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      const int64_t b = b0 + k * stride;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        v[k][i] = b < gridDim.x ? __ldcg(rows + 3 * b + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (b0 + k * stride < gridDim.x) {
        cnt += v[k][0];
        s1 += v[k][1];
        s2 += v[k][2];
      }
    }
  }
  stats_block_sum(cnt, s1, s2);
  if (threadIdx.x == 0) {
    out[0] = cnt;
    out[1] = s1;
    out[2] = s2;
    *counter = 0u;
  }
}

}  // namespace ota

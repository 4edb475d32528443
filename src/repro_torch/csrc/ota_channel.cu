// Fused f32 OTA channel: faded client sum plus alpha-stable interference.
//
// Replaces the TPU kernel src/repro/kernels/ota_channel.py,
// ota_channel_slab / _ota_kernel with its _residual_stats_row epilogue
// (Pallas).
//
//   out[c] = (sum_n h[n] * G[n, c]) / n_total + scale * xi(u[c], e[c])
//   xi     = sin(a u) / cos(u)^{1/a} * (cos((1-a) u) / e)^{(1-a)/a}
//
// with u clipped into (-CMS_U_BOUND, CMS_U_BOUND) and e floored at
// CMS_E_FLOOR (repro.core.channel.cms_transform). With pilot statistics
// on, each block also reduces the nonzero residuals r = scale * xi of its
// columns to [count, sum log|r|, sum log^2|r|] in its own row of a
// (blocks, 3) buffer; the wrapper sums the rows.
//
// What bounds it on an H100: device-memory bytes. The N x d gradient
// slab is read once (4 N d bytes; 35 MB at N = 50, d = 175,104) against
// 2 flops per entry, and the CMS epilogue's transcendentals are per
// column, not per entry.
//
// What the design does about it: the TPU kernel reduced a VMEM tile of
// all N rows per grid step. Here each thread owns four adjacent columns
// and walks the N rows itself, so the sum needs no cross-thread
// reduction and its order (n = 0, 1, ...) is fixed. A warp's loads of one
// row are 512 contiguous bytes (16-byte float4 loads); the row loop is
// unrolled so several rows' loads are in flight per thread. h is staged
// through shared memory in chunks of kHChunk, so N is not bounded by
// shared memory. Padding columns (u = 0, e = 1, G = 0) come out exactly
// 0 and are not counted in the statistics. The statistics use warp
// shuffles and one shared-memory pass per block, no atomics, so they are
// the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ota_common.cuh"

namespace {

using ota::Cms;
using ota::kMaxWarps;

constexpr int kHChunk = 1024;

template <int VEC, bool STATS>
__global__ void ota_channel_kernel(const float* __restrict__ G,
                                   const float* __restrict__ h,
                                   const float* __restrict__ u,
                                   const float* __restrict__ e,
                                   float* __restrict__ out,
                                   float* __restrict__ stats_rows, int n_rows,
                                   int64_t d, float n_total, float scale,
                                   Cms c) {
  __shared__ float h_s[kHChunk];
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool active = col0 < d;
  const int width = active ? (int)(d - col0 < VEC ? d - col0 : VEC) : 0;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int n0 = 0; n0 < n_rows; n0 += kHChunk) {
    const int rows = n_rows - n0 < kHChunk ? n_rows - n0 : kHChunk;
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) h_s[i] = h[n0 + i];
    __syncthreads();
    if (!active) continue;
    const float* row = G + (int64_t)n0 * d + col0;
    if (VEC == 4 && width == 4) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(row + (int64_t)r * d));
        const float hv = h_s[r];
        acc[0] = acc[0] + hv * gv.x;
        acc[1] = acc[1] + hv * gv.y;
        acc[2] = acc[2] + hv * gv.z;
        acc[3] = acc[3] + hv * gv.w;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const float hv = h_s[r];
        for (int j = 0; j < width; ++j)
          acc[j] = acc[j] + hv * __ldg(row + (int64_t)r * d + j);
      }
    }
  }

  float cnt = 0.f, s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < width; ++j) {
    const int64_t col = col0 + j;
    const float xi = ota::cms(u[col], e[col], c);
    out[col] = acc[j] / n_total + scale * xi;
    if (STATS) ota::stats_add(scale * xi, cnt, s1, s2);
  }

  if (STATS) ota::stats_block_reduce(cnt, s1, s2, stats_rows);
}

template <int VEC, bool STATS>
void launch(const void* G, const void* h, const void* u, const void* e,
            void* out, void* stats_rows, int n_rows, int64_t d, float n_total,
            float scale, const Cms& c, int threads, int blocks,
            cudaStream_t s) {
  ota_channel_kernel<VEC, STATS><<<blocks, threads, 0, s>>>(
      static_cast<const float*>(G), static_cast<const float*>(h),
      static_cast<const float*>(u), static_cast<const float*>(e),
      static_cast<float*>(out), static_cast<float*>(stats_rows), n_rows, d,
      n_total, scale, c);
}

}  // namespace

// One launch; `blocks` must be ceil(d / (threads * vec)), and `stats_rows`
// a (blocks, 3) f32 buffer when `stats` is set. `vec` (4 or 1) selects
// 16-byte row loads, which need d % 4 == 0 and 16-byte aligned G.
extern "C" int repro_ota_channel(int vec, int stats, const void* G,
                                 const void* h, const void* u, const void* e,
                                 void* out, void* stats_rows, int n_rows,
                                 long long d, float n_total, float scale,
                                 float alpha, float inv_alpha,
                                 float one_minus_alpha, float exponent,
                                 float u_bound, float e_floor, int threads,
                                 int blocks, void* stream) {
  if (d <= 0 || blocks <= 0) return 0;
  if (threads <= 0 || threads > 32 * kMaxWarps || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const Cms c{alpha, inv_alpha, one_minus_alpha, exponent, u_bound, e_floor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4 && stats)
    launch<4, true>(G, h, u, e, out, stats_rows, n_rows, d, n_total, scale, c, threads, blocks, s);
  else if (vec == 4)
    launch<4, false>(G, h, u, e, out, stats_rows, n_rows, d, n_total, scale, c, threads, blocks, s);
  else if (vec == 1 && stats)
    launch<1, true>(G, h, u, e, out, stats_rows, n_rows, d, n_total, scale, c, threads, blocks, s);
  else if (vec == 1)
    launch<1, false>(G, h, u, e, out, stats_rows, n_rows, d, n_total, scale, c, threads, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

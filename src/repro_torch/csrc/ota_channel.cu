// Fused f32 OTA channel (B2): faded client sum plus alpha-stable
// interference.
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
// slab is read once (4 N d bytes; 35 MB at N = 50, d = 175,104: 11.1 us
// at 3.35 TB/s) against 2 flops per entry. The CMS transform (two powf,
// a sinf, two cosf and two divides, precise) is per column, not per
// entry, but it is long: on the threads that stream G it delays their
// refills, and at N = 1 (the streamed finish) it is most of the work.
//
// The design. A block owns a tile of kTileCols = 512 columns; the grid
// is ceil(d / 512) tiles (342 at d = 175,104; kernels/ota_channel.py,
// channel_blocks). Its first 128 threads (4 warps) are the walkers: the
// rows stream through the bulk-copy ring of ota_ring.cuh, the same ring
// and walk as the accumulating transmit's (ota_transmit_stream.cu), one
// thread copying each 2 KB row of the tile into 4 stages of 8 rows
// (64 KB), each stage completing on an mbarrier, G's lines evict-first,
// h in shared memory 1024 rows at a time; a walker adds its 4 adjacent
// columns. The other 256 threads (8 warps) compute scale * xi of 2
// columns each into shared memory, and their statistics, at the same
// time: the walkers synchronize among themselves (a named barrier), so
// the transform never holds up a refill. One block barrier, then the
// walkers write out = part / n_total + scale * xi. 3 blocks of 384
// threads fit an SM (70.5 KB of shared memory each). The sum runs per
// column over rows n = 0, 1, ... in order (part = part + h[n] * G[n, c];
// --fmad=false, so every op rounds on its own) and divides once: with
// scale = 0 it is bitwise the accumulating transmit's no-carry call, so
// the streamed round with chunk = N is bitwise the resident round. The
// plain-load path (d % 4 != 0, or G or out not 16-byte aligned) has the
// walkers read G with 4-byte loads, walker t on columns t, t + 128,
// t + 256, t + 384 of the tile, in the same order. Padding columns
// (u = 0, e = 1, G = 0) come out exactly 0 and are not counted in the
// statistics; the statistics use warp shuffles and one shared-memory
// pass per block, no atomics, so they are the same from run to run.
//
// Measured (chip_smoke.py phase "times", NVIDIA H100 80GB HBM3, 700.00 W):
// 20.70 us at 50 x 175,104 (0.535 of the byte bound; the accumulating
// transmit's no-carry call over the same rows 20.45 us in turns with it;
// four columns a thread with plain loads and the transform after the
// sum, the previous design, 35.5 us in the same run); the one-row
// streamed finishes 9.02 us at 175,104 columns and 7.10 us at 4096,
// where a near-empty launch timed the same way takes 5.04 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ota_common.cuh"
#include "ota_ring.cuh"

namespace {

using ota::Cms;

constexpr int kTileCols = 512;
constexpr int kThreads = kTileCols / 4;  // ring walkers: 4 columns each
constexpr int kCmsCols = 2;              // columns a CMS thread
constexpr int kCmsThreads = kTileCols / kCmsCols;
constexpr int kBlock = kThreads + kCmsThreads;
constexpr int kStageRows = 8;
constexpr int kStages = 4;
constexpr int kHRows = 1024;
using Ring = ota_ring::Ring<kTileCols, kStageRows, kStages, kHRows>;

struct Args {
  const float* G;
  const float* h;
  const float* u;
  const float* e;
  float* out;
  float* stats_rows;  // (blocks, 3); unused without statistics
  int n_rows;
  int64_t d;
  float n_total;
  float scale;
  Cms c;
};

// How a block reads its rows of G.
enum Load { kScalar = 0, kBulk = 1 };

template <int LOAD, bool STATS>
// 3 blocks an SM: 3 x (64 KB of ring + 6.5 KB) of shared memory.
__global__ void __launch_bounds__(kBlock, 3)
    ota_channel_kernel(const Args a) {
  extern __shared__ __align__(128) float ring[];  // kBulk only
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float h_s[kHRows];
  __shared__ __align__(16) float r_s[kTileCols];  // scale * xi a column

  const int tid = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * kTileCols;
  const int width = (int)(a.d - tile0 < kTileCols ? a.d - tile0 : kTileCols);
  float cnt = 0.f, s1 = 0.f, s2 = 0.f;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid >= kThreads) {
    // The CMS warps: scale * xi of kCmsCols adjacent columns a thread,
    // and their statistics, while the walkers stream G.
    const int c0 = (tid - kThreads) * kCmsCols;
#pragma unroll
    for (int j = 0; j < kCmsCols; ++j) {
      const int c = c0 + j;
      if (c < width) {
        const float r = a.scale * ota::cms(a.u[tile0 + c], a.e[tile0 + c], a.c);
        r_s[c] = r;
        if (STATS) ota::stats_add(r, cnt, s1, s2);
      }
    }
  } else if (LOAD == kBulk) {
    // The walkers, 4 adjacent columns each (width is a multiple of 4).
    if (tid == 0)
      Ring::prime(a.G + tile0, a.d, width, 0, a.n_rows, ring, full,
                  ota_ring::evict_first_policy());
    const bool on = 4 * tid < width;
    Ring::stream_primed<kThreads>(
        a.G + tile0, a.h, a.d, width, 0, a.n_rows, ring, full, h_s,
        ota_ring::evict_first_policy(),
        [&](int, float hv, const float* st) {
          if (on) {
            const float4 g = *reinterpret_cast<const float4*>(st + 4 * tid);
            part[0] = part[0] + hv * g.x;
            part[1] = part[1] + hv * g.y;
            part[2] = part[2] + hv * g.z;
            part[3] = part[3] + hv * g.w;
          }
        });
  } else {
    // The walkers with plain loads, columns tid + kThreads * j.
    const float* g = a.G + tile0;
    for (int n0 = 0; n0 < a.n_rows; n0 += kHRows) {
      const int rows = a.n_rows - n0 < kHRows ? a.n_rows - n0 : kHRows;
      ota_ring::walkers_sync<kThreads>();
      for (int k = tid; k < rows; k += kThreads) h_s[k] = a.h[n0 + k];
      ota_ring::walkers_sync<kThreads>();
#pragma unroll 4
      for (int k = 0; k < rows; ++k) {
        const float hv = h_s[k];
        const float* row = g + (int64_t)(n0 + k) * a.d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tid + kThreads * j;
          if (c < width) part[j] = part[j] + hv * __ldg(row + c);
        }
      }
    }
  }
  __syncthreads();  // r_s is complete
  if (tid < kThreads) {
    if (LOAD == kBulk) {
      if (4 * tid < width) {
        const float4 r = *reinterpret_cast<const float4*>(r_s + 4 * tid);
        float4 o;
        o.x = part[0] / a.n_total + r.x;
        o.y = part[1] / a.n_total + r.y;
        o.z = part[2] / a.n_total + r.z;
        o.w = part[3] / a.n_total + r.w;
        *reinterpret_cast<float4*>(a.out + tile0 + 4 * tid) = o;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tid + kThreads * j;
        if (c < width) a.out[tile0 + c] = part[j] / a.n_total + r_s[c];
      }
    }
  }
  if (STATS) ota::stats_block_reduce(cnt, s1, s2, a.stats_rows);
}

template <int LOAD, bool STATS>
cudaError_t launch(const Args& a, unsigned blocks, cudaStream_t s) {
  const int bytes = LOAD == kBulk ? Ring::kBytes : 0;
  if (bytes > 0) {
    // The ring and the static arrays pass the 48 KB default: allow the
    // ring once a device.
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(ota_channel_kernel<LOAD, STATS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
      if (e != cudaSuccess) return e;
      allowed[dev] = true;
    }
  }
  ota_channel_kernel<LOAD, STATS><<<blocks, kBlock, bytes, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One launch on `stream`: `blocks` must be ceil(d / 512) (the wrapper's
// channel_blocks), and `stats_rows` a (blocks, 3) f32 buffer when `stats`
// is set. G is read through the bulk-copy ring when d % 4 == 0 and G and
// out are 16-byte aligned, else with plain 4-byte loads; both sum in the
// same order.
extern "C" int repro_ota_channel(int stats, const void* G, const void* h,
                                 const void* u, const void* e, void* out,
                                 void* stats_rows, int n_rows, long long d,
                                 float n_total, float scale, float alpha,
                                 float inv_alpha, float one_minus_alpha,
                                 float exponent, float u_bound,
                                 float e_floor, int blocks, void* stream) {
  if (d <= 0) return 0;
  if (n_rows < 0 || (long long)blocks != (d + kTileCols - 1) / kTileCols ||
      (stats && stats_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(G), static_cast<const float*>(h),
               static_cast<const float*>(u), static_cast<const float*>(e),
               static_cast<float*>(out), static_cast<float*>(stats_rows),
               n_rows, (int64_t)d, n_total, scale,
               Cms{alpha, inv_alpha, one_minus_alpha, exponent, u_bound,
                   e_floor}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bulk = d % 4 == 0 && aligned16(G) && aligned16(out);
  if (bulk)
    return (int)(stats ? launch<kBulk, true>(a, blocks, s)
                       : launch<kBulk, false>(a, blocks, s));
  return (int)(stats ? launch<kScalar, true>(a, blocks, s)
                     : launch<kScalar, false>(a, blocks, s));
}

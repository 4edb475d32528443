// OTA receive: dequantize and superpose R wire payloads, then add the
// alpha-stable interference, in one pass.
//
// Replaces the TPU kernel src/repro/kernels/ota_channel.py,
// ota_receive_slab / _rx_kernel (Pallas), together with the jnp unpack
// of the packed sign wire that runs before it (unpack_sign_slab).
//
//   out[c] = sum_{r=0..R-1} q[r, c] * s[r, c / 128]  +  scale * xi(u[c], e[c])
//
// The payload is either the int8 container (R, d), or packed uint32
// sign words: "fold" holds one sign plane (bit j of word w is the sign of
// column 32 w + j, 1 decodes to -1 and 0 to +1); "planes" holds the sign
// plane followed by the nonzero-mask plane, so {-1, 0, +1} decode
// exactly. The kernel reads the words directly: no int8 payload is made
// in between. With pilot statistics on, each block reduces the nonzero
// residuals r = scale * xi of its columns into its row of a (blocks, 3)
// buffer (ota_common.cuh), as the channel kernel does.
//
// What bounds it on an H100: device-memory bytes. Per column it reads
// one int8 (or 1-2 bits) per row, u and e, and writes out: 13 bytes a
// column at R = 1 (2.3 MB at d = 175,104) against ~20 flops of CMS
// transform, so the transcendental work is what keeps it from the byte
// bound at this size.
//
// What the design does about it: each thread owns 4 adjacent columns
// (one 4-byte int8 load, or 4 bits of a word, per row; 16-byte loads of
// u and e and a 16-byte store of out). A warp's 128 columns share one
// scale per row. The row sum runs r = 0, 1, ... in that order, from 0,
// with no mul+add contraction, as the plain version sums. Padding
// columns (q = 0, u = 0, e = 1) come out exactly 0 on the int8 container
// and on "planes"; under "fold" the caller re-masks the tail.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ota_common.cuh"

namespace {

using ota::Cms;

constexpr int kThreads = 128;

enum Packed { INT8 = 0, FOLD = 1, PLANES = 2 };

template <int PACKED, bool STATS>
__global__ void __launch_bounds__(kThreads)
ota_receive_kernel(const void* __restrict__ payload,
                   const float* __restrict__ scales,
                   const float* __restrict__ u, const float* __restrict__ e,
                   float* __restrict__ out, float* __restrict__ stats_rows,
                   int rows, int64_t d, float scale, Cms c) {
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  float cnt = 0.f, s1 = 0.f, s2 = 0.f;
  if (col0 < d) {
    const int64_t n_blocks = d >> 7, blk = col0 >> 7;
    const int64_t plane_words = d >> 5, word = col0 >> 5;
    const int shift = (int)(col0 & 31);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < rows; ++r) {
      const float sv = scales[(int64_t)r * n_blocks + blk];
      float q[4];
      if constexpr (PACKED == INT8) {
        const char4 v = *reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(payload) + (int64_t)r * d + col0);
        q[0] = (float)v.x; q[1] = (float)v.y;
        q[2] = (float)v.z; q[3] = (float)v.w;
      } else {
        const uint32_t* words = static_cast<const uint32_t*>(payload) +
                                (int64_t)r * plane_words *
                                    (PACKED == PLANES ? 2 : 1);
        const uint32_t neg = words[word] >> shift;
        const uint32_t nz = PACKED == PLANES
                                ? words[plane_words + word] >> shift
                                : 0xFu;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = ((nz >> j) & 1u) ? (((neg >> j) & 1u) ? -1.f : 1.f) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = acc[j] + q[j] * sv;
    }
    const float4 uv = *reinterpret_cast<const float4*>(u + col0);
    const float4 ev = *reinterpret_cast<const float4*>(e + col0);
    const float us[4] = {uv.x, uv.y, uv.z, uv.w};
    const float es[4] = {ev.x, ev.y, ev.z, ev.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xi = ota::cms(us[j], es[j], c);
      o[j] = acc[j] + scale * xi;
      if (STATS) ota::stats_add(scale * xi, cnt, s1, s2);
    }
    *reinterpret_cast<float4*>(out + col0) = make_float4(o[0], o[1], o[2], o[3]);
  }
  if (STATS) ota::stats_block_reduce(cnt, s1, s2, stats_rows);
}

template <int PACKED, bool STATS>
void launch(const void* payload, const void* scales, const void* u,
            const void* e, void* out, void* stats_rows, int rows, int64_t d,
            float scale, const Cms& c, int blocks, cudaStream_t s) {
  ota_receive_kernel<PACKED, STATS><<<blocks, kThreads, 0, s>>>(
      payload, static_cast<const float*>(scales), static_cast<const float*>(u),
      static_cast<const float*>(e), static_cast<float*>(out),
      static_cast<float*>(stats_rows), rows, d, scale, c);
}

}  // namespace

// One launch. `packed` is a Packed value; `blocks` must be
// ceil(d / 512) (128 threads, 4 columns each) and `stats_rows` a
// (blocks, 3) f32 buffer when `stats` is set. d must be a positive
// multiple of 128; u, e and out 16-byte aligned, an int8 payload 4-byte
// aligned. Returns the CUDA error of the launch (0 on success).
extern "C" int repro_ota_receive(int packed, int stats, const void* payload,
                                 const void* scales, const void* u,
                                 const void* e, void* out, void* stats_rows,
                                 int rows, long long d, float scale,
                                 float alpha, float inv_alpha,
                                 float one_minus_alpha, float exponent,
                                 float u_bound, float e_floor, int blocks,
                                 void* stream) {
  if (d <= 0 || d % 128 != 0 || rows < 0 ||
      (long long)blocks != (d + 4 * kThreads - 1) / (4 * kThreads))
    return (int)cudaErrorInvalidValue;
  const Cms c{alpha, inv_alpha, one_minus_alpha, exponent, u_bound, e_floor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed == INT8 && stats)
    launch<INT8, true>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else if (packed == INT8)
    launch<INT8, false>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else if (packed == FOLD && stats)
    launch<FOLD, true>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else if (packed == FOLD)
    launch<FOLD, false>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else if (packed == PLANES && stats)
    launch<PLANES, true>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else if (packed == PLANES)
    launch<PLANES, false>(payload, scales, u, e, out, stats_rows, rows, d, scale, c, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

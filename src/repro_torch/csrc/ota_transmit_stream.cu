// Accumulating f32 OTA transmit: the faded partial sum of a chunk of
// clients, folded into a running (d,) carry, over row chunks.
//
// Replaces the TPU kernels src/repro/kernels/ota_channel.py,
// ota_transmit_slab(acc=, row_chunk=) / _tx_stream_kernel (Pallas), and,
// with no carry and one row chunk, ota_transmit_slab(quantize=False) /
// _tx_kernel.
//
//   out[c] = acc[c] + sum_k (sum_{n in chunk k} h[n] * G[n, c]) / n_total
//
// Chunks are taken in order (rows [k*rc, (k+1)*rc)), and rows in order
// inside a chunk; each chunk's sum is divided by n_total as it lands, as
// the TPU kernel folds each row-chunk grid step into its output tile. A
// null acc is a zero carry. With one chunk and no carry the result is
// 0 + s / n_total == s / n_total, and s is summed exactly as the channel
// kernel (ota_channel.cu) sums it, so the streamed round's faded sum is
// bitwise the resident round's.
//
// What bounds it on an H100: device-memory bytes. The chunk's rows x d
// gradient stack is read once (4 rows d bytes; 35 MB at 50 x 175,104,
// 32.8 MB at 2000 x 4096) against 2 flops per entry.
//
// What the design does about it: the structure of the channel kernel.
// Each thread owns 4 adjacent columns (16-byte loads; 1 column when d is
// not a multiple of 4) and walks the rows itself, so the sum needs no
// cross-thread reduction and its order is fixed; h is staged through
// shared memory in pieces of kHChunk; the carry stays in registers from
// the first chunk to the last and is written once. This is the simple
// first version: at d = 4096 it runs 8 blocks, far too few to fill 132
// SMs (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHChunk = 1024;
constexpr int kMaxThreads = 1024;

template <int VEC>
__global__ void ota_transmit_stream_kernel(const float* __restrict__ G,
                                           const float* __restrict__ h,
                                           const float* __restrict__ acc,
                                           float* __restrict__ out,
                                           int n_rows, int64_t d,
                                           int row_chunk, float n_total) {
  __shared__ float h_s[kHChunk];
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool active = col0 < d;
  const int width = active ? (int)(d - col0 < VEC ? d - col0 : VEC) : 0;
  float carry[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    carry[j] = (acc != nullptr && j < width) ? acc[col0 + j] : 0.f;

  for (int c0 = 0; c0 < n_rows; c0 += row_chunk) {
    const int c_rows = n_rows - c0 < row_chunk ? n_rows - c0 : row_chunk;
    float part[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[j] = 0.f;
    for (int n0 = 0; n0 < c_rows; n0 += kHChunk) {
      const int rows = c_rows - n0 < kHChunk ? c_rows - n0 : kHChunk;
      __syncthreads();
      for (int i = threadIdx.x; i < rows; i += blockDim.x)
        h_s[i] = h[c0 + n0 + i];
      __syncthreads();
      if (!active) continue;
      const float* row = G + (int64_t)(c0 + n0) * d + col0;
      if (VEC == 4 && width == 4) {
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          const float4 gv =
              __ldg(reinterpret_cast<const float4*>(row + (int64_t)r * d));
          const float hv = h_s[r];
          part[0] = part[0] + hv * gv.x;
          part[1] = part[1] + hv * gv.y;
          part[2] = part[2] + hv * gv.z;
          part[3] = part[3] + hv * gv.w;
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          const float hv = h_s[r];
          for (int j = 0; j < width; ++j)
            part[j] = part[j] + hv * __ldg(row + (int64_t)r * d + j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) carry[j] = carry[j] + part[j] / n_total;
  }

  for (int j = 0; j < width; ++j) out[col0 + j] = carry[j];
}

}  // namespace

// One launch; `blocks` must be ceil(d / (threads * vec)). `vec` (4 or 1)
// selects 16-byte row loads, which need d % 4 == 0 and 16-byte aligned G.
// `acc` may be null (a zero carry); it must not alias `out`.
extern "C" int repro_ota_transmit_stream(int vec, const void* G,
                                         const void* h, const void* acc,
                                         void* out, int n_rows, long long d,
                                         int row_chunk, float n_total,
                                         int threads, int blocks,
                                         void* stream) {
  if (d <= 0 || blocks <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      row_chunk < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(G);
  const float* hp = static_cast<const float*>(h);
  const float* a = static_cast<const float*>(acc);
  float* o = static_cast<float*>(out);
  if (vec == 4)
    ota_transmit_stream_kernel<4><<<blocks, threads, 0, s>>>(
        g, hp, a, o, n_rows, d, row_chunk, n_total);
  else if (vec == 1)
    ota_transmit_stream_kernel<1><<<blocks, threads, 0, s>>>(
        g, hp, a, o, n_rows, d, row_chunk, n_total);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// OTA receive (B4): dequantize and superpose R wire payloads, then add
// the alpha-stable interference, in one pass.
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
// in between.
//
// What bounds it on an H100: device-memory bytes. Per column it reads
// one int8 (or 1-2 bits) per row, u and e, and writes out: 13 bytes a
// column at R = 1 (2.3 MB at d = 175,104, 0.68 us at 3.35 TB/s), less
// than the launch floor. Against that, each column runs the CMS
// transform (ota_common.cuh: two precise powf, a sinf, two cosf and two
// divides), a long dependent chain.
//
// The design: one column a thread, 256 threads a block, so the grid
// (ceil(d / 256) blocks: kernels/ota_channel.py, receive_blocks) is
// resident on the card at once (__launch_bounds__ keeps the registers
// low enough for it: 684 blocks at d = 175,104 on 132 SMs) and one
// thread's transform chain hides behind the other warps' instead of
// stalling the SM. u and e are loaded first, so their latency overlaps
// the row sum's loads. A warp's 32 columns share one scale per row (one
// address: a broadcast load); on a packed wire they are one word a
// plane, lane j taking bit j; the int8 container is one byte a lane, 32
// contiguous bytes a warp. The row sum runs r = 0, 1, ... in that order,
// from 0, with no mul+add contraction (--fmad=false), as the plain
// version sums; then out = acc + scale * xi. Padding columns (q = 0,
// u = 0, e = 1) come out exactly 0 on the int8 container and on
// "planes"; under "fold" the caller re-masks the tail. Timed in turns
// on the card, 128-thread blocks (1,368 of them) were about as fast
// without statistics and slower with them (the fold then reads its
// 1,368 rows in two round trips to L2), and two columns a thread (684
// blocks of 128) slower without them (two chains a thread).
//
// Pilot statistics ([count, sum log|r|, sum log^2|r|] over the nonzero
// r = scale * xi): each block reduces its columns into its row of a
// (blocks, 3) buffer (ota_common.cuh, stats_block_reduce), takes a
// ticket, and the block that draws the last one folds the rows in a
// fixed order into the (3,) result (stats_fold_last) and resets the
// counter. One launch; no float atomics, so the statistics are the same
// bits from run to run.
//
// Measured (chip_smoke.py phase "times", NVIDIA H100 80GB HBM3,
// 700.00 W): 8.34 us int8 and 8.2 us fold at R = 1 x 175,104, where a
// near-empty launch timed the same way takes 4.88 us (floor + 3.5 us);
// 10.59 us with pilot statistics, one launch. The previous design (4
// columns a thread, 342 blocks of 128, about 10 warps an SM, and the
// statistics rows summed by a second launch, torch.sum) took 9.3 us,
// 9.3 us and 13.8 us (the pair) in the same call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ota_common.cuh"

namespace {

using ota::Cms;

constexpr int kThreads = 256;  // one column a thread
// Blocks an SM that hold the grid of the main path's slab (d = 175,104)
// on an H100's 132 SMs at once: 6 (684 blocks; at most 42 registers a
// thread).
constexpr int kMinBlocksPerSm = (175104 / kThreads + 131) / 132;

enum Packed { INT8 = 0, FOLD = 1, PLANES = 2 };

struct Args {
  const void* payload;
  const float* scales;
  const float* u;
  const float* e;
  float* out;
  float* stats_rows;   // (blocks, 3); STATS only
  float* stats;        // (3,); STATS only
  unsigned* counter;   // 0 between launches; STATS only
  int rows;
  int64_t d;
  float scale;
  Cms c;
};

template <int PACKED, bool STATS>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    ota_receive_kernel(const Args a) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float cnt = 0.f, s1 = 0.f, s2 = 0.f;
  // d is a multiple of 128: a warp is wholly inside the slab or past it.
  if (col < a.d) {
    // u and e first: their loads are in flight during the row sum.
    const float u = __ldg(a.u + col), e = __ldg(a.e + col);
    const int64_t n_blocks = a.d >> 7, blk = col >> 7;
    const int64_t plane_words = a.d >> 5, word = col >> 5;
    const int bit = (int)(col & 31);
    float acc = 0.f;
    for (int r = 0; r < a.rows; ++r) {
      const float sv = a.scales[(int64_t)r * n_blocks + blk];
      float q;
      if constexpr (PACKED == INT8) {
        q = (float)static_cast<const int8_t*>(a.payload)[(int64_t)r * a.d +
                                                         col];
      } else {
        const uint32_t* words = static_cast<const uint32_t*>(a.payload) +
                                (int64_t)r * plane_words *
                                    (PACKED == PLANES ? 2 : 1);
        const uint32_t neg = (words[word] >> bit) & 1u;
        const uint32_t nz =
            PACKED == PLANES ? (words[plane_words + word] >> bit) & 1u : 1u;
        q = nz ? (neg ? -1.f : 1.f) : 0.f;
      }
      acc = acc + q * sv;
    }
    const float xi = ota::cms(u, e, a.c);
    a.out[col] = acc + a.scale * xi;
    if (STATS) ota::stats_add(a.scale * xi, cnt, s1, s2);
  }
  if (STATS) {
    ota::stats_block_reduce(cnt, s1, s2, a.stats_rows);
    ota::stats_fold_last(a.stats_rows, a.counter, a.stats);
  }
}

template <int PACKED, bool STATS>
cudaError_t launch(const Args& a, int blocks, cudaStream_t s) {
  ota_receive_kernel<PACKED, STATS><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int PACKED, bool STATS>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ota_receive_kernel<PACKED, STATS>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// One launch. `packed` is a Packed value; `blocks` must be
// ceil(d / 256) (kernels/ota_channel.py, receive_blocks). With
// `stats` set, `stats_rows` is a (blocks, 3) f32 workspace, `stats` the
// (3,) f32 result and `counter` one zeroed unsigned int, which the launch
// leaves at 0; launches that share it must not run at the same time. d
// must be a positive multiple of 128; u, e and out 16-byte aligned, an
// int8 payload 4-byte aligned. Returns the CUDA error of the launch (0 on
// success).
extern "C" int repro_ota_receive(int packed, int stats, const void* payload,
                                 const void* scales, const void* u,
                                 const void* e, void* out, void* stats_rows,
                                 void* stats_out, void* counter, int rows,
                                 long long d, float scale, float alpha,
                                 float inv_alpha, float one_minus_alpha,
                                 float exponent, float u_bound,
                                 float e_floor, int blocks, void* stream) {
  if (d <= 0 || d % 128 != 0 || rows < 0 ||
      (long long)blocks != (d + kThreads - 1) / kThreads ||
      (stats && (stats_rows == nullptr || stats_out == nullptr ||
                 counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{payload, static_cast<const float*>(scales),
               static_cast<const float*>(u), static_cast<const float*>(e),
               static_cast<float*>(out), static_cast<float*>(stats_rows),
               static_cast<float*>(stats_out),
               static_cast<unsigned*>(counter), rows, (int64_t)d, scale,
               Cms{alpha, inv_alpha, one_minus_alpha, exponent, u_bound,
                   e_floor}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed == INT8 && stats) return (int)launch<INT8, true>(a, blocks, s);
  if (packed == INT8) return (int)launch<INT8, false>(a, blocks, s);
  if (packed == FOLD && stats) return (int)launch<FOLD, true>(a, blocks, s);
  if (packed == FOLD) return (int)launch<FOLD, false>(a, blocks, s);
  if (packed == PLANES && stats)
    return (int)launch<PLANES, true>(a, blocks, s);
  if (packed == PLANES) return (int)launch<PLANES, false>(a, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the receive kernel that an SM holds at once, for the
// instance `packed` x `stats` on the current device (negative: a CUDA
// error). The grid is resident in one wave when this times the SMs is at
// least receive_blocks(d).
extern "C" int repro_ota_receive_blocks_per_sm(int packed, int stats) {
  if (packed == INT8) return stats ? blocks_per_sm<INT8, true>()
                                   : blocks_per_sm<INT8, false>();
  if (packed == FOLD) return stats ? blocks_per_sm<FOLD, true>()
                                   : blocks_per_sm<FOLD, false>();
  if (packed == PLANES) return stats ? blocks_per_sm<PLANES, true>()
                                     : blocks_per_sm<PLANES, false>();
  return -(int)cudaErrorInvalidValue;
}

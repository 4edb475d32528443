// The bulk-copy row ring shared by the channel kernel (ota_channel.cu,
// B2) and the accumulating transmit (ota_transmit_stream.cu, B3b): both
// stream the rows of an (n, d) f32 gradient stack through a block's
// column tile, in row order, and add h[n] * G[n, c] per column.
//
// What bounds both on an H100: device-memory bytes (4 n d read once
// against 2 flops an entry). A block keeps that stream going without
// tying its threads to it: one thread issues a 1-D bulk asynchronous
// copy (cp.async.bulk, the TMA's contiguous form) of each row of the
// tile (TILE_COLS * 4 bytes) into a ring of STAGES stages of STAGE_ROWS
// rows in shared memory, each stage completing on an mbarrier; every
// walker thread reads its columns of each row from shared memory in row
// order and, once every walker is done with a stage, the same thread
// refills it. So STAGES * STAGE_ROWS rows are in flight per block
// whatever the compiler does with the loop. G is read once, so its L2
// lines come in evict-first: the stream replaces its own lines and not
// the rest of L2. h comes into shared memory beside the ring, H_ROWS
// rows at a time.
//
// The walk calls body(row, h[row], row_in_shared_memory) on every walker
// for each row in order; the caller's body does the arithmetic (and, in
// B3b, ends its row-chunk pieces), so the two kernels share the ring and
// keep their own epilogues. The walkers are the block's first THREADS
// threads and synchronize among themselves only (a named barrier): B3b's
// block is all walkers; B2's has CMS warps beside them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ota_ring {

constexpr long long kWaitCycles = 20000000000LL;  // ~10 s: a lost barrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete. A barrier that
// never completes (a fault in a kernel) traps after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWaitCycles) __trap();
  } while (!done);
}

// An L2 policy that marks the lines it brings in evict-first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// One contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on bar,
// its L2 lines under the policy `pol`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// A barrier for the first THREADS threads of the block (warps 0 ..
// THREADS / 32 - 1), the ring's walkers: the block's other warps, if
// any, do other work meanwhile.
template <int THREADS>
__device__ __forceinline__ void walkers_sync() {
  static_assert(THREADS % 32 == 0, "whole warps");
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

template <int TILE_COLS, int STAGE_ROWS, int STAGES, int H_ROWS>
struct Ring {
  static constexpr int kRowBytes = TILE_COLS * 4;
  static constexpr int kStageBytes = STAGE_ROWS * kRowBytes;
  // the ring's dynamic shared memory
  static constexpr int kBytes = STAGES * kStageBytes;
  static_assert(H_ROWS % STAGE_ROWS == 0, "h chunks end on stage ends");

  // Rows [r, min(r + STAGE_ROWS, row1)) of the tile into stage s.
  static __device__ __forceinline__ void issue(const float* tile, int64_t d,
                                               uint32_t ring, uint32_t bars,
                                               int s, int r, int row1,
                                               uint32_t row_bytes,
                                               uint64_t pol) {
    const int n = row1 - r < STAGE_ROWS ? row1 - r : STAGE_ROWS;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, n * row_bytes);
    for (int k = 0; k < n; ++k)
      bulk_load(ring + (s * STAGE_ROWS + k) * kRowBytes,
                tile + (int64_t)(r + k) * d, row_bytes, bar, pol);
  }

  // Thread 0's half of the start: set up the barriers and issue the
  // first STAGES stages of rows [row0, row1). The block's threads may do
  // other work before they call stream_primed (its first barrier makes
  // the set-up visible to them).
  static __device__ __forceinline__ void prime(const float* tile, int64_t d,
                                               int width, int row0, int row1,
                                               float* ring, uint64_t* full,
                                               uint64_t pol) {
    const uint32_t bars = smem_u32(full);
    const int n_st = (row1 - row0 + STAGE_ROWS - 1) / STAGE_ROWS;
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < n_st && i < STAGES; ++i)
      issue(tile, d, smem_u32(ring), bars, i, row0 + i * STAGE_ROWS, row1,
            (uint32_t)width * 4u, pol);
  }

  // Stream rows [row0, row1) of the column tile `tile` (row stride d
  // floats, `width` columns; width * 4 a multiple of 16 and the tile
  // 16-byte aligned) through `ring` (kBytes of shared memory, 128-byte
  // aligned) and the STAGES barriers `full`, which thread 0 has primed
  // with the same arguments, with h[row0 ..] staged in `h_s` (H_ROWS
  // floats): body(row, h[row], row's TILE_COLS floats in shared memory)
  // runs on every walker for each row in order. The walkers are the
  // block's first THREADS threads; each calls it once a launch, and it
  // ends with them synchronized and the ring free. The block's other
  // threads, if any, do not call it.
  template <int THREADS, class Body>
  static __device__ __forceinline__ void stream_primed(
      const float* tile, const float* h, int64_t d, int width, int row0,
      int row1, float* ring, uint64_t* full, float* h_s, uint64_t pol,
      Body&& body) {
    const int tid = threadIdx.x;
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t bars = smem_u32(full);
    const uint32_t row_bytes = (uint32_t)width * 4u;
    const int n_st = (row1 - row0 + STAGE_ROWS - 1) / STAGE_ROWS;
    for (int k = tid; k < row1 - row0 && k < H_ROWS; k += THREADS)
      h_s[k] = h[row0 + k];
    walkers_sync<THREADS>();
    for (int i = 0; i < n_st; ++i) {
      const int s = i % STAGES;
      const int r = row0 + i * STAGE_ROWS;
      const int nr = row1 - r < STAGE_ROWS ? row1 - r : STAGE_ROWS;
      if (i > 0 && (r - row0) % H_ROWS == 0) {  // the next rows' h
        for (int k = tid; k < row1 - r && k < H_ROWS; k += THREADS)
          h_s[k] = h[r + k];
        walkers_sync<THREADS>();
      }
      mbar_wait(bars + 8 * s, (uint32_t)(i / STAGES) & 1u);
      const float* st = ring + s * STAGE_ROWS * TILE_COLS;
      for (int k = 0; k < nr; ++k)
        body(r + k, h_s[(r + k - row0) % H_ROWS], st + k * TILE_COLS);
      walkers_sync<THREADS>();  // every thread is done with stage s
      if (tid == 0 && i + STAGES < n_st)
        issue(tile, d, ring_s, bars, s, r + STAGES * STAGE_ROWS, row1,
              row_bytes, pol);
    }
  }

  // prime, then stream_primed.
  template <int THREADS, class Body>
  static __device__ __forceinline__ void stream_rows(
      const float* tile, const float* h, int64_t d, int width, int row0,
      int row1, float* ring, uint64_t* full, float* h_s, uint64_t pol,
      Body&& body) {
    if (threadIdx.x == 0) prime(tile, d, width, row0, row1, ring, full, pol);
    stream_primed<THREADS>(tile, h, d, width, row0, row1, ring, full, h_s,
                           pol, body);
  }
};

}  // namespace ota_ring

// Accumulating f32 OTA transmit: the faded partial sum of a chunk of
// clients, folded into a running (d,) carry, over row chunks; and,
// when the caller passes a clean carry, the chunk's unfaded masked sum
// folded into it from the same read of G.
//
// Replaces the TPU kernels src/repro/kernels/ota_channel.py,
// ota_transmit_slab(acc=, row_chunk=) / _tx_stream_kernel (Pallas), and,
// with no carry and one row chunk, ota_transmit_slab(quantize=False) /
// _tx_kernel.
//
//   out[c] = acc[c] + sum_k (sum_{n in chunk k} h[n] * G[n, c]) / n_total
//   clean_out[c] = clean[c] + sum_k sum_{n in chunk k} m[n] * G[n, c]
//                                                       (CLEAN only)
//
// What bounds it on an H100: device-memory bytes. The chunk's rows x d
// gradient stack is read once (4 rows d bytes; 35 MB at 50 x 175,104,
// 32.8 MB at 2000 x 4096) against 2 flops per entry (4 with CLEAN, which
// adds 8 bytes an entry: clean in, clean_out out).
//
// The design. A block owns a tile of kTileCols = 512 columns (128
// threads, 4 columns a thread) and a SEGMENT of rows; the grid is
// (column tiles) x (segments). The wrapper picks the number of segments
// S (kernels/ota_channel.py, row_split): 1 without a carry, whenever the
// column tiles alone give 2 blocks an SM, and when the rows come in more
// than 64 row chunks; else enough to give the card 2 blocks an SM, at
// most kFoldRows = 32. Segments are `seg_rows` rows each (the last one
// ragged); with more than one row chunk, `seg_rows` is a multiple of the
// chunk, so a segment holds whole chunks.
//
// Summation order (kernels/ota_channel.py, ota_transmit_split_model,
// mirrors it operation for operation). A PIECE is the rows of one row
// chunk inside one segment (a whole chunk, or, with one chunk, the
// whole segment); its sum runs over its rows in row order from 0,
// part = part + h[n] * G[n, c].
//   S = 1: v = acc[c] (0 for a null acc), then v = v + part / n_total for
//      each piece in order; out[c] = v. The carry is the running sum,
//      as in the TPU kernel and the plain version.
//   S > 1: each segment's partial P_s = 0, then P_s = P_s + part / n_total
//      for each of its pieces in order; the fold T = 0, T = T + P_s for
//      s = 0 .. S-1 in segment order; out[c] = acc[c] + T (0 + T for a
//      null acc). The carry is added once, after the chunk's sum: only
//      one rounding at the carry's magnitude. (That is why the split
//      stops at 64 row chunks: the plain version adds each chunk onto
//      the carry, and over hundreds of small chunks whose sums keep one
//      sign its roundings drift from any other order by more than the
//      1e-6 tier; 9.4 x the tier at 2000 chunks of 1 row on the
//      million-client path's rows, in the CPU model.)
// The clean sum (CLEAN) follows the same pieces and segments with no
// division: each piece cpart = 0, cpart = cpart + m[n] * G[n, c] in row
// order; S = 1: cv = clean[c], cv = cv + cpart for each piece in order;
// S > 1: each segment's CP_s = 0, CP_s = CP_s + cpart, the fold CT = 0,
// CT = CT + CP_s in segment order (through the same workspace, rows
// n_seg .. 2 n_seg - 1, and the same ticket), clean_out[c] = clean[c] +
// CT. With 2 rows, S = 1 and a 0/1 mask that is clean + (m0 g0 + m1 g1),
// the value of clean + torch.sum(m[:, None] * G, 0).
// With --fmad=false every product and sum rounds on its own, so the
// result is one fixed function of the inputs: it does not depend on
// which block ends last, and it is the same from run to run. With no
// carry (S = 1) and one row chunk it is 0 + s / n_total, s summed as the
// channel kernel (ota_channel.cu) sums it, so the streamed round's faded
// sum is bitwise the resident round's.
//
// The fold across blocks, in the same launch: each block of a tile
// writes its P_s into an (S, d) workspace and takes a ticket from the
// tile's counter (an acquire-release add); the block that draws the last
// ticket copies
// the tile's S partials into shared memory (bulk copies, one round trip
// from L2), adds them in segment order and then the carry, writes out,
// and puts the counter back to 0 for the next launch. No float atomics.
// With S = 1 the block writes out itself and touches neither.
//
// Loads (the bulk path: d % 4 == 0 and G 16-byte aligned): the bulk-copy
// row ring of ota_ring.cuh, shared with the channel kernel: one thread
// copies each 2 KB row of the tile into a ring of 4 stages of 8 rows
// (64 KB), each stage completing on an mbarrier, so 48-64 KB are in
// flight per block; G's lines come in evict-first; h comes into shared
// memory beside it, 1024 rows at a time. The scalar path (d % 4 != 0 or
// G not 16-byte aligned) reads G with plain loads, thread t on columns
// t, t + 128, t + 256, t + 384 of the tile, in the same order.
//
// Few rows (CLEAN, S = 1, at most kFewRows rows, d % 4 == 0 and every
// (d,) and (rows, d) operand 16-byte aligned): the ring would hold only
// the few rows of its one stage, a few KB a block, while its 64 KB of
// shared memory keeps 3 blocks on an SM. So the block walks no tile:
// each thread takes kFewGroups groups of 4 adjacent columns, issues
// every load of them first (each row of G, acc and clean: 16-byte
// streaming loads), then sums them in the order above. No shared
// memory: registers (62 a thread) keep 8 blocks on an SM, 1024 threads
// with kFewGroups x (rows + 2) loads of 16 B each in flight, 128 KB at 2
// rows. The choice is made from the shape here, in the launcher; every
// schedule computes the same value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ota_ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileCols = 512;          // 4 columns a thread
constexpr int kRowBytes = kTileCols * 4;  // a row of a tile: 2 KB
// 64 KB of shared memory a block: the ring of 4 stages of 8 rows, then
// (S > 1) the fold's buffer of kFoldRows partial rows; 3 blocks fit an
// SM. h comes into shared memory 1024 rows at a time (the bulk path).
constexpr int kStages = 4;
constexpr int kHRows = 1024;
using Ring = ota_ring::Ring<kTileCols, 8, kStages, kHRows>;
constexpr int kSmemBytes = Ring::kBytes;
constexpr int kFoldRows = kSmemBytes / kRowBytes;
// The few-row schedule: at most kFewRows rows, kFewGroups column groups
// of 4 a thread.
constexpr int kFewRows = 4;
constexpr int kFewGroups = 2;
using ota_ring::bulk_load;
using ota_ring::evict_first_policy;
using ota_ring::mbar_expect_tx;
using ota_ring::mbar_init;
using ota_ring::mbar_wait;
using ota_ring::smem_u32;

struct Args {
  const float* G;
  const float* h;
  const float* acc;        // may be null: a zero carry
  float* out;
  const float* m;          // CLEAN: the (n_rows,) clean coefficients
  const float* clean;      // CLEAN: the (d,) clean carry
  float* clean_out;        // CLEAN
  float* partials;         // (n_seg, ld), (2 n_seg, ld) with CLEAN;
                           // unused when n_seg == 1
  unsigned* counters;      // one a column tile, 0 between launches
  int64_t ld;              // d rounded up to a multiple of 4
  int n_rows;
  int64_t d;
  int row_chunk;
  int seg_rows;
  int n_seg;
  float n_total;
};

// How a block reads its rows of G.
enum Load { kScalar = 0, kBulk = 1, kFew = 2 };

// One column of the few-row schedule (S = 1): the faded sum onto the
// carry v and the clean sum onto cv, piece by piece, in row order.
template <bool CLEAN>
__device__ __forceinline__ void few_rows_column(const Args& a,
                                                const float* hv,
                                                const float* mv,
                                                const float* g, float& v,
                                                float& cv) {
  float part = 0.f, cpart = 0.f;
  int next = a.row_chunk < a.n_rows ? a.row_chunk : a.n_rows;
#pragma unroll
  for (int r = 0; r < kFewRows; ++r) {
    if (r >= a.n_rows) break;
    if (r == next) {  // a piece ends: it lands on the carries
      v = v + part / a.n_total;
      part = 0.f;
      if (CLEAN) {
        cv = cv + cpart;
        cpart = 0.f;
      }
      next = next + a.row_chunk < a.n_rows ? next + a.row_chunk : a.n_rows;
    }
    part = part + hv[r] * g[r];
    if (CLEAN) cpart = cpart + mv[r] * g[r];
  }
  if (a.n_rows > 0) {
    v = v + part / a.n_total;
    if (CLEAN) cv = cv + cpart;
  }
}

// The few-row schedule: kFewGroups groups of 4 columns a thread, every
// load issued before the sums.
template <bool CLEAN>
__device__ __forceinline__ void few_rows_walk(const Args& a) {
  float hv[kFewRows], mv[kFewRows];
#pragma unroll
  for (int r = 0; r < kFewRows; ++r) {
    hv[r] = r < a.n_rows ? __ldg(a.h + r) : 0.f;
    mv[r] = CLEAN && r < a.n_rows ? __ldg(a.m + r) : 0.f;
  }
  const int64_t groups = a.d / 4;
  const int64_t q0 =
      (int64_t)blockIdx.x * kThreads * kFewGroups + threadIdx.x;
  const float4* G4 = reinterpret_cast<const float4*>(a.G);
  float4 g[kFewGroups][kFewRows], acc[kFewGroups], cl[kFewGroups];
#pragma unroll
  for (int u = 0; u < kFewGroups; ++u) {
    const int64_t q = q0 + (int64_t)u * kThreads;
    if (q >= groups) continue;
#pragma unroll
    for (int r = 0; r < kFewRows; ++r)
      if (r < a.n_rows) g[u][r] = __ldcs(G4 + r * groups + q);
    acc[u] = a.acc != nullptr
                 ? __ldcs(reinterpret_cast<const float4*>(a.acc) + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    if (CLEAN) cl[u] = __ldcs(reinterpret_cast<const float4*>(a.clean) + q);
  }
#pragma unroll
  for (int u = 0; u < kFewGroups; ++u) {
    const int64_t q = q0 + (int64_t)u * kThreads;
    if (q >= groups) continue;
    float o[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
    float co[4] = {0.f, 0.f, 0.f, 0.f};
    if (CLEAN) {
      co[0] = cl[u].x;
      co[1] = cl[u].y;
      co[2] = cl[u].z;
      co[3] = cl[u].w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float col[kFewRows];
#pragma unroll
      for (int r = 0; r < kFewRows; ++r)
        col[r] = r < a.n_rows ? reinterpret_cast<const float*>(&g[u][r])[j]
                              : 0.f;
      few_rows_column<CLEAN>(a, hv, mv, col, o[j], co[j]);
    }
    __stcs(reinterpret_cast<float4*>(a.out) + q,
           make_float4(o[0], o[1], o[2], o[3]));
    if (CLEAN)
      __stcs(reinterpret_cast<float4*>(a.clean_out) + q,
             make_float4(co[0], co[1], co[2], co[3]));
  }
}

template <int LOAD, bool CLEAN>
__global__ void __launch_bounds__(kThreads)
    ota_transmit_stream_kernel(const Args a) {
  if (LOAD == kFew) {
    few_rows_walk<CLEAN>(a);
    return;
  }
  // the ring (kBulk), then the fold's buffer (S > 1)
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t fold_bar;
  __shared__ float h_s[LOAD == kBulk ? kHRows : 1];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * kTileCols;
  const int width = (int)(a.d - tile0 < kTileCols ? a.d - tile0 : kTileCols);
  const int seg = blockIdx.y;
  const int row0 = seg * a.seg_rows;
  const int row1 = a.n_rows - row0 < a.seg_rows ? a.n_rows : row0 + a.seg_rows;

  // This thread's columns within the tile: 4 adjacent ones (kBulk;
  // width is then a multiple of 4), or 4 strided by 128.
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    off[j] = LOAD == kScalar ? tid + kThreads * j : 4 * tid + j;
  const bool on = 4 * tid < width;

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  // S = 1: the carry is the running sum; S > 1: P_s starts at 0.
  float segp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    segp[j] = (a.n_seg == 1 && a.acc != nullptr && off[j] < width)
                  ? a.acc[tile0 + off[j]]
                  : 0.f;
  // The clean sum's piece and segment partials, in the same way.
  float cpart[4] = {0.f, 0.f, 0.f, 0.f};
  float csegp[4] = {0.f, 0.f, 0.f, 0.f};
  if (CLEAN && a.n_seg == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (off[j] < width) csegp[j] = a.clean[tile0 + off[j]];
  }
  // The end of the first piece: the first row chunk boundary after row0,
  // or row1 when the segment ends first.
  const int64_t first = ((int64_t)row0 / a.row_chunk + 1) * a.row_chunk;
  int next = first < row1 ? (int)first : row1;

  const uint64_t pol = evict_first_policy();  // G and the partials: read once
  if (LOAD == kBulk) {
    Ring::stream_rows<kThreads>(
        a.G + tile0, a.h, a.d, width, row0, row1, ring, full, h_s, pol,
        [&](int row, float hv, const float* st) {
          if (row == next) {  // a piece ends: it lands on the partial
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              segp[j] = segp[j] + part[j] / a.n_total;
              part[j] = 0.f;
              if (CLEAN) {
                csegp[j] = csegp[j] + cpart[j];
                cpart[j] = 0.f;
              }
            }
            next = next + a.row_chunk < row1 ? next + a.row_chunk : row1;
          }
          if (on) {
            const float4 g = *reinterpret_cast<const float4*>(st + 4 * tid);
            part[0] = part[0] + hv * g.x;
            part[1] = part[1] + hv * g.y;
            part[2] = part[2] + hv * g.z;
            part[3] = part[3] + hv * g.w;
            if (CLEAN) {
              const float mv = __ldg(a.m + row);
              cpart[0] = cpart[0] + mv * g.x;
              cpart[1] = cpart[1] + mv * g.y;
              cpart[2] = cpart[2] + mv * g.z;
              cpart[3] = cpart[3] + mv * g.w;
            }
          }
        });
  } else {
    // Plain loads, a piece at a time.
    for (int c0 = row0; c0 < row1;) {
      const int c1 = next;
      const float* g = a.G + tile0;
#pragma unroll 4
      for (int row = c0; row < c1; ++row) {
        const float hv = __ldg(a.h + row);
        const float mv = CLEAN ? __ldg(a.m + row) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (off[j] < width) {
            const float gv = __ldg(g + (int64_t)row * a.d + off[j]);
            part[j] = part[j] + hv * gv;
            if (CLEAN) cpart[j] = cpart[j] + mv * gv;
          }
      }
      if (c1 < row1) {  // a piece ends before the segment does
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          segp[j] = segp[j] + part[j] / a.n_total;
          part[j] = 0.f;
          if (CLEAN) {
            csegp[j] = csegp[j] + cpart[j];
            cpart[j] = 0.f;
          }
        }
        next = next + a.row_chunk < row1 ? next + a.row_chunk : row1;
      }
      c0 = c1;
    }
  }
  if (row1 > row0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      segp[j] = segp[j] + part[j] / a.n_total;
      if (CLEAN) csegp[j] = csegp[j] + cpart[j];
    }
  }

  if (a.n_seg == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (off[j] < width) {
        a.out[tile0 + off[j]] = segp[j];
        if (CLEAN) a.clean_out[tile0 + off[j]] = csegp[j];
      }
    return;
  }

  // Publish this segment's partials; the last block of the tile folds.
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (off[j] < width) {
      a.partials[seg * a.ld + tile0 + off[j]] = segp[j];
      if (CLEAN)
        a.partials[(a.n_seg + seg) * a.ld + tile0 + off[j]] = csegp[j];
    }
  // The block's writes are ordered before thread 0's by the barrier; its
  // acquire-release add makes them visible with the ticket, and the last
  // ticket sees every other block's.
  const uint32_t fbar = smem_u32(&fold_bar);
  __syncthreads();
  if (tid == 0) {
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(ticket)
                 : "l"(reinterpret_cast<uint64_t>(a.counters + blockIdx.x))
                 : "memory");
    last = ticket == (unsigned)(a.n_seg - 1);
    if (last) {
      mbar_init(fbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      // the partials were written through the generic proxy; the copies
      // read them through the async one
      asm volatile("fence.proxy.async.global;" ::: "memory");
    }
  }
  __syncthreads();
  if (!last) return;
  // The fold: the tile's partials come from L2 into shared memory by
  // bulk copies (a row of kFoldRows segments' partials a round: one round
  // when S <= kFoldRows), and are added in segment order; with CLEAN the
  // clean partials (workspace rows n_seg ..) after them, the same way.
  const uint32_t fold_bytes = 16u * ((width + 3) / 4);  // a partial's row
  int round = 0;
  auto fold = [&](const float* parts, float* t) {
    for (int s0 = 0; s0 < a.n_seg; s0 += kFoldRows, ++round) {
      const int ns = a.n_seg - s0 < kFoldRows ? a.n_seg - s0 : kFoldRows;
      __syncthreads();  // the barrier is set up; the previous round is read
      if (tid == 0) {
        mbar_expect_tx(fbar, ns * fold_bytes);
        for (int r = 0; r < ns; ++r)
          bulk_load(smem_u32(ring + r * kTileCols),
                    parts + (s0 + r) * a.ld + tile0, fold_bytes, fbar, pol);
      }
      mbar_wait(fbar, (uint32_t)round & 1u);
      for (int r = 0; r < ns; ++r) {
        const float* row = ring + r * kTileCols;
        if (LOAD == kScalar) {
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = t[j] + row[off[j]];
        } else {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * tid);
          t[0] = t[0] + v.x;
          t[1] = t[1] + v.y;
          t[2] = t[2] + v.z;
          t[3] = t[3] + v.w;
        }
      }
    }
  };
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  fold(a.partials, t);
  float ct[4] = {0.f, 0.f, 0.f, 0.f};
  if (CLEAN) fold(a.partials + a.n_seg * a.ld, ct);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (off[j] < width) {
      const int64_t c = tile0 + off[j];
      a.out[c] = (a.acc != nullptr ? a.acc[c] : 0.f) + t[j];
      if (CLEAN) a.clean_out[c] = a.clean[c] + ct[j];
    }
  if (tid == 0) a.counters[blockIdx.x] = 0u;
}

// Dynamic shared memory of a launch: the ring (kBulk), and the fold's
// buffer when the rows are split; the two are used one after the other.
// The few-row schedule (n_seg == 1) takes none.
int smem_bytes(int load, int n_seg) {
  return load == kBulk || n_seg > 1 ? kSmemBytes : 0;
}

template <int LOAD, bool CLEAN>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  // Above the 48 KB default: allow it once a device.
  static bool allowed[64] = {};
  const int bytes = smem_bytes(LOAD, a.n_seg);
  if (bytes > 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!allowed[dev]) {
      e = cudaFuncSetAttribute(ota_transmit_stream_kernel<LOAD, CLEAN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
      if (e != cudaSuccess) return e;
      allowed[dev] = true;
    }
  }
  ota_transmit_stream_kernel<LOAD, CLEAN><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool CLEAN>
cudaError_t launch_loads(const Args& a, dim3 grid, bool bulk,
                         cudaStream_t s) {
  return bulk ? launch<kBulk, CLEAN>(a, grid, s)
              : launch<kScalar, CLEAN>(a, grid, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One launch on `stream`: grid (ceil(d / 512), n_seg) of 128 threads.
// G is read through the bulk-copy ring when d % 4 == 0 and G is 16-byte
// aligned, else with plain 4-byte loads; both sum in the same order.
// Segments are `seg_rows` rows (a multiple of `row_chunk` when
// row_chunk < n_rows, so that no chunk is cut); `partials` is an
// (n_seg, ceil(d / 4) * 4) f32 workspace ((2 n_seg, ...) with a clean
// carry) and `counters` ceil(d / 512) zeroed ints, both used only when
// n_seg > 1, and a launch leaves the counters at 0. `acc` may be null (a
// zero carry); it must not alias `out`. `clean` (d,), with `m` (n_rows,)
// and `clean_out` (d,), adds the clean carry (all three or none;
// `clean` must not alias `clean_out`); such a launch with n_seg == 1 and
// at most kFewRows rows, d % 4 == 0 and every (d,) and (n_rows, d)
// operand 16-byte aligned takes the few-row schedule instead: a grid of
// ceil(d / (4 kFewGroups 128)) blocks. Launches that share `counters`
// must not run at the same time.
extern "C" int repro_ota_transmit_stream(const void* G, const void* h,
                                         const void* acc, void* out,
                                         const void* m, const void* clean,
                                         void* clean_out, void* partials,
                                         void* counters, int n_rows,
                                         long long d, int row_chunk,
                                         int seg_rows, int n_seg,
                                         float n_total, void* stream) {
  if (d <= 0) return 0;
  const bool with_clean = clean != nullptr;
  if (row_chunk < 1 || n_rows < 0 || seg_rows < 0 || n_seg < 1 ||
      n_seg > 65535 || (long long)seg_rows * n_seg < n_rows ||
      (n_seg > 1 && (partials == nullptr || counters == nullptr)) ||
      (with_clean != (m != nullptr)) ||
      (with_clean != (clean_out != nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(G), static_cast<const float*>(h),
         static_cast<const float*>(acc), static_cast<float*>(out),
         static_cast<const float*>(m), static_cast<const float*>(clean),
         static_cast<float*>(clean_out), static_cast<float*>(partials),
         static_cast<unsigned*>(counters), (d + 3) / 4 * 4, n_rows,
         (int64_t)d, row_chunk, seg_rows, n_seg, n_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_clean && n_seg == 1 && n_rows <= kFewRows && d % 4 == 0 &&
      aligned16(G) && aligned16(out) && aligned16(clean) &&
      aligned16(clean_out) && (acc == nullptr || aligned16(acc))) {
    const long long per_block = 4LL * kFewGroups * kThreads;
    const dim3 few((unsigned)((d + per_block - 1) / per_block));
    return (int)launch<kFew, true>(a, few, s);
  }
  const dim3 grid((unsigned)((d + kTileCols - 1) / kTileCols), n_seg);
  const bool bulk = d % 4 == 0 && aligned16(G);
  if (with_clean) return (int)launch_loads<true>(a, grid, bulk, s);
  return (int)launch_loads<false>(a, grid, bulk, s);
}

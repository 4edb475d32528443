// Blocked causal / sliding-window GQA attention for Hopper (sm_90a): TMA
// loads into a ring of shared-memory stages, wgmma for both products.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention / _flash_kernel (Pallas), for bf16 q, k and v with a
// head dimension of 64 or 128 (every dense model of the zoo has 128).
// The wrapper, kernels/flash_attention.py, sends every other call (f32,
// another head dimension, strides or addresses TMA refuses) to the
// scalar kernel in flash_attention.cu; it picks from dtype and shape
// alone, never on failure.
//
//   out[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / G, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) / sqrt(D)   if (i, j) is
//   visible, else -1e30 (finite, as in the TPU kernel), with G = H / K
//   and (i, j) visible when j < Sk, i >= j (causal) and i - j < window.
//
// What bounds it on an H100: operations. At Qwen3-14B's prefill (S =
// 4096, H = 40, K = 8, D = 128, causal) the visible pairs need 4 D flops
// each, 171.8 GFLOP a layer: 174 us at the bf16 tensor-core rate (989
// TFLOP/s), against 100.7 MB, 30 us at 3.35 TB/s. At StarCoder2-15B's
// (S = 6144, H = 48, K = 4, window 4096) 412.3 GFLOP, 417 us.
//
// Design, for the tensor cores:
// - One block per (128 query rows, query head, batch): two consumer
//   warpgroups of 64 rows each and a producer warpgroup, of which one
//   thread issues every TMA load; setmaxnreg moves registers from the
//   producer (40) to the consumers (232).
// - TMA copies q once and the K / V tiles of 128 keys through a ring of
//   kStages stages, each with a "full" mbarrier for K, one for V (so
//   q k^T starts before V lands) and an "empty" one the consumers
//   release. Each tensor map is 4-D over (D, heads, S, B) with boxes of
//   64 columns (128 bytes) x 128 rows in the 128-byte swizzle, so a D =
//   128 row takes two boxes; the ragged Sq / Sk edges are zero-filled by
//   TMA, with no padded copies.
// - s = q k^T: wgmma m64n128k16, both operands K-major from shared
//   memory. o += p v: wgmma m64nDk16 with p from registers (the s
//   accumulator's layout is the A fragment's) and V read MN-major through
//   the descriptor's transpose bit.
// - Softmax in registers: row max and sum over the 4 lanes of a quad,
//   exp2 with log2(e) / sqrt(D) folded into one scale, the sum l kept per
//   thread from the f32 p and reduced once at the end, o rescaled in
//   registers. The -1e30 sentinel stays, so a wholly masked tile before a
//   row's first visible key adds p = 1 terms that the first real max
//   wipes, as on the TPU. Keys past Sk score -inf (p = 0 always).
// - Only diagonal and window-edge tiles are masked; kv tiles hidden from
//   all 128 rows are skipped. A q tile holding rows that see no key at
//   all (only with a window, from row Sk + window - 1 on) walks every kv
//   tile, so those rows average v over all Sk keys (p = 1 each), the
//   plain version's value (a uniform softmax over -1e30 scores).
// - Grid: x = query head (fastest) then batch, y = q tile, last first:
//   the long causal rows start first and the query heads of one kv head
//   run side by side. K and V of a whole sequence (16.8 MB at Qwen3's
//   shape, 12.6 MB at StarCoder2's) fit the 50 MB L2, so K / V tiles are
//   not shared across the GQA group in shared memory.
//
// Where its numbers differ from the TPU kernel's: the TPU computes p @ v
// in f32; here p is rounded to bf16 (relative error <= 2^-9 a term) for
// the wgmma, with f32 sums. Its tier against the plain version is
// |got - ref| <= 2^-7 |ref| + 2^-8 attn(q, k, |v|) + 2e-5 an element.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // libcuda.so.1 at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;               // query rows a block
constexpr int kBK = 128;               // keys a kv tile
constexpr int kStages = 2;             // K / V ring depth
constexpr int kBox = 64;               // head-dim columns a TMA box (128 B)
constexpr int kBoxBytes = kBox * 128 * 2;  // a box of 128 rows: 16 KB
constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kMasked = -1e30f;
constexpr long long kWaitCycles = 20000000000LL;  // ~10 s: a lost barrier

static_assert(kBQ == 128 && kBK == 128, "a box holds 128 rows");
static_assert(kBQ == 64 * kConsumers, "64 rows a consumer warpgroup");

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete; the warp leaves
// converged (the wgmma that follows is .aligned). A barrier that never
// completes (a fault in this file) traps after ~10 s instead of hanging.
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
  __syncwarp();
}

// One 4-D TMA load of a box into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor in the 128-byte swizzle. K-major
// operands (q, K): sbo = 1024 B between 8-row groups, lbo unused.
// MN-major (V): lbo = the stride between 64-column boxes, sbo = 1024 B
// between groups of 8 keys.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses to accumulators across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b over one k16 step, m64n128k16: a and b from shared memory,
// both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b over one k16 step, m64n128k16: a (bf16 pairs) from registers,
// b from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at n = 64 (D = 64).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory from a 1024-byte aligned base (the swizzle's period): q,
// then the K stages, then the V stages, each tile D / 64 boxes of 16 KB;
// then the barriers: full_q, full_k[kStages], full_v[kStages],
// empty[kStages].
template <int D>
struct Layout {
  static constexpr uint32_t kTile = D / kBox * kBoxBytes;
  static constexpr uint32_t kBars = (1 + 2 * kStages) * kTile;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ out, int Sq,
                                int Sk, int H, int KH, int causal, int window,
                                float scale_log2) {
  using L = Layout<D>;
  constexpr int NB = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + L::kTile;                  // + stage * kTile
  const uint32_t s_v = base + (1 + kStages) * L::kTile;  // + stage * kTile
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;                      // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kh = h / (H / KH);

  // The kv tiles some row of this q tile sees; all of them when a row sees
  // no key (then its average runs over every key, as in the plain version).
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_lo = 0, kv_hi = Sk;
  const bool keyless =
      window > 0 && (long long)q_last >= (long long)Sk + window - 1;
  if (!keyless) {
    if (window > 0) kv_lo = max(0, q0 - window + 1) / kBK * kBK;
    if (causal) kv_hi = min(q_last + 1, Sk);
  }
  const int n_tiles = (kv_hi - kv_lo + kBK - 1) / kBK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        tma_load(s_q + i * kBoxBytes, &tq, bar_q, i * kBox, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int t0 = kv_lo + it * kBK;
        mbar_wait(bar_e + 8 * s, ph ^ 1);  // the first round passes
        mbar_expect_tx(bar_k + 8 * s, L::kTile);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tma_load(s_k + s * L::kTile + i * kBoxBytes, &tk, bar_k + 8 * s,
                   i * kBox, kh, t0, b);
        mbar_expect_tx(bar_v + 8 * s, L::kTile);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tma_load(s_v + s * L::kTile + i * kBoxBytes, &tv, bar_v + 8 * s,
                   i * kBox, kh, t0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // Consumer warpgroup wg: rows q0 + 64 wg .. + 63. Thread (warp w, lane
    // l) holds rows r_a = 16 w + l / 4 and r_b = r_a + 8 of them, columns
    // 8 n + 2 (l % 4) + {0, 1} of each accumulator (wgmma's D layout).
    const int t = tid % 128;
    const int lane = t % 32;
    const int wg_first = q0 + 64 * wg;
    const int wg_last = wg_first + 63;
    const int row_a = wg_first + 16 * (t / 32) + lane / 4;
    const int row_b = row_a + 8;
    const int col = 2 * (lane % 4);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int t0 = kv_lo + it * kBK;

      // s = q k^T over D / 16 steps of 16 columns: box kk / 4, 32 bytes
      // a step inside the 128-byte swizzled row.
      float sc[kBK / 2];
      mbar_wait(bar_k + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(s_q + off + wg * 64 * 128, 16, 1024),
                      smem_desc(s_k + s * L::kTile + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale into the exp2 domain; mask only the tiles that need it.
      const bool edge = t0 + kBK > Sk ||
                        (causal && t0 + kBK - 1 > wg_first) ||
                        (window > 0 && wg_last - t0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int j = t0 + 8 * (i / 4) + col + (i & 1);
          const int r = (i & 2) ? row_b : row_a;
          float x = sc[i] * scale_log2;
          if (j >= Sk)
            x = -INFINITY;
          else if ((causal && j > r) || (window > 0 && r - j >= window))
            x = kMasked;
          sc[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale_log2;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float c_a = ex2(m_a - mn_a), c_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // p = exp2(x - m) in f32 for l; rounded to bf16 pairs as wgmma's A
      // fragments: for k step kk, a0 / a2 = row r_a at columns 16 kk +
      // {0, 8} + 2 (l % 4), a1 / a3 = row r_b, which is the s accumulator's
      // own layout.
      uint32_t pa[kBK / 16][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float p0 = ex2(sc[4 * n] - mn_a), p1 = ex2(sc[4 * n + 1] - mn_a);
        const float p2 = ex2(sc[4 * n + 2] - mn_b);
        const float p3 = ex2(sc[4 * n + 3] - mn_b);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        pa[n / 2][2 * (n % 2)] = pack_bf16(p0, p1);
        pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= c_a;
        o[4 * n + 1] *= c_a;
        o[4 * n + 2] *= c_b;
        o[4 * n + 3] *= c_b;
      }

      // o += p v over kBK / 16 steps of 16 keys (2048 bytes of V each).
      mbar_wait(bar_v + 8 * s, ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv =
            smem_desc(s_v + s * L::kTile + kk * 2048, kBoxBytes, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(o, pa[kk], dv);
        else
          wgmma_rs_n64(o, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(bar_e + 8 * s);
    }

    const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
    const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
    __nv_bfloat16* out_a = out + (((int64_t)b * Sq + row_a) * H + h) * D;
    __nv_bfloat16* out_b = out + (((int64_t)b * Sq + row_b) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * n + col) =
            __floats2bfloat162_rn(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * n + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map over the contiguous bf16 tensor (B, S, heads, D), read in boxes of
// 64 columns x 1 head x 128 rows x 1 batch, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int heads, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {kBox, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* out, int B, int Sq, int Sk, int H,
           int KH, int causal, int window, float scale_log2,
           cudaStream_t s) {
  const int smem = (int)Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H * B, (Sq + kBQ - 1) / kBQ);
  flash_attention_sm90_kernel<D><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KH, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch. q: (B, Sq, H, D); k, v: (B, Sk, KH, D); out: (B, Sq, H, D);
// all contiguous bf16 at 16-byte aligned addresses, D in {64, 128}, H % KH
// == 0; window 0 means no window; scale = 1 / sqrt(D).
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Sq, int Sk, int H, int KH, int D,
                                          int causal, int window, float scale,
                                          void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (Sk <= 0 || KH <= 0 || H <= 0 || H % KH != 0 || (D != 64 && D != 128) ||
      window < 0 || (long long)H * B > 0x7fffffffLL ||
      (Sq + kBQ - 1) / kBQ > 65535 || !aligned(q) || !aligned(k) ||
      !aligned(v) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, B, Sq, H, D) ||
      !make_map(&tk, encode, k, B, Sk, KH, D) ||
      !make_map(&tv, encode, v, B, Sk, KH, D))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(tq, tk, tv, out, B, Sq, Sk, H, KH, causal, window,
                      scale_log2, s);
  return launch<128>(tq, tk, tv, out, B, Sq, Sk, H, KH, causal, window,
                     scale_log2, s);
}

// Dynamic shared memory a block of the kernel for head dimension D takes
// (0 for a D it does not take); printed beside the compiler's report.
extern "C" int repro_flash_attention_sm90_smem(int D) {
  if (D == 64) return (int)Layout<64>::kBytes;
  if (D == 128) return (int)Layout<128>::kBytes;
  return 0;
}

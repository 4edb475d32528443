// Quantize-on-write OTA transmit: the faded partial sum of one
// transmitter's client gradients, quantized per 128-column block.
//
// Replaces the TPU kernel src/repro/kernels/ota_channel.py,
// ota_transmit_slab(quantize=True) / _tx_quant_kernel (Pallas).
//
//   x[c]  = (sum_n h[n] * G[n, c]) / n_total  (+ ef[c] with error feedback)
//   int8: s = max|x| / 127 over the block (1 if the block is all zero),
//         q = clip(floor(x/s + r) | rint(x/s), -127, 127)
//   sign: m = mean|x| over the block; q = sign(x), s = m (1 if m == 0);
//         zero_fold: q = x < 0 ? -1 : +1, s = m (0 for an all-zero block)
//   residual[c] = x[c] - q[c] * s   (optional; the next round's ef)
//
// Stochastic rounding takes its uniforms r either from the host (a (d,)
// f32 draw, the parity oracle's) or, with in-kernel draws, from a
// Philox4x32-10 generator written out below: keyed by the 64-bit seed,
// counter = the thread's 4-column group, the low 24 bits of each word
// times 2^-24 as the uniform. That is the twin of the TPU kernel's pltpu
// PRNG path; its contract against the host-drawn plain version is one
// quantization step per entry, not bitwise.
//
// What bounds it on an H100: device-memory bytes. The N x d gradient
// slab is read once (35 MB at N = 50, d = 175,104) against 2 flops per
// entry; the epilogue moves a few bytes per column (r, ef, residual in
// f32, q in int8, one f32 scale per 128 columns).
//
// What the design does about it: as in the channel kernel, each thread
// owns 4 adjacent columns and walks the N rows itself in a fixed order
// (16-byte loads, h staged through shared memory in chunks of kHChunk),
// so the client sum needs no cross-thread reduction. With 4 columns a
// thread, a warp covers exactly one 128-column quantization block, so
// the block's max|x| or sum|x| is a warp reduction with __shfl_xor_sync:
// no shared memory, no atomics, and the payload leaves the kernel in
// wire format. d must be a multiple of 128 (slabs are), so a warp is
// either wholly inside the slab or wholly past it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHChunk = 1024;
constexpr float kInt8Max = 127.f;

enum Quant {
  INT8_SR = 0,           // host-drawn uniforms r
  INT8_SR_INKERNEL = 1,  // Philox uniforms drawn here
  INT8_RTN = 2,          // round half to even
  SIGN = 3,              // {-1, 0, +1}
  SIGN_FOLD = 4          // {-1, +1}, zero blocks scale 0
};

// Philox4x32-10 (Salmon et al., SC'11), as in Random123.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float u24(uint32_t bits) {
  return (float)(bits & 0xFFFFFFu) * 5.9604644775390625e-8f;  // 2^-24
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
ota_transmit_kernel(const float* __restrict__ G, const float* __restrict__ h,
                    const float* __restrict__ r, const float* __restrict__ ef,
                    int8_t* __restrict__ q_out, float* __restrict__ s_out,
                    float* __restrict__ resid, uint64_t seed, int n_rows,
                    int64_t d, float n_total) {
  __shared__ float h_s[kHChunk];
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const bool active = col0 < d;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < n_rows; n0 += kHChunk) {
    const int rows = n_rows - n0 < kHChunk ? n_rows - n0 : kHChunk;
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) h_s[i] = h[n0 + i];
    __syncthreads();
    if (!active) continue;
    const float* row = G + (int64_t)n0 * d + col0;
#pragma unroll 8
    for (int k = 0; k < rows; ++k) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(row + (int64_t)k * d));
      const float hv = h_s[k];
      acc[0] = acc[0] + hv * gv.x;
      acc[1] = acc[1] + hv * gv.y;
      acc[2] = acc[2] + hv * gv.z;
      acc[3] = acc[3] + hv * gv.w;
    }
  }
  // No block-wide barrier follows, and a warp is wholly in or out.
  if (!active) return;

  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = acc[j] / n_total;
  if (ef != nullptr) {
    const float4 ev = *reinterpret_cast<const float4*>(ef + col0);
    x[0] = x[0] + ev.x;
    x[1] = x[1] + ev.y;
    x[2] = x[2] + ev.z;
    x[3] = x[3] + ev.w;
  }

  // The warp's 128 columns are one quantization block.
  float s;
  if constexpr (Q == SIGN || Q == SIGN_FOLD) {
    float sum = fabsf(x[0]) + fabsf(x[1]) + fabsf(x[2]) + fabsf(x[3]);
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / 128.f;
    s = (Q == SIGN_FOLD || mean > 0.f) ? mean : 1.f;
  } else {
    float m = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                    fmaxf(fabsf(x[2]), fabsf(x[3])));
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    s = m > 0.f ? m / kInt8Max : 1.f;
  }

  float rv[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (Q == INT8_SR) {
    const float4 v = *reinterpret_cast<const float4*>(r + col0);
    rv[0] = v.x; rv[1] = v.y; rv[2] = v.z; rv[3] = v.w;
  } else if constexpr (Q == INT8_SR_INKERNEL) {
    const uint64_t group = (uint64_t)col0 >> 2;
    const uint4 bits = philox4x32_10(
        make_uint4((uint32_t)group, (uint32_t)(group >> 32), 0u, 0u),
        make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
    rv[0] = u24(bits.x); rv[1] = u24(bits.y);
    rv[2] = u24(bits.z); rv[3] = u24(bits.w);
  }

  float qf[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (Q == SIGN_FOLD) {
      qf[j] = x[j] < 0.f ? -1.f : 1.f;
    } else if constexpr (Q == SIGN) {
      qf[j] = x[j] > 0.f ? 1.f : (x[j] < 0.f ? -1.f : 0.f);
    } else {
      float y = x[j] / s;
      if constexpr (Q == INT8_RTN) {
        y = rintf(y);
      } else {
        y = floorf(y + rv[j]);
      }
      qf[j] = fminf(fmaxf(y, -kInt8Max), kInt8Max);
    }
  }
  char4 qv;
  qv.x = (signed char)qf[0];
  qv.y = (signed char)qf[1];
  qv.z = (signed char)qf[2];
  qv.w = (signed char)qf[3];
  *reinterpret_cast<char4*>(q_out + col0) = qv;
  if ((threadIdx.x & 31) == 0) s_out[col0 >> 7] = s;
  if (resid != nullptr) {
    *reinterpret_cast<float4*>(resid + col0) =
        make_float4(x[0] - qf[0] * s, x[1] - qf[1] * s, x[2] - qf[2] * s,
                    x[3] - qf[3] * s);
  }
}

template <int Q>
void launch(const void* G, const void* h, const void* r, const void* ef,
            void* q, void* s, void* resid, uint64_t seed, int n_rows,
            int64_t d, float n_total, cudaStream_t stream) {
  const int64_t blocks = (d + 4 * kThreads - 1) / (4 * kThreads);
  ota_transmit_kernel<Q><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(G), static_cast<const float*>(h),
      static_cast<const float*>(r), static_cast<const float*>(ef),
      static_cast<int8_t*>(q), static_cast<float*>(s),
      static_cast<float*>(resid), seed, n_rows, d, n_total);
}

}  // namespace

// One launch. `quant` is a Quant value. d must be a positive multiple of
// 128; G, r, ef and resid 16-byte aligned, q 4-byte aligned. r is read
// only for INT8_SR, `seed` only for INT8_SR_INKERNEL; ef and resid may be
// null. Returns the CUDA error of the launch (0 on success).
extern "C" int repro_ota_transmit(int quant, const void* G, const void* h,
                                  const void* r, const void* ef, void* q,
                                  void* s, void* resid,
                                  unsigned long long seed, int n_rows,
                                  long long d, float n_total, void* stream) {
  if (d <= 0 || d % 128 != 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (quant) {
    case INT8_SR: launch<INT8_SR>(G, h, r, ef, q, s, resid, seed, n_rows, d, n_total, st); break;
    case INT8_SR_INKERNEL: launch<INT8_SR_INKERNEL>(G, h, r, ef, q, s, resid, seed, n_rows, d, n_total, st); break;
    case INT8_RTN: launch<INT8_RTN>(G, h, r, ef, q, s, resid, seed, n_rows, d, n_total, st); break;
    case SIGN: launch<SIGN>(G, h, r, ef, q, s, resid, seed, n_rows, d, n_total, st); break;
    case SIGN_FOLD: launch<SIGN_FOLD>(G, h, r, ef, q, s, resid, seed, n_rows, d, n_total, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

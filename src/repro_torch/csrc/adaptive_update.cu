// Fused ADOTA server update: the six server optimizers in one pass.
//
// Replaces the TPU kernel src/repro/kernels/adaptive_update.py,
// adaptive_update_slab / _adaptive_update_kernel (Pallas).
//
//   Delta <- b1*Delta + gain*g      (gain = 1 - b1; 1 for momentum)
//   v     <- f(v, |Delta|^a)        adagrad: v + |D|^a
//                                   adam / amsgrad: b2 v + (1-b2)|D|^a
//                                   yogi: v - (1-b2) sign(v-|D|^a) |D|^a
//   vmax  <- max(vmax, v)           amsgrad only; the step divides by vmax
//   w     <- w - lr*Delta / max(v+eps, 0)^{1/a}
//   momentum: w <- w - lr*Delta;  sgd: w <- w - lr*g (no state)
//
// What bounds it on an H100: device-memory bytes. Per element the update
// reads g, w and the mode's state and writes the state and w back (f32:
// sgd 12 B, momentum 20 B, adagrad/adam/yogi 28 B, amsgrad 36 B) against
// a few dozen flops, far below the card's ~20 flop/byte ridge for f32
// outside the tensor cores. But at the main path's slab (175,104 entries,
// 4.9 MB for adam: 1.46 us at 3.35 TB/s) the pass is short, and each
// element is a long dependent chain: its loads, two precise powf and an
// IEEE divide, then its stores. Four elements a thread (16-byte loads)
// gave 171 blocks of 256 on 132 SMs, about 10 warps an SM, too few to
// hide that chain.
//
// The design: one element a thread, 256 threads a block, one pass with
// no grid-stride loop, no shared memory and no reduction: 684 blocks at
// d = 175,104, all resident at once (about 41 warps an SM), so every
// operand's load is in flight at the start and the chains of the warps
// whose data has come overlap the loads of the rest. A warp's accesses
// to each operand are 128 contiguous bytes (f32; 64 for bf16), so the
// same code serves every slab, aligned or not, ragged or not. Two or
// four elements a thread (8- or 16-byte loads), 128 or 512 threads a
// block and streaming cache hints measured no faster.
//
// Measured (chip_smoke.py phase "times", NVIDIA H100 80GB HBM3, 700.00 W;
// adam, f32): 8.13 us at d = 175,104 (four elements a thread: 9.2 us in
// the same run), 6.18 us at d = 4096, where a near-empty launch timed
// the same way takes 5.04 us: 3.09 us above that floor at 175,104.
//
// Numerics follow the plain version op for op: the mode and the g/w
// types are template parameters, the constants (1-b1, 1-b2, 1/alpha) are
// computed in double on the host and passed as float, the build uses
// precise powf (no fast math) and no mul+add contraction (--fmad=false).
//
// Runtime alpha: the closed alpha loop keeps its estimate on the card as
// a 0-dim f32 tensor. Its address arrives as `alpha_dev`; each thread
// reads it once and computes 1/alpha in f32 (IEEE division), as the JAX
// kernel does with its traced (1, 1) alpha operand and as the plain
// version does with a tensor alpha. No value crosses back to the host.
// A null `alpha_dev` keeps the host-float path unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { ADAGRAD = 0, ADAM = 1, AMSGRAD = 2, YOGI = 3, MOMENTUM = 4, SGD = 5 };
enum DType { F32 = 0, BF16 = 1 };

struct Params {
  float lr, beta1, gain, beta2, one_minus_beta2, alpha, inv_alpha, eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// jnp.maximum / torch.maximum: NaN in either operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// jnp.sign: sign(0) == 0 (copysignf would give +-1).
__device__ __forceinline__ float sign_f(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// One element of the update. Inputs and outputs are f32 values; the
// caller converts g and w from and to their storage type.
template <int MODE>
__device__ __forceinline__ void update_one(float g, float w, float d_in,
                                           float v_in, float m_in,
                                           const Params& p, float& d_out,
                                           float& v_out, float& m_out,
                                           float& w_out) {
  if constexpr (MODE == SGD) {
    w_out = w - p.lr * g;
    return;
  } else {
    const float d = p.beta1 * d_in + p.gain * g;
    d_out = d;
    if constexpr (MODE == MOMENTUM) {
      w_out = w - p.lr * d;
      return;
    } else {
      const float ad = fabsf(d);
      const float da = (ad == 0.f) ? 0.f : powf(ad, p.alpha);
      float v;
      if constexpr (MODE == ADAGRAD) {
        v = v_in + da;
      } else if constexpr (MODE == ADAM || MODE == AMSGRAD) {
        v = p.beta2 * v_in + p.one_minus_beta2 * da;
      } else {  // YOGI
        v = v_in - p.one_minus_beta2 * sign_f(v_in - da) * da;
      }
      v_out = v;
      float denom_v = v;
      if constexpr (MODE == AMSGRAD) {
        denom_v = max_nan(m_in, v);
        m_out = denom_v;
      }
      const float denom = powf(max_nan(denom_v + p.eps, 0.f), p.inv_alpha);
      w_out = w - p.lr * d / denom;
    }
  }
}

template <int MODE> constexpr bool kHasDelta = MODE != SGD;
template <int MODE> constexpr bool kHasNu = MODE != SGD && MODE != MOMENTUM;
template <int MODE> constexpr bool kHasVmax = MODE == AMSGRAD;

constexpr int kThreads = 256;

template <int MODE, typename TG, typename TW>
__global__ void __launch_bounds__(kThreads)
adaptive_update_kernel(const TG* __restrict__ g, const float* __restrict__ d_in,
                       const float* __restrict__ v_in,
                       const float* __restrict__ m_in,
                       const TW* __restrict__ w_in, float* __restrict__ d_out,
                       float* __restrict__ v_out, float* __restrict__ m_out,
                       TW* __restrict__ w_out, int64_t n, Params p,
                       const float* __restrict__ alpha_dev) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (alpha_dev != nullptr) {
    p.alpha = *alpha_dev;
    p.inv_alpha = 1.0f / p.alpha;
  }
  const float g1 = to_f(g[i]), w1 = to_f(w_in[i]);
  const float d1 = kHasDelta<MODE> ? d_in[i] : 0.f;
  const float v1 = kHasNu<MODE> ? v_in[i] : 0.f;
  const float m1 = kHasVmax<MODE> ? m_in[i] : 0.f;
  float dn = 0.f, vn = 0.f, mn = 0.f, wn = 0.f;
  update_one<MODE>(g1, w1, d1, v1, m1, p, dn, vn, mn, wn);
  w_out[i] = from_f<TW>(wn);
  if constexpr (kHasDelta<MODE>) d_out[i] = dn;
  if constexpr (kHasNu<MODE>) v_out[i] = vn;
  if constexpr (kHasVmax<MODE>) m_out[i] = mn;
}

template <int MODE, typename TG, typename TW>
void launch(const void* g, const void* d_in, const void* v_in, const void* m_in,
            const void* w_in, void* d_out, void* v_out, void* m_out, void* w_out,
            int64_t n, const Params& p, const float* alpha_dev,
            cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  adaptive_update_kernel<MODE, TG, TW><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const float*>(d_in),
      static_cast<const float*>(v_in), static_cast<const float*>(m_in),
      static_cast<const TW*>(w_in), static_cast<float*>(d_out),
      static_cast<float*>(v_out), static_cast<float*>(m_out),
      static_cast<TW*>(w_out), n, p, alpha_dev);
}

template <int MODE>
int dispatch_types(int g_dtype, int w_dtype, const void* g, const void* d_in,
                   const void* v_in, const void* m_in, const void* w_in,
                   void* d_out, void* v_out, void* m_out, void* w_out,
                   int64_t n, const Params& p, const float* a_dev,
                   cudaStream_t s) {
  if (g_dtype == F32 && w_dtype == F32)
    launch<MODE, float, float>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a_dev, s);
  else if (g_dtype == F32 && w_dtype == BF16)
    launch<MODE, float, __nv_bfloat16>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a_dev, s);
  else if (g_dtype == BF16 && w_dtype == F32)
    launch<MODE, __nv_bfloat16, float>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a_dev, s);
  else if (g_dtype == BF16 && w_dtype == BF16)
    launch<MODE, __nv_bfloat16, __nv_bfloat16>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a_dev, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_adaptive_update(
    int mode, int g_dtype, int w_dtype, const void* g,
    const void* d_in, const void* v_in, const void* m_in, const void* w_in,
    void* d_out, void* v_out, void* m_out, void* w_out, long long n, float lr,
    float beta1, float gain, float beta2, float one_minus_beta2, float alpha,
    float inv_alpha, float eps, const void* alpha_dev, void* stream) {
  if (n <= 0) return 0;
  if (n / kThreads >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;  // more blocks than a grid holds
  const Params p{lr, beta1, gain, beta2, one_minus_beta2, alpha, inv_alpha, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha_dev);
  switch (mode) {
    case ADAGRAD: return dispatch_types<ADAGRAD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    case ADAM: return dispatch_types<ADAM>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    case AMSGRAD: return dispatch_types<AMSGRAD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    case YOGI: return dispatch_types<YOGI>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    case MOMENTUM: return dispatch_types<MOMENTUM>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    case SGD: return dispatch_types<SGD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, p, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

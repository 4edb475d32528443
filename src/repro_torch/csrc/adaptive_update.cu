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
// a few dozen flops (two powf), far below the card's ~20 flop/byte ridge
// for f32 outside the tensor cores.
//
// What the design does about it: every operand is read once and every
// output written once, in one grid-stride pass with no shared memory and
// no reduction. Each thread handles four consecutive elements with one
// 16-byte (f32) or 8-byte (bf16) load per operand when every pointer is
// aligned, else scalar loads. At the main path's slab (175,104 entries)
// the pass moves ~4.9 MB, so launch latency rather than bandwidth sets
// its time.
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

// Four consecutive elements: one 16-byte (f32) or 8-byte (bf16) access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
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

template <int MODE, typename TG, typename TW>
__global__ void __launch_bounds__(256)
adaptive_update_kernel(const TG* __restrict__ g, const float* __restrict__ d_in,
                       const float* __restrict__ v_in,
                       const float* __restrict__ m_in,
                       const TW* __restrict__ w_in, float* __restrict__ d_out,
                       float* __restrict__ v_out, float* __restrict__ m_out,
                       TW* __restrict__ w_out, int64_t n, int vec, Params p,
                       const float* __restrict__ alpha_dev) {
  if (alpha_dev != nullptr) {
    p.alpha = *alpha_dev;
    p.inv_alpha = 1.0f / p.alpha;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t base = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       base < n; base += stride) {
    float gv[4], wv[4], dv[4] = {0, 0, 0, 0}, vv[4] = {0, 0, 0, 0},
                        mv[4] = {0, 0, 0, 0};
    float dn[4], vn[4], mn[4], wn[4];
    if (vec && base + 4 <= n) {
      load4(g + base, gv);
      load4(w_in + base, wv);
      if constexpr (kHasDelta<MODE>) load4(d_in + base, dv);
      if constexpr (kHasNu<MODE>) load4(v_in + base, vv);
      if constexpr (kHasVmax<MODE>) load4(m_in + base, mv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        update_one<MODE>(gv[j], wv[j], dv[j], vv[j], mv[j], p, dn[j], vn[j],
                         mn[j], wn[j]);
      store4(w_out + base, wn);
      if constexpr (kHasDelta<MODE>) store4(d_out + base, dn);
      if constexpr (kHasNu<MODE>) store4(v_out + base, vn);
      if constexpr (kHasVmax<MODE>) store4(m_out + base, mn);
    } else {
      const int64_t end = base + 4 < n ? base + 4 : n;
      for (int64_t i = base; i < end; ++i) {
        float dn1 = 0.f, vn1 = 0.f, mn1 = 0.f, wn1 = 0.f;
        const float d1 = kHasDelta<MODE> ? d_in[i] : 0.f;
        const float v1 = kHasNu<MODE> ? v_in[i] : 0.f;
        const float m1 = kHasVmax<MODE> ? m_in[i] : 0.f;
        update_one<MODE>(to_f(g[i]), to_f(w_in[i]), d1, v1, m1, p, dn1, vn1,
                         mn1, wn1);
        w_out[i] = from_f<TW>(wn1);
        if constexpr (kHasDelta<MODE>) d_out[i] = dn1;
        if constexpr (kHasNu<MODE>) v_out[i] = vn1;
        if constexpr (kHasVmax<MODE>) m_out[i] = mn1;
      }
    }
  }
}

constexpr int kThreads = 256;

template <int MODE, typename TG, typename TW>
void launch(const void* g, const void* d_in, const void* v_in, const void* m_in,
            const void* w_in, void* d_out, void* v_out, void* m_out, void* w_out,
            int64_t n, int vec, const Params& p, const float* alpha_dev,
            cudaStream_t stream) {
  int64_t blocks = (n + (int64_t)kThreads * 4 - 1) / ((int64_t)kThreads * 4);
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  adaptive_update_kernel<MODE, TG, TW><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const float*>(d_in),
      static_cast<const float*>(v_in), static_cast<const float*>(m_in),
      static_cast<const TW*>(w_in), static_cast<float*>(d_out),
      static_cast<float*>(v_out), static_cast<float*>(m_out),
      static_cast<TW*>(w_out), n, vec, p, alpha_dev);
}

template <int MODE>
int dispatch_types(int g_dtype, int w_dtype, const void* g, const void* d_in,
                   const void* v_in, const void* m_in, const void* w_in,
                   void* d_out, void* v_out, void* m_out, void* w_out,
                   int64_t n, int vec, const Params& p, const float* a_dev,
                   cudaStream_t s) {
  if (g_dtype == F32 && w_dtype == F32)
    launch<MODE, float, float>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a_dev, s);
  else if (g_dtype == F32 && w_dtype == BF16)
    launch<MODE, float, __nv_bfloat16>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a_dev, s);
  else if (g_dtype == BF16 && w_dtype == F32)
    launch<MODE, __nv_bfloat16, float>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a_dev, s);
  else if (g_dtype == BF16 && w_dtype == BF16)
    launch<MODE, __nv_bfloat16, __nv_bfloat16>(g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a_dev, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_adaptive_update(
    int mode, int g_dtype, int w_dtype, int vec, const void* g,
    const void* d_in, const void* v_in, const void* m_in, const void* w_in,
    void* d_out, void* v_out, void* m_out, void* w_out, long long n, float lr,
    float beta1, float gain, float beta2, float one_minus_beta2, float alpha,
    float inv_alpha, float eps, const void* alpha_dev, void* stream) {
  if (n <= 0) return 0;
  const Params p{lr, beta1, gain, beta2, one_minus_beta2, alpha, inv_alpha, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha_dev);
  switch (mode) {
    case ADAGRAD: return dispatch_types<ADAGRAD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    case ADAM: return dispatch_types<ADAM>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    case AMSGRAD: return dispatch_types<AMSGRAD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    case YOGI: return dispatch_types<YOGI>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    case MOMENTUM: return dispatch_types<MOMENTUM>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    case SGD: return dispatch_types<SGD>(g_dtype, w_dtype, g, d_in, v_in, m_in, w_in, d_out, v_out, m_out, w_out, n, vec, p, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

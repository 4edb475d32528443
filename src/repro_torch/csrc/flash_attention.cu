// Blocked causal / sliding-window GQA attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention / _flash_kernel (Pallas).
//
//   out[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / G, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h / G, :]) / sqrt(D)   if (i, j) is
//   visible, else -1e30 (finite, as in the TPU kernel), with G = H / K
//   and (i, j) visible when j < Sk, i >= j (causal) and i - j < window.
//
// q, k and v are read in their storage type (f32 or bf16) and turned
// into f32; scores, the running max m, the normaliser l and the
// accumulator are f32; the output is acc / max(l, 1e-30) in q's type.
// The running max starts at -1e30, so a row's tiles that are wholly
// masked before its first visible key add p = 1 terms that the first
// real max then wipes (corr = exp(-1e30 - m) == 0), as on the TPU.
//
// Layout. One block per (q tile of kBQ rows, query head, batch), 128
// threads; a loop inside the block walks the kv tiles of kBK keys (the
// TPU's sequential kv grid axis). The q tile and the current K / V tile
// are staged in shared memory as f32 (above 48 KB through
// cudaFuncSetAttribute); the kv head h / G comes from the block index,
// so nothing is copied per query head. Thread (ty, tx) = (tid / 8,
// tid % 8) owns query rows 4 ty .. 4 ty + 3: score columns tx + 8 c of
// each kv tile and output columns tx + 8 c of the head dimension. The
// eight threads of a row group are adjacent lanes of one warp, so a
// row's max and sum are three xor shuffles. The ragged edges are masked
// in the kernel (zero-filled rows and columns), with no padded copies.
// KV tiles that the causal or window mask hides from every row of the q
// tile are skipped; a skipped tile would only add terms the correction
// wipes, so no row with a visible key changes. Keys past Sk score -inf
// (p = 0 always). A q tile holding rows that see no key at all (only
// with a window, from row Sk + window - 1 on) walks every kv tile, so
// those rows average v over all Sk keys (p = 1 each), the plain
// version's value (a uniform softmax over -1e30 scores). Query tiles are
// taken last-first, so the long causal rows start first.
//
// What bounds it on an H100: operations. At Qwen3-14B's prefill (S =
// 4096, H = 40, K = 8, D = 128, causal) the visible pairs need 4 D
// flops each, 171.8 GFLOP a layer: 174 us at the bf16 tensor-core rate
// (989 TFLOP/s), against 100.7 MB of bytes, 30 us at 3.35 TB/s. At
// StarCoder2-15B's (S = 6144, H = 48, K = 4, window 4096) it is 412.3
// GFLOP, 417 us. This kernel runs scalar f32 FMAs (no tensor cores;
// the TPU kernel's p @ v stays f32), whose peak is 67 TFLOP/s: at best
// 2.6 ms a layer at S = 4096. bf16 calls with a head dimension of 64 or
// 128 go to the wgmma / TMA kernel in flash_attention_sm90.cu instead;
// this one takes f32 and every other head dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 32;        // keys a kv tile
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // query rows a thread
constexpr int kLanes = 8;      // threads sharing a row group
constexpr int kCols = kBK / kLanes;  // score columns a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DMAX + 1) + (size_t)kBK * (DMAX + 1) +
                          (size_t)kBK * DMAX + (size_t)kBQ * (kBK + 1));
}

// DMAX: the head dimension rounded up to 64, 128 or 256; columns D ..
// DMAX - 1 are zero in shared memory and never stored.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int KH, int D, int causal,
                           int window, float scale) {
  constexpr int QLD = DMAX + 1;  // row strides in shared memory, padded
  constexpr int KLD = DMAX + 1;  // against bank conflicts
  constexpr int VLD = DMAX;
  constexpr int PLD = kBK + 1;
  constexpr int kOut = DMAX / kLanes;  // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;             // kBQ x QLD
  float* ks = qs + kBQ * QLD;   // kBK x KLD
  float* vs = ks + kBK * KLD;   // kBK x VLD
  float* ps = vs + kBK * VLD;   // kBQ x PLD

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;
  const int row0 = ty * kRows;

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int qp = q0 + r;
    float x = 0.f;
    if (qp < Sq && c < D) x = to_f32(q[(((int64_t)b * Sq + qp) * H + h) * D + c]);
    qs[r * QLD + c] = x;
  }

  // The kv tiles some row of this q tile can see; all of them when a row
  // sees no key.
  const int q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int kv_lo = 0, kv_hi = Sk;
  const bool keyless =
      window > 0 && (long long)q_last >= (long long)Sk + window - 1;
  if (!keyless) {
    if (window > 0 && q0 - window + 1 > 0) kv_lo = q0 - window + 1;
    kv_lo = kv_lo / kBK * kBK;
    if (causal) kv_hi = q_last + 1 < Sk ? q_last + 1 : Sk;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      const int kp = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk && c < D) {
        const int64_t off = (((int64_t)b * Sk + kp) * KH + kh) * D + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r * KLD + c] = kx;
      vs[r * VLD + c] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DMAX; ++d) {
      float a[kRows], kb[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = qs[(row0 + r) * QLD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kb[c] = ks[(tx + kLanes * c) * KLD + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(a[r], kb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kp = t0 + tx + kLanes * c;
        bool ok = true;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        s[r][c] = kp >= Sk ? -INFINITY : ok ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        ps[(row0 + r) * PLD + tx + kLanes * c] = s[r][c];
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = ps[(row0 + r) * PLD + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = vs[j * VLD + tx + kLanes * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + row0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* row = out + (((int64_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int col = tx + kLanes * c;
      if (col < D) row[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KH, int D, int causal, int window,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int KH, int D, int causal, int window,
             float scale, cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KH, D, causal, window,
                         scale, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KH, D, causal, window,
                          scale, s);
  return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KH, D, causal, window,
                        scale, s);
}

}  // namespace

// One launch. q: (B, Sq, H, D); k, v: (B, Sk, KH, D); out: (B, Sq, H, D);
// all contiguous, of one type: dtype 0 = f32, 1 = bf16. H % KH == 0,
// 1 <= D <= 256; window 0 means no window.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KH, int D, int causal,
                                     int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || KH <= 0 || H <= 0 || H % KH != 0 || D <= 0 || D > 256 ||
      H > 65535 || B > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Sq, Sk, H, KH, D, causal, window,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, causal,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}

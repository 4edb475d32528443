// The round's CMS inputs in one launch: the padded (u, e) slabs that
// repro_torch.core.draws.cms_slab_inputs hands the channel.
//
// Replaces no TPU kernel: the JAX package draws u and e with
// jax.random inside the jitted round (repro.core.ota._cms_slab_inputs),
// where XLA fuses the transforms into the draw. The port draws them
// from a torch.Generator, and its plain version
// (kernels/ref.py:cms_draws_ref) is two torch.rand calls, six
// elementwise transforms and two F.pad copies: 12-16 launches and ~72 B
// of device-memory traffic an entry. This kernel writes the same bits
// in one launch and 8 B an entry, the two stores.
//
//   u = 2B * r1 - B                      (B = CMS_U_BOUND)
//   e = max(-log(max(r2, FLT_MIN)), CMS_E_FLOOR)
//   [total, padded): the fixed point u = 0, e = 1
//
// r1 and r2 are the uniforms two torch.rand((total,), generator=g)
// calls would draw, in that order, on the card's torch
// (ATen/native/cuda/DistributionTemplates.h): each call advances the
// generator's Philox offset by its counter_offset, and a tensor whose
// byte offsets overflow 32 bits is drawn as the pieces that
// TensorIterator::with_32bit_indexing halves it into, after the whole
// call's offset was taken (and left unused). A piece of n entries is
// one grid of min(SMs x maxThreadsPerSM / 256, ceil(n / 256)) blocks
// of 256: thread t calls curand_init(seed, t, offset) and, at each step
// of its grid-stride loop, curand_uniform4, whose four values go to
// entries base + k * 256 * grid, k = 0..3 (uniform's transform maps the
// value 1 to 0). The wrapper (kernels/cms_draws.py) works out the
// pieces, their grids and offsets on the host, passes them here, and
// advances the generator past both calls afterwards. Block (x, y) is
// block x of piece y; it draws r1 and r2 of the same entries from two
// Philox states, so both streams come from one thread and one launch.
//
// Its bound on an H100 is the 8 B an entry it writes (2.36 ms at
// 3.35 TB/s for StarCoder2-15B's 987.8 M entries). The grid-stride
// order is fixed by the bits it must reproduce; its stores are
// coalesced (a warp writes 32 adjacent floats of each slab). Measured
// (H100 80GB HBM3, 700 W): 3.77 ms at 987.8 M entries, 62.6 % of the
// byte bound, against 24.02 ms for the plain version; neither 8 blocks
// an SM (32 registers, spilling) nor splitting each thread's steps
// across blocks was faster. What holds it above the bound is not
// measured (the two Philox blocks and four precise logf per four
// entries are a guess no profile backs).
//
// Numerics: curand's own curand_init / curand_uniform4 (the functions
// torch calls), the transforms in torch's f32 roundings with explicit
// intrinsics (the multiply and the subtract each rounded; no
// contraction), precise logf (no fast math).

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // torch's block_size_bound
constexpr int kUnroll = 4;      // a float4 from each curand_uniform4
constexpr int kMaxPieces = 16;

struct Piece {
  long long start;                 // first entry of the piece in the slab
  long long n;                     // its entries
  unsigned long long off_u, off_e; // Philox offsets of its r1 and r2
  int grid;                        // the blocks torch's launch takes
};

struct Args {
  Piece p[kMaxPieces];
  unsigned long long seed;
  float two_b, b, e_floor;
  float* u;
  float* e;
  long long total, pad;
};

// torch's uniform transform: rand * 1 + 0, then 1 -> 0.
__device__ __forceinline__ float uniform01(float r) {
  return r == 1.0f ? 0.0f : r;
}

__global__ void __launch_bounds__(kThreads)
    cms_draws_kernel(const __grid_constant__ Args a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.y == 0) {
    for (long long i = t; i < a.pad; i += (long long)gridDim.x * kThreads) {
      a.u[a.total + i] = 0.0f;
      a.e[a.total + i] = 1.0f;
    }
  }
  const Piece& pc = a.p[blockIdx.y];
  if ((int)blockIdx.x >= pc.grid) return;
  const long long stride = (long long)pc.grid * kThreads;
  const long long step = stride * kUnroll;
  const long long rounded = ((pc.n - 1) / step + 1) * step;
  float* up = a.u + pc.start;
  float* ep = a.e + pc.start;
  curandStatePhilox4_32_10_t s1, s2;
  curand_init(a.seed, t, pc.off_u, &s1);
  curand_init(a.seed, t, pc.off_e, &s2);
  for (long long li = t; li < rounded; li += step) {
    const float4 r1 = curand_uniform4(&s1);
    const float4 r2 = curand_uniform4(&s2);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = li + stride * k;
      if (j < pc.n) {
        const float x1 = uniform01((&r1.x)[k]);
        const float x2 = uniform01((&r2.x)[k]);
        up[j] = __fsub_rn(__fmul_rn(x1, a.two_b), a.b);
        ep[j] = fmaxf(-logf(fmaxf(x2, FLT_MIN)), a.e_floor);
      }
    }
  }
}

}  // namespace

extern "C" int repro_cms_draws(
    int count, const long long* starts, const long long* ns,
    const int* grids, const unsigned long long* off_u,
    const unsigned long long* off_e, unsigned long long seed, float two_b,
    float b, float e_floor, void* u, void* e, long long total,
    long long padded, void* stream) {
  if (count < 1 || count > kMaxPieces || total < 1 || padded < total)
    return (int)cudaErrorInvalidValue;
  Args a{};
  int gx = 1;
  for (int i = 0; i < count; ++i) {
    if (ns[i] < 1 || grids[i] < 1) return (int)cudaErrorInvalidValue;
    a.p[i] = Piece{starts[i], ns[i], off_u[i], off_e[i], grids[i]};
    gx = grids[i] > gx ? grids[i] : gx;
  }
  a.seed = seed;
  a.two_b = two_b;
  a.b = b;
  a.e_floor = e_floor;
  a.u = static_cast<float*>(u);
  a.e = static_cast<float*>(e);
  a.total = total;
  a.pad = padded - total;
  cms_draws_kernel<<<dim3(gx, count), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

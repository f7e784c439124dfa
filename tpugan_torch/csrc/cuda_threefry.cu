// The train step's random draws, made on the card: JAX's threefry-2x32
// bernoulli, randint and normal, as sample/threefry.py computes them on
// the host (jax_threefry_partitionable=True).
//
// Replaces: no TPU kernel.  The JAX step draws inside its jitted step on
// the device; the port drew in numpy on the host and copied each draw to
// the card with a blocking copy from pageable memory, which drained the
// card's queue every step.  Here each draw is one launch that writes into
// a tensor of the caller's, on the caller's stream: nothing is copied and
// the host never waits.
//
// What bounds it on an H100: nothing the step notices.  A draw is at most
// ~10^5 elements (the 1024 x 100 latents), each one 20-round hash (three
// for randint) and, for normal, a float32 polynomial and a double log1p;
// chip_smoke.py's phase 2 times each of the step's three draws on the card.
//
// What the design does about it: one thread per element (a grid-stride
// loop past 4,096 blocks), the key's two words as launch arguments, so no
// key tensor is copied either.  An element's bits: the hash of its flat
// index as a 64-bit count, the halves xor-ed (threefry.random_bits).
// randint takes the two keys of split(key, 2) in each thread.  The float
// arithmetic is written with round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, ...), so no fused multiply-add rounds otherwise than numpy
// does; the constants are given by their bits.  randint and bernoulli
// draws are threefry.py's bits.  normal takes log1p in double, rounded
// once to float32, where numpy's float32 log1p may be off by an ulp (SIMD
// builds), which the erf_inv polynomial carries to at most 3 ulps of the
// result.  JAX's own normal on the CPU is no closer: XLA takes its own
// float32 log1p there and fuses the polynomial's multiply-adds, and lies
// within 3 ulps of both.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32 (20 rounds) of the count (x0, x1) under the key (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  const uint2 h = threefry2x32(k0, k1, static_cast<uint32_t>(i >> 32),
                               static_cast<uint32_t>(i));
  return h.x ^ h.y;
}

// threefry.uniform on [lo, hi): the top 23 bits as a float in [1, 2),
// minus 1, scaled, shifted, and kept at lo or above.
__device__ __forceinline__ float uniform_of(uint32_t bits, float lo,
                                            float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo));
}

// XLA's float32 erf_inv (threefry._erfinv): a degree-8 polynomial in
// w = -log1p(-x^2), shifted, split at w = 5.
__constant__ uint32_t kErfinvLt5[9] = {
    0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
    0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
__constant__ uint32_t kErfinvGe5[9] = {
    0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
    0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};

__device__ __forceinline__ float erfinv(float x) {
  const float w = -__double2float_rn(log1p(
      static_cast<double>(__fmul_rn(-x, x))));
  const bool lt = w < 5.0f;
  const float s = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = __uint_as_float(lt ? kErfinvLt5[0] : kErfinvGe5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(__uint_as_float(lt ? kErfinvLt5[i] : kErfinvGe5[i]),
                  __fmul_rn(p, s));
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : __fmul_rn(p, x);
}

struct Bernoulli {
  uint32_t k0, k1;
  float p;
  __device__ bool operator()(unsigned long long i) const {
    return uniform_of(bits_at(k0, k1, i), 0.0f, 1.0f) < p;
  }
};

// threefry.randint: the bits of both keys of split(key, 2), reduced modulo
// the span in uint32 arithmetic that wraps as numpy's does, then minval +
// offset wrapped to int32 and widened.
struct Randint {
  uint32_t k0, k1, span;
  long long minval;
  __device__ long long operator()(unsigned long long i) const {
    const uint2 ka = threefry2x32(k0, k1, 0u, 0u);
    const uint2 kb = threefry2x32(k0, k1, 0u, 1u);
    const uint32_t hi = bits_at(ka.x, ka.y, i), lo = bits_at(kb.x, kb.y, i);
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;
    const uint32_t off = ((hi % span) * mult + lo % span) % span;
    return static_cast<int32_t>(
        static_cast<uint32_t>(minval + static_cast<long long>(off)));
  }
};

// threefry.normal: sqrt(2) * erf_inv(U(nextafter(-1, 0), 1)).
struct Normal {
  uint32_t k0, k1;
  __device__ float operator()(unsigned long long i) const {
    const float u = uniform_of(bits_at(k0, k1, i), __uint_as_float(0xBF7FFFFFu),
                               1.0f);
    return __fmul_rn(__uint_as_float(0x3FB504F3u), erfinv(u));
  }
};

template <class Draw, class T>
__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(Draw draw, T* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = draw(static_cast<unsigned long long>(i));
}

template <class Draw, class T>
int launch(Draw draw, void* out, long long n, void* stream) {
  if (n < 0 || (n > 0 && out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  threefry_draw_kernel<<<static_cast<unsigned>(
                             blocks < kMaxBlocks ? blocks : kMaxBlocks),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      draw, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point fills n elements of out (contiguous, on the card) with
// the draw of key (k0, k1) at flat indices 0 .. n-1, on `stream`; returns
// the launch's CUDA error (0: launched).

// bool, uniform < p (threefry.bernoulli).
extern "C" int tg_threefry_bernoulli(uint32_t k0, uint32_t k1, long long n,
                                     float p, void* out, void* stream) {
  return launch<Bernoulli, bool>(Bernoulli{k0, k1, p}, out, n, stream);
}

// int64 in [minval, minval + span) (threefry.randint, span >= 1).
extern "C" int tg_threefry_randint(uint32_t k0, uint32_t k1, long long n,
                                   long long minval, uint32_t span, void* out,
                                   void* stream) {
  if (span == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Randint, long long>(Randint{k0, k1, span, minval}, out, n,
                                    stream);
}

// float32 standard normal (threefry.normal).
extern "C" int tg_threefry_normal(uint32_t k0, uint32_t k1, long long n,
                                  void* out, void* stream) {
  return launch<Normal, float>(Normal{k0, k1}, out, n, stream);
}

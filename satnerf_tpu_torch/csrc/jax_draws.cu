// JAX's training draws on Hopper: jax.random's bits, uniform, randint and
// normal, to the bit, over a counter range under a key given as scalars.
//
// Replaces no Pallas kernel. The JAX package draws its training randomness
// with jax.random inside its jitted step (satnerf_tpu/train/system.py:
// 665-730, render/sampling.py:31, :96, render/render.py:82), which XLA
// lowers to threefry on the device. The port draws the same numbers
// (utils/jax_prng.py in numpy is the plain version), so that a run of the
// port and a run of the JAX package see the same rays and depths at every
// step. Done as torch integer ops on the device, the twenty threefry rounds
// over a step's 65,536 depth draws would be some hundred launches; here a
// draw is one launch.
//
//   bits     jax.random.bits(key, (n,), uint32): threefry-2x32 of the
//            64-bit counter i (high word, low word) under the key, the two
//            output words XORed (JAX's partitionable threefry, its default)
//   uniform  jax.random.uniform(key, (n,), float32, lo, lo + scale): the
//            top 23 bits as the mantissa of a float in [1, 2), minus one,
//            times scale plus lo in one rounding (XLA's CPU code fuses it),
//            at least lo
//   randint  jax.random.randint(key, (n,), minval, maxval) for int32:
//            words h and l from the two keys of split(key) (the hash of
//            counters 0 and 1 under the key, both words kept; two threads
//            of each block make them into shared memory), ((h % span) *
//            mult + l % span) % span in uint32 (the sum wraps), plus minval
//            in int32; written as int64, the type torch indexes with
//   normal   jax.random.normal(key, (n,), float32): sqrt(2) * erf_inv(u)
//            with u uniform in (-1, 1), through XLA's float32 erf_inv and
//            its CPU log1p and log polynomials
//
// Rounding: nvcc contracts a * b + c into one fma by default, so every
// float operation here is an explicit intrinsic: __fmaf_rn exactly where
// utils/jax_prng.py fuses (fma32), __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn everywhere else. The constants are the float32
// values jax_prng.py rounds its decimal constants to, written as hex.
//
// What bounds it: the instructions of threefry (at least 68 a 32-bit word:
// twenty rounds of an add, a rotate and an xor, the counter's add and the
// key injections into x1 that no three-input add absorbs, the final xor),
// 4 or 8 bytes written a draw. At 65,536 x 64 uniforms that is 4.2 M words,
// 0.29 G instructions against 16.8 MB written: the SMs' issue rate (four
// warp instructions a clock an SM), not memory, is the bound. A thread a
// draw, a grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { BITS = 0, UNIFORM = 1, RANDINT = 2, NORMAL = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// threefry-2x32, 20 rounds, of the counter (hi, lo) of i: both words
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
#define SATNERF_TF_ROUND(r) \
  x0 += x1;                 \
  x1 = rotl(x1, r) ^ x0;
#define SATNERF_TF_EVEN \
  SATNERF_TF_ROUND(13) SATNERF_TF_ROUND(15) SATNERF_TF_ROUND(26) SATNERF_TF_ROUND(6)
#define SATNERF_TF_ODD \
  SATNERF_TF_ROUND(17) SATNERF_TF_ROUND(29) SATNERF_TF_ROUND(16) SATNERF_TF_ROUND(24)
  SATNERF_TF_EVEN x0 += k1; x1 += k2 + 1u;
  SATNERF_TF_ODD  x0 += k2; x1 += k0 + 2u;
  SATNERF_TF_EVEN x0 += k0; x1 += k1 + 3u;
  SATNERF_TF_ODD  x0 += k1; x1 += k2 + 4u;
  SATNERF_TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef SATNERF_TF_EVEN
#undef SATNERF_TF_ODD
#undef SATNERF_TF_ROUND
  return make_uint2(x0, x1);
}

// jax.random.bits' word of counter i: the two words of the hash XORed
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint2 x = threefry(k0, k1, i);
  return x.x ^ x.y;
}

__device__ __forceinline__ float uniform_from_bits(uint32_t b, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, scale, lo));
}

// XLA's CPU float32 log (Cephes' logf) for x > 0 (jax_prng._xla_log)
__device__ __forceinline__ float xla_log(float x) {
  x = fmaxf(__uint_as_float(0x00800000u), x);
  const uint32_t bits = __float_as_uint(x);
  float e = __fadd_rn(1.0f, static_cast<float>(static_cast<int>(bits >> 23) - 0x7F));
  float m = __uint_as_float((bits & 0x807FFFFFu) | 0x3F000000u);
  const bool small = m < 0x1.6a09e6p-1f;
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float m2 = __fmul_rn(m, m);
  const float m3 = __fmul_rn(m2, m);
  float y = __fmaf_rn(__fmaf_rn(m, 0x1.204376p-4f, -0x1.d7a370p-4f), m, 0x1.de4a34p-4f);
  const float y1 = __fmaf_rn(__fmaf_rn(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), m, -0x1.555ca0p-3f);
  const float y2 = __fmaf_rn(__fmaf_rn(m, 0x1.999d58p-3f, -0x1.fffff8p-3f), m, 0x1.555554p-2f);
  y = __fmaf_rn(__fmaf_rn(y, m3, y1), m3, y2);
  y = __fmaf_rn(y, m3, __fmul_rn(-0x1.bd0106p-13f, e));
  return __fadd_rn(__fadd_rn(__fsub_rn(m, __fmul_rn(0.5f, m2)), y),
                   __fmul_rn(0x1.63p-1f, e));
}

// XLA's float32 log1p for x > -1 (jax_prng._xla_log1p)
__device__ __forceinline__ float xla_log1p(float x) {
  constexpr float num[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f, 0x1.de9738p+4f,
                            0x1.e798ecp+5f,  0x1.c8e75ap+5f, 0x1.40a202p+4f};
  constexpr float den[7] = {0x1.0p+0f,      0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                            0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  float pn = 0.0f, pd = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pn = __fmaf_rn(pn, x, num[i]);
    pd = __fmaf_rn(pd, x, den[i]);
  }
  const float x2 = __fmul_rn(x, x);
  const float r = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(pn, pd));
  const float near = __fadd_rn(x, __fadd_rn(__fmul_rn(-0.5f, x2), r));
  return fabsf(x) < 0x1.a8279ap-2f ? near : xla_log(__fadd_rn(x, 1.0f));
}

// XLA's float32 erf_inv, Giles' polynomials (jax_prng.erf_inv)
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float lt5[9] = {0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                            -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a810p-10f,
                            -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  constexpr float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                            -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
                            0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float w = -xla_log1p(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

template <int MODE>
__global__ void jax_draws_kernel(uint32_t ka0, uint32_t ka1, long long n, float lo,
                                 float scale, uint32_t span, uint32_t mult, int minval,
                                 void* out) {
  // randint draws from the two keys of split(key): counters 0 and 1
  __shared__ uint2 split[2];
  if constexpr (MODE == RANDINT) {
    if (threadIdx.x < 2) split[threadIdx.x] = threefry(ka0, ka1, threadIdx.x);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t c = static_cast<uint64_t>(i);
    if constexpr (MODE == BITS) {
      static_cast<uint32_t*>(out)[i] = threefry_bits(ka0, ka1, c);
    } else if constexpr (MODE == UNIFORM) {
      static_cast<float*>(out)[i] = uniform_from_bits(threefry_bits(ka0, ka1, c), lo, scale);
    } else if constexpr (MODE == RANDINT) {
      const uint32_t h = threefry_bits(split[0].x, split[0].y, c);
      const uint32_t l = threefry_bits(split[1].x, split[1].y, c);
      const uint32_t off = ((h % span) * mult + l % span) % span;
      static_cast<long long*>(out)[i] =
          static_cast<int32_t>(static_cast<uint32_t>(minval) + off);
    } else {
      const float u = uniform_from_bits(threefry_bits(ka0, ka1, c), lo, scale);
      static_cast<float*>(out)[i] = __fmul_rn(0x1.6a09e6p+0f, xla_erf_inv(u));
    }
  }
}

constexpr int DRAW_THREADS = 256;

template <int MODE>
int launch(uint32_t ka0, uint32_t ka1, long long n, float lo, float scale, uint32_t span,
           uint32_t mult, int minval, void* out, cudaStream_t st) {
  // enough blocks to fill 132 SMs several times over; the loop takes the rest
  const long long want = (n + DRAW_THREADS - 1) / DRAW_THREADS;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  jax_draws_kernel<MODE><<<blocks, DRAW_THREADS, 0, st>>>(ka0, ka1, n, lo, scale, span, mult,
                                                          minval, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 bits (uint32 out), 1 uniform (float), 2 randint (int64), 3 normal
// (float). (ka0, ka1) the key; uniform and normal: lo and scale (= hi - lo
// in float32); randint: span, mult, minval.
extern "C" int satnerf_jax_draws(int mode, unsigned ka0, unsigned ka1, long long n, float lo,
                                 float scale, unsigned span, unsigned mult, int minval,
                                 void* out, void* stream) {
  if (n < 0 || (mode == RANDINT && span == 0)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case BITS:
      return launch<BITS>(ka0, ka1, n, lo, scale, span, mult, minval, out, st);
    case UNIFORM:
      return launch<UNIFORM>(ka0, ka1, n, lo, scale, span, mult, minval, out, st);
    case RANDINT:
      return launch<RANDINT>(ka0, ka1, n, lo, scale, span, mult, minval, out, st);
    case NORMAL:
      return launch<NORMAL>(ka0, ka1, n, lo, scale, span, mult, minval, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

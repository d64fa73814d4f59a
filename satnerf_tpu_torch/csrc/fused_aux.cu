// Solar-correction pass for the SIREN variants (s-nerf, sat-nerf) on Hopper.
//
// Replaces the per-ray stage of the TPU kernel fused_sc_loss_grads
// (satnerf_tpu/ops/pallas/fused_mlp.py:1719, kernel body
// _make_sc_loss_bwd_kernel :1638). That kernel evaluates the field along the
// SUN rays (the march direction is the sun direction), composites forward
// with transparency and weights carrying no gradient, forms terms 2 and 3 of
// the S-NeRF loss and runs their adjoint, which reaches the weights through
// the sun-visibility head only. Here the field forward and backward are the
// dense launches of the training chain (siren_dense, siren_dense_dgrad,
// siren_dense_wgrad; ops/fused_mlp.py _sc_staged) and this file holds what
// is left between them:
//
//   sc_loss_bwd   a warp per ray, one walk over its S samples in order:
//                 sigma = softplus(h . w_sigma + b), sun_v = sigmoid(s2 .
//                 w_sun + b), alpha = 1 - exp(-delta * relu(sigma + noise)),
//                 T_i = prod_{k<i} (1 - alpha_k + 1e-10), w = alpha * T;
//                 sums[0] += sum_s (T - sun_v)^2, sums[1] += 1 - sum_s w *
//                 sun_v; the cotangent of sun_v is scale * (-2 (T - sun_v) -
//                 w) with scale = lambda / 3 / R (fused_mlp.py:1703-1705),
//                 taken through the sigmoid, rounded to the compute type and
//                 multiplied into d_s2 (P, Fh), dWn row 4 and dbn[4].
//
// T and w are data here, so no suffix sum is needed and the forward and the
// adjoint share one pass. Sigma gets no gradient: d_h of this stage is zero
// and no other narrow row moves. The TPU kernel forms T as exp(sum log(1 -
// alpha + 1e-10)); this one takes the product directly, as heads_composite
// and render/composite.py do.
//
// Bound by device memory: it reads h (F values a sample) and s2 (Fh) once and
// writes d_s2 in fp32. The sums over rays meet by fp32 atomicAdd into buffers
// the wrapper zeroes, so the last bits change from run to run. Rays past R
// are masked by the warp's early exit: nothing is padded, and the
// normalisation uses the true R.

#include "common.cuh"

namespace {

constexpr int SC_WARPS = 4;
constexpr int SC_MAX_FH = 256;  // widest sun_v hidden layer the register rows hold
constexpr int SC_H_REGS = SC_MAX_FH / 32;

template <typename T>
__global__ void __launch_bounds__(SC_WARPS * 32)
sc_loss_bwd_kernel(const T* __restrict__ h, int F, const T* __restrict__ s2, int Fh,
                   const T* __restrict__ Wn, const float* __restrict__ bn,
                   const float* __restrict__ z, const float* __restrict__ noise, int R, int S,
                   float scale, float* __restrict__ sums, float* __restrict__ d_s2,
                   float* __restrict__ dWn, float* __restrict__ dbn) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * SC_WARPS + threadIdx.x / 32;
  if (ray >= R) return;  // the whole warp leaves together

  const T* w_sig = Wn;
  const T* w_sun = Wn + (size_t)4 * F;
  float wsun[SC_H_REGS], a_sun[SC_H_REGS];
#pragma unroll
  for (int i = 0; i < SC_H_REGS; ++i) {
    const int k = lane + 32 * i;
    wsun[i] = k < Fh ? to_f32<T>(w_sun[k]) : 0.f;
    a_sun[i] = 0.f;
  }

  const float* zr = z + (size_t)ray * S;
  float trans = 1.f, term2 = 0.f, wsum = 0.f, b_acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t q = (size_t)ray * S + s;
    float sig = 0.f, sn = 0.f, sv[SC_H_REGS];
    const T* hq = h + q * F;
    for (int k = lane; k < F; k += 32) sig = fmaf(to_f32<T>(hq[k]), to_f32<T>(w_sig[k]), sig);
    const T* sq = s2 + q * Fh;
#pragma unroll
    for (int i = 0; i < SC_H_REGS; ++i) {
      const int k = lane + 32 * i;
      sv[i] = k < Fh ? to_f32<T>(sq[k]) : 0.f;
      sn = fmaf(sv[i], wsun[i], sn);
    }
    const float sigma = softplusf(warp_sum(sig) + bn[0]);
    const float sunv = sigmoidf(warp_sum(sn) + bn[4]);

    const float delta = s < S - 1 ? zr[s + 1] - zr[s] : 1e10f;
    const float sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    const float alpha = 1.f - expf(-delta * fmaxf(sigma_n, 0.f));
    const float w = alpha * trans;
    const float diff = trans - sunv;
    term2 += diff * diff;
    wsum += w * sunv;
    trans *= 1.f - alpha + 1e-10f;

    const float g_pre = scale * (-2.f * diff - w) * sunv * (1.f - sunv);
    b_acc += g_pre;
    const float gb = round_to<T>(g_pre);
#pragma unroll
    for (int i = 0; i < SC_H_REGS; ++i) {
      const int k = lane + 32 * i;
      if (k < Fh) {
        a_sun[i] = fmaf(gb, sv[i], a_sun[i]);
        d_s2[q * Fh + k] = gb * wsun[i];
      }
    }
  }

  if (lane == 0) {
    atomicAdd(sums + 0, term2);
    atomicAdd(sums + 1, 1.f - wsum);
    atomicAdd(dbn + 4, b_acc);
  }
#pragma unroll
  for (int i = 0; i < SC_H_REGS; ++i) {
    const int k = lane + 32 * i;
    if (k < Fh) atomicAdd(dWn + (size_t)4 * F + k, a_sun[i]);
  }
}

}  // namespace

// Returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.
extern "C" int satnerf_sc_loss_bwd(int dtype, const void* h, int F, const void* s2, int Fh,
                                   const void* Wn, const void* bn, const void* z,
                                   const void* noise, int R, int S, float scale, void* sums,
                                   void* d_s2, void* dWn, void* dbn, void* stream) {
  if (Fh > SC_MAX_FH || Fh > F || S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int grid = (R + SC_WARPS - 1) / SC_WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    sc_loss_bwd_kernel<float><<<grid, SC_WARPS * 32, 0, st>>>(
        f(h), F, f(s2), Fh, f(Wn), f(bn), f(z), f(noise), R, S, scale, o(sums), o(d_s2), o(dWn),
        o(dbn));
  } else if (dtype == 1) {
    auto b = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
    sc_loss_bwd_kernel<__nv_bfloat16><<<grid, SC_WARPS * 32, 0, st>>>(
        b(h), F, b(s2), Fh, b(Wn), f(bn), f(z), f(noise), R, S, scale, o(sums), o(d_s2), o(dWn),
        o(dbn));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

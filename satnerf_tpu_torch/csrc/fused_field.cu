// Per-sample field outputs for the SIREN variants (s-nerf, sat-nerf) on Hopper.
//
// Replaces, of the TPU kernels fused_field_apply_rays (satnerf_tpu/ops/pallas/
// fused_mlp.py:1152, bodies _make_fwd_kernel_rays :635 and
// _make_bwd_kernel_rays :657) and fused_field_apply (:799, bodies
// _make_fwd_kernel :356 and _make_bwd_kernel :526), what lies between the
// dense layers: the five narrow heads with their activations (_heads_fwd
// :311-353) and their backward from a per-sample cotangent (narrow_bwd and
// the head part of _point_bwd_from_saves :432-502). Those kernels return the
// field's outputs for every sample, uncomposited, and take a cotangent for
// every sample; the compositor stays outside, in plain tensor code. The TPU
// kernels hold all weights in VMEM and run trunk, heads and backward in one
// launch; here the wide layers are the siren_dense / siren_dense_dgrad /
// siren_dense_wgrad launches of the other sources (ops/fused_mlp.py
// _chain_forward, _chain_backward) and this file holds:
//
//   field_heads      out[q] = [rgb 0:3 | sigma 3 | sun_v 4 | sky 5:8 | beta 8]
//                    of sample q: sigma = softplus(h . w0 + b0), rgb =
//                    sigmoid(r . w1:4 + b) * (1 + 2 pad) - pad, sun_v =
//                    sigmoid(s2 . w4 + b4), sky = sigmoid(skyh[ray] . w5:8 + b),
//                    beta = softplus(bh . w8 + b8). Sigma comes out before
//                    noise and relu: those belong to the compositor.
//   field_heads_bwd  from the same operands and g (P, 16) fp32: the narrow
//                    pre-activation cotangents, each rounded to the compute
//                    type before both of its products; dWn (9, F) and dbn (9,)
//                    summed over all points; d_h (the sigma head's share),
//                    d_r, d_s2, d_bh (P, .) in fp32. A second small kernel
//                    does the sky head once a ray: the ray's sky cotangent is
//                    the sum over its samples, taken before sky_1's backward
//                    and before rounding; d_skyh comes out masked by relu.
//
// The points are independent (no compositor, no walk along the ray).
// field_heads streams them, a warp a point with 16-byte loads and the
// weights in shared memory (its note below). The backward takes one point a warp at a
// time as warp-reduced dot products, a block of eight warps walking 128
// points; each lane keeps its columns of the narrow weights and of the dWn
// rows in registers over its points; the block's dWn and dbn meet in shared
// memory and leave as one fp32 atomicAdd per entry and block into buffers
// the wrapper zeroes, so the order of addition, and with it the last bits,
// changes from run to run.
//
// softplus' is formed as -expm1f(-softplus): where sigma is below 1e-8,
// 1.f - expf(-sigma) is 0 and the sample would lose its gradient.
//
// Bound by device memory: per point the forward reads h (F values) and three
// (Fh) activations and writes 64 bytes (2.6 KB a point at 8 x 512 in bf16:
// 0.103 ms for 1,024 rays x 128 points at 3.35 TB/s; the warp-a-point body
// it replaced, 156 registers a thread and one block an SM, took 0.418, PERF.md);
// the backward reads the same and writes F + 3 Fh floats of cotangents.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FLD_WARPS = 8;
constexpr int FLD_PTS = 16;  // points a warp walks
constexpr int FLD_MAX_F = 512;
constexpr int FLD_F_REGS = FLD_MAX_F / 32;
constexpr int FLD_H_REGS = FLD_F_REGS / 2;
constexpr int FLD_COLS = 16;    // rgb 0:3 | sigma 3 | sun_v 4 | sky 5:8 | beta 8
constexpr int SKY_RAYS = 4;     // rays a warp of the sky kernel walks

// The lane's columns lane, lane + 32, ... of a row of n values; 0 past n.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int n, int lane,
                                         float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int k = lane + 32 * i;
    v[i] = k < n ? to_f32<T>(x[k]) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ float dot_row(const float (&a)[N], const float (&b)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = fmaf(a[i], b[i], s);
  return warp_sum(s);
}

// sky = sigmoid(skyh[ray] . w_sky + b), the warp's lanes all hold the result.
template <typename T>
__device__ __forceinline__ void sky_forward(const T* __restrict__ x, int Fh, int lane,
                                            const float (&w_sky)[3][FLD_H_REGS],
                                            const float* __restrict__ bn,
                                            float (&xv)[FLD_H_REGS], float (&sky)[3]) {
  load_row<T>(x, Fh, lane, xv);
#pragma unroll
  for (int c = 0; c < 3; ++c) sky[c] = sigmoidf(dot_row(xv, w_sky[c]) + bn[5 + c]);
}

// ---------------------------------------------------------------- field_heads
//
// A streaming kernel: the points are independent and the work a point is
// small (3,584 flops at F = 512) beside its bytes (h, r, s2, bh: 2.5 KB in
// bf16, 64 B written), so it is bound by how many bytes are in flight. A
// block of FH_THREADS takes FH_BLOCK_POINTS neighbouring points, a warp
// FH_POINTS of them one after another: its lanes read 16 bytes at a time of
// each of the point's rows (a whole row per load instruction where it is 512
// bytes, neighbouring lanes on neighbouring addresses), all five loads of a
// lane issued before any product and kept as raw 16-byte chunks, 20
// registers; the six dot products are then reduced by shuffles. The nine
// narrow weight rows sit in shared memory in the compute type (F + 8 Fh
// values, 5 KB at F = 512 in bf16), loaded once a block and read as one
// 16-byte chunk a lane, lanes on neighbouring chunks: no weight stays in
// registers, and at 64 registers a thread four blocks (32 warps, 80 KB of
// rows in flight) fit an SM. A warp a point rather than a smaller group of
// lanes, or a tile staged by cp.async: a point's rows are already whole
// 16-byte chunks a lane, and a smaller group would hold twice the chunks a
// lane, past the 64 registers. Before the points the block's warps form sky
// for each ray its points belong to, once a ray (every point with S = 1,
// K6), into shared memory. Lane l < 16 writes column l of the point's 16:
// its 64 bytes in one coalesced store.
constexpr int FH_THREADS = 256;
constexpr int FH_WARPS = FH_THREADS / 32;
constexpr int FH_POINTS = 16;                          // points a warp takes, one at a time
constexpr int FH_BLOCK_POINTS = FH_WARPS * FH_POINTS;  // 128
// a lane's 16-byte chunks of h and of each Fh row in one pass: the 8 x 512
// field's rows in one pass in bf16, in two in fp32
constexpr int FH_CF = FLD_MAX_F / (32 * 8), FH_CH = FH_CF / 2;

// The dynamic shared memory of a block, in bytes: the weight rows in the
// compute type (each padded to a multiple of 8 values), then sky of each ray
// of the block's points and the nine biases as floats.
__host__ __device__ constexpr int fh_smem_bytes(int F, int Fh, int elem_bytes) {
  return ((F + 7) / 8 * 8 + 8 * ((Fh + 7) / 8 * 8)) * elem_bytes +
         (3 * FH_BLOCK_POINTS + 12) * 4;
}

// acc + the dot product of a raw chunk with its weights, a chunk of the
// compute type in shared memory
template <typename T>
__device__ __forceinline__ float chunk_dot(const uint4& raw, const T* w, float acc) {
  constexpr int V = Vec16<T>::N;
  float x[V], wv[V];
  chunk_values<T>(raw, x);
  chunk_values<T>(*reinterpret_cast<const uint4*>(w), wv);
#pragma unroll
  for (int i = 0; i < V; ++i) acc = fmaf(x[i], wv[i], acc);
  return acc;
}

// Registers for 4 blocks an SM (at most 64 a thread).
template <typename T>
__global__ void __launch_bounds__(FH_THREADS, 4)
field_heads_stream(const T* __restrict__ h, int F, const T* __restrict__ rf,
                   const T* __restrict__ s2, const T* __restrict__ bh,
                   const T* __restrict__ skyh, int Fh, const T* __restrict__ Wn,
                   const float* __restrict__ bn, int P, int S, float rgb_padding, int vec,
                   float* __restrict__ out) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char fh_smem[];
  const int Fp = (F + 7) / 8 * 8, Fhp = (Fh + 7) / 8 * 8;
  T* ws = reinterpret_cast<T*>(fh_smem);  // sigma (Fp) | rgb x3, sun_v, sky x3, beta (Fhp each)
  T* wh = ws + Fp;
  float* sky_s = reinterpret_cast<float*>(ws + Fp + 8 * Fhp);  // 3 a ray
  float* bs = sky_s + 3 * FH_BLOCK_POINTS;                      // 9 biases
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const bool use_beta = bh != nullptr;
  const long long qb = (long long)blockIdx.x * FH_BLOCK_POINTS;
  const long long q_end = qb + FH_BLOCK_POINTS < P ? qb + FH_BLOCK_POINTS : P;
  const long long r0 = qb / S;
  const int n_rays = (int)((q_end - 1) / S - r0 + 1);

  for (int i = tid; i < Fp; i += FH_THREADS) ws[i] = i < F ? Wn[i] : from_f32<T>(0.f);
  for (int i = tid; i < 8 * Fhp; i += FH_THREADS) {
    const int row = 1 + i / Fhp, k = i % Fhp;
    wh[i] = k < Fh && (row != 8 || use_beta) ? Wn[(size_t)row * F + k] : from_f32<T>(0.f);
  }
  if (tid < 9) bs[tid] = bn[tid];
  __syncthreads();

  // ---- sky, once a ray of the block's points: a warp a ray
  for (int i = warp; i < n_rays; i += FH_WARPS) {
    const T* x = skyh + (size_t)(r0 + i) * Fh;
    float part[3] = {0.f, 0.f, 0.f};
    for (int kb = 0; kb < Fh; kb += 32 * V * FH_CH) {
      uint4 xr[FH_CH];
#pragma unroll
      for (int ci = 0; ci < FH_CH; ++ci) {
        const int k = kb + (lane + 32 * ci) * V;
        if (k < Fh) xr[ci] = row_chunk_raw<T>(x, k, Fh, vec);
      }
#pragma unroll
      for (int ci = 0; ci < FH_CH; ++ci) {
        const int k = kb + (lane + 32 * ci) * V;
        if (k >= Fh) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) part[c] = chunk_dot<T>(xr[ci], wh + (4 + c) * Fhp + k, part[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) part[c] = warp_sum(part[c]);
    if (lane < 3) {
      const float v = lane == 0 ? part[0] : (lane == 1 ? part[1] : part[2]);
      sky_s[3 * i + lane] = sigmoidf(v + bs[5 + lane]);
    }
  }
  __syncthreads();

  // ---- the points: a warp a point, FH_POINTS in turn
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int passes = max((F + 32 * V * FH_CF - 1) / (32 * V * FH_CF),
                         (Fh + 32 * V * FH_CH - 1) / (32 * V * FH_CH));
  for (int it = 0; it < FH_POINTS; ++it) {
    const long long q = qb + warp + (long long)FH_WARPS * it;
    if (q >= P) break;  // the whole warp leaves together
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // sigma, rgb x3, sun_v, beta
    for (int pass = 0; pass < passes; ++pass) {
      uint4 xh[FH_CF], xr[FH_CH], xs[FH_CH], xb[FH_CH];  // raw until the products
#pragma unroll
      for (int ci = 0; ci < FH_CF; ++ci) {
        const int k = (pass * 32 * FH_CF + lane + 32 * ci) * V;
        if (k < F) xh[ci] = row_chunk_raw<T>(h + (size_t)q * F, k, F, vec);
      }
#pragma unroll
      for (int ci = 0; ci < FH_CH; ++ci) {
        const int k = (pass * 32 * FH_CH + lane + 32 * ci) * V;
        if (k < Fh) {
          xr[ci] = row_chunk_raw<T>(rf + (size_t)q * Fh, k, Fh, vec);
          xs[ci] = row_chunk_raw<T>(s2 + (size_t)q * Fh, k, Fh, vec);
          if (use_beta) xb[ci] = row_chunk_raw<T>(bh + (size_t)q * Fh, k, Fh, vec);
        }
      }
#pragma unroll
      for (int ci = 0; ci < FH_CF; ++ci) {
        const int k = (pass * 32 * FH_CF + lane + 32 * ci) * V;
        if (k < F) part[0] = chunk_dot<T>(xh[ci], ws + k, part[0]);
      }
#pragma unroll
      for (int ci = 0; ci < FH_CH; ++ci) {
        const int k = (pass * 32 * FH_CH + lane + 32 * ci) * V;
        if (k >= Fh) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          part[1 + c] = chunk_dot<T>(xr[ci], wh + c * Fhp + k, part[1 + c]);
        part[4] = chunk_dot<T>(xs[ci], wh + 3 * Fhp + k, part[4]);
        if (use_beta) part[5] = chunk_dot<T>(xb[ci], wh + 7 * Fhp + k, part[5]);
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) part[i] = warp_sum(part[i]);
    float v = 0.f;  // column `lane` of the point's 16
    if (lane < 3) {
      const float pre = lane == 0 ? part[1] : (lane == 1 ? part[2] : part[3]);
      v = sigmoidf(pre + bs[1 + lane]) * pad2 - rgb_padding;
    } else if (lane == 3) {
      v = softplusf(part[0] + bs[0]);
    } else if (lane == 4) {
      v = sigmoidf(part[4] + bs[4]);
    } else if (lane < 8) {
      v = sky_s[3 * (int)(q / S - r0) + lane - 5];
    } else if (lane == 8 && use_beta) {
      v = softplusf(part[5] + bs[8]);
    }
    if (lane < FLD_COLS) out[(size_t)q * FLD_COLS + lane] = v;
  }
}

// ------------------------------------------------------------ field_heads_bwd

template <typename T>
__global__ void __launch_bounds__(FLD_WARPS * 32)
field_heads_bwd_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf,
                       const T* __restrict__ s2, const T* __restrict__ bh, int Fh,
                       const T* __restrict__ Wn, const float* __restrict__ bn,
                       const float* __restrict__ g, int P, float rgb_padding,
                       float* __restrict__ d_h, float* __restrict__ d_r,
                       float* __restrict__ d_s2, float* __restrict__ d_bh,
                       float* __restrict__ dWn, float* __restrict__ dbn) {
  // the block's share of dWn: sigma (F) | rgb x3 | sun_v | beta (Fh each)
  __shared__ float red[FLD_MAX_F + 5 * (FLD_MAX_F / 2)];
  __shared__ float red_b[9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const bool use_beta = bh != nullptr;
  const int n_red = F + 5 * Fh;
  for (int i = threadIdx.x; i < n_red; i += FLD_WARPS * 32) red[i] = 0.f;
  if (threadIdx.x < 9) red_b[threadIdx.x] = 0.f;
  __syncthreads();

  float w_sig[FLD_F_REGS], w_rgb[3][FLD_H_REGS], w_sun[FLD_H_REGS], w_beta[FLD_H_REGS];
  load_row<T>(Wn, F, lane, w_sig);
#pragma unroll
  for (int c = 0; c < 3; ++c) load_row<T>(Wn + (size_t)(1 + c) * F, Fh, lane, w_rgb[c]);
  load_row<T>(Wn + (size_t)4 * F, Fh, lane, w_sun);
  load_row<T>(Wn + (size_t)8 * F, Fh, lane, w_beta);
  const float pad2 = 1.f + 2.f * rgb_padding;

  float a_sig[FLD_F_REGS], a_rgb[3][FLD_H_REGS], a_sun[FLD_H_REGS], a_beta[FLD_H_REGS];
#pragma unroll
  for (int i = 0; i < FLD_F_REGS; ++i) a_sig[i] = 0.f;
#pragma unroll
  for (int i = 0; i < FLD_H_REGS; ++i) {
    a_rgb[0][i] = a_rgb[1][i] = a_rgb[2][i] = a_sun[i] = a_beta[i] = 0.f;
  }
  float b_sig = 0.f, b_rgb[3] = {0.f, 0.f, 0.f}, b_sun = 0.f, b_beta = 0.f;

  const long long q0 = ((long long)blockIdx.x * FLD_WARPS + warp) * FLD_PTS;
  for (int i = 0; i < FLD_PTS; ++i) {
    const long long q = q0 + i;
    if (q >= P) break;  // the whole warp leaves the loop together
    float hv[FLD_F_REGS], rv[FLD_H_REGS], sv[FLD_H_REGS], bv[FLD_H_REGS];
    load_row<T>(h + (size_t)q * F, F, lane, hv);
    load_row<T>(rf + (size_t)q * Fh, Fh, lane, rv);
    load_row<T>(s2 + (size_t)q * Fh, Fh, lane, sv);
    const float sigma = softplusf(dot_row(hv, w_sig) + bn[0]);
    float cs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cs[c] = sigmoidf(dot_row(rv, w_rgb[c]) + bn[1 + c]);
    const float sunv = sigmoidf(dot_row(sv, w_sun) + bn[4]);
    float beta = 0.f;
    if (use_beta) {
      load_row<T>(bh + (size_t)q * Fh, Fh, lane, bv);
      beta = softplusf(dot_row(bv, w_beta) + bn[8]);
    }

    const float* gq = g + (size_t)q * FLD_COLS;
    float g_pre_rgb[3], gb_rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_pre_rgb[c] = gq[c] * pad2 * cs[c] * (1.f - cs[c]);
      gb_rgb[c] = round_to<T>(g_pre_rgb[c]);
      b_rgb[c] += g_pre_rgb[c];
    }
    const float g_pre_sig = gq[3] * -expm1f(-sigma);
    const float g_pre_sun = gq[4] * sunv * (1.f - sunv);
    const float g_pre_beta = use_beta ? gq[8] * -expm1f(-beta) : 0.f;
    b_sig += g_pre_sig;
    b_sun += g_pre_sun;
    b_beta += g_pre_beta;
    const float gb_sig = round_to<T>(g_pre_sig), gb_sun = round_to<T>(g_pre_sun);
    const float gb_beta = round_to<T>(g_pre_beta);

    float* dhq = d_h + (size_t)q * F;
#pragma unroll
    for (int j = 0; j < FLD_F_REGS; ++j) {
      const int k = lane + 32 * j;
      if (k < F) {
        a_sig[j] = fmaf(gb_sig, hv[j], a_sig[j]);
        dhq[k] = gb_sig * w_sig[j];
      }
    }
    const size_t qh = (size_t)q * Fh;
#pragma unroll
    for (int j = 0; j < FLD_H_REGS; ++j) {
      const int k = lane + 32 * j;
      if (k < Fh) {
        float dr = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a_rgb[c][j] = fmaf(gb_rgb[c], rv[j], a_rgb[c][j]);
          dr = fmaf(gb_rgb[c], w_rgb[c][j], dr);
        }
        d_r[qh + k] = dr;
        a_sun[j] = fmaf(gb_sun, sv[j], a_sun[j]);
        d_s2[qh + k] = gb_sun * w_sun[j];
        if (use_beta) {
          a_beta[j] = fmaf(gb_beta, bv[j], a_beta[j]);
          d_bh[qh + k] = gb_beta * w_beta[j];
        }
      }
    }
  }

  // the warps' sums meet in shared memory, then one atomic per entry and block
#pragma unroll
  for (int j = 0; j < FLD_F_REGS; ++j) {
    const int k = lane + 32 * j;
    if (k < F) atomicAdd(&red[k], a_sig[j]);
  }
#pragma unroll
  for (int j = 0; j < FLD_H_REGS; ++j) {
    const int k = lane + 32 * j;
    if (k < Fh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&red[F + c * Fh + k], a_rgb[c][j]);
      atomicAdd(&red[F + 3 * Fh + k], a_sun[j]);
      if (use_beta) atomicAdd(&red[F + 4 * Fh + k], a_beta[j]);
    }
  }
  if (lane == 0) {
    atomicAdd(&red_b[0], b_sig);
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(&red_b[1 + c], b_rgb[c]);
    atomicAdd(&red_b[4], b_sun);
    atomicAdd(&red_b[8], b_beta);
  }
  __syncthreads();
  const int n_out = use_beta ? n_red : F + 4 * Fh;
  for (int i = threadIdx.x; i < n_out; i += FLD_WARPS * 32) {
    // red index -> (row of dWn, column)
    int row = 0, k = i;
    if (i >= F) {
      const int part = (i - F) / Fh;  // 0..2 rgb, 3 sun_v, 4 beta
      k = (i - F) % Fh;
      row = part < 3 ? 1 + part : (part == 3 ? 4 : 8);
    }
    atomicAdd(dWn + (size_t)row * F + k, red[i]);
  }
  if (threadIdx.x < 5 || (threadIdx.x == 8 && use_beta))  // rows 5:8 are the sky kernel's
    atomicAdd(dbn + threadIdx.x, red_b[threadIdx.x]);
}

// The sky head's backward, once a ray: g_sky summed over the ray's samples,
// through the sigmoid, rounded, into dWn rows 5:8, dbn 5:8 and d_skyh.
template <typename T>
__global__ void __launch_bounds__(FLD_WARPS * 32)
field_sky_bwd_kernel(const T* __restrict__ skyh, int Fh, int F, const T* __restrict__ Wn,
                     const float* __restrict__ bn, const float* __restrict__ g, int R,
                     int S, float* __restrict__ d_skyh, float* __restrict__ dWn,
                     float* __restrict__ dbn) {
  __shared__ float red[3 * (FLD_MAX_F / 2)];
  __shared__ float red_b[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < 3 * Fh; i += FLD_WARPS * 32) red[i] = 0.f;
  if (threadIdx.x < 3) red_b[threadIdx.x] = 0.f;
  __syncthreads();

  float w_sky[3][FLD_H_REGS], a_sky[3][FLD_H_REGS];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    load_row<T>(Wn + (size_t)(5 + c) * F, Fh, lane, w_sky[c]);
#pragma unroll
    for (int j = 0; j < FLD_H_REGS; ++j) a_sky[c][j] = 0.f;
  }
  float b_sky[3] = {0.f, 0.f, 0.f};

  const int r0 = (blockIdx.x * FLD_WARPS + warp) * SKY_RAYS;
  for (int i = 0; i < SKY_RAYS; ++i) {
    const int ray = r0 + i;
    if (ray >= R) break;  // the whole warp leaves the loop together
    float xv[FLD_H_REGS], sky[3], gs[3] = {0.f, 0.f, 0.f};
    sky_forward<T>(skyh + (size_t)ray * Fh, Fh, lane, w_sky, bn, xv, sky);
    for (int s = lane; s < S; s += 32) {
      const float* gq = g + ((size_t)ray * S + s) * FLD_COLS;
#pragma unroll
      for (int c = 0; c < 3; ++c) gs[c] += gq[5 + c];
    }
    float gb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g_pre = warp_sum(gs[c]) * sky[c] * (1.f - sky[c]);
      b_sky[c] += g_pre;
      gb[c] = round_to<T>(g_pre);
    }
#pragma unroll
    for (int j = 0; j < FLD_H_REGS; ++j) {
      const int k = lane + 32 * j;
      if (k < Fh) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a_sky[c][j] = fmaf(gb[c], xv[j], a_sky[c][j]);
          d = fmaf(gb[c], w_sky[c][j], d);
        }
        d_skyh[(size_t)ray * Fh + k] = xv[j] > 0.f ? d : 0.f;  // sky_0's relu
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FLD_H_REGS; ++j) {
    const int k = lane + 32 * j;
    if (k < Fh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&red[c * Fh + k], a_sky[c][j]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(&red_b[c], b_sky[c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * Fh; i += FLD_WARPS * 32)
    atomicAdd(dWn + (size_t)(5 + i / Fh) * F + i % Fh, red[i]);
  if (threadIdx.x < 3) atomicAdd(dbn + 5 + threadIdx.x, red_b[threadIdx.x]);
}

bool field_shapes_ok(int F, int Fh, int P, int S) {
  return F >= 1 && F <= FLD_MAX_F && Fh >= 1 && Fh <= FLD_MAX_F / 2 && Fh <= F && S >= 1 &&
         P >= 0 && P % S == 0;
}

template <typename T>
int launch_field_heads(const void* h, int F, const void* rf, const void* s2, const void* bh,
                       const void* skyh, int Fh, const void* Wn, const void* bn, int P, int S,
                       float rgb_padding, void* out, cudaStream_t st) {
  auto t = [](const void* p) { return static_cast<const T*>(p); };
  constexpr int V = Vec16<T>::N;
  const bool vec = F % V == 0 && Fh % V == 0 && hopper::aligned16(h) && hopper::aligned16(rf) &&
                   hopper::aligned16(s2) && (bh == nullptr || hopper::aligned16(bh)) &&
                   hopper::aligned16(skyh);
  const int grid = (int)(((long long)P + FH_BLOCK_POINTS - 1) / FH_BLOCK_POINTS);
  field_heads_stream<T><<<grid, FH_THREADS, fh_smem_bytes(F, Fh, sizeof(T)), st>>>(
      t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), static_cast<const float*>(bn), P, S,
      rgb_padding, vec, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_field_heads_bwd(const void* h, int F, const void* rf, const void* s2,
                           const void* bh, const void* skyh, int Fh, const void* Wn,
                           const void* bn, const void* g, int P, int S, float rgb_padding,
                           void* d_h, void* d_r, void* d_s2, void* d_bh, void* d_skyh,
                           void* dWn, void* dbn, cudaStream_t st) {
  auto t = [](const void* p) { return static_cast<const T*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int per_block = FLD_WARPS * FLD_PTS;
  const int grid = (int)(((long long)P + per_block - 1) / per_block);
  field_heads_bwd_kernel<T><<<grid, FLD_WARPS * 32, 0, st>>>(
      t(h), F, t(rf), t(s2), t(bh), Fh, t(Wn), f(bn), f(g), P, rgb_padding, o(d_h), o(d_r),
      o(d_s2), o(d_bh), o(dWn), o(dbn));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = P / S, rays_per_block = FLD_WARPS * SKY_RAYS;
  field_sky_bwd_kernel<T><<<(R + rays_per_block - 1) / rays_per_block, FLD_WARPS * 32, 0, st>>>(
      t(skyh), Fh, F, t(Wn), f(bn), f(g), R, S, o(d_skyh), o(dWn), o(dbn));
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C entry points
// Each returns cudaGetLastError() after its launches; the wrapper raises if it
// is not 0. P = R * S points, ray-major; S = 1 makes every point its own ray.

extern "C" int satnerf_field_heads(int dtype, const void* h, int F, const void* rf,
                                   const void* s2, const void* bh, const void* skyh, int Fh,
                                   const void* Wn, const void* bn, int P, int S,
                                   float rgb_padding, void* out, void* stream) {
  if (!field_shapes_ok(F, Fh, P, S)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_field_heads<float>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, P, S, rgb_padding, out,
                                     st);
  if (dtype == 1)
    return launch_field_heads<__nv_bfloat16>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, P, S,
                                             rgb_padding, out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int satnerf_field_heads_bwd(int dtype, const void* h, int F, const void* rf,
                                       const void* s2, const void* bh, const void* skyh,
                                       int Fh, const void* Wn, const void* bn, const void* g,
                                       int P, int S, float rgb_padding, void* d_h, void* d_r,
                                       void* d_s2, void* d_bh, void* d_skyh, void* dWn,
                                       void* dbn, void* stream) {
  if (!field_shapes_ok(F, Fh, P, S) || g == nullptr) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_field_heads_bwd<float>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, g, P, S,
                                         rgb_padding, d_h, d_r, d_s2, d_bh, d_skyh, dWn, dbn, st);
  if (dtype == 1)
    return launch_field_heads_bwd<__nv_bfloat16>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, g, P, S,
                                                 rgb_padding, d_h, d_r, d_s2, d_bh, d_skyh, dWn,
                                                 dbn, st);
  return (int)cudaErrorInvalidValue;
}

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
//                    d_r, d_s2, d_bh (P, .) in fp32; and, once a ray, the sky
//                    head's: the ray's sky cotangent is the sum over its
//                    samples, taken before sky_1's backward and before
//                    rounding; d_skyh comes out masked by relu.
//
// The points are independent (no compositor, no walk along the ray). Both
// kernels take them a warp a point, with the point's heads computed by
// heads.cuh: 16-byte loads, the nine narrow weight rows in shared memory.
//
// softplus' is formed as -expm1f(-softplus): where sigma is below 1e-8,
// 1.f - expf(-sigma) is 0 and the sample would lose its gradient.
//
// Bound by device memory: per point the forward reads h (F values) and three
// (Fh) activations and writes 64 bytes (2.6 KB a point at 8 x 512 in bf16:
// 0.103 ms for 1,024 rays x 128 points at 3.35 TB/s; the warp-a-point body
// it replaced, 156 registers a thread and one block an SM, took 0.418, PERF.md);
// the backward reads the same and g, and writes F + 3 Fh floats of
// cotangents (7.6 KB a point: 0.303 ms at 1,024 x 128).

#include <initializer_list>

#include "common.cuh"
#include "heads.cuh"
#include "hopper.cuh"

namespace {

constexpr int FLD_MAX_F = 512;
constexpr int FLD_COLS = 16;    // rgb 0:3 | sigma 3 | sun_v 4 | sky 5:8 | beta 8

// ---------------------------------------------------------------- field_heads
//
// A streaming kernel: the points are independent and the work a point is
// small (3,584 flops at F = 512) beside its bytes (h, r, s2, bh: 2.5 KB in
// bf16, 64 B written), so it is bound by how many bytes are in flight. A
// block of FH_THREADS takes FH_BLOCK_POINTS neighbouring points, a warp
// FH_POINTS of them one after another, each by heads.cuh's point_heads: 20
// registers of rows in flight a lane. No weight stays in registers, and at
// 64 registers a thread four blocks (32 warps, 80 KB of rows in flight) fit
// an SM. A warp a point rather than a smaller group of lanes, or a tile
// staged by cp.async: a point's rows are already whole 16-byte chunks a
// lane, and a smaller group would hold twice the chunks a lane, past the 64
// registers. Before the points the block's warps form sky for each ray its
// points belong to, once a ray (every point with S = 1, K6), into shared
// memory. Lane l < 16 writes column l of the point's 16: its 64 bytes in
// one coalesced store.
constexpr int FH_THREADS = 256;
constexpr int FH_WARPS = FH_THREADS / 32;
constexpr int FH_POINTS = 16;                          // points a warp takes, one at a time
constexpr int FH_BLOCK_POINTS = FH_WARPS * FH_POINTS;  // 128

// The dynamic shared memory of a block, in bytes: the rows and biases
// (heads.cuh), then sky of each ray of the block's points.
__host__ __device__ constexpr int fh_smem_bytes(int F, int Fh, int elem_bytes) {
  return heads_smem_bytes(F, Fh, elem_bytes) + 3 * FH_BLOCK_POINTS * 4;
}

// Registers for 4 blocks an SM (at most 64 a thread).
template <typename T>
__global__ void __launch_bounds__(FH_THREADS, 4)
field_heads_stream(const T* __restrict__ h, int F, const T* __restrict__ rf,
                   const T* __restrict__ s2, const T* __restrict__ bh,
                   const T* __restrict__ skyh, int Fh, const T* __restrict__ Wn,
                   const float* __restrict__ bn, int P, int S, float rgb_padding, int vec,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fh_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const bool use_beta = bh != nullptr;
  const HeadRows<T> w = load_head_rows<T>(Wn, bn, F, Fh, use_beta, fh_smem);
  float* sky_s = reinterpret_cast<float*>(fh_smem + heads_smem_bytes(F, Fh, sizeof(T)));
  const long long qb = (long long)blockIdx.x * FH_BLOCK_POINTS;
  const long long q_end = qb + FH_BLOCK_POINTS < P ? qb + FH_BLOCK_POINTS : P;
  const long long r0 = qb / S;
  const int n_rays = (int)((q_end - 1) / S - r0 + 1);
  __syncthreads();

  // ---- sky, once a ray of the block's points: a warp a ray
  for (int i = warp; i < n_rays; i += FH_WARPS) {
    float part[3];
    ray_sky<T>(skyh + (size_t)(r0 + i) * Fh, Fh, vec, w, lane, part);
    if (lane < 3) {
      const float v = lane == 0 ? part[0] : (lane == 1 ? part[1] : part[2]);
      sky_s[3 * i + lane] = sigmoidf(v + w.bs[5 + lane]);
    }
  }
  __syncthreads();

  // ---- the points: a warp a point, FH_POINTS in turn
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int passes = head_passes<T, HEADS_CF, HEADS_CH>(F, Fh);
  for (int it = 0; it < FH_POINTS; ++it) {
    const long long q = qb + warp + (long long)FH_WARPS * it;
    if (q >= P) break;  // the whole warp leaves together
    float part[6];      // sigma, rgb x3, sun_v, beta
    point_heads<T>(h, F, rf, s2, bh, Fh, use_beta, (size_t)q, vec, passes, w, lane, part);
    float v = 0.f;  // column `lane` of the point's 16
    if (lane < 3) {
      const float pre = lane == 0 ? part[1] : (lane == 1 ? part[2] : part[3]);
      v = sigmoidf(pre + w.bs[1 + lane]) * pad2 - rgb_padding;
    } else if (lane == 3) {
      v = softplusf(part[0] + w.bs[0]);
    } else if (lane == 4) {
      v = sigmoidf(part[4] + w.bs[4]);
    } else if (lane < 8) {
      v = sky_s[3 * (int)(q / S - r0) + lane - 5];
    } else if (lane == 8 && use_beta) {
      v = softplusf(part[5] + w.bs[8]);
    }
    if (lane < FLD_COLS) out[(size_t)q * FLD_COLS + lane] = v;
  }
}

// ------------------------------------------------------------ field_heads_bwd
//
// A persistent grid (hopper::resident_blocks) of blocks of FHB_THREADS; warp
// i of block b takes points b * FHB_WARPS + i, then every gridDim.x *
// FHB_WARPS after it, one at a time:
//  * the forward again by heads.cuh, in one pass: every 16-byte chunk of the
//    point's rows (5 in bf16, 10 in fp32, at 8 x 512) stays in registers,
//    raw, after the products;
//  * the six pre-activation cotangents, each rounded to the compute type;
//    lane c < 9 sums column c's unrounded ones (dbn);
//  * dWn's rows 0:5 and 8 over the lane's columns of the chunks, 56 fp32
//    sums in registers kept over all of the warp's points (a warp-a-point
//    lane keeps its columns from point to point);
//  * d_h, d_r, d_s2, d_bh need the weights only: a lane takes 4 columns of
//    each 128, read from the rows in shared memory, and writes them as one
//    16-byte store, so a store instruction of the warp covers 512
//    contiguous bytes;
//  * where the point is its ray's first sample, the ray's sky head: its
//    cotangent summed over the ray's samples (lanes over samples), sky
//    again, and then, 4 columns of each 128 a lane, d_skyh (skyh read again,
//    from L1, for the relu's mask) and dWn's rows 5:8 summed in the warp's
//    row of shared memory. At S = 1 (K6) that is every point; it was a
//    second kernel that read g again and made one global atomic per column
//    for each 32 rays.
// At the end each warp writes its sums to its row of shared memory, and a
// thread a column adds the block's rows and makes one fp32 atomicAdd into
// dWn and dbn (which the wrapper zeroes): 2,572 atomics a block at 8 x 512,
// 264 blocks, where the body it replaced made 1,792 for each 128 points. The
// atomics add in an order that changes from run to run, as before.
//
// Registers: 56 sums and 20 registers of rows in bf16, at most 128 a thread
// for 2 blocks (16 warps) an SM; in fp32 the rows take 40, and one block of
// up to 255 an SM. Shared memory 85 KB a block at 8 x 512 (the warps' rows
// of sums), opted into past 48 KB.
constexpr int FHB_THREADS = 256;
constexpr int FHB_WARPS = FHB_THREADS / 32;

// Floats of a warp's row of sums: dWn's rows laid out as the weights are in
// shared memory (heads.cuh), then dbn (HEADS_BIAS_SLOTS).
__host__ __device__ constexpr int fhb_row_floats(int F, int Fh) {
  return heads_pad8(F) + 8 * heads_pad8(Fh) + HEADS_BIAS_SLOTS;
}

__host__ __device__ constexpr int fhb_smem_bytes(int F, int Fh, int elem_bytes) {
  return heads_smem_bytes(F, Fh, elem_bytes) + FHB_WARPS * fhb_row_floats(F, Fh) * 4;
}

// v[i] += a * x[i], 4 floats of shared memory at a 16-byte boundary
__device__ __forceinline__ void smem_axpy4(float* v, float a, const float (&x)[4]) {
  float4 u = *reinterpret_cast<float4*>(v);
  u.x = fmaf(a, x[0], u.x);
  u.y = fmaf(a, x[1], u.y);
  u.z = fmaf(a, x[2], u.z);
  u.w = fmaf(a, x[3], u.w);
  *reinterpret_cast<float4*>(v) = u;
}

template <typename T>
__global__ void __launch_bounds__(FHB_THREADS, sizeof(T) == 2 ? 2 : 1)
field_heads_bwd_stream(const T* __restrict__ h, int F, const T* __restrict__ rf,
                       const T* __restrict__ s2, const T* __restrict__ bh,
                       const T* __restrict__ skyh, int Fh, const T* __restrict__ Wn,
                       const float* __restrict__ bn, const float* __restrict__ g, int P,
                       int S, float rgb_padding, int vec, float* __restrict__ d_h,
                       float* __restrict__ d_r, float* __restrict__ d_s2,
                       float* __restrict__ d_bh, float* __restrict__ d_skyh,
                       float* __restrict__ dWn, float* __restrict__ dbn) {
  constexpr int V = Vec16<T>::N;
  constexpr int CF = FLD_MAX_F / (32 * V), CH = CF / 2;  // every chunk in one pass
  extern __shared__ __align__(16) unsigned char fhb_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const bool use_beta = bh != nullptr;
  const HeadRows<T> w = load_head_rows<T>(Wn, bn, F, Fh, use_beta, fhb_smem);
  const int Fp = heads_pad8(F), Fhp = heads_pad8(Fh), row_len = fhb_row_floats(F, Fh);
  float* red = reinterpret_cast<float*>(fhb_smem + heads_smem_bytes(F, Fh, sizeof(T)));
  float* mine = red + warp * row_len;  // this warp's sums
  for (int i = lane; i < row_len; i += 32) mine[i] = 0.f;
  __syncthreads();

  float a_sig[CF][V], a_h[5][CH][V];  // dWn rows 0 and 1:4, 4, 8 at the lane's chunks
#pragma unroll
  for (int ci = 0; ci < CF; ++ci)
#pragma unroll
    for (int i = 0; i < V; ++i) a_sig[ci][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int ci = 0; ci < CH; ++ci)
#pragma unroll
      for (int i = 0; i < V; ++i) a_h[r][ci][i] = 0.f;
  float b_sum = 0.f;  // lane c < 9: dbn[c], the unrounded cotangents
  const float pad2 = 1.f + 2.f * rgb_padding;
  const long long stride = (long long)gridDim.x * FHB_WARPS;

  for (long long q = (long long)blockIdx.x * FHB_WARPS + warp; q < P; q += stride) {
    const float g_lane = lane < FLD_COLS ? g[(size_t)q * FLD_COLS + lane] : 0.f;
    uint4 xh[CF], xr[CH], xs[CH], xb[CH];
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    head_loads<T, CF, CH>(h, F, rf, s2, bh, Fh, use_beta, (size_t)q, vec, 0, lane, xh, xr, xs,
                          xb);
    head_dots<T, CF, CH>(F, Fh, use_beta, w, 0, lane, xh, xr, xs, xb, part);
#pragma unroll
    for (int i = 0; i < 6; ++i) part[i] = warp_sum(part[i]);
    const float sigma = softplusf(part[0] + w.bs[0]);
    const float sunv = sigmoidf(part[4] + w.bs[4]);
    const float beta = use_beta ? softplusf(part[5] + w.bs[8]) : 0.f;

    float gp_rgb[3], gb_rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float cs = sigmoidf(part[1 + c] + w.bs[1 + c]);
      gp_rgb[c] = __shfl_sync(0xffffffffu, g_lane, c) * pad2 * cs * (1.f - cs);
      gb_rgb[c] = round_to<T>(gp_rgb[c]);
    }
    const float gp_sig = __shfl_sync(0xffffffffu, g_lane, 3) * -expm1f(-sigma);
    const float gp_sun = __shfl_sync(0xffffffffu, g_lane, 4) * sunv * (1.f - sunv);
    const float g_beta = __shfl_sync(0xffffffffu, g_lane, 8);
    const float gp_beta = use_beta ? g_beta * -expm1f(-beta) : 0.f;
    b_sum += lane == 0   ? gp_sig
             : lane == 1 ? gp_rgb[0]
             : lane == 2 ? gp_rgb[1]
             : lane == 3 ? gp_rgb[2]
             : lane == 4 ? gp_sun
             : lane == 8 ? gp_beta
                         : 0.f;
    const float gb_sig = round_to<T>(gp_sig), gb_sun = round_to<T>(gp_sun);
    const float gb_beta = round_to<T>(gp_beta);

    // dWn over the lane's chunks, from the rows still in registers
#pragma unroll
    for (int ci = 0; ci < CF; ++ci) {
      if (chunk_col<T, CF>(0, lane, ci) >= F) continue;
      float x[V];
      chunk_values<T>(xh[ci], x);
#pragma unroll
      for (int i = 0; i < V; ++i) a_sig[ci][i] = fmaf(gb_sig, x[i], a_sig[ci][i]);
    }
#pragma unroll
    for (int ci = 0; ci < CH; ++ci) {
      if (chunk_col<T, CH>(0, lane, ci) >= Fh) continue;
      float x[V];
      chunk_values<T>(xr[ci], x);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) a_h[c][ci][i] = fmaf(gb_rgb[c], x[i], a_h[c][ci][i]);
      chunk_values<T>(xs[ci], x);
#pragma unroll
      for (int i = 0; i < V; ++i) a_h[3][ci][i] = fmaf(gb_sun, x[i], a_h[3][ci][i]);
      if (use_beta) {
        chunk_values<T>(xb[ci], x);
#pragma unroll
        for (int i = 0; i < V; ++i) a_h[4][ci][i] = fmaf(gb_beta, x[i], a_h[4][ci][i]);
      }
    }

    // the cotangents of h, r, s2 and bh: 4 columns of each 128 a lane
    for (int k = 4 * lane; k < F; k += 128) {
      float wv[4], d[4];
      smem4<T>(w.ws + k, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = gb_sig * wv[i];
      store_chunk<4>(d_h + (size_t)q * F, k, F, vec, d);
    }
    const size_t qh = (size_t)q * Fh;
    for (int k = 4 * lane; k < Fh; k += 128) {
      float wv[4], d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        smem4<T>(w.wh + c * Fhp + k, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = fmaf(gb_rgb[c], wv[i], d[i]);
      }
      store_chunk<4>(d_r + qh, k, Fh, vec, d);
      smem4<T>(w.wh + 3 * Fhp + k, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = gb_sun * wv[i];
      store_chunk<4>(d_s2 + qh, k, Fh, vec, d);
      if (use_beta) {
        smem4<T>(w.wh + 7 * Fhp + k, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = gb_beta * wv[i];
        store_chunk<4>(d_bh + qh, k, Fh, vec, d);
      }
    }

    if (q % S != 0) continue;  // the same for the whole warp
    // ---- the sky head of the ray whose first sample this is
    const long long ray = q / S;
    float gs[3] = {0.f, 0.f, 0.f};
    for (int s = lane; s < S; s += 32) {
      const float* gq = g + ((size_t)ray * S + s) * FLD_COLS;
#pragma unroll
      for (int c = 0; c < 3; ++c) gs[c] += gq[5 + c];
    }
    const T* x_sky = skyh + (size_t)ray * Fh;
    float sp[3], gb_sky[3];
    ray_sky<T>(x_sky, Fh, vec, w, lane, sp);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sky = sigmoidf(sp[c] + w.bs[5 + c]);
      const float gp = warp_sum(gs[c]) * sky * (1.f - sky);
      if (lane == 5 + c) b_sum += gp;
      gb_sky[c] = round_to<T>(gp);
    }
    for (int k = 4 * lane; k < Fh; k += 128) {
      float xv[4], wv[4], d[4] = {0.f, 0.f, 0.f, 0.f};
      values4<T>(row4_raw<T>(x_sky, k, Fh, vec), xv);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        smem4<T>(w.wh + (4 + c) * Fhp + k, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = fmaf(gb_sky[c], wv[i], d[i]);
        smem_axpy4(mine + Fp + (4 + c) * Fhp + k, gb_sky[c], xv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = xv[i] > 0.f ? d[i] : 0.f;  // sky_0's relu
      store_chunk<4>(d_skyh + (size_t)ray * Fh, k, Fh, vec, d);
    }
  }

  // the warps' sums meet in shared memory, a row a warp, then a thread a
  // column adds the rows and makes one atomicAdd
#pragma unroll
  for (int ci = 0; ci < CF; ++ci) {
    const int k = chunk_col<T, CF>(0, lane, ci);
    if (k >= F) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) mine[k + i] = a_sig[ci][i];
  }
#pragma unroll
  for (int ci = 0; ci < CH; ++ci) {
    const int k = chunk_col<T, CH>(0, lane, ci);
    if (k >= Fh) continue;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int row = r < 4 ? r : 7;  // rgb x3, sun_v, beta; sky's rows 4:7 are summed
#pragma unroll
      for (int i = 0; i < V; ++i) mine[Fp + row * Fhp + k + i] = a_h[r][ci][i];
    }
  }
  if (lane < 9) mine[Fp + 8 * Fhp + lane] = b_sum;
  __syncthreads();
  for (int i = tid; i < Fp + 8 * Fhp; i += FHB_THREADS) {
    const int row = i < Fp ? 0 : 1 + (i - Fp) / Fhp, k = i < Fp ? i : (i - Fp) % Fhp;
    if (k >= (row == 0 ? F : Fh) || (row == 8 && !use_beta)) continue;
    float v = 0.f;
    for (int wp = 0; wp < FHB_WARPS; ++wp) v += red[wp * row_len + i];
    atomicAdd(dWn + (size_t)row * F + k, v);
  }
  if (tid < 9 && (tid != 8 || use_beta)) {
    float v = 0.f;
    for (int wp = 0; wp < FHB_WARPS; ++wp) v += red[wp * row_len + Fp + 8 * Fhp + tid];
    atomicAdd(dbn + tid, v);
  }
}

bool field_shapes_ok(int F, int Fh, int P, int S) {
  return F >= 1 && F <= FLD_MAX_F && Fh >= 1 && Fh <= FLD_MAX_F / 2 && Fh <= F && S >= 1 &&
         P >= 0 && P % S == 0;
}

template <typename T>
bool field_vec(int F, int Fh, std::initializer_list<const void*> ptrs) {
  bool ok = F % Vec16<T>::N == 0 && Fh % Vec16<T>::N == 0;
  for (const void* p : ptrs) ok = ok && (p == nullptr || hopper::aligned16(p));
  return ok;
}

template <typename T>
int launch_field_heads(const void* h, int F, const void* rf, const void* s2, const void* bh,
                       const void* skyh, int Fh, const void* Wn, const void* bn, int P, int S,
                       float rgb_padding, void* out, cudaStream_t st) {
  auto t = [](const void* p) { return static_cast<const T*>(p); };
  const bool vec = field_vec<T>(F, Fh, {h, rf, s2, bh, skyh});
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
  auto o = [](void* p) { return static_cast<float*>(p); };
  const int smem = fhb_smem_bytes(F, Fh, sizeof(T));
  static int resident = 0, resident_smem = -1;  // the persistent grid, for this smem
  if (smem != resident_smem) {
    resident = hopper::resident_blocks(field_heads_bwd_stream<T>, FHB_THREADS, smem);
    resident_smem = smem;
  }
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  const bool vec = field_vec<T>(F, Fh, {h, rf, s2, bh, skyh, d_h, d_r, d_s2, d_bh, d_skyh});
  const long long want = ((long long)P + FHB_WARPS - 1) / FHB_WARPS;
  const int grid = (int)(want < resident ? want : resident);
  field_heads_bwd_stream<T><<<grid, FHB_THREADS, smem, st>>>(
      t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), static_cast<const float*>(bn),
      static_cast<const float*>(g), P, S, rgb_padding, vec, o(d_h), o(d_r), o(d_s2), o(d_bh),
      o(d_skyh), o(dWn), o(dbn));
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C entry points
// Each returns cudaGetLastError() after its launch; the wrapper raises if it
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

// The narrow heads of one point, shared by the kernels that compute them:
// field_heads and field_heads_bwd (fused_field.cu), heads_composite
// (fused_render.cu), and for the nerf variant's two heads (the end of this
// file) nerf_heads_composite and nerf_composite_loss_bwd (fused_nerf.cu).
// From the point's rows h (F), r, s2 and bh (Fh each) and the nine narrow
// weight rows, the pre-activations of sigma (h . w0), rgb x 3
// (r . w1:4), sun_v (s2 . w4) and beta (bh . w8); and of a ray, from its
// sky_0 row skyh (Fh), those of sky x 3 (skyh . w5:8).
//
// A warp takes a point: each lane reads 16 bytes at a time of each row (a
// whole 512-byte row per load instruction, neighbouring lanes on
// neighbouring addresses), all of a pass's loads issued before any product
// and kept as raw 16-byte chunks (4 registers each) until then, against the
// weight rows read as one 16-byte chunk a lane. A pass covers HEADS_PASS_F
// features of h and half as many of each Fh row: the 8 x 512 field's rows
// in one pass in bf16, in two in fp32; wider fields take more passes. The
// caller sums the lanes' partial products (warp_sum) and applies the
// activations.
//
// The weight rows sit in shared memory (HeadRows<T, true>), from a 16-byte
// boundary: the sigma row (F padded to a multiple of 8 values), then rows
// 1:9 (rgb x3, sun_v, sky x3, beta; Fh padded to a multiple of 8 each) in
// the compute type, zero past their lengths and the beta row zero without
// the beta head; then the nine biases as floats (12 slots). The kernels put
// their own scratch after it. A kernel whose rows may not fit the 227 KB a
// block may hold (heads_composite takes any width) has a second
// instantiation, HeadRows<T, false>, that reads Wn's own rows in global
// memory (through L1 and L2) and keeps only the biases in shared memory.

#pragma once

#include "common.cuh"

namespace {

constexpr int HEADS_PASS_F = 512;  // features of h one pass covers in bf16
constexpr int HEADS_BIAS_SLOTS = 12;

__host__ __device__ constexpr int heads_pad8(int n) { return (n + 7) / 8 * 8; }

// Bytes of shared memory the rows (where `rows`) and the biases take (a
// multiple of 16).
__host__ __device__ constexpr int heads_smem_bytes(int F, int Fh, int elem_bytes,
                                                   bool rows = true) {
  return (rows ? (heads_pad8(F) + 8 * heads_pad8(Fh)) * elem_bytes : 0) +
         HEADS_BIAS_SLOTS * 4;
}

// The weight rows: ws the sigma row, wh rows 1:9 at a stride of ld values
// (wh + (row - 1) * ld), bs the nine biases in shared memory. SMEM: the
// rows in shared memory as laid out above; else Wn's rows (ld = F), read
// with 16-byte loads where vec (Wn 16-byte aligned, F and Fh multiples of 16
// bytes' values), else a value at a time, zero past the row's end.
template <typename T, bool SMEM = true> struct HeadRows {
  const T* ws;
  const T* wh;
  const float* bs;
  int ld;
  int vec;
};

// Copies Wn (9, F) (where SMEM) and bn (9,) into `smem` (heads_smem_bytes
// of it) by the block's threads; the caller synchronizes before reading
// them. vec: the global rows' loads (see HeadRows).
template <typename T, bool SMEM = true>
__device__ __forceinline__ HeadRows<T, SMEM> load_head_rows(const T* __restrict__ Wn,
                                                            const float* __restrict__ bn,
                                                            int F, int Fh, bool use_beta,
                                                            unsigned char* smem, int vec = 1) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (SMEM) {
    const int Fp = heads_pad8(F), Fhp = heads_pad8(Fh);
    T* ws = reinterpret_cast<T*>(smem);
    T* wh = ws + Fp;
    float* bs = reinterpret_cast<float*>(wh + 8 * Fhp);
    for (int i = tid; i < Fp; i += nt) ws[i] = i < F ? Wn[i] : from_f32<T>(0.f);
    for (int i = tid; i < 8 * Fhp; i += nt) {
      const int row = 1 + i / Fhp, k = i % Fhp;
      wh[i] = k < Fh && (row != 8 || use_beta) ? Wn[(size_t)row * F + k] : from_f32<T>(0.f);
    }
    if (tid < 9) bs[tid] = bn[tid];
    return HeadRows<T, SMEM>{ws, wh, bs, Fhp, 1};
  } else {
    float* bs = reinterpret_cast<float*>(smem);
    if (tid < 9) bs[tid] = bn[tid];
    return HeadRows<T, SMEM>{Wn, Wn + F, bs, F, vec};
  }
}

// The weights [k, k + 16 bytes) of a row of n values, raw: returned by
// value, so that a chunk in shared memory is one 16-byte load (unpacked
// through a pointer into shared memory it compiles to a 2-byte load a value).
template <typename T, bool SMEM>
__device__ __forceinline__ uint4 weight_chunk(const HeadRows<T, SMEM>& w, const T* row, int k,
                                              int n) {
  if constexpr (SMEM) return *reinterpret_cast<const uint4*>(row + k);
  else return row_chunk_raw<T>(row, k, n, w.vec);
}

// acc + the dot product of a raw chunk with a raw chunk of its weights
template <typename T>
__device__ __forceinline__ float chunk_dot(const uint4& raw, const uint4& w, float acc) {
  constexpr int V = Vec16<T>::N;
  float x[V], wv[V];
  chunk_values<T>(raw, x);
  chunk_values<T>(w, wv);
#pragma unroll
  for (int i = 0; i < V; ++i) acc = fmaf(x[i], wv[i], acc);
  return acc;
}

// v = the 4 values of the compute type at p in shared memory (8 bytes of
// bf16 or 16 of fp32, aligned so), read by one load: the raw copy in
// registers comes first (unpacking through a pointer into shared memory
// compiles to a 2-byte load a value)
template <typename T>
__device__ __forceinline__ void smem4(const T* p, float (&v)[4]) {
  const typename Raw4<T>::type raw = *reinterpret_cast<const typename Raw4<T>::type*>(p);
  values4<T>(raw, v);
}

// The chunks a lane takes of h (HEADS_CF) and of each Fh row (HEADS_CH) in
// one pass of the pass loop below. A kernel that keeps every chunk of a
// point of the 8 x 512 field in registers at once takes one pass of
// 512 / (32 V) and half that instead.
constexpr int HEADS_CF = HEADS_PASS_F / (32 * 8), HEADS_CH = HEADS_CF / 2;

// Feature k of chunk ci of pass `pass` of a lane (0 for its first value).
template <typename T, int C>
__device__ __forceinline__ int chunk_col(int pass, int lane, int ci) {
  return (pass * 32 * C + lane + 32 * ci) * Vec16<T>::N;
}

// Point q's chunks of one pass into xh, xr, xs, xb (left as they were past
// the row's end; xb only with the beta head).
template <typename T, int CF, int CH>
__device__ __forceinline__ void head_loads(const T* __restrict__ h, int F,
                                           const T* __restrict__ rf, const T* __restrict__ s2,
                                           const T* __restrict__ bh, int Fh, bool use_beta,
                                           size_t q, int vec,
                                           int pass, int lane, uint4 (&xh)[CF], uint4 (&xr)[CH],
                                           uint4 (&xs)[CH], uint4 (&xb)[CH]) {
#pragma unroll
  for (int ci = 0; ci < CF; ++ci) {
    const int k = chunk_col<T, CF>(pass, lane, ci);
    if (k < F) xh[ci] = row_chunk_raw<T>(h + q * F, k, F, vec);
  }
#pragma unroll
  for (int ci = 0; ci < CH; ++ci) {
    const int k = chunk_col<T, CH>(pass, lane, ci);
    if (k < Fh) {
      xr[ci] = row_chunk_raw<T>(rf + q * Fh, k, Fh, vec);
      xs[ci] = row_chunk_raw<T>(s2 + q * Fh, k, Fh, vec);
      if (use_beta) xb[ci] = row_chunk_raw<T>(bh + q * Fh, k, Fh, vec);
    }
  }
}

// Adds the lane's partial products of one pass's chunks to part[6] =
// sigma, rgb x 3, sun_v, beta (beta only with the beta head).
template <typename T, int CF, int CH, bool SMEM>
__device__ __forceinline__ void head_dots(int F, int Fh, bool use_beta, HeadRows<T, SMEM> w,
                                          int pass, int lane, const uint4 (&xh)[CF],
                                          const uint4 (&xr)[CH], const uint4 (&xs)[CH],
                                          const uint4 (&xb)[CH], float (&part)[6]) {
#pragma unroll
  for (int ci = 0; ci < CF; ++ci) {
    const int k = chunk_col<T, CF>(pass, lane, ci);
    if (k < F) part[0] = chunk_dot<T>(xh[ci], weight_chunk(w, w.ws, k, F), part[0]);
  }
#pragma unroll
  for (int ci = 0; ci < CH; ++ci) {
    const int k = chunk_col<T, CH>(pass, lane, ci);
    if (k >= Fh) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      part[1 + c] = chunk_dot<T>(xr[ci], weight_chunk(w, w.wh + c * w.ld, k, Fh), part[1 + c]);
    part[4] = chunk_dot<T>(xs[ci], weight_chunk(w, w.wh + 3 * w.ld, k, Fh), part[4]);
    if (use_beta)
      part[5] = chunk_dot<T>(xb[ci], weight_chunk(w, w.wh + 7 * w.ld, k, Fh), part[5]);
  }
}

// How many passes a point of these widths takes with CF and CH chunks a lane.
template <typename T, int CF, int CH>
__device__ __forceinline__ int head_passes(int F, int Fh) {
  constexpr int V = Vec16<T>::N;
  return max((F + 32 * V * CF - 1) / (32 * V * CF), (Fh + 32 * V * CH - 1) / (32 * V * CH));
}

// The pre-activations of point q's six heads, summed over the warp: every
// lane holds them. passes: head_passes<T, HEADS_CF, HEADS_CH>(F, Fh), which
// the caller forms once; use_beta: bh is not null.
template <typename T, bool SMEM>
__device__ __forceinline__ void point_heads(const T* __restrict__ h, int F,
                                            const T* __restrict__ rf,
                                            const T* __restrict__ s2,
                                            const T* __restrict__ bh, int Fh, bool use_beta,
                                            size_t q, int vec, int passes,
                                            HeadRows<T, SMEM> w, int lane, float (&part)[6]) {
  constexpr int CF = HEADS_CF, CH = HEADS_CH;
#pragma unroll
  for (int i = 0; i < 6; ++i) part[i] = 0.f;
  for (int pass = 0; pass < passes; ++pass) {
    uint4 xh[CF], xr[CH], xs[CH], xb[CH];  // raw until the products
    head_loads<T, CF, CH>(h, F, rf, s2, bh, Fh, use_beta, q, vec, pass, lane, xh, xr, xs, xb);
    head_dots<T, CF, CH>(F, Fh, use_beta, w, pass, lane, xh, xr, xs, xb, part);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) part[i] = warp_sum(part[i]);
}

// The pre-activations of sky x 3 of the ray whose sky_0 row is x, summed
// over the warp: every lane holds them.
template <typename T, bool SMEM>
__device__ __forceinline__ void ray_sky(const T* __restrict__ x, int Fh, int vec,
                                        HeadRows<T, SMEM> w, int lane, float (&part)[3]) {
  constexpr int V = Vec16<T>::N, CH = HEADS_CH;
  part[0] = part[1] = part[2] = 0.f;
  for (int kb = 0; kb < Fh; kb += 32 * V * CH) {
    uint4 xr[CH];
#pragma unroll
    for (int ci = 0; ci < CH; ++ci) {
      const int k = kb + (lane + 32 * ci) * V;
      if (k < Fh) xr[ci] = row_chunk_raw<T>(x, k, Fh, vec);
    }
#pragma unroll
    for (int ci = 0; ci < CH; ++ci) {
      const int k = kb + (lane + 32 * ci) * V;
      if (k >= Fh) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        part[c] = chunk_dot<T>(xr[ci], weight_chunk(w, w.wh + (4 + c) * w.ld, k, Fh), part[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) part[c] = warp_sum(part[c]);
}

// ---- the classic NeRF variant's two heads (fused_nerf.cu): Wn (4, F), row
// 0 sigma (F values), rows 1:4 rgb_1 (the first Fh values of each), bn (4,).
// In shared memory as HeadRows<T, true>: the sigma row (F padded to a
// multiple of 8 values), the three rgb rows (Fh padded so, ld apart), in the
// compute type, then the four biases as floats.

// Bytes of shared memory the nerf rows and biases take (a multiple of 16).
__host__ __device__ constexpr int nerf_rows_smem_bytes(int F, int Fh, int elem_bytes) {
  return (heads_pad8(F) + 3 * heads_pad8(Fh)) * elem_bytes + 4 * 4;
}

// Copies Wn's four rows and bn into `smem` by the block's threads; the
// caller synchronizes before reading them.
template <typename T>
__device__ __forceinline__ HeadRows<T, true> load_nerf_rows(const T* __restrict__ Wn,
                                                            const float* __restrict__ bn,
                                                            int F, int Fh, unsigned char* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Fp = heads_pad8(F), Fhp = heads_pad8(Fh);
  T* ws = reinterpret_cast<T*>(smem);
  T* wh = ws + Fp;
  float* bs = reinterpret_cast<float*>(wh + 3 * Fhp);
  for (int i = tid; i < Fp; i += nt) ws[i] = i < F ? Wn[i] : from_f32<T>(0.f);
  for (int i = tid; i < 3 * Fhp; i += nt) {
    const int row = 1 + i / Fhp, k = i % Fhp;
    wh[i] = k < Fh ? Wn[(size_t)row * F + k] : from_f32<T>(0.f);
  }
  if (tid < 4) bs[tid] = bn[tid];
  return HeadRows<T, true>{ws, wh, bs, Fhp, 1};
}

// The sums over the warp of v[0:4], one shuffle tree for the four: lane L
// gets the sum of v[L / 8] (6 shuffles where four warp_sums take 20).
__device__ __forceinline__ float warp_sum4(const float (&v)[4], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const float a0 = (hi16 ? v[2] : v[0]) + __shfl_xor_sync(0xffffffffu, hi16 ? v[0] : v[2], 16);
  const float a1 = (hi16 ? v[3] : v[1]) + __shfl_xor_sync(0xffffffffu, hi16 ? v[1] : v[3], 16);
  float a = (hi8 ? a1 : a0) + __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// How many passes nerf_point_heads takes: a pass covers 32 16-byte chunks
// of h and of r (256 features of each in bf16, 128 in fp32).
template <typename T>
__device__ __forceinline__ int nerf_head_passes(int F, int Fh) {
  constexpr int V = Vec16<T>::N;
  return (max(F, Fh) + 32 * V - 1) / (32 * V);
}

// The pre-activations of sigma (h . w0) and rgb x 3 (r . w1:4) of the U
// points q0, q0 + stride, ... (those from `live` on skipped), summed over
// the warp: lane L holds pre[u] = point u's pre-activation L / 8 (warp_sum4).
// A lane takes one 16-byte chunk of h and one of r a pass, the U points'
// loads all issued before any product and kept raw until then, against the
// weight rows read as 16-byte chunks and unpacked once for the U points;
// passes: nerf_head_passes<T>(F, Fh).
template <typename T, int U>
__device__ __forceinline__ void nerf_point_heads(const T* __restrict__ h, int F,
                                                 const T* __restrict__ rf, int Fh, size_t q0,
                                                 int stride, int live, int vec, int passes,
                                                 HeadRows<T, true> w, int lane,
                                                 float (&pre)[U]) {
  constexpr int V = Vec16<T>::N;
  float part[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) part[u][0] = part[u][1] = part[u][2] = part[u][3] = 0.f;
  for (int pass = 0; pass < passes; ++pass) {
    const int k = (pass * 32 + lane) * V;
    uint4 xh[U], xr[U];  // raw until the products
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= live) break;
      const size_t q = q0 + (size_t)u * stride;
      if (k < F) xh[u] = row_chunk_raw<T>(h + q * F, k, F, vec);
      if (k < Fh) xr[u] = row_chunk_raw<T>(rf + q * Fh, k, Fh, vec);
    }
    if (k < F) {
      float ws[V], x[V];
      chunk_values<T>(weight_chunk(w, w.ws, k, F), ws);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        chunk_values<T>(xh[u], x);
#pragma unroll
        for (int i = 0; i < V; ++i) part[u][0] = fmaf(x[i], ws[i], part[u][0]);
      }
    }
    if (k < Fh) {
      float wc[3][V], x[V];
#pragma unroll
      for (int c = 0; c < 3; ++c) chunk_values<T>(weight_chunk(w, w.wh + c * w.ld, k, Fh), wc[c]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        chunk_values<T>(xr[u], x);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) part[u][1 + c] = fmaf(x[i], wc[c][i], part[u][1 + c]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) pre[u] = warp_sum4(part[u], lane);
}

}  // namespace

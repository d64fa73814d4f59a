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
//   sc_loss_bwd   sigma = softplus(h . w_sigma + b), sun_v = sigmoid(s2 .
//                 w_sun + b), alpha = 1 - exp(-delta * relu(sigma + noise)),
//                 T_i = prod_{k<i} (1 - alpha_k + 1e-10), w = alpha * T;
//                 sums[0] += sum_s (T - sun_v)^2, sums[1] += 1 - sum_s w *
//                 sun_v; the cotangent of sun_v is scale * (-2 (T - sun_v) -
//                 w) with scale = lambda / 3 / R (fused_mlp.py:1703-1705),
//                 taken through the sigmoid, rounded to the compute type and
//                 multiplied into d_s2 (P, Fh), dWn row 4 and dbn[4].
//
// T and w carry no gradient, so once T is known every sample's cotangent is
// independent of the others: no suffix sum, and the forward and the adjoint
// share one pass. Sigma gets no gradient: d_h of this stage is zero and no
// other narrow row moves. The TPU kernel forms T as exp(sum log(1 - alpha +
// 1e-10)); this one multiplies the factors, as heads_composite and
// render/composite.py do.
//
// One block of SCAN_THREADS a ray (common.cuh), in three phases:
//   A. the two heads of every sample: a warp takes SC_IN_FLIGHT neighbouring
//      samples at a time, a lane 16 bytes of each of their h and s2 rows (the
//      rows read whole, lanes on neighbouring addresses), every load issued
//      before the products, against w_sigma and w_sun staged once a block in
//      shared memory as floats; warp sums; sigma and sun_v into shared memory
//   B. a thread a sample of each chunk of SCAN_THREADS: alpha, T as a block
//      exclusive product of the fp32 factors (1 - alpha + 1e-10) carried from
//      chunk to chunk, w, the terms and the cotangent g, rounded into shared
//      memory; the ray's two terms and the sum of the unrounded g (dbn[4]) as
//      block sums, one atomicAdd each a ray. The product and the sums run in
//      double: in float a tree of products of factors near 1 drops the
//      second-order term of each (common.cuh), and dbn[4], a sum of terms of
//      both signs, magnifies what T loses
//   C. a warp a row of s2, SC_ROWS_IN_FLIGHT rows in flight, a lane 4
//      columns of each 128: d_s2 = round(g) w_sun as 16-byte fp32 stores,
//      each store instruction of the warp 512 contiguous bytes, and the
//      columns of dWn row 4, sum_q round(g_q) s2_q, in registers, then a row
//      a warp in shared memory, then a thread a column sums the warps' and
//      makes one atomicAdd a ray. s2 is read a second time here (from L2:
//      the ray's rows were read in A a few microseconds before) rather than
//      kept in shared memory, which would grow with S and cut the blocks an
//      SM holds.
//
// What bounds it: device memory. At 1,024 rays x 64 samples of the 8 x 512
// field in bf16 it reads h (67 MB, for one dot product a sample) and s2 (34
// MB) and writes d_s2 in fp32 (67 MB): 168 MB, 0.050 ms at 3.35 TB/s. The
// warp walk it replaced (a warp a ray, the samples in order, two serial warp
// reductions a sample) ran at 18 % of that (0.276 ms, PERF.md); here a ray's
// samples are all in flight at once and 1,024 blocks fill 132 SMs.
//
// Any S whose shared memory fits the 227 KB a block may opt into
// (sc_smem_floats; ops/fused_mlp.py sc_max_samples mirrors it: 18,416 at
// 8 x 512): past one chunk of SCAN_THREADS samples the MULTI instantiation
// carries the product from chunk to chunk. The sums over rays meet by fp32
// atomicAdd into buffers the wrapper zeroes, so the last bits change from
// run to run; T is the double product rounded once, so it differs from the
// walk's fp32 product in its last bits.
// vec: F and Fh multiples of 16 bytes' worth and h, s2, d_s2 16-byte
// aligned (else element loads and stores).

#include "common.cuh"
#include "hopper.cuh"

namespace {

// SATNERF_SC_ABLATE is 0 unless tools/profile_render_torch.py --heads builds
// this file with it, to time the kernel's parts alone: 1 drops C (no d_s2,
// no dWn row 4), 2 drops A's loads (dot products of nothing). The same tool
// builds it with other SATNERF_SC_IN_FLIGHT, SATNERF_SC_MIN_BLOCKS and
// SATNERF_SC_ROWS.
#ifndef SATNERF_SC_ABLATE
#define SATNERF_SC_ABLATE 0
#endif
#ifndef SATNERF_SC_IN_FLIGHT
#define SATNERF_SC_IN_FLIGHT 4
#endif
#ifndef SATNERF_SC_MIN_BLOCKS
#define SATNERF_SC_MIN_BLOCKS 2
#endif
#ifndef SATNERF_SC_ROWS
#define SATNERF_SC_ROWS 4
#endif

constexpr int SC_THREADS = SCAN_THREADS;
constexpr int SC_WARPS = SCAN_WARPS;
constexpr int SC_SUMS = 3;          // block sums: term 2, sum of w sun_v, dbn[4]
constexpr int SC_IN_FLIGHT = SATNERF_SC_IN_FLIGHT;  // samples a warp loads at once in A
constexpr int SC_ROWS_IN_FLIGHT = SATNERF_SC_ROWS;  // rows of s2 a warp reads at once in C
constexpr int SC_COL_GROUPS = 2;    // groups of 4 columns a lane takes in one pass of C
constexpr int SC_PASS_F = 512;      // features of h one pass of a lane's chunks covers (bf16)

// The shared memory of a block, in floats: the block scans' and sums'
// scratch (doubles), w_sigma and w_sun (rows padded to a multiple of 8), each
// warp's column sums of dWn row 4 (Fh padded), sigma, sun_v and the rounded
// cotangent a sample.
__host__ __device__ constexpr int sc_smem_floats(int F, int Fh, int S) {
  return 2 * block_scratch_floats(SC_SUMS) + (F + 7) / 8 * 8 +
         (1 + SC_WARPS) * ((Fh + 7) / 8 * 8) + 3 * S;
}

// v[0, N) = p[0, N), fp32 in shared memory, 16-byte aligned: N / 4 vector reads.
template <int N>
__device__ __forceinline__ void smem_floats(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}

// acc + the dot product of a raw chunk of V values with w[0, V), fp32 in
// shared memory, 16-byte aligned
template <typename T>
__device__ __forceinline__ float chunk_dot(const uint4& raw, const float* w, float acc) {
  constexpr int V = Vec16<T>::N;
  float x[V], wv[V];
  chunk_values<T>(raw, x);
  smem_floats<V>(w, wv);
#pragma unroll
  for (int i = 0; i < V; ++i) acc = fmaf(x[i], wv[i], acc);
  return acc;
}

// Registers for SATNERF_SC_MIN_BLOCKS blocks an SM (2: at most 128 a
// thread), so that a warp holds the rows of SC_IN_FLIGHT samples in flight
// in A as raw 16-byte chunks (4 registers each) until the products: 16
// warps an SM with four samples each ran faster than 32 with one or two
// (tools/profile_render_torch.py --heads; PERF.md section 6, PR 12). Two
// samples a warp at 64 registers spilled the loaded chunks, and a spill
// store waits for its load.
template <typename T, bool MULTI>
__global__ void __launch_bounds__(SC_THREADS, SATNERF_SC_MIN_BLOCKS)
sc_loss_bwd_block(const T* __restrict__ h, int F, const T* __restrict__ s2, int Fh,
                  const T* __restrict__ Wn, const float* __restrict__ bn,
                  const float* __restrict__ z, const float* __restrict__ noise, int S,
                  float scale, int vec, float* __restrict__ sums, float* __restrict__ d_s2,
                  float* __restrict__ dWn, float* __restrict__ dbn) {
  constexpr int V = Vec16<T>::N;
  // a lane's 16-byte chunks of h and of s2 in one pass: all of the 8 x 512
  // field's rows in bf16, half of them in fp32
  constexpr int CF = SC_PASS_F / (32 * 8), CH = CF / 2;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int Fp = (F + 7) / 8 * 8, Fhp = (Fh + 7) / 8 * 8;
  double* scratch = reinterpret_cast<double*>(smem);  // block_scratch_floats(SC_SUMS) doubles
  float* w_sig = smem + 2 * block_scratch_floats(SC_SUMS);  // Fp
  float* w_sun = w_sig + Fp;  // Fhp
  float* red = w_sun + Fhp;   // SC_WARPS x Fhp: each warp's columns of dWn row 4
  float* v_sig = red + SC_WARPS * Fhp;  // S
  float* v_sun = v_sig + S;   // S
  float* cot = v_sun + S;     // S: the cotangent of sun_v's pre-activation, rounded
  const size_t q0 = (size_t)blockIdx.x * S;  // the ray's first sample

  for (int i = tid; i < Fp; i += SC_THREADS) w_sig[i] = i < F ? to_f32<T>(Wn[i]) : 0.f;
  for (int i = tid; i < Fhp; i += SC_THREADS)
    w_sun[i] = i < Fh ? to_f32<T>(Wn[(size_t)4 * F + i]) : 0.f;
  for (int i = tid; i < SC_WARPS * Fhp; i += SC_THREADS) red[i] = 0.f;
  __syncthreads();

  // ---- A. sigma and sun_v of every sample
  const int passes = max((F + 32 * V * CF - 1) / (32 * V * CF),
                         (Fh + 32 * V * CH - 1) / (32 * V * CH));
  for (int s0 = warp * SC_IN_FLIGHT; s0 < S; s0 += SC_WARPS * SC_IN_FLIGHT) {
    float part[SC_IN_FLIGHT][2] = {};
    for (int pass = 0; pass < passes; ++pass) {
      uint4 xh[SC_IN_FLIGHT][CF], xs[SC_IN_FLIGHT][CH];  // raw until the products
#pragma unroll
      for (int j = 0; j < SC_IN_FLIGHT; ++j) {
        const size_t q = q0 + s0 + j;
        const bool live = s0 + j < S;
#pragma unroll
        for (int ci = 0; ci < CF; ++ci) {
          const int k = (pass * 32 * CF + lane + 32 * ci) * V;
          xh[j][ci] = make_uint4(0u, 0u, 0u, 0u);
          if (live && k < F && !(SATNERF_SC_ABLATE & 2))
            xh[j][ci] = row_chunk_raw<T>(h + q * F, k, F, vec);
        }
#pragma unroll
        for (int ci = 0; ci < CH; ++ci) {
          const int k = (pass * 32 * CH + lane + 32 * ci) * V;
          xs[j][ci] = make_uint4(0u, 0u, 0u, 0u);
          if (live && k < Fh && !(SATNERF_SC_ABLATE & 2))
            xs[j][ci] = row_chunk_raw<T>(s2 + q * Fh, k, Fh, vec);
        }
      }
#pragma unroll
      for (int j = 0; j < SC_IN_FLIGHT; ++j) {
        if (s0 + j >= S) continue;
#pragma unroll
        for (int ci = 0; ci < CF; ++ci) {
          const int k = (pass * 32 * CF + lane + 32 * ci) * V;
          if (k < F) part[j][0] = chunk_dot<T>(xh[j][ci], w_sig + k, part[j][0]);
        }
#pragma unroll
        for (int ci = 0; ci < CH; ++ci) {
          const int k = (pass * 32 * CH + lane + 32 * ci) * V;
          if (k < Fh) part[j][1] = chunk_dot<T>(xs[j][ci], w_sun + k, part[j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SC_IN_FLIGHT; ++j) {
      const float sig = warp_sum(part[j][0]), sun = warp_sum(part[j][1]);
      if (lane == 0 && s0 + j < S) {
        v_sig[s0 + j] = softplusf(sig + bn[0]);
        v_sun[s0 + j] = sigmoidf(sun + bn[4]);
      }
    }
  }
  __syncthreads();

  // ---- B. a thread a sample of each chunk: T, w, the terms, the cotangent;
  // the product, its carry and the sums in double (common.cuh)
  const float* zr = z + q0;
  const float* nr = noise != nullptr ? noise + q0 : nullptr;
  const int chunks = MULTI ? (S + SC_THREADS - 1) / SC_THREADS : 1;
  double acc[SC_SUMS] = {0.0, 0.0, 0.0};  // (T - sun_v)^2, w sun_v, g
  double carry = 1.0;  // the product of the earlier chunks' factors
  for (int c = 0; c < chunks; ++c) {
    const int s = c * SC_THREADS + tid;
    const bool mine = s < S;
    float sunv = 0.f, alpha = 0.f;
    if (mine) {
      sunv = v_sun[s];
      const float delta = s < S - 1 ? zr[s + 1] - zr[s] : 1e10f;
      const float sigma_n = v_sig[s] + (nr != nullptr ? nr[s] : 0.f);
      alpha = 1.f - expf(-delta * fmaxf(sigma_n, 0.f));
    }
    double total;
    const double prod = block_exclusive_product<double>(
        mine ? (double)(1.f - alpha + 1e-10f) : 1.0, scratch, MULTI ? &total : nullptr);
    const float tr = (float)(carry * prod);
    if (MULTI) carry = carry * total;
    if (mine) {
      const float w = alpha * tr;
      const float diff = tr - sunv;
      acc[0] += diff * diff;
      acc[1] += w * sunv;
      const float g = scale * (-2.f * diff - w) * sunv * (1.f - sunv);
      acc[2] += g;
      cot[s] = round_to<T>(g);
    }
  }
  block_sums<SC_SUMS, double>(acc, scratch);  // also makes the cotangents visible
  if (tid == 0) {
    atomicAdd(sums + 0, (float)acc[0]);
    atomicAdd(sums + 1, (float)(1.0 - acc[1]));
    atomicAdd(dbn + 4, (float)acc[2]);
  }

  // ---- C. d_s2 and dWn row 4: a warp a row, a lane a group of 4 columns in
  // each 128 (each store instruction of the warp writes 512 contiguous
  // bytes of d_s2); the warps' column sums meet in shared memory, a row a
  // warp, then a thread a column sums them and adds the ray's to dWn
  constexpr int U = SC_ROWS_IN_FLIGHT;
  using R4 = typename Raw4<T>::type;
  for (int kb = 0; kb < ((SATNERF_SC_ABLATE & 1) ? 0 : Fh); kb += 128 * SC_COL_GROUPS) {
    float a[SC_COL_GROUPS][4] = {}, wv[SC_COL_GROUPS][4] = {};
#pragma unroll
    for (int m = 0; m < SC_COL_GROUPS; ++m) {
      const int k = kb + 128 * m + 4 * lane;
      if (k < Fh) smem_floats<4>(w_sun + k, wv[m]);
    }
    for (int s0 = warp * U; s0 < S; s0 += SC_WARPS * U) {
      R4 xr[U][SC_COL_GROUPS];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < SC_COL_GROUPS; ++m) {
          const int k = kb + 128 * m + 4 * lane;
          if (k < Fh && s0 + u < S) xr[u][m] = row4_raw<T>(s2 + (q0 + s0 + u) * Fh, k, Fh, vec);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= S) continue;
        const float gb = cot[s0 + u];
#pragma unroll
        for (int m = 0; m < SC_COL_GROUPS; ++m) {
          const int k = kb + 128 * m + 4 * lane;
          if (k >= Fh) continue;
          float x[4], d[4];
          values4<T>(xr[u][m], x);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[m][i] = fmaf(gb, x[i], a[m][i]);
            d[i] = gb * wv[m][i];
          }
          store_chunk<4>(d_s2 + (q0 + s0 + u) * Fh, k, Fh, vec, d);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < SC_COL_GROUPS; ++m) {
      const int k = kb + 128 * m + 4 * lane;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k + i < Fh) red[warp * Fhp + k + i] = a[m][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < Fh; i += SC_THREADS) {
    float v = 0.f;
    for (int w = 0; w < SC_WARPS; ++w) v += red[w * Fhp + i];
    atomicAdd(dWn + (size_t)4 * F + i, v);
  }
}

template <typename T>
int launch_sc(const void* h, int F, const void* s2, int Fh, const void* Wn, const void* bn,
              const void* z, const void* noise, int R, int S, float scale, void* sums,
              void* d_s2, void* dWn, void* dbn, cudaStream_t st) {
  // S past what shared memory holds is refused (cudaErrorInvalidValue)
  const long long smem = (long long)sc_smem_floats(F, Fh, S) * sizeof(float);
  if (smem > hopper::SMEM_OPTIN_BYTES) return (int)cudaErrorInvalidValue;
  const bool multi = S > SC_THREADS;
  static int allowed[2] = {0, 0};  // what each instantiation has opted into
  const int err = multi ? hopper::allow_smem(sc_loss_bwd_block<T, true>, (int)smem, &allowed[1])
                        : hopper::allow_smem(sc_loss_bwd_block<T, false>, (int)smem, &allowed[0]);
  if (err != 0) return err;
  constexpr int V = Vec16<T>::N;
  const bool vec = F % V == 0 && Fh % V == 0 && hopper::aligned16(h) && hopper::aligned16(s2) &&
                   hopper::aligned16(d_s2);
  auto kernel = multi ? sc_loss_bwd_block<T, true> : sc_loss_bwd_block<T, false>;
  kernel<<<R, SC_THREADS, smem, st>>>(
      static_cast<const T*>(h), F, static_cast<const T*>(s2), Fh, static_cast<const T*>(Wn),
      static_cast<const float*>(bn), static_cast<const float*>(z),
      static_cast<const float*>(noise), S, scale, vec, static_cast<float*>(sums),
      static_cast<float*>(d_s2), static_cast<float*>(dWn), static_cast<float*>(dbn));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after its launch; the wrapper raises if it is
// not 0.
extern "C" int satnerf_sc_loss_bwd(int dtype, const void* h, int F, const void* s2, int Fh,
                                   const void* Wn, const void* bn, const void* z,
                                   const void* noise, int R, int S, float scale, void* sums,
                                   void* d_s2, void* dWn, void* dbn, void* stream) {
  if (F < 1 || Fh < 1 || Fh > F || S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sc<float>(h, F, s2, Fh, Wn, bn, z, noise, R, S, scale, sums, d_s2, dWn, dbn,
                            st);
  if (dtype == 1)
    return launch_sc<__nv_bfloat16>(h, F, s2, Fh, Wn, bn, z, noise, R, S, scale, sums, d_s2,
                                    dWn, dbn, st);
  return (int)cudaErrorInvalidValue;
}

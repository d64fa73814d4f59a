// The classic NeRF variant (positional encoding, ReLU trunk, view-direction
// rgb head) on Hopper.
//
// Replaces the four TPU kernels of satnerf_tpu/ops/pallas/fused_nerf.py:
// fused_nerf_train_loss_grads (:653, body _make_train_loss_bwd_kernel_nerf
// :594), fused_nerf_render_rays (:464, body _make_render_kernel_rays_nerf
// :442) and the forward and backward of fused_nerf_apply / fused_nerf_packed
// (:740, :286, bodies _make_fwd_kernel :180 and _make_bwd_kernel :257). Those
// keep every weight and a tile of activations in VMEM and run the field, the
// compositor and their adjoints in one launch. A block here has 227 KB of
// shared memory, so the field is a chain of GEMM launches with activations in
// device memory, as for the SIREN variants (fused_render.cu, fused_train.cu),
// and the per-ray and per-point stages are launches of their own:
//
//   nerf_dense            Y = act(X.W + b + enc.C), act relu or none. enc is
//                         the positional encoding of the sample point o + d*z
//                         (ENC_XYZ: layer 0, where there is no X, and the skip
//                         layer) or of the ray's direction (ENC_DIR: rgb_0),
//                         per frequency k the block [sin(2^k x) (3), cos(2^k x)
//                         (3)], fused_nerf.py _posenc :125. It is a second
//                         stretch of the product's depth whose A tile is
//                         computed from rays8 and z into shared memory: the
//                         encoded points never exist in device memory. sinf and
//                         cosf, not the fast intrinsics: the argument reaches
//                         512 |x|.
//   nerf_dense_dgrad      dX (+)= round(dY * [Y > 0]) . W^T. The relu's mask is
//                         read from the layer's stored output in the compute
//                         type (fused_nerf.py:222,243,252); no slope tensor is
//                         written. There is no gradient of enc: positions and
//                         directions are data.
//   nerf_dense_wgrad      dW = X^T . round(G), dC = enc^T . round(G) with the
//                         encoding tile computed again, db = sum G, where
//                         G = dY * [Y > 0] (Y absent: a linear layer).
//   nerf_heads_composite  a warp per ray: sigma head (softplus), rgb_1
//                         (sigmoid, padded), the compositor of
//                         _composite_tile_nerf :402 in order along the ray: no
//                         irradiance, no clip; out (R, 8) [rgb | depth |
//                         opacity] and on request the (R, S) weights.
//   nerf_composite_loss_bwd  the same walk, the squared error against gt, its
//                         adjoint g_rgb = 2 (rgb - gt) / (3 R), the compositor
//                         adjoint of _composite_bwd_tile_nerf :545 and the two
//                         narrow heads' backward: d_h (the sigma head's share),
//                         d_r, dWn, dbn.
//   nerf_field_heads      the two narrow heads per point, no compositor:
//                         out (P, 8) [rgb | sigma] (fused_nerf.py:188-190).
//   nerf_field_heads_bwd  their backward from a (P, 8) cotangent.
//
// The two backward kernels each have three mainloops and one rule, as the
// SIREN variants' (fused_train.cu): wgmma, the Hopper mainloops of
// dense_bwd_wgmma.cuh with the relu's mask read from a TMA-loaded bf16 tile
// of Y (the dgrad: four 40 KB stages; the wgrad: dW, dC against the
// encoding computed into shared memory, and db in its epilogue, one launch);
// wmma, warp-level tensor-core fragments with dC by a second launch and db
// by nerf_bias_grad; simt (fp32, other shapes).
//
// Operands are fp32 or bf16 (dtype 0 / 1), sums fp32. Rounding follows the
// TPU kernels: the encoding, every activation and every cotangent are rounded
// to the compute type before a product; bias gradients sum the unrounded
// cotangent. softplus' is -expm1f(-sigma): 1 - exp(-sigma), the form of
// fused_nerf.py:236, is 0 in fp32 below 1e-8, where a ray's last sample (delta
// 1e10) still has weight.
//
// What bounds them: the forward at K = N = 256 does 512 operations an output
// for 2 bytes written, above the card's ridge: the tensor cores bound it
// (bf16: WMMA m16n16k16 fragments, 128 x 128 x 32 tiles; fp32: a SIMT
// register-tiled GEMM that stays exact). Layer 0 has no X: its 64-deep product
// over a computed tile writes (P, N) and is bound by the stores and by sinf.
// The backward reads dY in fp32 and Y in bf16 (6 bytes a value) for 256 or
// 512 operations: device memory bounds it (0.050 ms for the dgrad, 0.040 for
// the skip layer's wgrad at 65,536 points).
// The per-ray and per-point kernels read h (F values) and r (Fh) a sample for
// a few operations a byte: device memory bounds them.
//
// Sums across blocks use fp32 atomicAdd into buffers the wrapper zeroes, so the
// last bits change from run to run. Rays and points past the end are masked
// here; the wrappers pad nothing.

#include "common.cuh"
#include "dense_bwd_wgmma.cuh"

namespace {

constexpr int NERF_RAY_COLS = 8;  // rays8 layout: o 0:3 | d 3:6 | 0
constexpr int NERF_COLS = 8;      // per ray: rgb 0:3 | depth 3 | opacity 4; per point: rgb 0:3 | sigma 3
enum { ENC_NONE = 0, ENC_XYZ = 1, ENC_DIR = 2 };

constexpr int SIMT_BK = 8, TM = 8, TN = 8;
constexpr int A_LD = TC_BK + 8;  // padded row of a [128][32] bf16 tile
constexpr int B_LD = BN + 8;     // padded row of a [32][128] bf16 tile

using bf16 = __nv_bfloat16;

// enc[q, j], rounded to the compute type; 0 from column 6 * n_freq on (the
// padding of C's rows).
template <typename T>
__device__ __forceinline__ float enc_value(const float* __restrict__ rays,
                                           const float* __restrict__ z, int S, int enc_mode,
                                           int n_freq, int q, int j) {
  if (j >= 6 * n_freq) return 0.f;
  const int k = j / 6, r = j % 6, c = r % 3;
  const float* ray = rays + (size_t)(q / S) * NERF_RAY_COLS;
  // o + d*z as a rounded product then a rounded sum (no fma), the two steps
  // the plain version takes; 2^k * x is exact
  const float x = enc_mode == ENC_XYZ ? __fadd_rn(ray[c], __fmul_rn(ray[3 + c], z[q]))
                                      : ray[3 + c];
  const float a = x * (float)(1 << k);
  return round_to<T>(r < 3 ? sinf(a) : cosf(a));
}

// G[p, n] = dY[p, n] where the layer's output Y[p, n] is positive, else 0;
// Y == nullptr for a linear layer.
template <typename T>
__device__ __forceinline__ float masked(const float* __restrict__ dY,
                                        const T* __restrict__ Y, size_t idx) {
  const float g = dY[idx];
  return (Y == nullptr || to_f32<T>(Y[idx]) > 0.f) ? g : 0.f;
}

__device__ __forceinline__ float4 masked4(const float* __restrict__ dY,
                                          const bf16* __restrict__ Y, size_t idx) {
  float4 g = *reinterpret_cast<const float4*>(dY + idx);
  if (Y != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(Y + idx);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    if (!(__low2float(lo) > 0.f)) g.x = 0.f;
    if (!(__high2float(lo) > 0.f)) g.y = 0.f;
    if (!(__low2float(hi) > 0.f)) g.z = 0.f;
    if (!(__high2float(hi) > 0.f)) g.w = 0.f;
  }
  return g;
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 g) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(g.x, g.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(g.z, g.w);
  uint2 r;
  r.x = *reinterpret_cast<const unsigned int*>(&lo);
  r.y = *reinterpret_cast<const unsigned int*>(&hi);
  return r;
}

// One SIMT_BK-deep step of the register-tiled product: acc += As^T . Bs.
__device__ __forceinline__ void simt_products(float (&acc)[TM][TN],
                                              float (*As)[BM], float (*Bs)[BN],
                                              int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < SIMT_BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// One TC_BK-deep step on the tensor cores. 8 warps as 4 (rows) x 2 (cols),
// each with 2 x 4 accumulator fragments of the 128 x 128 tile. As [m][k] row
// major, Bs [k][n] row major.
__device__ __forceinline__ void wmma_products(AccFrag (&acc)[2][4], bf16 (*As)[A_LD],
                                              bf16 (*Bs)[B_LD], int wm, int wn) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < TC_BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 64 + j * 16], B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// ----------------------------------------------------------------- nerf_dense
//
// Replaces the trunk and wide-head matmuls of fused_nerf.py _forward :142.
// Y[q, n] = act(sum_k X[q, k] W[k, n] + sum_j enc[q, j] C[j, n] + b[n]). C has
// e_rows rows, zero from row 6 * n_freq on.

template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
nerf_dense_simt(const T* __restrict__ X, int K, const T* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ rays,
                const float* __restrict__ z, int S, int enc_mode, int n_freq, int e_rows,
                const T* __restrict__ C, int act, T* __restrict__ Y, int P, int N) {
  __shared__ float As[SIMT_BK][BM];
  __shared__ float Bs[SIMT_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int am = tid / 2, akb = (tid % 2) * 4;    // A tile: row, first of 4 depths
  const int bk = tid / 32, bnb = (tid % 32) * 4;  // B tile: depth, first of 4 columns
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SIMT_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + akb + i, gn = col0 + bnb + i;
      As[akb + i][am] = (row0 + am < P && gk < K) ? to_f32<T>(X[(size_t)(row0 + am) * K + gk]) : 0.f;
      Bs[bk][bnb + i] = (k0 + bk < K && gn < N) ? to_f32<T>(W[(size_t)(k0 + bk) * N + gn]) : 0.f;
    }
    __syncthreads();
    simt_products(acc, As, Bs, tx, ty);
    __syncthreads();
  }
  if (enc_mode != ENC_NONE) {
    for (int e0 = 0; e0 < e_rows; e0 += SIMT_BK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = e0 + akb + i, gn = col0 + bnb + i;
        As[akb + i][am] = (row0 + am < P && j < e_rows)
                              ? enc_value<T>(rays, z, S, enc_mode, n_freq, row0 + am, j) : 0.f;
        Bs[bk][bnb + i] = (e0 + bk < e_rows && gn < N) ? to_f32<T>(C[(size_t)(e0 + bk) * N + gn]) : 0.f;
      }
      __syncthreads();
      simt_products(acc, As, Bs, tx, ty);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = row0 + ty + 16 * i;
    if (q >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= N) continue;
      const float v = acc[i][j] + bias[n];
      Y[(size_t)q * N + n] = from_f32<T>(act == ACT_RELU ? fmaxf(v, 0.f) : v);
    }
  }
}

// bf16 on the tensor cores; K, N multiples of 8, e_rows a multiple of TC_BK.
__global__ void __launch_bounds__(DENSE_THREADS)
nerf_dense_wmma(const bf16* __restrict__ X, int K, const bf16* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ rays,
                const float* __restrict__ z, int S, int enc_mode, int n_freq, int e_rows,
                const bf16* __restrict__ C, int act, bf16* __restrict__ Y, int P, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BM][A_LD];
  __shared__ __align__(32) bf16 Bs[TC_BK][B_LD];
  __shared__ __align__(32) float Stage[DENSE_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // each thread moves two 16-byte vectors (8 bf16) of A and two of B a tile
  uint4 ra[2], rb[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int ar = v / (TC_BK / 8), ac = (v % (TC_BK / 8)) * 8;
      const bool a_in = row0 + ar < P && k0 + ac < K;
      ra[i] = a_in ? *reinterpret_cast<const uint4*>(X + (size_t)(row0 + ar) * K + k0 + ac)
                   : make_uint4(0, 0, 0, 0);
      const int br = v / (BN / 8), bc = (v % (BN / 8)) * 8;
      const bool b_in = k0 + br < K && col0 + bc < N;
      rb[i] = b_in ? *reinterpret_cast<const uint4*>(W + (size_t)(k0 + br) * N + col0 + bc)
                   : make_uint4(0, 0, 0, 0);
    }
  };

  if (K > 0) load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += TC_BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      *reinterpret_cast<uint4*>(&As[v / (TC_BK / 8)][(v % (TC_BK / 8)) * 8]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[v / (BN / 8)][(v % (BN / 8)) * 8]) = rb[i];
    }
    __syncthreads();
    if (k0 + TC_BK < K) load_tiles(k0 + TC_BK);  // in flight during the products
    wmma_products(acc, As, Bs, wm, wn);
    __syncthreads();
  }
  // the encoding's stretch of the depth: the A tile is computed, not loaded
  if (enc_mode != ENC_NONE) {
    for (int e0 = 0; e0 < e_rows; e0 += TC_BK) {
      for (int idx = tid; idx < BM * TC_BK; idx += DENSE_THREADS) {
        const int m = idx / TC_BK, j = idx % TC_BK;
        const int q = row0 + m;
        As[m][j] = __float2bfloat16_rn(
            q < P ? enc_value<bf16>(rays, z, S, enc_mode, n_freq, q, e0 + j) : 0.f);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + DENSE_THREADS * i;
        const int br = v / (BN / 8), bc = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[br][bc]) =
            col0 + bc < N ? *reinterpret_cast<const uint4*>(C + (size_t)(e0 + br) * N + col0 + bc)
                          : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
      wmma_products(acc, As, Bs, wm, wn);
      __syncthreads();
    }
  }

  float* stage = Stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int q = row0 + wm * 32 + i * 16 + e / 16;
        const int n = col0 + wn * 64 + j * 16 + e % 16;
        if (q < P && n < N) {
          const float v = stage[e] + bias[n];
          Y[(size_t)q * N + n] = __float2bfloat16_rn(act == ACT_RELU ? fmaxf(v, 0.f) : v);
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------- nerf_dense_dgrad
//
// dX[p, k] (+)= sum_n round(G[p, n]) * W[k, n], the _dot_t_rhs products of
// fused_nerf.py _point_bwd_from_saves :195. W is the forward's (K, N) weight.
// Where two branches meet (d_h: the sigma head's share and the feats layer's)
// the launch accumulates onto what is there. The wgmma mainloop is
// dgrad_wgmma<G_RELU> (dense_bwd_wgmma.cuh); the two below have a
// one-dimensional grid, the column tile running fastest, so the blocks that
// share a row tile of dY find it in L2.

template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
nerf_dgrad_simt(const float* __restrict__ dY, const T* __restrict__ Ymask,
                const T* __restrict__ W, float* __restrict__ dX, int accumulate, int P, int N,
                int K) {
  __shared__ float As[SIMT_BK][BM];  // G tile, n-major
  __shared__ float Bs[SIMT_BK][BN];  // W^T tile: Bs[n][k]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col_tiles = (K + BN - 1) / BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;  // points
  const int col0 = (blockIdx.x % col_tiles) * BN;  // k
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += SIMT_BK) {
    const int m = tid / 2, nb = (tid % 2) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + nb + i;
      const int q = row0 + m, gk = col0 + m;
      const float g = (q < P && gn < N) ? masked<T>(dY, Ymask, (size_t)q * N + gn) : 0.f;
      As[nb + i][m] = round_to<T>(g);
      Bs[nb + i][m] = (gk < K && gn < N) ? to_f32<T>(W[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
    simt_products(acc, As, Bs, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = row0 + ty + 16 * i;
    if (q >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = col0 + tx + 16 * j;
      if (k >= K) continue;
      float* out = dX + (size_t)q * K + k;
      *out = accumulate ? *out + acc[i][j] : acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(DENSE_THREADS)
nerf_dgrad_wmma(const float* __restrict__ dY, const bf16* __restrict__ Ymask,
                const bf16* __restrict__ W, float* __restrict__ dX, int accumulate, int P,
                int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 Gs[BM][A_LD];  // G tile [p][n]
  __shared__ __align__(32) bf16 Ws[BN][A_LD];  // W tile [k][n]
  __shared__ __align__(32) float Stage[DENSE_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int col_tiles = (K + BN - 1) / BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int col0 = (blockIdx.x % col_tiles) * BN;

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // a thread moves four float4 of G (16 values) and two 16-byte vectors of W
  float4 rg[4];
  uint4 rw[2];
  auto load_tiles = [&](int n0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int r = v / (TC_BK / 4), c = (v % (TC_BK / 4)) * 4;
      rg[i] = (row0 + r < P && n0 + c < N) ? masked4(dY, Ymask, (size_t)(row0 + r) * N + n0 + c)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int r = v / (TC_BK / 8), c = (v % (TC_BK / 8)) * 8;
      rw[i] = (col0 + r < K && n0 + c < N)
                  ? *reinterpret_cast<const uint4*>(W + (size_t)(col0 + r) * N + n0 + c)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  load_tiles(0);
  for (int n0 = 0; n0 < N; n0 += TC_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + DENSE_THREADS * i;
      *reinterpret_cast<uint2*>(&Gs[v / (TC_BK / 4)][(v % (TC_BK / 4)) * 4]) = pack_bf16x4(rg[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      *reinterpret_cast<uint4*>(&Ws[v / (TC_BK / 8)][(v % (TC_BK / 8)) * 8]) = rw[i];
    }
    __syncthreads();
    if (n0 + TC_BK < N) load_tiles(n0 + TC_BK);
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      // W^T as a column-major B: element (n, k) sits at Ws[k][n]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &Gs[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Ws[wn * 64 + j * 16][kk], A_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* stage = Stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int q = row0 + wm * 32 + i * 16 + e / 16;
        const int k = col0 + wn * 64 + j * 16 + e % 16;
        if (q < P && k < K) {
          float* out = dX + (size_t)q * K + k;
          *out = accumulate ? *out + stage[e] : stage[e];
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------- nerf_dense_wgrad
//
// dW[k, n] += sum_p X[p, k] * round(G[p, n]), the _dot_t_lhs products of
// fused_nerf.py:220-253. The wgmma mainloop (wgrad_wgmma<G_RELU, ...> of
// dense_bwd_wgmma.cuh) forms dW, dC and db in one launch. The two below are
// the wmma and simt mainloops. The sum runs over all P points for K*N
// outputs, so the points are split across blockIdx.z (`split` a block, a
// multiple of TC_BK) and the partial tiles meet in dW by fp32 atomicAdd. The
// ENC instantiations take the left operand from the positional encoding,
// computed again from rays8 and z: that is dC (dA at layer 0, dC at the skip layer,
// dWrgb0d at rgb_0). Its output has one row tile only (64 or 32 rows), so it
// takes a finer split to fill the card, and sinf / cosf set its time.
// nerf_bias_grad sums the unrounded G over a chunk of points, one thread a
// column.

constexpr int WGRAD_SPLIT = 2048;
constexpr int ENC_WGRAD_SPLIT = 512;
constexpr int BIAS_THREADS = 128;
constexpr int BIAS_CHUNK = 64;

template <typename T, bool ENC>
__global__ void __launch_bounds__(DENSE_THREADS)
nerf_wgrad_simt(const T* __restrict__ X, const float* __restrict__ dY,
                const T* __restrict__ Ymask, const float* __restrict__ rays,
                const float* __restrict__ z, int S, int enc_mode, int n_freq,
                float* __restrict__ dW, int P, int N, int K, int split) {
  __shared__ float As[SIMT_BK][BM];  // X^T tile: As[p][k]
  __shared__ float Bs[SIMT_BK][BN];  // G tile: Bs[p][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;  // k
  const int col0 = blockIdx.y * BN;  // n
  const int p_begin = blockIdx.z * split;
  const int p_end = min(P, p_begin + split);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += SIMT_BK) {
    const int pp = tid / 32, cb = (tid % 32) * 4;
    const int q = p0 + pp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = row0 + cb + i, gn = col0 + cb + i;
      float x = 0.f;
      if (q < p_end && gk < K) {
        if constexpr (ENC) x = enc_value<T>(rays, z, S, enc_mode, n_freq, q, gk);
        else x = to_f32<T>(X[(size_t)q * K + gk]);
      }
      As[pp][cb + i] = x;
      const float g = (q < p_end && gn < N) ? masked<T>(dY, Ymask, (size_t)q * N + gn) : 0.f;
      Bs[pp][cb + i] = round_to<T>(g);
    }
    __syncthreads();
    simt_products(acc, As, Bs, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = row0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < N) atomicAdd(dW + (size_t)k * N + n, acc[i][j]);
    }
  }
}

template <bool ENC>
__global__ void __launch_bounds__(DENSE_THREADS)
nerf_wgrad_wmma(const bf16* __restrict__ X, const float* __restrict__ dY,
                const bf16* __restrict__ Ymask, const float* __restrict__ rays,
                const float* __restrict__ z, int S, int enc_mode, int n_freq,
                float* __restrict__ dW, int P, int N, int K, int split) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 Xs[TC_BK][B_LD];  // X tile [p][k]
  __shared__ __align__(32) bf16 Gs[TC_BK][B_LD];  // G tile [p][n]
  __shared__ __align__(32) float Stage[DENSE_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.x * BM;  // k
  const int col0 = blockIdx.y * BN;  // n
  const int p_begin = blockIdx.z * split;
  const int p_end = min(P, p_begin + split);

  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 rx[2];
  float4 rg[4];
  auto load_tiles = [&](int p0) {
    if constexpr (!ENC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + DENSE_THREADS * i;
        const int r = v / (BM / 8), c = (v % (BM / 8)) * 8;
        rx[i] = (p0 + r < p_end && row0 + c < K)
                    ? *reinterpret_cast<const uint4*>(X + (size_t)(p0 + r) * K + row0 + c)
                    : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      rg[i] = (p0 + r < p_end && col0 + c < N)
                  ? masked4(dY, Ymask, (size_t)(p0 + r) * N + col0 + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  load_tiles(p_begin);
  for (int p0 = p_begin; p0 < p_end; p0 += TC_BK) {
    if constexpr (ENC) {  // the encoding of this tile's points, computed in place
      for (int idx = tid; idx < TC_BK * BM; idx += DENSE_THREADS) {
        const int r = idx / BM, c = idx % BM;
        const int q = p0 + r, j = row0 + c;
        Xs[r][c] = __float2bfloat16_rn(
            (q < p_end && j < K) ? enc_value<bf16>(rays, z, S, enc_mode, n_freq, q, j) : 0.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + DENSE_THREADS * i;
        *reinterpret_cast<uint4*>(&Xs[v / (BM / 8)][(v % (BM / 8)) * 8]) = rx[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + DENSE_THREADS * i;
      *reinterpret_cast<uint2*>(&Gs[v / (BN / 4)][(v % (BN / 4)) * 4]) = pack_bf16x4(rg[i]);
    }
    __syncthreads();
    if (p0 + TC_BK < p_end) load_tiles(p0 + TC_BK);
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      // X^T as a column-major A: element (k, p) sits at Xs[p][k]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &Xs[kk][wm * 32 + i * 16], B_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Gs[kk][wn * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* stage = Stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int k = row0 + wm * 32 + i * 16 + e / 16;
        const int n = col0 + wn * 64 + j * 16 + e % 16;
        if (k < K && n < N) atomicAdd(dW + (size_t)k * N + n, stage[e]);
      }
      __syncwarp();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BIAS_THREADS)
nerf_bias_grad(const float* __restrict__ dY, const T* __restrict__ Ymask, int P, int N,
               float* __restrict__ db) {
  const int n = blockIdx.y * BIAS_THREADS + threadIdx.x;
  if (n >= N) return;  // no barrier below
  const int p_begin = blockIdx.x * BIAS_CHUNK;
  const int p_end = min(P, p_begin + BIAS_CHUNK);
  float s = 0.f;
  for (int p = p_begin; p < p_end; ++p) s += masked<T>(dY, Ymask, (size_t)p * N + n);
  atomicAdd(db + n, s);
}

// The wgmma wgrad's encoding operand (dense_bwd_wgmma.cuh wgrad_wgmma): the
// position point q's encoding is computed from, o + d*z (ENC_XYZ) or d
// (ENC_DIR), as enc_value takes it; 0 past the last point. The kernel turns
// it into the tile of sines and cosines.
struct PosEncoding {
  const float* rays;
  const float* z;
  int S, enc_mode, n_freq, P;

  __device__ __forceinline__ float coord(int q, int c) const {
    if (q >= P) return 0.f;
    const float* ray = rays + (size_t)(q / S) * NERF_RAY_COLS;
    return enc_mode == ENC_XYZ ? __fadd_rn(ray[c], __fmul_rn(ray[3 + c], z[q])) : ray[3 + c];
  }
};

// ------------------------------------------------------- nerf_heads_composite
//
// Replaces the narrow heads of fused_nerf.py _forward :162-173 and the
// compositor _composite_tile_nerf :402. One warp per ray: for each of the
// ray's S samples the sigma head (from h) and rgb_1 (from r) as warp-reduced
// dot products, then all lanes advance the compositor in fp32 along S in
// order. The TPU kernel's log-space cumprod on the MXU is not carried over:
// the product is taken directly, as render/composite.py does. Wn packs the
// narrow weights as (4, F) rows in the compute type: 0 sigma (length F), 1:4
// rgb_1 (length Fh); bn their 4 biases in fp32. NOISE (a template parameter:
// the serving instantiation carries no trace of it) adds a per-sample noise
// to sigma before the relu.

constexpr int NH_WARPS = 4;

template <typename T, bool NOISE>
__global__ void __launch_bounds__(NH_WARPS * 32)
nerf_heads_composite_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                            const T* __restrict__ Wn, const float* __restrict__ bn,
                            const float* __restrict__ z, const float* __restrict__ noise,
                            int R, int S, float rgb_padding, float* __restrict__ out,
                            float* __restrict__ weights) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * NH_WARPS + threadIdx.x / 32;
  if (ray >= R) return;  // the whole warp leaves together
  const T* w_sig = Wn;
  const T* w_rgb = Wn + (size_t)F;
  const float pad2 = 1.f + 2.f * rgb_padding;
  const float* zr = z + (size_t)ray * S;

  float trans = 1.f, depth = 0.f, opacity = 0.f, rgb_acc[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const size_t q = (size_t)ray * S + s;
    float sig = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    const T* hq = h + q * F;
    for (int k = lane; k < F; k += 32) sig = fmaf(to_f32<T>(hq[k]), to_f32<T>(w_sig[k]), sig);
    const T* rq = rf + q * Fh;
    for (int k = lane; k < Fh; k += 32) {
      const float v = to_f32<T>(rq[k]);
      c0 = fmaf(v, to_f32<T>(w_rgb[k]), c0);
      c1 = fmaf(v, to_f32<T>(w_rgb[(size_t)F + k]), c1);
      c2 = fmaf(v, to_f32<T>(w_rgb[(size_t)2 * F + k]), c2);
    }
    const float sigma = softplusf(warp_sum(sig) + bn[0]);
    const float rgb[3] = {sigmoidf(warp_sum(c0) + bn[1]) * pad2 - rgb_padding,
                          sigmoidf(warp_sum(c1) + bn[2]) * pad2 - rgb_padding,
                          sigmoidf(warp_sum(c2) + bn[3]) * pad2 - rgb_padding};
    const float zs = zr[s];
    const float delta = s < S - 1 ? zr[s + 1] - zs : 1e10f;
    float sigma_n = sigma;
    if constexpr (NOISE) sigma_n += noise[q];
    const float alpha = 1.f - expf(-delta * fmaxf(sigma_n, 0.f));
    const float w = alpha * trans;
    trans *= 1.f - alpha + 1e-10f;
    depth += w * zs;
    opacity += w;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb_acc[c] += w * rgb[c];
    if (weights != nullptr && lane == 0) weights[q] = w;
  }
  if (lane < NERF_COLS) {
    float v = 0.f;
    if (lane < 3) v = lane == 0 ? rgb_acc[0] : (lane == 1 ? rgb_acc[1] : rgb_acc[2]);
    else if (lane == 3) v = depth;
    else if (lane == 4) v = opacity;
    out[(size_t)ray * NERF_COLS + lane] = v;
  }
}

// ---------------------------------------------------- nerf_composite_loss_bwd
//
// Replaces, of fused_nerf.py:594: the narrow heads forward, the compositor
// with sigma noise, the squared error and its adjoint (:626-644), the
// compositor adjoint _composite_bwd_tile_nerf :545 and the head part of
// _point_bwd_from_saves :216-239. One warp per ray:
//   1. forward over the ray's S samples; per-sample values go to shared memory
//   2. sq = |rgb - gt|^2 added to loss_sum; g_rgb = 2 (rgb - gt) / (3 R), R
//      the number of rays (none is padded)
//   3. backward from the last sample to the first, carrying the suffix sum of
//      dw * w: d_alpha = dw * T - suffix / (1 - alpha + 1e-10), masked where
//      sigma + noise <= 0; the two pre-activation cotangents, rounded to the
//      compute type before both of their products, give the rows of dWn (in
//      registers over the ray) and d_h (the sigma head's share), d_r in fp32
// The quotient is large but finite where alpha saturates (the last sample's
// delta is 1e10), and its product with 1 - alpha is then exactly 0.

constexpr int NCL_WARPS = 4;
constexpr int NCL_MAX_F = 512;  // widest trunk the register rows hold
constexpr int NCL_F_REGS = NCL_MAX_F / 32;
constexpr int NCL_H_REGS = NCL_F_REGS / 2;
constexpr int NCL_SAMPLE_VALS = 8;  // sigma, delta, 1-alpha, T, w, rgb_s x3

template <typename T>
__global__ void __launch_bounds__(NCL_WARPS * 32)
nerf_composite_loss_bwd_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf,
                               int Fh, const T* __restrict__ Wn, const float* __restrict__ bn,
                               const float* __restrict__ z, const float* __restrict__ noise,
                               const float* __restrict__ gt, int R, int S, float rgb_padding,
                               float* __restrict__ loss_sum, float* __restrict__ d_h,
                               float* __restrict__ d_r, float* __restrict__ dWn,
                               float* __restrict__ dbn) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int ray = blockIdx.x * NCL_WARPS + warp;
  if (ray >= R) return;  // the whole warp leaves together; no block barrier below
  float* sv = smem + (size_t)warp * NCL_SAMPLE_VALS * S;
  float* v_sigma = sv;          float* v_delta = sv + S;     float* v_oma = sv + 2 * S;
  float* v_trans = sv + 3 * S;  float* v_w = sv + 4 * S;     float* v_c0 = sv + 5 * S;
  float* v_c1 = sv + 6 * S;     float* v_c2 = sv + 7 * S;

  const T* w_sig = Wn;
  const T* w_rgb = Wn + (size_t)F;
  const float pad2 = 1.f + 2.f * rgb_padding;
  const float* zr = z + (size_t)ray * S;

  // ---- 1. forward
  float trans = 1.f, rgb_acc[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const size_t q = (size_t)ray * S + s;
    float sig = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    const T* hq = h + q * F;
    for (int k = lane; k < F; k += 32) sig = fmaf(to_f32<T>(hq[k]), to_f32<T>(w_sig[k]), sig);
    const T* rq = rf + q * Fh;
    for (int k = lane; k < Fh; k += 32) {
      const float v = to_f32<T>(rq[k]);
      c0 = fmaf(v, to_f32<T>(w_rgb[k]), c0);
      c1 = fmaf(v, to_f32<T>(w_rgb[(size_t)F + k]), c1);
      c2 = fmaf(v, to_f32<T>(w_rgb[(size_t)2 * F + k]), c2);
    }
    const float sigma = softplusf(warp_sum(sig) + bn[0]);
    const float cs[3] = {sigmoidf(warp_sum(c0) + bn[1]), sigmoidf(warp_sum(c1) + bn[2]),
                         sigmoidf(warp_sum(c2) + bn[3])};
    const float zs = zr[s];
    const float delta = s < S - 1 ? zr[s + 1] - zs : 1e10f;
    const float sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    const float oma = expf(-delta * fmaxf(sigma_n, 0.f));  // 1 - alpha
    const float alpha = 1.f - oma;
    const float w = alpha * trans;
    if (lane == 0) {
      v_sigma[s] = sigma; v_delta[s] = delta; v_oma[s] = oma; v_trans[s] = trans;
      v_w[s] = w; v_c0[s] = cs[0]; v_c1[s] = cs[1]; v_c2[s] = cs[2];
    }
    trans *= 1.f - alpha + 1e-10f;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb_acc[c] += w * (cs[c] * pad2 - rgb_padding);
  }
  __syncwarp();

  // ---- 2. the loss and the ray's cotangent
  float g_rgb[3], sq_err = 0.f;
  const float scale = 2.f / (3.f * (float)R);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float diff = rgb_acc[c] - gt[(size_t)ray * 3 + c];
    sq_err += diff * diff;
    g_rgb[c] = diff * scale;
  }
  if (lane == 0) atomicAdd(loss_sum, sq_err);

  // ---- 3. backward over the samples
  float a_sig[NCL_F_REGS], a_rgb[3][NCL_H_REGS];
#pragma unroll
  for (int i = 0; i < NCL_F_REGS; ++i) a_sig[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NCL_H_REGS; ++i) a_rgb[0][i] = a_rgb[1][i] = a_rgb[2][i] = 0.f;
  float b_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float suffix = 0.f;  // sum over later samples of dw * w

  for (int s = S - 1; s >= 0; --s) {
    const size_t q = (size_t)ray * S + s;
    const float sigma = v_sigma[s], delta = v_delta[s], oma = v_oma[s];
    const float tr = v_trans[s], w = v_w[s];
    const float cs[3] = {v_c0[s], v_c1[s], v_c2[s]};
    float dw = 0.f, g_pre_rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dw += (cs[c] * pad2 - rgb_padding) * g_rgb[c];
      g_pre_rgb[c] = w * g_rgb[c] * pad2 * cs[c] * (1.f - cs[c]);
    }
    // the factor the forward multiplied the transparency by, formed the same way
    const float d_alpha = dw * tr - suffix / (1.f - (1.f - oma) + 1e-10f);
    suffix += dw * w;
    const float sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    const float d_sn = sigma_n > 0.f ? d_alpha * oma * delta : 0.f;
    const float g_pre_sig = d_sn * -expm1f(-sigma);

    b_acc[0] += g_pre_sig;
    b_acc[1] += g_pre_rgb[0]; b_acc[2] += g_pre_rgb[1]; b_acc[3] += g_pre_rgb[2];
    const float gb_sig = round_to<T>(g_pre_sig);
    const float gb_rgb[3] = {round_to<T>(g_pre_rgb[0]), round_to<T>(g_pre_rgb[1]),
                             round_to<T>(g_pre_rgb[2])};

    const T* hq = h + q * F;
    float* dhq = d_h + q * F;
#pragma unroll
    for (int i = 0; i < NCL_F_REGS; ++i) {
      const int k = lane + 32 * i;
      if (k < F) {
        a_sig[i] = fmaf(gb_sig, to_f32<T>(hq[k]), a_sig[i]);
        dhq[k] = gb_sig * to_f32<T>(w_sig[k]);
      }
    }
    const T* rq = rf + q * Fh;
#pragma unroll
    for (int i = 0; i < NCL_H_REGS; ++i) {
      const int k = lane + 32 * i;
      if (k < Fh) {
        const float rv = to_f32<T>(rq[k]);
        float dr = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a_rgb[c][i] = fmaf(gb_rgb[c], rv, a_rgb[c][i]);
          dr = fmaf(gb_rgb[c], to_f32<T>(w_rgb[(size_t)c * F + k]), dr);
        }
        d_r[q * Fh + k] = dr;
      }
    }
  }

  // ---- the ray's share of dWn and dbn
#pragma unroll
  for (int i = 0; i < NCL_F_REGS; ++i) {
    const int k = lane + 32 * i;
    if (k < F) atomicAdd(dWn + k, a_sig[i]);
  }
#pragma unroll
  for (int i = 0; i < NCL_H_REGS; ++i) {
    const int k = lane + 32 * i;
    if (k < Fh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(dWn + (size_t)(1 + c) * F + k, a_rgb[c][i]);
    }
  }
  if (lane < 4) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == lane) v = b_acc[j];
    atomicAdd(dbn + lane, v);
  }
}

// ------------------------------------------- nerf_field_heads and its backward
//
// Replaces the narrow heads of fused_nerf.py _make_fwd_kernel :180 and the
// head part of _make_bwd_kernel :257 (_point_bwd_from_saves :216-239). The
// points are independent, so a warp takes one point at a time as warp-reduced
// dot products and a block of eight warps walks 128 points, each lane keeping
// its columns of the narrow weights and of the dWn rows in registers. The
// block's dWn and dbn meet in shared memory and leave as one atomicAdd per
// entry and block.

constexpr int NF_WARPS = 8;
constexpr int NF_PTS = 16;  // points a warp walks
constexpr int NF_MAX_F = 512;
constexpr int NF_F_REGS = NF_MAX_F / 32;
constexpr int NF_H_REGS = NF_F_REGS / 2;

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

template <typename T>
__global__ void __launch_bounds__(NF_WARPS * 32)
nerf_field_heads_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                        const T* __restrict__ Wn, const float* __restrict__ bn, int P,
                        float rgb_padding, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  float w_sig[NF_F_REGS], w_rgb[3][NF_H_REGS];
  load_row<T>(Wn, F, lane, w_sig);
#pragma unroll
  for (int c = 0; c < 3; ++c) load_row<T>(Wn + (size_t)(1 + c) * F, Fh, lane, w_rgb[c]);
  const float pad2 = 1.f + 2.f * rgb_padding;

  const long long q0 = ((long long)blockIdx.x * NF_WARPS + warp) * NF_PTS;
  for (int i = 0; i < NF_PTS; ++i) {
    const long long q = q0 + i;
    if (q >= P) break;  // the whole warp leaves together
    float hv[NF_F_REGS], rv[NF_H_REGS];
    load_row<T>(h + (size_t)q * F, F, lane, hv);
    load_row<T>(rf + (size_t)q * Fh, Fh, lane, rv);
    const float sigma = softplusf(dot_row(hv, w_sig) + bn[0]);
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = sigmoidf(dot_row(rv, w_rgb[c]) + bn[1 + c]) * pad2 - rgb_padding;
    if (lane < NERF_COLS) {
      float v = 0.f;
      if (lane < 3) v = lane == 0 ? rgb[0] : (lane == 1 ? rgb[1] : rgb[2]);
      else if (lane == 3) v = sigma;
      out[(size_t)q * NERF_COLS + lane] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NF_WARPS * 32)
nerf_field_heads_bwd_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                            const T* __restrict__ Wn, const float* __restrict__ bn,
                            const float* __restrict__ g, int P, float rgb_padding,
                            float* __restrict__ d_h, float* __restrict__ d_r,
                            float* __restrict__ dWn, float* __restrict__ dbn) {
  // the block's share of dWn: sigma (F) | rgb x3 (Fh each)
  __shared__ float red[NF_MAX_F + 3 * (NF_MAX_F / 2)];
  __shared__ float red_b[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int n_red = F + 3 * Fh;
  for (int i = threadIdx.x; i < n_red; i += NF_WARPS * 32) red[i] = 0.f;
  if (threadIdx.x < 4) red_b[threadIdx.x] = 0.f;
  __syncthreads();

  float w_sig[NF_F_REGS], w_rgb[3][NF_H_REGS];
  load_row<T>(Wn, F, lane, w_sig);
#pragma unroll
  for (int c = 0; c < 3; ++c) load_row<T>(Wn + (size_t)(1 + c) * F, Fh, lane, w_rgb[c]);
  const float pad2 = 1.f + 2.f * rgb_padding;

  float a_sig[NF_F_REGS], a_rgb[3][NF_H_REGS];
#pragma unroll
  for (int i = 0; i < NF_F_REGS; ++i) a_sig[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NF_H_REGS; ++i) a_rgb[0][i] = a_rgb[1][i] = a_rgb[2][i] = 0.f;
  float b_sig = 0.f, b_rgb[3] = {0.f, 0.f, 0.f};

  const long long q0 = ((long long)blockIdx.x * NF_WARPS + warp) * NF_PTS;
  for (int i = 0; i < NF_PTS; ++i) {
    const long long q = q0 + i;
    if (q >= P) break;  // the whole warp leaves the loop together
    float hv[NF_F_REGS], rv[NF_H_REGS];
    load_row<T>(h + (size_t)q * F, F, lane, hv);
    load_row<T>(rf + (size_t)q * Fh, Fh, lane, rv);
    const float sigma = softplusf(dot_row(hv, w_sig) + bn[0]);
    const float* gq = g + (size_t)q * NERF_COLS;
    float gb_rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float cs = sigmoidf(dot_row(rv, w_rgb[c]) + bn[1 + c]);
      const float g_pre = gq[c] * pad2 * cs * (1.f - cs);
      b_rgb[c] += g_pre;
      gb_rgb[c] = round_to<T>(g_pre);
    }
    const float g_pre_sig = gq[3] * -expm1f(-sigma);
    b_sig += g_pre_sig;
    const float gb_sig = round_to<T>(g_pre_sig);

    float* dhq = d_h + (size_t)q * F;
#pragma unroll
    for (int j = 0; j < NF_F_REGS; ++j) {
      const int k = lane + 32 * j;
      if (k < F) {
        a_sig[j] = fmaf(gb_sig, hv[j], a_sig[j]);
        dhq[k] = gb_sig * w_sig[j];
      }
    }
    const size_t qh = (size_t)q * Fh;
#pragma unroll
    for (int j = 0; j < NF_H_REGS; ++j) {
      const int k = lane + 32 * j;
      if (k < Fh) {
        float dr = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a_rgb[c][j] = fmaf(gb_rgb[c], rv[j], a_rgb[c][j]);
          dr = fmaf(gb_rgb[c], w_rgb[c][j], dr);
        }
        d_r[qh + k] = dr;
      }
    }
  }

  // the warps' sums meet in shared memory, then one atomic per entry and block
#pragma unroll
  for (int j = 0; j < NF_F_REGS; ++j) {
    const int k = lane + 32 * j;
    if (k < F) atomicAdd(&red[k], a_sig[j]);
  }
#pragma unroll
  for (int j = 0; j < NF_H_REGS; ++j) {
    const int k = lane + 32 * j;
    if (k < Fh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(&red[F + c * Fh + k], a_rgb[c][j]);
    }
  }
  if (lane == 0) {
    atomicAdd(&red_b[0], b_sig);
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(&red_b[1 + c], b_rgb[c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_red; i += NF_WARPS * 32) {
    // red index -> (row of dWn, column)
    const int row = i < F ? 0 : 1 + (i - F) / Fh;
    const int k = i < F ? i : (i - F) % Fh;
    atomicAdd(dWn + (size_t)row * F + k, red[i]);
  }
  if (threadIdx.x < 4) atomicAdd(dbn + threadIdx.x, red_b[threadIdx.x]);
}

bool narrow_shapes_ok(int F, int Fh) {
  return F >= 1 && F <= NCL_MAX_F && Fh >= 1 && Fh <= NCL_MAX_F / 2 && Fh <= F;
}

template <typename T> const T* as(const void* p) { return static_cast<const T*>(p); }
float* out_f32(void* p) { return static_cast<float*>(p); }

template <typename T>
int launch_nerf_heads(const void* h, int F, const void* rf, int Fh, const void* Wn,
                      const void* bn, const void* z, const void* noise, int R, int S,
                      float rgb_padding, void* out, void* weights, cudaStream_t st) {
  const int grid = (R + NH_WARPS - 1) / NH_WARPS;
  if (noise != nullptr) {
    nerf_heads_composite_kernel<T, true><<<grid, NH_WARPS * 32, 0, st>>>(
        as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), as<float>(z), as<float>(noise), R,
        S, rgb_padding, out_f32(out), out_f32(weights));
  } else {
    nerf_heads_composite_kernel<T, false><<<grid, NH_WARPS * 32, 0, st>>>(
        as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), as<float>(z), nullptr, R, S,
        rgb_padding, out_f32(out), out_f32(weights));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nerf_wgrad(const void* X, int K, const void* dY, const void* Ymask, const void* rays,
                      const void* z, int S, int enc_mode, int n_freq, int e_rows, void* dW,
                      void* db, void* dC, int P, int N, bool tensor_cores, cudaStream_t st) {
  const float* dy = as<float>(dY);
  if ((P + ENC_WGRAD_SPLIT - 1) / ENC_WGRAD_SPLIT > 65535)  // the grid's z extent
    return (int)cudaErrorInvalidValue;
  if (K > 0) {  // dW = X^T . G
    const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, (P + WGRAD_SPLIT - 1) / WGRAD_SPLIT);
    if (tensor_cores)  // only ever set for bf16
      nerf_wgrad_wmma<false><<<grid, DENSE_THREADS, 0, st>>>(
          as<bf16>(X), dy, as<bf16>(Ymask), nullptr, nullptr, S, ENC_NONE, 0, out_f32(dW), P, N,
          K, WGRAD_SPLIT);
    else
      nerf_wgrad_simt<T, false><<<grid, DENSE_THREADS, 0, st>>>(
          as<T>(X), dy, as<T>(Ymask), nullptr, nullptr, S, ENC_NONE, 0, out_f32(dW), P, N, K,
          WGRAD_SPLIT);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (enc_mode != ENC_NONE) {  // dC = enc^T . G, the encoding's rows in place of K
    const dim3 grid((e_rows + BM - 1) / BM, (N + BN - 1) / BN,
                    (P + ENC_WGRAD_SPLIT - 1) / ENC_WGRAD_SPLIT);
    if (tensor_cores)
      nerf_wgrad_wmma<true><<<grid, DENSE_THREADS, 0, st>>>(
          nullptr, dy, as<bf16>(Ymask), as<float>(rays), as<float>(z), S, enc_mode, n_freq,
          out_f32(dC), P, N, e_rows, ENC_WGRAD_SPLIT);
    else
      nerf_wgrad_simt<T, true><<<grid, DENSE_THREADS, 0, st>>>(
          nullptr, dy, as<T>(Ymask), as<float>(rays), as<float>(z), S, enc_mode, n_freq,
          out_f32(dC), P, N, e_rows, ENC_WGRAD_SPLIT);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 bgrid((P + BIAS_CHUNK - 1) / BIAS_CHUNK, (N + BIAS_THREADS - 1) / BIAS_THREADS);
  nerf_bias_grad<T><<<bgrid, BIAS_THREADS, 0, st>>>(dy, as<T>(Ymask), P, N, out_f32(db));
  return (int)cudaGetLastError();
}

// The wgmma wgrad: dW (K > 0), dC against the encoding (e_rows 32 or 64)
// and db in one launch.
int launch_nerf_wgrad_wgmma(const void* X, int K, const void* dY, const void* Ymask,
                            const void* rays, const void* z, int S, int enc_mode, int n_freq,
                            int e_rows, void* dW, void* db, void* dC, int P, int N, int split,
                            cudaStream_t st) {
  const bf16* x = as<bf16>(X);
  const float* dy = as<float>(dY);
  float *dw = out_f32(dW), *dbias = out_f32(db), *dc = out_f32(dC);
  if (enc_mode == ENC_NONE)
    return launch_wgrad_wgmma<G_RELU, 0>(st, x, dy, Ymask, dw, dbias, nullptr, NoEncoding{}, P,
                                         N, K, split);
  const PosEncoding enc{as<float>(rays), as<float>(z), S, enc_mode, n_freq, P};
  return e_rows == 64 ? launch_wgrad_wgmma<G_RELU, 64>(st, x, dy, Ymask, dw, dbias, dc, enc, P, N,
                                                       K, split)
                      : launch_wgrad_wgmma<G_RELU, 32>(st, x, dy, Ymask, dw, dbias, dc, enc, P, N,
                                                       K, split);
}

bool aligned16(const void* a, const void* b = nullptr, const void* c = nullptr,
               const void* d = nullptr) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16 == 0;
}

}  // namespace

// ------------------------------------------------------------- C entry points
// Each returns cudaGetLastError() after its launches; the wrapper raises if it
// is not 0. P = R * S points, ray-major; S = 1 makes every point its own ray.

extern "C" int satnerf_nerf_dense(int dtype, const void* X, int K, const void* W,
                                  const void* bias, const void* rays, const void* z, int S,
                                  int enc_mode, int n_freq, int e_rows, const void* C, int act,
                                  void* Y, int P, int N, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (S < 1 || (act != ACT_NONE && act != ACT_RELU)) return (int)cudaErrorInvalidValue;
  if (enc_mode != ENC_NONE && (n_freq < 1 || n_freq > 16 || e_rows < 6 * n_freq))
    return (int)cudaErrorInvalidValue;
  if (K == 0 && enc_mode == ENC_NONE) return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((P + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = as<float>(bias);
  const float* r = as<float>(rays);
  const float* zz = as<float>(z);
  if (dtype == 0) {
    nerf_dense_simt<float><<<grid, DENSE_THREADS, 0, st>>>(
        as<float>(X), K, as<float>(W), b, r, zz, S, enc_mode, n_freq, e_rows, as<float>(C), act,
        static_cast<float*>(Y), P, N);
  } else if (K % 8 == 0 && N % 8 == 0 && aligned16(X, W, C) &&
             (enc_mode == ENC_NONE || e_rows % TC_BK == 0)) {
    nerf_dense_wmma<<<grid, DENSE_THREADS, 0, st>>>(
        as<bf16>(X), K, as<bf16>(W), b, r, zz, S, enc_mode, n_freq, e_rows, as<bf16>(C), act,
        static_cast<bf16*>(Y), P, N);
  } else {
    nerf_dense_simt<bf16><<<grid, DENSE_THREADS, 0, st>>>(
        as<bf16>(X), K, as<bf16>(W), b, r, zz, S, enc_mode, n_freq, e_rows, as<bf16>(C), act,
        static_cast<bf16*>(Y), P, N);
  }
  return (int)cudaGetLastError();
}

// The mainloop rule of a launch of nerf_dense_dgrad (mainloop =
// MAINLOOP_RULE); ops/fused_mlp.py dense_mainloop is the same rule in Python:
//   wgmma  bf16, N and K multiples of 64; dY, Ymask, W and dX 16-byte aligned
//   wmma   bf16, N a multiple of 8; dY, Ymask and W 16-byte aligned
//   simt   any other shape (and fp32 always)
// MAINLOOP_WMMA / MAINLOOP_WGMMA ask for one; a launch it cannot take is
// refused with cudaErrorInvalidValue, never sent to another mainloop.
extern "C" int satnerf_nerf_dense_dgrad(int dtype, const void* dY, const void* Ymask,
                                        const void* W, void* dX, int accumulate, int P, int N,
                                        int K, int mainloop, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (mainloop < MAINLOOP_RULE || mainloop > MAINLOOP_WGMMA) return (int)cudaErrorInvalidValue;
  const bool in_ok = aligned16(dY, Ymask, W);
  const bool tc_ok = dtype == 1 && N % 8 == 0 && in_ok;
  const bool wg_ok = dtype == 1 && N % 64 == 0 && K % 64 == 0 && in_ok && aligned16(dX);
  if ((mainloop == MAINLOOP_WMMA && !tc_ok) || (mainloop == MAINLOOP_WGMMA && !wg_ok))
    return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_RULE)
    mainloop = wg_ok ? MAINLOOP_WGMMA : tc_ok ? MAINLOOP_WMMA : MAINLOOP_RULE;
  if (P == 0 || N == 0 || K == 0) return (int)cudaSuccess;
  const long long tiles = (long long)((P + BM - 1) / BM) * ((K + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = as<float>(dY);
  float* dx = static_cast<float*>(dX);
  if (dtype == 0) {
    nerf_dgrad_simt<float><<<grid, DENSE_THREADS, 0, st>>>(dy, as<float>(Ymask), as<float>(W),
                                                           dx, accumulate, P, N, K);
  } else if (mainloop == MAINLOOP_WGMMA) {
    return launch_dgrad_wgmma<G_RELU>(st, dy, Ymask, as<bf16>(W), dx, accumulate, P, N, K);
  } else if (mainloop == MAINLOOP_WMMA) {
    nerf_dgrad_wmma<<<grid, DENSE_THREADS, 0, st>>>(dy, as<bf16>(Ymask), as<bf16>(W), dx,
                                                    accumulate, P, N, K);
  } else {
    nerf_dgrad_simt<bf16><<<grid, DENSE_THREADS, 0, st>>>(dy, as<bf16>(Ymask), as<bf16>(W), dx,
                                                          accumulate, P, N, K);
  }
  return (int)cudaGetLastError();
}

// The mainloop rule of a launch of nerf_dense_wgrad (mainloop =
// MAINLOOP_RULE); ops/fused_mlp.py dense_mainloop is the same rule in Python:
//   wgmma  bf16, K and N multiples of 64 (K = 0 too: layer 0, the encoding
//          alone); with an encoding, e_rows 32 or 64; X, dY and Ymask 16-byte
//          aligned
//   wmma   bf16, K and N multiples of 8; the same pointers aligned
//   simt   any other shape (and fp32 always)
// MAINLOOP_WMMA / MAINLOOP_WGMMA ask for one; a launch it cannot take is
// refused with cudaErrorInvalidValue, never sent to another mainloop.
// split: points a block of the wgmma mainloop, a positive multiple of WGR_P
// (the wrapper's rule, ops/fused_mlp.py wgrad_split). bias: whether
// nerf_bias_grad runs and sums db, which must be 0 on wgmma (its epilogue
// sums db) and 1 otherwise (ops/fused_nerf.py nerf_bias_grad_runs).
extern "C" int satnerf_nerf_dense_wgrad(int dtype, const void* X, int K, const void* dY,
                                        const void* Ymask, const void* rays, const void* z,
                                        int S, int enc_mode, int n_freq, int e_rows, void* dW,
                                        void* db, void* dC, int P, int N, int mainloop,
                                        int split, int bias, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (S < 1 || (enc_mode != ENC_NONE && (n_freq < 1 || n_freq > 16 || e_rows < 6 * n_freq)))
    return (int)cudaErrorInvalidValue;
  if (K == 0 && enc_mode == ENC_NONE) return (int)cudaErrorInvalidValue;
  if (mainloop < MAINLOOP_RULE || mainloop > MAINLOOP_WGMMA) return (int)cudaErrorInvalidValue;
  const bool in_ok = aligned16(dY, Ymask, X);
  const bool tc_ok = dtype == 1 && K % 8 == 0 && N % 8 == 0 && in_ok;
  const bool enc_ok = enc_mode == ENC_NONE || e_rows == 32 || e_rows == 64;
  const bool wg_ok = dtype == 1 && K % 64 == 0 && N % 64 == 0 && enc_ok && in_ok;
  if ((mainloop == MAINLOOP_WMMA && !tc_ok) || (mainloop == MAINLOOP_WGMMA && !wg_ok))
    return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_RULE)
    mainloop = wg_ok ? MAINLOOP_WGMMA : tc_ok ? MAINLOOP_WMMA : MAINLOOP_RULE;
  if (bias != (mainloop == MAINLOOP_WGMMA ? 0 : 1)) return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_WGMMA && (split <= 0 || split % WGR_P != 0))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nerf_wgrad<float>(X, K, dY, Ymask, rays, z, S, enc_mode, n_freq, e_rows, dW,
                                    db, dC, P, N, false, st);
  if (mainloop == MAINLOOP_WGMMA)
    return launch_nerf_wgrad_wgmma(X, K, dY, Ymask, rays, z, S, enc_mode, n_freq, e_rows, dW, db,
                                   dC, P, N, split, st);
  return launch_nerf_wgrad<bf16>(X, K, dY, Ymask, rays, z, S, enc_mode, n_freq, e_rows, dW, db,
                                 dC, P, N, mainloop == MAINLOOP_WMMA, st);
}

extern "C" int satnerf_nerf_heads_composite(int dtype, const void* h, int F, const void* rf,
                                            int Fh, const void* Wn, const void* bn,
                                            const void* z, const void* noise, int R, int S,
                                            float rgb_padding, void* out, void* weights,
                                            void* stream) {
  if (!narrow_shapes_ok(F, Fh) || S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nerf_heads<float>(h, F, rf, Fh, Wn, bn, z, noise, R, S, rgb_padding, out,
                                    weights, st);
  if (dtype == 1)
    return launch_nerf_heads<bf16>(h, F, rf, Fh, Wn, bn, z, noise, R, S, rgb_padding, out,
                                   weights, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int satnerf_nerf_composite_loss_bwd(int dtype, const void* h, int F, const void* rf,
                                               int Fh, const void* Wn, const void* bn,
                                               const void* z, const void* noise, const void* gt,
                                               int R, int S, float rgb_padding, void* loss_sum,
                                               void* d_h, void* d_r, void* dWn, void* dbn,
                                               void* stream) {
  if (!narrow_shapes_ok(F, Fh) || S < 1 || gt == nullptr || loss_sum == nullptr)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int grid = (R + NCL_WARPS - 1) / NCL_WARPS;
  const size_t smem = (size_t)NCL_WARPS * NCL_SAMPLE_VALS * S * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    nerf_composite_loss_bwd_kernel<float><<<grid, NCL_WARPS * 32, smem, st>>>(
        as<float>(h), F, as<float>(rf), Fh, as<float>(Wn), as<float>(bn), as<float>(z),
        as<float>(noise), as<float>(gt), R, S, rgb_padding, out_f32(loss_sum), out_f32(d_h),
        out_f32(d_r), out_f32(dWn), out_f32(dbn));
  } else if (dtype == 1) {
    nerf_composite_loss_bwd_kernel<bf16><<<grid, NCL_WARPS * 32, smem, st>>>(
        as<bf16>(h), F, as<bf16>(rf), Fh, as<bf16>(Wn), as<float>(bn), as<float>(z),
        as<float>(noise), as<float>(gt), R, S, rgb_padding, out_f32(loss_sum), out_f32(d_h),
        out_f32(d_r), out_f32(dWn), out_f32(dbn));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int satnerf_nerf_field_heads(int dtype, const void* h, int F, const void* rf, int Fh,
                                        const void* Wn, const void* bn, int P,
                                        float rgb_padding, void* out, void* stream) {
  if (!narrow_shapes_ok(F, Fh) || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_block = NF_WARPS * NF_PTS;
  const int grid = (int)(((long long)P + per_block - 1) / per_block);
  if (dtype == 0) {
    nerf_field_heads_kernel<float><<<grid, NF_WARPS * 32, 0, st>>>(
        as<float>(h), F, as<float>(rf), Fh, as<float>(Wn), as<float>(bn), P, rgb_padding,
        out_f32(out));
  } else if (dtype == 1) {
    nerf_field_heads_kernel<bf16><<<grid, NF_WARPS * 32, 0, st>>>(
        as<bf16>(h), F, as<bf16>(rf), Fh, as<bf16>(Wn), as<float>(bn), P, rgb_padding,
        out_f32(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int satnerf_nerf_field_heads_bwd(int dtype, const void* h, int F, const void* rf,
                                            int Fh, const void* Wn, const void* bn,
                                            const void* g, int P, float rgb_padding, void* d_h,
                                            void* d_r, void* dWn, void* dbn, void* stream) {
  if (!narrow_shapes_ok(F, Fh) || P < 0 || g == nullptr) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_block = NF_WARPS * NF_PTS;
  const int grid = (int)(((long long)P + per_block - 1) / per_block);
  if (dtype == 0) {
    nerf_field_heads_bwd_kernel<float><<<grid, NF_WARPS * 32, 0, st>>>(
        as<float>(h), F, as<float>(rf), Fh, as<float>(Wn), as<float>(bn), as<float>(g), P,
        rgb_padding, out_f32(d_h), out_f32(d_r), out_f32(dWn), out_f32(dbn));
  } else if (dtype == 1) {
    nerf_field_heads_bwd_kernel<bf16><<<grid, NF_WARPS * 32, 0, st>>>(
        as<bf16>(h), F, as<bf16>(rf), Fh, as<bf16>(Wn), as<float>(bn), as<float>(g), P,
        rgb_padding, out_f32(d_h), out_f32(d_r), out_f32(dWn), out_f32(dbn));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

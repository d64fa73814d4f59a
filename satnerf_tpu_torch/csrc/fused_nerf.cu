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
//                         cosf (on wgmma libdevice's sincosf written out), not
//                         the fast intrinsics: the argument reaches 512 |x|.
//   nerf_dense_dgrad      dX (+)= round(dY * [Y > 0]) . W^T. The relu's mask is
//                         read from the layer's stored output in the compute
//                         type (fused_nerf.py:222,243,252); no slope tensor is
//                         written. There is no gradient of enc: positions and
//                         directions are data.
//   nerf_dense_wgrad      dW = X^T . round(G), dC = enc^T . round(G) with the
//                         encoding tile computed again, db = sum G, where
//                         G = dY * [Y > 0] (Y absent: a linear layer).
//   nerf_heads_composite  a block scan (nerf_heads_scan): sigma head
//                         (softplus), rgb_1 (sigmoid, padded), a warp a
//                         sample, then the compositor of _composite_tile_nerf
//                         :402 a thread a sample, T a product scan segmented
//                         by ray over chunks of 256 samples: no irradiance,
//                         no clip; out (R, 8) [rgb | depth | opacity] and on
//                         request the (R, S) weights.
//   nerf_composite_loss_bwd  a block a ray (nerf_composite_loss_bwd_block):
//                         the same forward, the squared error against gt, its
//                         adjoint g_rgb = 2 (rgb - gt) / (3 R), the compositor
//                         adjoint of _composite_bwd_tile_nerf :545 as a
//                         suffix scan and the two narrow heads' backward: d_h
//                         (the sigma head's share), d_r, dWn, dbn.
//   nerf_field_heads      the two narrow heads per point, no compositor, a
//                         streaming kernel (nerf_field_heads_stream): out
//                         (P, 8) [rgb | sigma] (fused_nerf.py:188-190).
//   nerf_field_heads_bwd  their backward from a (P, 8) cotangent, streaming
//                         on a persistent grid (nerf_field_heads_bwd_stream):
//                         d_h, d_r, dWn, dbn.
//
// The dense kernels each have three mainloops and one rule, as the SIREN
// variants' (fused_render.cu, fused_train.cu). nerf_dense: wgmma
// (nerf_dense_wgmma below, siren_dense_wgmma's persistent TMA-fed layout with
// the encoding a k tile computed into shared memory), wmma, simt. The two
// backward kernels: wgmma, the Hopper mainloops of
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
// What bounds them: the forward at K = N = 256 does K N / (K + N) = 128
// operations a byte of X read and Y written, below the card's ridge (about
// 295): device memory bounds it (1.29 ms for the skip layer at a 4.19
// M-point serving chunk, PERF.md), then the encoding's sines. Its three
// mainloops have one rule (satnerf_nerf_dense): wgmma (nerf_dense_wgmma, a
// Hopper mainloop fed by TMA, the encoding a k tile computed into shared
// memory), wmma (WMMA m16n16k16 fragments, 128 x 128 x 32 tiles, the
// encoding computed element by element by every column tile), simt (fp32 and
// other shapes: a register-tiled GEMM that stays exact). Layer 0 has no X:
// its 64-deep product over the encoding writes (P, N), bound by the stores
// and the sines.
// The backward reads dY in fp32 and Y in bf16 (6 bytes a value) for 256 or
// 512 operations: device memory bounds it (0.050 ms for the dgrad, 0.040 for
// the skip layer's wgrad at 65,536 points).
// The per-ray and per-point kernels read h (F values) and r (Fh) a sample for
// a few operations a byte: device memory bounds them.
//
// Sums across blocks use fp32 atomicAdd into buffers the wrapper zeroes, so the
// last bits change from run to run. Rays and points past the end are masked
// here; the wrappers pad nothing.

#include <algorithm>

#include "common.cuh"
#include "dense_bwd_wgmma.cuh"
#include "heads.cuh"

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

// ----------------------------------------------------- nerf_dense on wgmma
//
// siren_dense_wgmma's persistent layout (fused_render.cu) with the positional
// encoding as one more k tile that is computed, not loaded. A block keeps a
// 128-column slice of W (K x 128 bf16, 64 KB at K = 256) and of C (the
// encoding's e_rows x 128) in shared memory for its whole life; a producer
// warp streams 64 x 64 X stages through a ring by TMA, and three consumer
// warpgroups take the block's 64-row tiles in turn. Before its turn a
// warpgroup writes its tile's encoding (64 points x 64 columns, bf16) into
// shared memory in the layout of an X stage, from positions it loaded while
// its previous tile ran, so the sines overlap the other warpgroups'
// products. Its mainloop is the X stages' m64n128k16 products, then the
// encoding's (four k16 steps for 64 rows, two for 32) against C; the
// epilogue adds the bias, takes the relu and stores Y as 16-byte vectors: it
// is far lighter than siren_dense's sine, so the products, the loads and
// the sines set the pace. ENC_DIR encodes the ray's direction, the same for
// all of the ray's samples: the sines of each ray a tile touches are
// computed once into a row buffer and copied to the ray's rows. At K = 0
// (layer 0) the encoding is the whole product: no X stage, no turns.
//
// Each point's 6 n_freq sines are computed once a column slice, twice at
// N = 256. A 256-column slice, each point's sines computed once (W at 128 KB,
// 128 accumulators a thread, two consumer warpgroups), ran the 4.19 M-point
// skip layer in 2.40-2.43 ms against 2.28-2.29 on an H100 (PERF.md section 6):
// two warpgroups hide less of the epilogue and the encoding than three.

// SATNERF_NERF_ABLATE is 0 unless tools/profile_render_torch.py --model nerf
// --ablate builds this file with it, to time the kernel's parts alone: 1
// drops the encoding's sines (the tile stays zero: products, loads and the
// epilogue alone), 2 the products, the X and W loads and the epilogue (the
// encoding alone: the positions' loads, the sines, the tiles' barriers).
#ifndef SATNERF_NERF_ABLATE
#define SATNERF_NERF_ABLATE 0
#endif

constexpr int NDW_BM = 64;           // rows of a warpgroup's tile
constexpr int NDW_BN = 128;          // the block's slice of W's and C's columns
constexpr int NDW_BK = 64;           // depth of an X stage, a W chunk, the encoding tile
constexpr int NDW_MAX_K = 512;       // the W slice must fit shared memory
constexpr int NDW_MAX_STAGES = 8;
constexpr int NDW_WG = 128;
constexpr int NDW_NC = 3;                           // consumer warpgroups
constexpr int NDW_THREADS = NDW_NC * NDW_WG + 32;   // and a producer warp
constexpr int NDW_TILE = NDW_BM * NDW_BK * 2;       // 8 KB: an X stage, an encoding tile
constexpr int NDW_W_BOX = NDW_BK * 64 * 2;          // 64 rows of W x 64 columns
constexpr int NDW_W_CHUNK = NDW_BN / 64 * NDW_W_BOX;  // 64 rows of W x the slice

// The fixed part of the shared memory; the W slice (K / 64 chunks) and the
// ring of X stages follow it, as many stages as fit (at most 8).
struct NdwSmem {
  __nv_bfloat16 c[NDW_BK * NDW_BN];               // C's slice, two 64-column boxes
  __nv_bfloat16 enc[NDW_NC][NDW_BM * NDW_BK];     // each warpgroup's encoding tile
  __nv_bfloat16 rows[NDW_NC][NDW_BM * NDW_BK];    // ENC_DIR: a ray's values a row
  float bias[NDW_BN];
  uint64_t full[NDW_MAX_STAGES], empty[NDW_MAX_STAGES], w_full;
  uint64_t turn[NDW_NC];  // warpgroup w may start its next mainloop
};
constexpr int NDW_FIXED = ((int)sizeof(NdwSmem) + 1023) / 1024 * 1024;

// Columns [32 H + 16 Q, 32 H + 16 Q + 16) of the positional encoding of one
// position x (fused_nerf.py _posenc: per frequency k the block
// [sin(2^k x) (3), cos(2^k x) (3)], zero from column 6 n_freq on), rounded to
// bf16, into two 16-byte chunks of row p of dst (128-byte rows, with the
// 128-byte swizzle of an X stage, or plain). The columns' places are known at
// compile time, so the values stay in registers and the stores are 16 bytes
// wide. libdevice's sincosf written out (common.cuh sincosf_fast) where every
// argument lies below TRIG_FAST_LIMIT, the library's call otherwise: the
// argument reaches 512 |x|.
template <int H, int Q>
__device__ __forceinline__ void ndw_enc_chunks(uint8_t* dst, int p, bool swizzle,
                                               const float (&x)[3], int n_freq) {
  constexpr int J0 = 32 * H + 16 * Q;
  // the frequencies these columns hold; 64 columns hold at most 10
  constexpr int K0 = J0 / 6, K1 = (J0 + 15) / 6 < 9 ? (J0 + 15) / 6 : 9;
  constexpr int NK = K1 - K0 + 1;
  float arg[NK][3], sn[NK + 1][3], cs[NK + 1][3];
  bool fast = true;
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // exact: a power of two; 0 past n_freq (those columns are zero)
      arg[i][c] = K0 + i < n_freq ? x[c] * (float)(1 << (K0 + i)) : 0.f;
      fast = fast && !(fabsf(arg[i][c]) >= TRIG_FAST_LIMIT);
    }
  if (__builtin_expect(fast, 1)) {
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) sincosf_fast(arg[i][c], sn[i][c], cs[i][c]);
  } else {
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) sincosf(arg[i][c], &sn[i][c], &cs[i][c]);
  }
  uint32_t w[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = J0 + 2 * m + e, k = j / 6, r = j % 6;
      v[e] = k > K1 || k >= n_freq ? 0.f : r < 3 ? sn[k - K0][r] : cs[k - K0][r - 3];
    }
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[0], v[1]);
    w[m] = *reinterpret_cast<const uint32_t*>(&b);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = 4 * H + 2 * Q + h;
    *reinterpret_cast<uint4*>(dst + p * 128 + ((swizzle ? ch ^ (p & 7) : ch) << 4)) =
        make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
  }
}

// Half H of row p's encoding (32 columns), in two passes of 16 columns.
template <int H>
__device__ __forceinline__ void ndw_enc_half(uint8_t* dst, int p, bool swizzle,
                                             const float (&x)[3], int n_freq) {
  ndw_enc_chunks<H, 0>(dst, p, swizzle, x, n_freq);
  ndw_enc_chunks<H, 1>(dst, p, swizzle, x, n_freq);
}

// e_rows: C's rows, 0 (no encoding), 32 or 64; `enc` gives the positions
// (PosEncoding::coord for ENC_XYZ, the rays' directions for ENC_DIR) and P.
__global__ void __launch_bounds__(NDW_THREADS, 1)
nerf_dense_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c, int K, int e_rows,
                 const float* __restrict__ bias, const PosEncoding enc, int act,
                 __nv_bfloat16* __restrict__ Y, int N, int stages) {
  using namespace hopper;
  constexpr int NC = NDW_NC, W_CHUNK = NDW_W_CHUNK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  NdwSmem& sm = *reinterpret_cast<NdwSmem*>(base);
  uint8_t* w_smem = base + NDW_FIXED;
  const int k_blocks = SATNERF_NERF_ABLATE == 2 ? 0 : K / NDW_BK;
  uint8_t* x_smem = w_smem + k_blocks * W_CHUNK;
  const int P = enc.P, S = enc.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // block b keeps column slice b % col_tiles and walks the row tiles
  // b / col_tiles, + row_step, ...: tile o of the block is its o-th of those
  const int col_tiles = (N + NDW_BN - 1) / NDW_BN;
  const int row_tiles = (P + NDW_BM - 1) / NDW_BM;
  const int col0 = (blockIdx.x % col_tiles) * NDW_BN;
  const int first_row = blockIdx.x / col_tiles, row_step = gridDim.x / col_tiles;
  const int n_tiles = (row_tiles - first_row + row_step - 1) / row_step;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NDW_WG);
    }
    mbar_init(&sm.w_full, 1);
    for (int w = 0; w < NC; ++w) mbar_init(&sm.turn[w], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NC * 4) {  // producer: one lane issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.w_full, k_blocks * W_CHUNK + e_rows * NDW_BN * 2);
      for (int kb = 0; kb < k_blocks; ++kb)
        for (int b = 0; b < NDW_BN / 64; ++b)
          tma_load_2d(w_smem + kb * W_CHUNK + b * NDW_W_BOX, &map_w, &sm.w_full, col0 + 64 * b,
                      kb * NDW_BK);
      if (e_rows > 0)  // C's rows in the first e_rows of each 64-row box
        for (int b = 0; b < NDW_BN / 64; ++b)
          tma_load_2d(reinterpret_cast<uint8_t*>(sm.c) + b * NDW_W_BOX, &map_c, &sm.w_full,
                      col0 + 64 * b, 0);
      // X position p = o k_blocks + kb (the block's tile o, depth block kb)
      // goes to stage p % stages
      int stage = 0;
      uint32_t phase = 0;
      for (int o = 0; o < n_tiles && k_blocks > 0; ++o) {
        const int row0 = (first_row + o * row_step) * NDW_BM;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&sm.full[stage], NDW_TILE);
          tma_load_2d(x_smem + stage * NDW_TILE, &map_x, &sm.full[stage], kb * NDW_BK, row0);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes the block's tiles wg, wg + NC, ...
  const int wg = warp / 4, wl = warp % 4, ltid = threadIdx.x % NDW_WG;
  const int g = lane / 4, t = lane % 4;
  const bool dir = enc.enc_mode == ENC_DIR;
  const bool sines = e_rows > 0 && SATNERF_NERF_ABLATE != 1;
  uint8_t* et = reinterpret_cast<uint8_t*>(sm.enc[wg]);
  uint8_t* rb = reinterpret_cast<uint8_t*>(sm.rows[wg]);
  for (int i = threadIdx.x; i < NDW_BN; i += NC * NDW_WG)
    sm.bias[i] = col0 + i < N ? bias[col0 + i] : 0.f;
  // ENC_XYZ writes the tile's columns [0, e_rows), ENC_DIR the row buffer's:
  // the rest stays zero
  for (int i = ltid; i < NDW_TILE / 16; i += NDW_WG) {
    reinterpret_cast<uint4*>(et)[i] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(rb)[i] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();  // the zeros are read by wgmma
  bar_sync(1, NC * NDW_WG);  // bias and the zeroed tiles in place
  mbar_wait(&sm.w_full, 0);

  // A thread fills half `hh` of the encoding's row `pr`: ENC_XYZ row pr of the
  // tile from point row0 + pr's o + d z; ENC_DIR row pr of the row buffer
  // from the direction of the tile's pr-th ray. It loads that position
  // while its previous tile runs (x_next).
  const int pr = ltid % NDW_BM, hh = ltid / NDW_BM;
  const bool fills = hh == 0 || 6 * enc.n_freq > 32;  // half 1 holds columns 32 ..
  float x_next[3] = {0.f, 0.f, 0.f};
  auto fetch = [&](int o) {
    const int row0 = (first_row + o * row_step) * NDW_BM;
    const int r = row0 / S + pr, r_last = (min(row0 + NDW_BM, P) - 1) / S;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x_next[c] = !dir ? enc.coord(row0 + pr, c)
                       : (r <= r_last ? enc.rays[(size_t)r * NERF_RAY_COLS + 3 + c] : 0.f);
  };
  if (sines && wg < n_tiles) fetch(wg);
  // The mainloops run in the block's tile order, one warpgroup after the
  // other: tile o's starts once every stage of tile o - 1 has come (the
  // parity of a stage's full barrier only tells its fill from the one two
  // rounds of the ring before). acc is never written but by wgmma: the first
  // product of a tile ignores acc's old value (scale-d 0).
  float acc[64];
  for (int o = wg, mine = 0; o < n_tiles; o += NC, ++mine) {
    const int row0 = (first_row + o * row_step) * NDW_BM;
    if (sines) {  // this tile's encoding, before the turn
      // every warp of the warpgroup is past its wait on the products that
      // read the tiles last
      bar_sync(2 + wg, NDW_WG);
      const float x[3] = {x_next[0], x_next[1], x_next[2]};
      if (o + NC < n_tiles) fetch(o + NC);  // in flight meanwhile
      const int r0 = row0 / S, nr = (min(row0 + NDW_BM, P) - 1) / S - r0 + 1;
      if (fills && (!dir || pr < nr)) {
        uint8_t* dst = dir ? rb : et;
        if (hh == 0) ndw_enc_half<0>(dst, pr, !dir, x, enc.n_freq);
        else ndw_enc_half<1>(dst, pr, !dir, x, enc.n_freq);
      }
      if (dir) {  // each row of the tile takes its ray's values
        bar_sync(2 + wg, NDW_WG);
        for (int i = ltid; i < NDW_BM * 8; i += NDW_WG) {  // 16-byte chunks of the rows
          const int q = i / 8, ch = i % 8;
          const int ray = min(row0 + q, P - 1) / S - r0;
          *reinterpret_cast<uint4*>(et + q * 128 + (((ch ^ q) & 7) << 4)) =
              reinterpret_cast<const uint4*>(rb + ray * 128)[ch];
        }
      }
      fence_proxy_async();  // the tile is read by wgmma
      bar_sync(2 + wg, NDW_WG);
    }
    if (k_blocks > 0 && o > 0) mbar_wait(&sm.turn[wg], (wg == 0 ? mine - 1 : mine) & 1);
    // a stage's products stay in flight while the next stage's are issued:
    // stage kb - 1 is released once wgmma_wait<1> has seen it done
    for (int kb = 0; kb < k_blocks; ++kb) {
      const int pos = o * k_blocks + kb;  // the producer's order
      const int stage = pos % stages;
      mbar_wait(&sm.full[stage], (pos / stages) & 1);
      if (kb == k_blocks - 1 && ltid == 0)
        mbar_arrive(&sm.turn[(wg + 1) % NC]);  // every stage of this tile has come
      const uint8_t* a = x_smem + stage * NDW_TILE;
      const uint8_t* b = w_smem + kb * W_CHUNK;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NDW_BK / 16; ++s)  // 16 of depth: 32 bytes of an X row, 16 W rows
        if (SATNERF_NERF_ABLATE != 2)
          wgmma_m64n128k16_ss_tb(acc, smem_desc(a + 32 * s, 16, 1024, SWIZZLE_128B),
                                 smem_desc(b + 2048 * s, NDW_W_BOX, 1024, SWIZZLE_128B),
                                 kb + s > 0);
      wgmma_commit();
      if (kb > 0) {  // no instruction may touch acc until the last wait
        wgmma_wait<1>();
        mbar_arrive(&sm.empty[(pos - 1) % stages]);
      }
    }
    if (e_rows > 0) {  // the encoding's k tile against C
      const uint8_t* c = reinterpret_cast<const uint8_t*>(sm.c);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NDW_BK / 16; ++s)
        if (SATNERF_NERF_ABLATE != 2 && 16 * s < e_rows)
          wgmma_m64n128k16_ss_tb(acc, smem_desc(et + 32 * s, 16, 1024, SWIZZLE_128B),
                                 smem_desc(c + 2048 * s, NDW_W_BOX, 1024, SWIZZLE_128B),
                                 k_blocks + s > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (k_blocks > 0) mbar_arrive(&sm.empty[(o * k_blocks + k_blocks - 1) % stages]);
    if (SATNERF_NERF_ABLATE == 2) continue;

    // epilogue: rows q0 and q0 + 8, columns 8j + 2t, 8j + 2t + 1 of each block j
    const int q0 = row0 + wl * 16 + g, q1 = q0 + 8;
#pragma unroll 1
    for (int jb = 0; jb < NDW_BN / 32; ++jb) {  // four 8-column blocks at a time
      float a16[16];
      switch (jb) {
        case 0: take16<0>(a16, acc); break;
        case 1: take16<1>(a16, acc); break;
        case 2: take16<2>(a16, acc); break;
        default: take16<3>(a16, acc); break;
      }
      uint32_t y0[4], y1[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int nl = 8 * (jb * 4 + jj) + 2 * t;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = a16[4 * jj + i] + sm.bias[nl + (i & 1)];
          if (act == ACT_RELU) v[i] = fmaxf(v[i], 0.f);
        }
        const __nv_bfloat162 r0 = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 r1 = __floats2bfloat162_rn(v[2], v[3]);
        y0[jj] = *reinterpret_cast<const uint32_t*>(&r0);
        y1[jj] = *reinterpret_cast<const uint32_t*>(&r1);
      }
      quad_transpose(y0, t);
      quad_transpose(y1, t);
      const int n = col0 + 8 * (jb * 4 + t);  // lane t now holds block jb * 4 + t
      if (n < N) {
        if (q0 < P)
          *reinterpret_cast<uint4*>(Y + (size_t)q0 * N + n) = make_uint4(y0[0], y0[1], y0[2], y0[3]);
        if (q1 < P)
          *reinterpret_cast<uint4*>(Y + (size_t)q1 * N + n) = make_uint4(y1[0], y1[1], y1[2], y1[3]);
      }
    }
  }
}

// X (P, K) bf16 (nullptr at K = 0), W (K, N), C (e_rows, N) bf16 (nullptr
// without an encoding), Y (P, N) bf16; K a multiple of 64 up to
// NDW_MAX_K, N a multiple of 64, e_rows 0, 32 or 64, every pointer
// 16-byte aligned.
int launch_nerf_dense_wgmma(cudaStream_t st, const bf16* X, int K, const bf16* W,
                            const float* bias, const PosEncoding& enc, int e_rows, const bf16* C,
                            int act, bf16* Y, int N) {
  static const int max_smem = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    return v;
  }();
  static const int resident = hopper::resident_blocks(nerf_dense_wgmma, NDW_THREADS, max_smem);
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  if (K > NDW_MAX_K) return (int)cudaErrorInvalidValue;
  const int fixed = 1024 + NDW_FIXED + (K / NDW_BK) * NDW_W_CHUNK;
  const int fit = (max_smem - fixed) / NDW_TILE;
  const int stages = fit < NDW_MAX_STAGES ? fit : NDW_MAX_STAGES;
  if (stages < (K > 0 ? 2 : 1)) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_x{}, map_w{}, map_c{};
  const int P = enc.P;
  int err = 0;
  if (K > 0) {
    err = hopper::tensor_map_2d(&map_x, X, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, P, K, NDW_BM,
                                NDW_BK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = hopper::tensor_map_2d(&map_w, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, NDW_BK,
                                  64, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == 0 && e_rows > 0)
    err = hopper::tensor_map_2d(&map_c, C, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, e_rows, N, e_rows,
                                64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  // a whole number of blocks for each column slice, no more than row tiles
  const int col_tiles = (N + NDW_BN - 1) / NDW_BN, row_tiles = (P + NDW_BM - 1) / NDW_BM;
  int per_slice = resident / col_tiles;
  if (per_slice > row_tiles) per_slice = row_tiles;
  if (per_slice < 1) per_slice = 1;
  nerf_dense_wgmma<<<per_slice * col_tiles, NDW_THREADS, fixed + stages * NDW_TILE, st>>>(
      map_x, map_w, map_c, K, e_rows, bias, enc, act, Y, N, stages);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- nerf_heads_composite
//
// Replaces the narrow heads of fused_nerf.py _forward :162-173 and the
// compositor _composite_tile_nerf :402: sigma = softplus(h . w0 + b0), rgb =
// sigmoid(r . w1:4 + b1:4) padded, alpha = 1 - exp(-delta relu(sigma [+
// noise])), T = cumprod_excl(1 - alpha + 1e-10), w = alpha T, and the ray's
// integrals sum_s w_s [rgb_s | z_s | 1]: no irradiance, no clip. out (R, 8)
// [rgb | depth | opacity | 0 0 0] and on request the (R, S) weights. The
// TPU kernel's log-space cumprod on the MXU is not carried over. NOISE (a
// template parameter: the serving instantiation carries no trace of it) adds
// a per-sample noise to sigma before the relu (the wrapper's `noise=`; the
// main path serves without it). Wn packs the narrow weights as (4, F) rows in
// the compute type (0 sigma over F, 1:4 rgb_1 over the first Fh); bn their 4
// biases.
//
// heads_composite_scan's design (fused_render.cu) for the nerf layout, with
// chunks that cross rays. The heads of the samples are independent; only T
// carries from one sample of a ray to the next, and T is a prefix product. A
// block of NH_THREADS takes a range of whole rays (block b of G: rays [R b /
// G, R (b + 1) / G), a persistent grid) and walks their samples, ray after
// ray, in chunks of NH_THREADS consecutive samples: a chunk may hold the end
// of one ray, whole rays and the start of another.
//  A. the chunk's heads, a warp NH_IN_FLIGHT samples at a time, by
//     heads.cuh's nerf_point_heads (16-byte loads of h and r kept raw until
//     the products, the four rows in shared memory read as 16-byte chunks
//     and unpacked once for the samples in flight, the four dot products
//     reduced by one shuffle tree); the four pre-activations of each sample
//     into shared memory.
//  B. a thread a sample: the activations (a thread each, where in A a
//     warp would take them a sample at a time); alpha (the noise added
//     here, coalesced); T as an exclusive product of the fp32 factors 1 -
//     alpha + 1e-10 in double, segmented by ray (a warp scan, then the
//     earlier warps' last values
//     where the ray began before the warp), the product of a ray's earlier
//     chunks carried and the whole rounded once (a tree of fp32 products of
//     factors near 1 drops the second-order term of each, common.cuh); w,
//     written as a contiguous row when asked for; the five integrals as
//     segmented sums the same way, written by each ray's last sample.
// A chunk costs three barriers whatever it holds: at the serving chunk's 64
// samples a ray, a block a ray at a time (heads_composite_scan's walk) left
// three quarters of B's threads idle and took five barriers a ray.
// Shared memory does not grow with S: any S runs. The body this replaced
// gave a warp a ray and walked its samples in order: four serial warp
// reductions a sample of rows read 2 bytes a lane, the weights read again
// from device memory for every sample.
//
// What bounds it: device memory. It reads h (F values) and r (Fh) a sample,
// 768 bytes at F = 256 in bf16, and z (and the noise), and writes 32 bytes a
// ray (and the weights, 4 bytes a sample): at the serving chunk (65,536 rays
// x 64) 3.26 GB, 0.972 ms at 3.35 TB/s.
constexpr int NH_THREADS = SCAN_THREADS;
constexpr int NH_WARPS = SCAN_WARPS;
// the samples a warp's heads load at once (A.): 1 ran slower, 3 spilled at
// 64 registers (PERF.md section 6; tools/outputs_torch.py variants)
constexpr int NH_IN_FLIGHT = 2;
constexpr int NH_SUMS = 5;  // rgb x 3, depth, opacity: the output's columns 0:5

// The dynamic shared memory of a block, in bytes: the rows and biases
// (heads.cuh); each warp's last product (double) and sums; the four
// pre-activations of each sample of a chunk; the carried product (double)
// and sums (8 slots).
__host__ __device__ constexpr int nh_smem_bytes(int F, int Fh, int elem_bytes) {
  return nerf_rows_smem_bytes(F, Fh, elem_bytes) + 8 * (NH_WARPS + 1) +
         4 * (NH_WARPS * NH_SUMS + 4 * NH_THREADS + 8);
}

// The inclusive scans of a warp, segmented by ray: lane L's sample is the
// j-th of its ray, and a partner o lanes up is of the same ray where j >= o
// (Hillis-Steele), so each lane gets the product (the sums) over its ray's
// samples from the warp's first lane on.
__device__ __forceinline__ double warp_segmented_product(double v, int j, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o && j >= o) v *= u;
  }
  return v;
}

template <int M>
__device__ __forceinline__ void warp_segmented_sums(float (&v)[M], int j, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float u[M];
#pragma unroll
    for (int i = 0; i < M; ++i) u[i] = __shfl_up_sync(0xffffffffu, v[i], o);
    if (lane >= o && j >= o) {
#pragma unroll
      for (int i = 0; i < M; ++i) v[i] += u[i];
    }
  }
}

// Registers for 4 blocks an SM (at most 64 a thread), as heads_composite_scan.
template <typename T, bool NOISE>
__global__ void __launch_bounds__(NH_THREADS, 4)
nerf_heads_scan(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                const T* __restrict__ Wn, const float* __restrict__ bn,
                const float* __restrict__ z, const float* __restrict__ noise, int R, int S,
                float rgb_padding, int vec, float* __restrict__ out,
                float* __restrict__ weights) {
  extern __shared__ __align__(16) unsigned char nh_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const HeadRows<T, true> w = load_nerf_rows<T>(Wn, bn, F, Fh, nh_smem);
  double* tail_p = reinterpret_cast<double*>(nh_smem + nerf_rows_smem_bytes(F, Fh, sizeof(T)));
  float* tail_s = reinterpret_cast<float*>(tail_p + NH_WARPS);  // NH_WARPS x NH_SUMS
  float* v_pre = tail_s + NH_WARPS * NH_SUMS;  // 4 x NH_THREADS: sigma's, then rgb's
  double* carry_p = reinterpret_cast<double*>(v_pre + 4 * NH_THREADS);  // 8-byte aligned
  float* carry_s = reinterpret_cast<float*>(carry_p + 1);          // NH_SUMS
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int passes = nerf_head_passes<T>(F, Fh);
  const int head = lane >> 3;  // the head whose pre-activation the lane gets
  const int r_begin = (int)((long long)R * blockIdx.x / gridDim.x);
  const int r_end = (int)((long long)R * (blockIdx.x + 1) / gridDim.x);
  const size_t q_end = (size_t)r_end * S;
  __syncthreads();

  int ray0 = r_begin, j0 = 0;  // the chunk's first sample is sample j0 of ray ray0
  for (size_t cq = (size_t)r_begin * S; cq < q_end; cq += NH_THREADS) {
    const int n = q_end - cq < (size_t)NH_THREADS ? (int)(q_end - cq) : NH_THREADS;

    // ---- A. the heads of the chunk's samples: a warp takes samples s0,
    // s0 + NH_WARPS, ..., NH_IN_FLIGHT of them at once
    for (int s0 = warp; s0 < n; s0 += NH_WARPS * NH_IN_FLIGHT) {
      const int live = (n - s0 + NH_WARPS - 1) / NH_WARPS;
      float pre[NH_IN_FLIGHT];  // sigma, rgb x 3 by the lane's head
      nerf_point_heads<T, NH_IN_FLIGHT>(h, F, rf, Fh, cq + s0, NH_WARPS, live, vec, passes, w,
                                        lane, pre);
      if ((lane & 7) == 0) {
#pragma unroll
        for (int u = 0; u < NH_IN_FLIGHT; ++u)
          if (u < live) v_pre[head * NH_THREADS + s0 + u * NH_WARPS] = pre[u];
      }
    }
    __syncthreads();

    // ---- B. a thread a sample: alpha; T and the integrals as scans
    // segmented by ray. Past n a thread is a ray of its own (j = 0).
    const bool mine = tid < n;
    const int rr = (j0 + tid) / S;  // rays after the chunk's first
    const int j = mine ? j0 + tid - rr * S : 0;
    const int first = tid - j;  // its ray's first sample in the chunk; < 0: in an earlier one
    const size_t q = cq + tid;
    float alpha = 0.f, zs = 0.f;
    if (mine) {
      zs = z[q];
      const float delta = j < S - 1 ? z[q + 1] - zs : 1e10f;
      float sigma_n = softplusf(v_pre[tid] + w.bs[0]);
      if constexpr (NOISE) sigma_n += noise[q];
      alpha = 1.f - expf(-delta * fmaxf(sigma_n, 0.f));
    }
    const double f = mine ? (double)(1.f - alpha + 1e-10f) : 1.0;
    const double inc = warp_segmented_product(f, j, lane);
    const double up = __shfl_up_sync(0xffffffffu, inc, 1);
    double tr = lane > 0 && j > 0 ? up : 1.0;
    if (lane == 31) tail_p[warp] = inc;
    double c_p = 1.0;  // what the ray carries from the earlier chunks
    float c_s[NH_SUMS] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (first < 0) {
      c_p = *carry_p;
#pragma unroll
      for (int i = 0; i < NH_SUMS; ++i) c_s[i] = carry_s[i];
    }
    __syncthreads();
    const int w_first = max(first, 0) / 32;  // the warp its ray begins in, in this chunk
    for (int w2 = w_first; w2 < warp; ++w2) tr *= tail_p[w2];
    tr *= c_p;
    const float wt = alpha * (float)tr;
    float v[NH_SUMS] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (mine) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pre = v_pre[(1 + c) * NH_THREADS + tid];
        v[c] = wt * (sigmoidf(pre + w.bs[1 + c]) * pad2 - rgb_padding);
      }
      v[3] = wt * zs;
      v[4] = wt;
      if (weights != nullptr) weights[q] = wt;
    }
    warp_segmented_sums<NH_SUMS>(v, j, lane);
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < NH_SUMS; ++i) tail_s[warp * NH_SUMS + i] = v[i];
    }
    __syncthreads();
    for (int w2 = w_first; w2 < warp; ++w2) {
#pragma unroll
      for (int i = 0; i < NH_SUMS; ++i) v[i] += tail_s[w2 * NH_SUMS + i];
    }
#pragma unroll
    for (int i = 0; i < NH_SUMS; ++i) v[i] += c_s[i];
    // a ray's last sample writes its integrals; the chunk's last sample, of
    // a ray that goes on, what the ray carries to the next chunk
    if (mine && j == S - 1) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)(ray0 + rr) * NERF_COLS);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], 0.f, 0.f, 0.f);
    } else if (tid == n - 1) {
      *carry_p = tr * f;
#pragma unroll
      for (int i = 0; i < NH_SUMS; ++i) carry_s[i] = v[i];
    }
    const int next = j0 + NH_THREADS;
    ray0 += next / S;
    j0 = next % S;
  }
}

// ---------------------------------------------------- nerf_composite_loss_bwd
//
// Replaces, of fused_nerf.py:594: the narrow heads forward, the compositor
// with sigma noise, the squared error and its adjoint (:626-644), the
// compositor adjoint _composite_bwd_tile_nerf :545 and the head part of
// _point_bwd_from_saves :216-239. composite_loss_bwd_block's design
// (fused_train.cu) for the nerf layout: a block of NCL_THREADS a ray, on a
// persistent grid (at most R blocks, each walking rays b, b + gridDim.x, ...):
//   1. the heads of every sample, a warp NCL_IN_FLIGHT samples at a time,
//      as nerf_heads_scan's A (the four rows staged once a block): the four
//      pre-activations of each sample into shared memory
//   2. a thread a sample of each chunk of NCL_THREADS: the activations,
//      alpha, T as a block
//      exclusive product in double carried from chunk to chunk (kept a
//      sample in shared memory above one chunk), w, and the rgb integrals as
//      block sums
//   3. every thread: sq = |rgb - gt|^2 and g_rgb = 2 (rgb - gt) / (3 R), R
//      the number of rays (none is padded); thread 0 adds sq to the loss
//   4. a thread a sample of each chunk, the last chunk first: d_alpha = dw T
//      - suffix / (1 - alpha + 1e-10), the suffix sum of dw w over the later
//      samples an exclusive block scan carried from the later chunks, masked
//      where sigma + noise <= 0; the four pre-activation cotangents rounded
//      to the compute type into shared memory (they feed both products);
//      dbn's block sums of the unrounded ones
//   5. the outer products by rows: a warp a sample, a lane 4 columns of each
//      128 (a store instruction writes 512 contiguous bytes), rows in flight
//      NCL_ROWS_IN_FLIGHT at a time: d_h = gb_sig w_sig (F, fp32), d_r =
//      sum_c gb_c w_c (Fh, fp32); dWn's columns summed in each lane's
//      registers, then a row a warp in shared memory, summed over the
//      block's rays; one atomicAdd a column a block at the end.
// A saturated sample (the last one's delta is 1e10) stays as in the walk:
// its factor is 1e-10, and 4. divides the suffix sum by it (large, finite)
// and multiplies the quotient by 1 - alpha (exactly 0). softplus' is
// -expm1f(-sigma) (see the top of this file).
//
// The body it replaced gave a warp a ray (1,024 warps at a training batch,
// eight an SM) and walked the samples twice in order, four serial warp
// reductions a sample, with 40 accumulator registers a lane and 640 atomics
// a ray. Bound by device memory: h and r read (the second time mostly from
// L2), d_h and d_r written in fp32: 151 MB at 1,024 rays x 64 in bf16,
// 0.045 ms at 3.35 TB/s. The sums run in another order than the walk's
// (scans, block sums), so the last bits differ. Any S whose shared memory
// fits the 227 KB a block may opt into (ncl_smem_bytes; ops/fused_nerf.py
// nerf_composite_max_samples mirrors it); vec: F and Fh multiples of 16
// bytes' worth and the row tensors 16-byte aligned (else element loads and
// stores).
constexpr int NCL_THREADS = SCAN_THREADS;
constexpr int NCL_WARPS = SCAN_WARPS;
// Measured choices (PERF.md section 6; tools/outputs_torch.py variants): the
// samples a warp's heads load at once in 1. (1 and 3 ran slower); 2 blocks
// an SM, so 128 registers a thread (at 3 and 4 blocks it spilled and ran
// slower); a persistent grid (a block a ray, a grid of R, ran as fast; the
// persistent grid adds dWn's columns once a block, not once a ray).
constexpr int NCL_IN_FLIGHT = 2;
constexpr int NCL_MIN_BLOCKS = 2;
constexpr bool NCL_PERSISTENT = true;
constexpr int NCL_SUMS = 4;            // dbn
constexpr int NCL_ROWS_IN_FLIGHT = 4;  // 5.: the rows a warp loads before their products
constexpr int NCL_COL_GROUPS = 2;      // 5.: the groups of 128 columns of h a lane takes at once

// The dynamic shared memory of a block, in bytes: the rows and biases
// (heads.cuh); the block sums' and scans' scratch (8-byte aligned); each
// warp's columns of dWn (the four rows, padded as the weights); the four
// pre-activations and the four rounded cotangents of each sample (S each);
// above one chunk, T of each sample.
__host__ __device__ constexpr long long ncl_smem_bytes(int F, int Fh, int S, int elem_bytes) {
  return nerf_rows_smem_bytes(F, Fh, elem_bytes) +
         4LL * (block_scratch_floats(NCL_SUMS) +
                NCL_WARPS * (heads_pad8(F) + 3 * heads_pad8(Fh)) + 8LL * S +
                (S > NCL_THREADS ? S : 0));
}

// Step 5 for one head: the rows x (n values a sample) of samples [0, S) from
// q0, their NC rounded cotangents (cot + j * S), the NC weight rows in shared
// memory (wrow + j * wld); writes dst = sum_j cot_j w_j in fp32 and adds the
// warp's sums sum_s cot_j x_s to its rows of dWn's columns (red + j * wld).
template <typename T, int NC, int G>
__device__ __forceinline__ void ncl_outer(const T* __restrict__ x, int n,
                                          const float* cot, int S, const T* wrow, int wld,
                                          float* __restrict__ dst, float* red, size_t q0,
                                          int vec, int lane, int warp) {
  constexpr int U = NCL_ROWS_IN_FLIGHT;
  using R4 = typename Raw4<T>::type;
  for (int kb = 0; kb < n; kb += 128 * G) {
    float a[NC][G][4] = {}, wv[NC][G][4] = {};
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int k = kb + 128 * m + 4 * lane;
      if (k < n) {
#pragma unroll
        for (int j = 0; j < NC; ++j) smem4<T>(wrow + j * wld + k, wv[j][m]);
      }
    }
    for (int s0 = warp * U; s0 < S; s0 += NCL_WARPS * U) {
      R4 xr[U][G];  // raw until the products
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < G; ++m) {
          const int k = kb + 128 * m + 4 * lane;
          if (k < n && s0 + u < S) xr[u][m] = row4_raw<T>(x + (q0 + s0 + u) * n, k, n, vec);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= S) break;
        float g[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) g[j] = cot[j * S + s0 + u];
#pragma unroll
        for (int m = 0; m < G; ++m) {
          const int k = kb + 128 * m + 4 * lane;
          if (k >= n) continue;
          float xv[4], d[4];
          values4<T>(xr[u][m], xv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[i] = 0.f;
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              a[j][m][i] = fmaf(g[j], xv[i], a[j][m][i]);
              d[i] = fmaf(g[j], wv[j][m][i], d[i]);
            }
          }
          store_chunk<4>(dst + (q0 + s0 + u) * n, k, n, vec, d);
        }
      }
    }
    // the warp's column sums (its rows are padded to a multiple of 8: a
    // 16-byte store a lane, zero past n)
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int k = kb + 128 * m + 4 * lane;
      if (k >= n) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float4* r = reinterpret_cast<float4*>(red + j * wld + k);
        const float4 o = *r;
        *r = make_float4(o.x + a[j][m][0], o.y + a[j][m][1], o.z + a[j][m][2], o.w + a[j][m][3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NCL_THREADS, NCL_MIN_BLOCKS)
nerf_composite_loss_bwd_block(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                              const T* __restrict__ Wn, const float* __restrict__ bn,
                              const float* __restrict__ z, const float* __restrict__ noise,
                              const float* __restrict__ gt, int R, int S, float rgb_padding,
                              int vec, float* __restrict__ loss_sum, float* __restrict__ d_h,
                              float* __restrict__ d_r, float* __restrict__ dWn,
                              float* __restrict__ dbn) {
  extern __shared__ __align__(16) unsigned char ncl_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int Fp = heads_pad8(F), Fhp = heads_pad8(Fh), ld = Fp + 3 * Fhp;
  const HeadRows<T, true> w = load_nerf_rows<T>(Wn, bn, F, Fh, ncl_smem);
  float* scratch = reinterpret_cast<float*>(ncl_smem + nerf_rows_smem_bytes(F, Fh, sizeof(T)));
  float* red = scratch + block_scratch_floats(NCL_SUMS);  // NCL_WARPS x ld
  float* v_pre = red + NCL_WARPS * ld;  // 4 x S: the pre-activations, sigma's then rgb's
  float* cot_sig = v_pre + 4 * S;       // S: the rounded cotangents
  float* cot_rgb = cot_sig + S;         // 3 x S
  float* v_tr = cot_rgb + 3 * S;        // S, above one chunk
  const int chunks = (S + NCL_THREADS - 1) / NCL_THREADS;
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int passes = nerf_head_passes<T>(F, Fh);
  const int head = lane >> 3;  // the head whose pre-activation the lane gets
  const float scale = 2.f / (3.f * (float)R);
  for (int i = tid; i < NCL_WARPS * ld; i += NCL_THREADS) red[i] = 0.f;
  float sq_block = 0.f, b_block = 0.f;  // thread 0: the loss; thread i < 4: dbn[i]
  __syncthreads();

  for (int ray = blockIdx.x; ray < R; ray += gridDim.x) {
    const size_t q0 = (size_t)ray * S;
    const float* zr = z + q0;
    const float* nz = noise != nullptr ? noise + q0 : nullptr;

    // ---- 1. the heads of every sample: a warp takes samples s0, s0 +
    // NCL_WARPS, ..., NCL_IN_FLIGHT of them at once
    for (int s0 = warp; s0 < S; s0 += NCL_WARPS * NCL_IN_FLIGHT) {
      const int live = (S - s0 + NCL_WARPS - 1) / NCL_WARPS;
      float pre[NCL_IN_FLIGHT];  // sigma, rgb x 3 by the lane's head
      nerf_point_heads<T, NCL_IN_FLIGHT>(h, F, rf, Fh, q0 + s0, NCL_WARPS, live, vec, passes, w,
                                         lane, pre);
      if ((lane & 7) == 0) {
#pragma unroll
        for (int u = 0; u < NCL_IN_FLIGHT; ++u)
          if (u < live) v_pre[head * S + s0 + u * NCL_WARPS] = pre[u];
      }
    }
    __syncthreads();

    // ---- 2. a thread a sample of each chunk: alpha, T, w, the integrals.
    // The last chunk's values stay in registers for 4.
    bool mine = false;
    int s = 0;
    float sigma = 0.f, cs[3] = {0.f, 0.f, 0.f}, delta = 0.f, sigma_n = 0.f, oma = 1.f;
    float tr = 0.f, wt = 0.f;
    float acc[3] = {0.f, 0.f, 0.f};
    double carry = 1.0;  // the product of the earlier chunks' factors
    auto sample = [&](int c) {  // chunk c's values of this thread's sample, T aside
      s = c * NCL_THREADS + tid;
      mine = s < S;
      sigma = delta = sigma_n = 0.f;
      cs[0] = cs[1] = cs[2] = 0.f;
      oma = 1.f;
      if (mine) {
        sigma = softplusf(v_pre[s] + w.bs[0]);
#pragma unroll
        for (int k = 0; k < 3; ++k) cs[k] = sigmoidf(v_pre[(1 + k) * S + s] + w.bs[1 + k]);
        delta = s < S - 1 ? zr[s + 1] - zr[s] : 1e10f;
        sigma_n = sigma + (nz != nullptr ? nz[s] : 0.f);
        oma = expf(-delta * fmaxf(sigma_n, 0.f));  // 1 - alpha
      }
    };
    for (int c = 0; c < chunks; ++c) {
      sample(c);
      const float alpha = 1.f - oma;
      double all;
      const double prod = block_exclusive_product<double>(
          mine ? (double)(1.f - alpha + 1e-10f) : 1.0, reinterpret_cast<double*>(scratch), &all);
      tr = (float)(carry * prod);
      carry *= all;
      wt = alpha * tr;  // 0 past S
      if (mine && chunks > 1) v_tr[s] = tr;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] += wt * (cs[k] * pad2 - rgb_padding);
    }
    block_sums<3, float>(acc, scratch);

    // ---- 3. the loss and the ray's cotangent
    float g_rgb[3], sq = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = acc[c] - gt[(size_t)ray * 3 + c];
      sq += diff * diff;
      g_rgb[c] = diff * scale;
    }
    sq_block += sq;

    // ---- 4. a thread a sample of each chunk, the last chunk first: the
    // compositor adjoint and the narrow pre-activation cotangents
    float b[NCL_SUMS];
    float carry_s = 0.f;  // the sum of dw * w over the later chunks
    for (int c = chunks - 1; c >= 0; --c) {
      if (c < chunks - 1) {  // this chunk's values, as 2. formed them
        sample(c);
        tr = v_tr[s];  // every sample of an earlier chunk is below S
        wt = (1.f - oma) * tr;
      }
      float dw = 0.f, g_pre_rgb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dw += (cs[k] * pad2 - rgb_padding) * g_rgb[k];
        g_pre_rgb[k] = wt * g_rgb[k] * pad2 * cs[k] * (1.f - cs[k]);
      }
      float total;
      const float suffix =
          block_exclusive_suffix_sum(mine ? dw * wt : 0.f, scratch, &total) + carry_s;
      carry_s += total;
      // the factor the forward multiplied the transparency by, formed the same way
      const float d_alpha = dw * tr - suffix / (1.f - (1.f - oma) + 1e-10f);
      const float d_sn = sigma_n > 0.f ? d_alpha * oma * delta : 0.f;
      float bc[NCL_SUMS] = {d_sn * -expm1f(-sigma), g_pre_rgb[0], g_pre_rgb[1], g_pre_rgb[2]};
      if (!mine) {
#pragma unroll
        for (int i = 0; i < NCL_SUMS; ++i) bc[i] = 0.f;
      } else {
        cot_sig[s] = round_to<T>(bc[0]);
#pragma unroll
        for (int k = 0; k < 3; ++k) cot_rgb[k * S + s] = round_to<T>(bc[1 + k]);
      }
#pragma unroll
      for (int i = 0; i < NCL_SUMS; ++i) b[i] = c < chunks - 1 ? b[i] + bc[i] : bc[i];
    }
    block_sums<NCL_SUMS, float>(b, scratch);  // also makes the cotangents visible
#pragma unroll
    for (int i = 0; i < NCL_SUMS; ++i)
      if (tid == i) b_block += b[i];

    // ---- 5. the outer products by rows: d_h and dWn row 0, d_r and rows 1:4
    float* red_w = red + warp * ld;
    ncl_outer<T, 1, NCL_COL_GROUPS>(h, F, cot_sig, S, w.ws, 0, d_h, red_w, q0, vec, lane, warp);
    ncl_outer<T, 3, 1>(rf, Fh, cot_rgb, S, w.wh, Fhp, d_r, red_w + Fp, q0, vec, lane, warp);
  }

  // the block's sums: one atomicAdd a column of dWn, an entry of dbn, the loss
  __syncthreads();
  for (int i = tid; i < F + 3 * Fh; i += NCL_THREADS) {
    const int row = i < F ? 0 : 1 + (i - F) / Fh, col = i < F ? i : (i - F) % Fh;
    const int off = row == 0 ? col : Fp + (row - 1) * Fhp + col;
    float v = 0.f;
    for (int wp = 0; wp < NCL_WARPS; ++wp) v += red[wp * ld + off];
    atomicAdd(dWn + (size_t)row * F + col, v);
  }
  if (tid < NCL_SUMS) atomicAdd(dbn + tid, b_block);
  if (tid == 0) atomicAdd(loss_sum, sq_block);
}

// ------------------------------------------- nerf_field_heads and its backward
//
// The two narrow heads a point, no compositor: fused_nerf.py _make_fwd_kernel
// :180 (the heads of _forward :162-173 and the (P, 8) output :188-190) and
// the head part of _make_bwd_kernel :257 (_point_bwd_from_saves :216-239).
// The points are independent, and a point's work is small (2 F + 6 Fh
// flops forward) beside its bytes, so both kernels stream the points and are
// bound by device memory. Both stage the four rows and biases in shared
// memory (heads.cuh load_nerf_rows) and compute a warp's U points' heads
// with heads.cuh's nerf_point_heads or its pieces: the U points' 16-byte
// chunks of h and r all loaded before any product and kept raw, the weight
// chunks unpacked once for the U points, the four dot products reduced in
// one shuffle tree. The bodies they replaced took a point at a time a warp,
// read h and r two bytes a lane, kept the rows as 40 floats a lane and
// reduced the four heads in four warp sums (20 shuffles).

constexpr int NF_MAX_F = 512;  // narrow_shapes_ok: F <= 512, Fh <= 256
constexpr int NF_MAX_FH = NF_MAX_F / 2;

// ---- nerf_field_heads: out[q] = [rgb 0:3 | sigma 3 | 0 4:8] of point q.
// A streaming kernel: a block of NFH_THREADS takes NFH_BLOCK_POINTS
// neighbouring points, its warps NFH_IN_FLIGHT (U) neighbouring points at a
// time (the block's warps on neighbouring groups), NFH_WARP_POINTS a warp
// in turn. Lane L of a group takes column L % 8 of point L / 8: it fetches
// its head's pre-activation from a lane that holds it (one shuffle a
// point), applies the one activation its column needs (the sigmoid padded
// by rgb_padding, softplus, or none), and the group's U points leave in one
// coalesced store of 32 U contiguous bytes. At most 64 registers a thread,
// so 4 blocks (32 warps) an SM.
//
// Bound by device memory: h (F values) and r (Fh) read, 32 bytes written a
// point: 800 bytes at 8 x 256 in bf16, 105 MB at 131,072 points, 0.031 ms
// at 3.35 TB/s; it takes 0.044 on an H100 (PERF.md section 6; the body it
// replaced 0.233).
constexpr int NFH_THREADS = 256;
constexpr int NFH_WARPS = NFH_THREADS / 32;
// Measured choices (PERF.md section 6; tools/outputs_torch.py variants): the
// points a warp's heads load at once (1 ran slower, 4 spilled at 64
// registers and ran slower); 32 points a warp ran as fast as 16.
constexpr int NFH_IN_FLIGHT = 2;
constexpr int NFH_MIN_BLOCKS = 4;
constexpr int NFH_WARP_POINTS = 16;
constexpr int NFH_BLOCK_POINTS = NFH_WARPS * NFH_WARP_POINTS;

template <typename T>
__global__ void __launch_bounds__(NFH_THREADS, NFH_MIN_BLOCKS)
nerf_field_heads_stream(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                        const T* __restrict__ Wn, const float* __restrict__ bn, int P,
                        float rgb_padding, int vec, float* __restrict__ out) {
  constexpr int U = NFH_IN_FLIGHT;
  static_assert(U >= 1 && U <= 32 / NERF_COLS && NFH_WARP_POINTS % U == 0,
                "a warp's group of points fills at most 32 lanes of columns");
  extern __shared__ __align__(16) unsigned char nfh_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const HeadRows<T, true> w = load_nerf_rows<T>(Wn, bn, F, Fh, nfh_smem);
  __syncthreads();
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int passes = nerf_head_passes<T>(F, Fh);
  const int col = lane % NERF_COLS, mine = lane / NERF_COLS;  // column, point of the group
  const int src = (col < 3 ? 1 + col : 0) * 8;  // a lane that holds the column's head
  const long long qb = (long long)blockIdx.x * NFH_BLOCK_POINTS;
  for (int it = 0; it < NFH_WARP_POINTS / U; ++it) {
    const long long q0 = qb + (long long)(it * NFH_WARPS + warp) * U;
    if (q0 >= P) break;  // the whole warp leaves together
    const int live = P - q0 < U ? (int)(P - q0) : U;
    float pre[U];
    nerf_point_heads<T, U>(h, F, rf, Fh, (size_t)q0, 1, live, vec, passes, w, lane, pre);
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float x = __shfl_sync(0xffffffffu, pre[u], src);
      if (u == mine) v = x;
    }
    if (col < 3) v = sigmoidf(v + w.bs[1 + col]) * pad2 - rgb_padding;
    else v = col == 3 ? softplusf(v + w.bs[0]) : 0.f;
    if (lane < NERF_COLS * live) out[(size_t)q0 * NERF_COLS + lane] = v;
  }
}

// ---- nerf_field_heads_bwd: from g (P, 8) fp32, the four pre-activation
// cotangents of each point, rgb g_c (1 + 2 pad) cs (1 - cs) and sigma g_3
// softplus'(pre) = g_3 (-expm1f(-sigma)) (1 - expf(-sigma) is 0 below 1e-8),
// each rounded to the compute type before both of its products: d_h =
// gb_sig w_sig (F) and d_r = sum_c gb_c w_c (Fh) in fp32, and dWn (4, F)
// summed over all points; dbn (4,) sums the unrounded cotangents.
//
// A persistent grid (hopper::resident_blocks) of blocks of NFB_THREADS;
// warp i of block b takes the U = NFB_IN_FLIGHT points from (b NFB_WARPS +
// i) U, then the U from every gridDim.x NFB_WARPS U points after:
//  * the heads again, from the U points' chunks of h and r (NP passes, a
//    template parameter: all of a point's chunks in flight at once);
//  * lane L forms the cotangent of head L / 8 of each point (g read once,
//    32 U contiguous bytes, and shuffled), then every lane fetches the four
//    rounded ones of each point (4 U shuffles);
//  * dWn's columns over the lane's chunks, NP (V + 3 V) fp32 sums in
//    registers kept over all of the warp's points (NFB_KEEP_ROWS: from the
//    chunks the heads loaded, still in registers; else read again, from L1);
//  * d_h and d_r need the weights only: a lane takes 4 columns of each 128,
//    read from the rows in shared memory once for the U points, and writes
//    them as one 16-byte store, so a store instruction of the warp covers
//    512 contiguous bytes.
// At the end each warp writes its sums to its row of shared memory, and a
// thread a column adds the block's rows and makes one fp32 atomicAdd into
// dWn and dbn (which the wrapper zeroes): F + 3 Fh + 4 atomics a block, 264
// blocks at 2 an SM, where the body it replaced made as many for each 128
// points (after 640 shared atomics a warp on the same addresses). The
// atomics add in an order that changes from run to run.
//
// Bound by device memory: h, r and g read, d_h and d_r written in fp32:
// 2,336 bytes a point at 8 x 256 in bf16, 306 MB at 131,072 points, 0.091
// ms at 3.35 TB/s; it takes 0.122 on an H100 (PERF.md section 6; the body
// it replaced 0.443).
constexpr int NFB_THREADS = 256;
constexpr int NFB_WARPS = NFB_THREADS / 32;
// Measured choices (PERF.md section 6; tools/outputs_torch.py variants): the
// points a warp takes at once (1 ran slower, 4 spilled and ran slower); 2
// blocks an SM, so 128 registers a thread (at 3, 80 registers, it spilled
// and ran 53 % slower); dWn's products from the heads' chunks kept in
// registers (read again from L1 they ran 6 % slower).
constexpr int NFB_IN_FLIGHT = 2;
constexpr int NFB_MIN_BLOCKS = 2;
constexpr bool NFB_KEEP_ROWS = true;

// Floats of a warp's row of sums: dWn's rows laid out as the weights are in
// shared memory (heads.cuh), then dbn (8 slots: rows stay 32 bytes apart).
__host__ __device__ constexpr int nfb_row_floats(int F, int Fh) {
  return heads_pad8(F) + 3 * heads_pad8(Fh) + 8;
}

// The dynamic shared memory of a block, in bytes: the rows and biases
// (heads.cuh), then each warp's row of sums.
__host__ __device__ constexpr int nfb_smem_bytes(int F, int Fh, int elem_bytes) {
  return nerf_rows_smem_bytes(F, Fh, elem_bytes) + 4 * NFB_WARPS * nfb_row_floats(F, Fh);
}

template <typename T, int NP>
__global__ void __launch_bounds__(NFB_THREADS, NFB_MIN_BLOCKS)
nerf_field_heads_bwd_stream(const T* __restrict__ h, int F, const T* __restrict__ rf, int Fh,
                            const T* __restrict__ Wn, const float* __restrict__ bn,
                            const float* __restrict__ g, int P, float rgb_padding, int vec,
                            float* __restrict__ d_h, float* __restrict__ d_r,
                            float* __restrict__ dWn, float* __restrict__ dbn) {
  constexpr int V = Vec16<T>::N, U = NFB_IN_FLIGHT;
  // the passes of r (Fh <= NF_MAX_FH and Fh <= F)
  constexpr int NPR = NP < NF_MAX_FH / (32 * V) ? NP : NF_MAX_FH / (32 * V);
  static_assert(U >= 1 && U <= 32 / NERF_COLS, "a group's cotangents fill at most a warp");
  extern __shared__ __align__(16) unsigned char nfb_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const HeadRows<T, true> w = load_nerf_rows<T>(Wn, bn, F, Fh, nfb_smem);
  const int Fp = heads_pad8(F), Fhp = heads_pad8(Fh), ld = nfb_row_floats(F, Fh);
  float* red = reinterpret_cast<float*>(nfb_smem + nerf_rows_smem_bytes(F, Fh, sizeof(T)));
  __syncthreads();

  float a_sig[NP][V], a_rgb[NPR][3][V];  // dWn rows 0 and 1:4 at the lane's chunks
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < V; ++i) a_sig[p][i] = 0.f;
#pragma unroll
  for (int p = 0; p < NPR; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) a_rgb[p][c][i] = 0.f;
  float b_sum = 0.f;  // dbn[head]: the unrounded cotangents
  const float pad2 = 1.f + 2.f * rgb_padding;
  const int head = lane >> 3;                  // the head whose pre-activation the lane gets
  const int g_col = head == 0 ? 3 : head - 1;  // that head's column of g
  const long long stride = (long long)gridDim.x * NFB_WARPS * U;

  for (long long q0 = ((long long)blockIdx.x * NFB_WARPS + warp) * U; q0 < P; q0 += stride) {
    const int live = P - q0 < U ? (int)(P - q0) : U;
    const float g_lane = lane < NERF_COLS * live ? g[(size_t)q0 * NERF_COLS + lane] : 0.f;

    // the heads again, every chunk of the U points in flight at once
    uint4 xh[NP][U], xr[NPR][U];  // raw until the products
#pragma unroll
    for (int p = 0; p < NP; ++p)
      nerf_chunk_loads<T, U>(h, F, (size_t)q0, 1, live, vec, (p * 32 + lane) * V, xh[p]);
#pragma unroll
    for (int p = 0; p < NPR; ++p)
      nerf_chunk_loads<T, U>(rf, Fh, (size_t)q0, 1, live, vec, (p * 32 + lane) * V, xr[p]);
    float part[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) part[u][0] = part[u][1] = part[u][2] = part[u][3] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      nerf_sigma_dots<T, U>(w, F, (p * 32 + lane) * V, live, xh[p], part);
#pragma unroll
    for (int p = 0; p < NPR; ++p)
      nerf_rgb_dots<T, U>(w, Fh, (p * 32 + lane) * V, live, xr[p], part);

    // the lane's head's cotangent of each point, then all four to every lane
    float gs[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pre = warp_sum4(part[u], lane);
      const float gq = __shfl_sync(0xffffffffu, g_lane, u * NERF_COLS + g_col);
      float gp;
      if (head == 0) {
        gp = gq * -expm1f(-softplusf(pre + w.bs[0]));
      } else {
        const float cs = sigmoidf(pre + w.bs[head]);
        gp = gq * pad2 * cs * (1.f - cs);
      }
      if (u < live) b_sum += gp;
      const float gb = round_to<T>(gp);
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[u][j] = __shfl_sync(0xffffffffu, gb, 8 * j);
    }

    // dWn over the lane's chunks
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int k = (p * 32 + lane) * V;
      if (k >= F) continue;
      if constexpr (!NFB_KEEP_ROWS)
        nerf_chunk_loads<T, U>(h, F, (size_t)q0, 1, live, vec, k, xh[p]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        float x[V];
        chunk_values<T>(xh[p][u], x);
#pragma unroll
        for (int i = 0; i < V; ++i) a_sig[p][i] = fmaf(gs[u][0], x[i], a_sig[p][i]);
      }
    }
#pragma unroll
    for (int p = 0; p < NPR; ++p) {
      const int k = (p * 32 + lane) * V;
      if (k >= Fh) continue;
      if constexpr (!NFB_KEEP_ROWS)
        nerf_chunk_loads<T, U>(rf, Fh, (size_t)q0, 1, live, vec, k, xr[p]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        float x[V];
        chunk_values<T>(xr[p][u], x);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) a_rgb[p][c][i] = fmaf(gs[u][1 + c], x[i], a_rgb[p][c][i]);
      }
    }

    // the cotangents of h and r: 4 columns of each 128 a lane
    for (int k = 4 * lane; k < F; k += 128) {
      float wv[4];
      smem4<T>(w.ws + k, wv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        float d[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = gs[u][0] * wv[i];
        store_chunk<4>(d_h + (size_t)(q0 + u) * F, k, F, vec, d);
      }
    }
    for (int k = 4 * lane; k < Fh; k += 128) {
      float wc[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) smem4<T>(w.wh + c * Fhp + k, wc[c]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= live) break;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = fmaf(gs[u][1 + c], wc[c][i], d[i]);
        store_chunk<4>(d_r + (size_t)(q0 + u) * Fh, k, Fh, vec, d);
      }
    }
  }

  // the warps' sums meet in shared memory, a row a warp (the NP passes write
  // every column below F and Fh), then a thread a column adds the block's
  // rows and makes one atomicAdd
  float* mine = red + warp * ld;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int k = (p * 32 + lane) * V;
    if (k >= F) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) mine[k + i] = a_sig[p][i];
  }
#pragma unroll
  for (int p = 0; p < NPR; ++p) {
    const int k = (p * 32 + lane) * V;
    if (k >= Fh) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) mine[Fp + c * Fhp + k + i] = a_rgb[p][c][i];
  }
  if (lane % 8 == 0) mine[Fp + 3 * Fhp + head] = b_sum;
  __syncthreads();
  for (int i = tid; i < F + 3 * Fh + 4; i += NFB_THREADS) {
    const int row = i < F ? 0 : i < F + 3 * Fh ? 1 + (i - F) / Fh : 4;
    const int col = row == 0 ? i : row < 4 ? (i - F) % Fh : i - F - 3 * Fh;
    const int off = row == 0 ? col : Fp + (row - 1) * Fhp + col;  // row 4: dbn's slots
    float v = 0.f;
    for (int wp = 0; wp < NFB_WARPS; ++wp) v += red[wp * ld + off];
    atomicAdd(row < 4 ? dWn + (size_t)row * F + col : dbn + col, v);
  }
}

// The widths the per-ray and per-point kernels take; ops/fused_nerf.py
// _check_narrow.
bool narrow_shapes_ok(int F, int Fh) {
  return F >= 1 && F <= NF_MAX_F && Fh >= 1 && Fh <= NF_MAX_FH && Fh <= F;
}

template <typename T> const T* as(const void* p) { return static_cast<const T*>(p); }
float* out_f32(void* p) { return static_cast<float*>(p); }

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

// nerf_heads_scan on its persistent grid; out must be 16-byte aligned.
template <typename T, bool NOISE>
int launch_nerf_heads(const void* h, int F, const void* rf, int Fh, const void* Wn,
                      const void* bn, const void* z, const void* noise, int R, int S,
                      float rgb_padding, void* out, void* weights, cudaStream_t st) {
  const int smem = nh_smem_bytes(F, Fh, sizeof(T));
  static int resident = 0, resident_smem = -1;  // the persistent grid, for this smem
  if (smem != resident_smem) {
    resident = hopper::resident_blocks(nerf_heads_scan<T, NOISE>, NH_THREADS, smem);
    resident_smem = smem;
  }
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  constexpr int V = Vec16<T>::N;
  const int vec = F % V == 0 && Fh % V == 0 && aligned16(h, rf);
  // no more blocks than rays, nor than chunks of samples
  const long long chunks = ((long long)R * S + NH_THREADS - 1) / NH_THREADS;
  const int grid = (int)std::min<long long>(std::min(R, resident), chunks);
  nerf_heads_scan<T, NOISE><<<grid, NH_THREADS, smem, st>>>(
      as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), as<float>(z), as<float>(noise), R,
      S, rgb_padding, vec, out_f32(out), out_f32(weights));
  return (int)cudaGetLastError();
}

// nerf_composite_loss_bwd_block on its persistent grid; S whose shared
// memory passes the 227 KB a block may hold is refused.
template <typename T>
int launch_nerf_composite(const void* h, int F, const void* rf, int Fh, const void* Wn,
                          const void* bn, const void* z, const void* noise, const void* gt,
                          int R, int S, float rgb_padding, void* loss_sum, void* d_h, void* d_r,
                          void* dWn, void* dbn, cudaStream_t st) {
  const long long bytes = ncl_smem_bytes(F, Fh, S, sizeof(T));
  if (bytes > hopper::SMEM_OPTIN_BYTES) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes;
  static int resident = 0, resident_smem = -1;  // the persistent grid, for this smem
  if (smem != resident_smem) {
    resident = hopper::resident_blocks(nerf_composite_loss_bwd_block<T>, NCL_THREADS, smem);
    resident_smem = smem;
  }
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  constexpr int V = Vec16<T>::N;
  const int vec = F % V == 0 && Fh % V == 0 && aligned16(h, rf, d_h, d_r);
  const int grid = NCL_PERSISTENT ? std::min(R, resident) : R;
  nerf_composite_loss_bwd_block<T><<<grid, NCL_THREADS, smem, st>>>(
      as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), as<float>(z), as<float>(noise),
      as<float>(gt), R, S, rgb_padding, vec, out_f32(loss_sum), out_f32(d_h), out_f32(d_r),
      out_f32(dWn), out_f32(dbn));
  return (int)cudaGetLastError();
}

// nerf_field_heads_stream over blocks of NFH_BLOCK_POINTS points.
template <typename T>
int launch_nerf_field_heads(const void* h, int F, const void* rf, int Fh, const void* Wn,
                            const void* bn, int P, float rgb_padding, void* out,
                            cudaStream_t st) {
  constexpr int V = Vec16<T>::N;
  const int vec = F % V == 0 && Fh % V == 0 && aligned16(h, rf);
  const int grid = (int)(((long long)P + NFH_BLOCK_POINTS - 1) / NFH_BLOCK_POINTS);
  nerf_field_heads_stream<T><<<grid, NFH_THREADS, nerf_rows_smem_bytes(F, Fh, sizeof(T)), st>>>(
      as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), P, rgb_padding, vec, out_f32(out));
  return (int)cudaGetLastError();
}

// nerf_field_heads_bwd_stream<T, NP> on its persistent grid.
template <typename T, int NP>
int launch_nerf_field_heads_bwd(const void* h, int F, const void* rf, int Fh, const void* Wn,
                                const void* bn, const void* g, int P, float rgb_padding,
                                void* d_h, void* d_r, void* dWn, void* dbn, cudaStream_t st) {
  const int smem = nfb_smem_bytes(F, Fh, sizeof(T));
  static int resident = 0, resident_smem = -1;  // the persistent grid, for this smem
  if (smem != resident_smem) {
    resident = hopper::resident_blocks(nerf_field_heads_bwd_stream<T, NP>, NFB_THREADS, smem);
    resident_smem = smem;
  }
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  constexpr int V = Vec16<T>::N;
  const int vec = F % V == 0 && Fh % V == 0 && aligned16(h, rf, d_h, d_r);
  const long long groups = ((long long)P + NFB_IN_FLIGHT - 1) / NFB_IN_FLIGHT;
  const int grid = (int)std::min<long long>(resident, (groups + NFB_WARPS - 1) / NFB_WARPS);
  nerf_field_heads_bwd_stream<T, NP><<<grid, NFB_THREADS, smem, st>>>(
      as<T>(h), F, as<T>(rf), Fh, as<T>(Wn), as<float>(bn), as<float>(g), P, rgb_padding, vec,
      out_f32(d_h), out_f32(d_r), out_f32(dWn), out_f32(dbn));
  return (int)cudaGetLastError();
}

// The instantiation whose NP passes cover F: 1, 2 or 4 (3 rounds up; its
// fourth pass's chunks lie past F).
template <typename T>
int launch_nerf_field_heads_bwd_np(const void* h, int F, const void* rf, int Fh, const void* Wn,
                                   const void* bn, const void* g, int P, float rgb_padding,
                                   void* d_h, void* d_r, void* dWn, void* dbn, cudaStream_t st) {
  constexpr int PASS_F = 32 * Vec16<T>::N;  // the features of h a pass covers
  auto launch = F <= PASS_F ? launch_nerf_field_heads_bwd<T, 1>
                : F <= 2 * PASS_F ? launch_nerf_field_heads_bwd<T, 2>
                                  : launch_nerf_field_heads_bwd<T, NF_MAX_F / PASS_F>;
  return launch(h, F, rf, Fh, Wn, bn, g, P, rgb_padding, d_h, d_r, dWn, dbn, st);
}

}  // namespace

// ------------------------------------------------------------- C entry points
// Each returns cudaGetLastError() after its launches; the wrapper raises if it
// is not 0. P = R * S points, ray-major; S = 1 makes every point its own ray.

// The mainloop rule of a launch of nerf_dense (mainloop = MAINLOOP_RULE);
// ops/fused_mlp.py dense_mainloop is the same rule in Python:
//   wgmma  bf16, K a multiple of 64 up to NDW_MAX_K (0 too: layer 0, the
//          encoding alone), N a multiple of 64, an encoding of 0, 32 or 64
//          rows; X, W, C and Y 16-byte aligned
//   wmma   bf16, K and N multiples of 8, e_rows a multiple of 32; X, W and C
//          16-byte aligned
//   simt   any other shape (and fp32 always)
// MAINLOOP_WMMA / MAINLOOP_WGMMA ask for one; a launch it cannot take is
// refused with cudaErrorInvalidValue, never sent to another mainloop.
extern "C" int satnerf_nerf_dense(int dtype, const void* X, int K, const void* W,
                                  const void* bias, const void* rays, const void* z, int S,
                                  int enc_mode, int n_freq, int e_rows, const void* C, int act,
                                  void* Y, int P, int N, int mainloop, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (S < 1 || (act != ACT_NONE && act != ACT_RELU)) return (int)cudaErrorInvalidValue;
  if (enc_mode != ENC_NONE && (n_freq < 1 || n_freq > 16 || e_rows < 6 * n_freq))
    return (int)cudaErrorInvalidValue;
  if (K == 0 && enc_mode == ENC_NONE) return (int)cudaErrorInvalidValue;
  if (mainloop < MAINLOOP_RULE || mainloop > MAINLOOP_WGMMA) return (int)cudaErrorInvalidValue;
  const int rows = enc_mode == ENC_NONE ? 0 : e_rows;
  const bool tc_ok = dtype == 1 && K % 8 == 0 && N % 8 == 0 && aligned16(X, W, C) &&
                     rows % TC_BK == 0;
  const bool wg_ok = dtype == 1 && K % 64 == 0 && K <= NDW_MAX_K && N % 64 == 0 &&
                     (rows == 0 || rows == 32 || rows == 64) && aligned16(X, W, C, Y);
  if ((mainloop == MAINLOOP_WMMA && !tc_ok) || (mainloop == MAINLOOP_WGMMA && !wg_ok))
    return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_RULE)
    mainloop = wg_ok ? MAINLOOP_WGMMA : tc_ok ? MAINLOOP_WMMA : MAINLOOP_RULE;
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
  } else if (mainloop == MAINLOOP_WGMMA) {
    const PosEncoding enc{r, zz, S, enc_mode, n_freq, P};
    return launch_nerf_dense_wgmma(st, as<bf16>(X), K, as<bf16>(W), b, enc, rows,
                                        as<bf16>(C), act, static_cast<bf16*>(Y), N);
  } else if (mainloop == MAINLOOP_WMMA) {
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nz = noise != nullptr;
  auto launch = dtype == 0 ? (nz ? launch_nerf_heads<float, true> : launch_nerf_heads<float, false>)
                           : (nz ? launch_nerf_heads<bf16, true> : launch_nerf_heads<bf16, false>);
  return launch(h, F, rf, Fh, Wn, bn, z, noise, R, S, rgb_padding, out, weights, st);
}

// S past what shared memory holds is refused (ncl_smem_bytes;
// ops/fused_nerf.py nerf_composite_max_samples mirrors the rule).
extern "C" int satnerf_nerf_composite_loss_bwd(int dtype, const void* h, int F, const void* rf,
                                               int Fh, const void* Wn, const void* bn,
                                               const void* z, const void* noise, const void* gt,
                                               int R, int S, float rgb_padding, void* loss_sum,
                                               void* d_h, void* d_r, void* dWn, void* dbn,
                                               void* stream) {
  if (!narrow_shapes_ok(F, Fh) || S < 1 || gt == nullptr || loss_sum == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_nerf_composite<float> : launch_nerf_composite<bf16>;
  return launch(h, F, rf, Fh, Wn, bn, z, noise, gt, R, S, rgb_padding, loss_sum, d_h, d_r, dWn,
                dbn, st);
}

extern "C" int satnerf_nerf_field_heads(int dtype, const void* h, int F, const void* rf, int Fh,
                                        const void* Wn, const void* bn, int P,
                                        float rgb_padding, void* out, void* stream) {
  if (!narrow_shapes_ok(F, Fh) || P < 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = dtype == 0 ? launch_nerf_field_heads<float> : launch_nerf_field_heads<bf16>;
  return launch(h, F, rf, Fh, Wn, bn, P, rgb_padding, out, st);
}

extern "C" int satnerf_nerf_field_heads_bwd(int dtype, const void* h, int F, const void* rf,
                                            int Fh, const void* Wn, const void* bn,
                                            const void* g, int P, float rgb_padding, void* d_h,
                                            void* d_r, void* dWn, void* dbn, void* stream) {
  if (!narrow_shapes_ok(F, Fh) || P < 0 || g == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch =
      dtype == 0 ? launch_nerf_field_heads_bwd_np<float> : launch_nerf_field_heads_bwd_np<bf16>;
  return launch(h, F, rf, Fh, Wn, bn, g, P, rgb_padding, d_h, d_r, dWn, dbn, st);
}

// Training step for the SIREN variants (s-nerf, sat-nerf) on Hopper.
//
// Replaces the TPU kernel fused_train_loss_grads (satnerf_tpu/ops/pallas/
// fused_mlp.py:1804, kernel body _make_train_loss_bwd_kernel :1536): rays,
// depths, sigma noise and target colors in; the loss sums, every weight
// gradient and the per-ray gradient of the transient embedding out. The TPU
// kernel keeps all weights and their fp32 gradient accumulators in VMEM and
// moves between rays and points with selection-matrix matmuls. Here the
// forward is the serving chain of siren_dense launches (fused_render.cu),
// which in training also write each sine layer's slope w0*cos(w0*pre) in
// fp32, and the backward is three more kernels:
//
//   composite_loss_bwd   narrow heads, compositor, loss and their adjoints,
//                        a block per ray (or, asked for, the earlier walk of
//                        a warp per ray): loss sums, the narrow heads' weight
//                        gradients, and the cotangents of h, r, s2, bh, skyh
//   composite_bwd        the same walk with the loss stage replaced by a given
//                        (R, 16) cotangent of the per-ray products: the
//                        backward of the training render fused_train_render_rays
//                        (fused_mlp.py:1312, _composite_bwd_tile :1202)
//   siren_dense_dgrad    dX (+)= (dY * slope) . W^T
//   siren_dense_wgrad    dW += X^T . (dY * slope), db += sum (dY * slope),
//                        dC += E^T . (dY * slope) (on wgmma in the GEMM's
//                        epilogue; elsewhere narrow_grads)
//   narrow_grads         db, dC where no GEMM formed them, and the per-ray
//                        gradient of E, sum_s (dY * slope) . C^T (for beta_0
//                        t_grad), of one or more layers a launch
//
// Rounding follows the JAX kernel (_point_bwd_from_saves :406): a cotangent
// G = dY * slope is formed in fp32, rounded to the compute type before both
// of its products, bias gradients sum the unrounded G, and every weight
// gradient accumulates in fp32. Cotangents between layers (dY, dX) are fp32.
//
// Sums across blocks use fp32 atomicAdd into buffers the wrapper zeroes, so
// the order of addition, and with it the last bits, changes from run to run.

#include <algorithm>

#include "common.cuh"
#include "dense_bwd_wgmma.cuh"
#include "hopper.cuh"

namespace {

// G[p, n] = dY[p, n] * slope[p, n]; slope == nullptr for a linear layer.
__device__ __forceinline__ float4 cotangent4(const float* __restrict__ dY,
                                             const float* __restrict__ slope, size_t idx) {
  float4 g = *reinterpret_cast<const float4*>(dY + idx);
  if (slope != nullptr) {
    const float4 c = *reinterpret_cast<const float4*>(slope + idx);
    g.x *= c.x; g.y *= c.y; g.z *= c.z; g.w *= c.w;
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

constexpr int SIMT_BK = 8, TM = 8, TN = 8;
constexpr int T_LD = TC_BK + 8;  // padded row of a [128][32] bf16 tile
constexpr int W_LD = BN + 8;     // padded row of a [32][128] bf16 tile

// ---------------------------------------------------------- siren_dense_dgrad
//
// dX[p, k] (+)= sum_n round(G[p, n]) * W[k, n]   (fused_mlp.py:452-516, the
// _dot_t_rhs products). W is the forward's (K, N) weight: contiguous along
// N, the reduction, so it is the ordinary K-major B operand. Where two
// branches meet (d_feats, d_h) the second launch accumulates onto the first's
// output, without atomics: the result is the same from run to run.
//
// What bounds it: G comes as two fp32 tensors, 8 bytes of operand a value,
// and dX leaves in fp32: at 512 x 512 and 65,536 points 0.120 ms of bytes
// against 0.035 ms of products, so it is bound by device memory. Three
// mainloops, one rule (satnerf_siren_dense_dgrad below; ops/fused_mlp.py
// dense_mainloop mirrors it):
//  * wgmma (bf16, N and K multiples of 64, dY, slope, W and dX 16-byte
//    aligned: every main-path launch). dgrad_wgmma<G_SLOPE>
//    (dense_bwd_wgmma.cuh, shared with the nerf variant's dgrad) is
//    persistent, one block an SM walking 128 x 256 tiles of dX. A producer
//    warp keeps four 32-deep stages in flight, TMA loads of the fp32 dY and
//    slope tiles (128 x 32, 128-byte swizzle) and of W (256 x 32 bf16,
//    64-byte swizzle), 48 KB a stage, so the card's memory stays busy while
//    the consumers convert, multiply and write. Two consumer warpgroups own
//    64 rows each: a thread reads its A-fragment elements of dY and slope
//    from shared memory, forms G in fp32, rounds it to bf16 and packs it into
//    the registers of a register-A (RS) m64n256k16 wgmma. The epilogue writes
//    dX from the accumulators as 16-byte vectors (an exchange between
//    neighbouring lanes), adding onto out where asked; the column tiles of a
//    row tile are neighbours in the walk, so G's second read comes from L2.
//  * wmma (bf16, N a multiple of 8, dY, slope and W 16-byte aligned; or
//    asked for): WMMA fragments with the G tile formed from its two fp32
//    operands on the way into shared memory, 128 x 128 x 32 tiles.
//  * simt (fp32, and bf16 of other shapes): a register-tiled SIMT GEMM.
// The grids of the last two are one-dimensional with the column tile running
// fastest: the blocks that share a row tile of G run next to each other and
// find it in L2.

template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
dgrad_simt(const float* __restrict__ dY, const float* __restrict__ slope,
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
      const int q = row0 + m;
      float g = 0.f;
      if (q < P && gn < N) {
        const size_t idx = (size_t)q * N + gn;
        g = dY[idx];
        if (slope != nullptr) g *= slope[idx];
      }
      As[nb + i][m] = round_to<T>(g);
      const int gk = col0 + m;
      Bs[nb + i][m] = (gk < K && gn < N) ? to_f32<T>(W[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
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
dgrad_wmma(const float* __restrict__ dY, const float* __restrict__ slope,
           const __nv_bfloat16* __restrict__ W, float* __restrict__ dX, int accumulate,
           int P, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 Gs[BM][T_LD];  // G tile [p][n]
  __shared__ __align__(32) __nv_bfloat16 Ws[BN][T_LD];  // W tile [k][n]
  __shared__ __align__(32) float Stage[DENSE_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int col_tiles = (K + BN - 1) / BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int col0 = (blockIdx.x % col_tiles) * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
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
      rg[i] = (row0 + r < P && n0 + c < N)
                  ? cotangent4(dY, slope, (size_t)(row0 + r) * N + n0 + c)
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
      *reinterpret_cast<uint2*>(&Gs[v / (TC_BK / 4)][(v % (TC_BK / 4)) * 4]) =
          pack_bf16x4(rg[i]);
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      // W^T as a column-major B: element (n, k) sits at Ws[k][n]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &Gs[wm * 32 + i * 16][kk], T_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[wn * 64 + j * 16][kk], T_LD);
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

// ---------------------------------------------------------- siren_dense_wgrad
//
// dW[k, n] += sum_p X[p, k] * round(G[p, n])   (the _dot_t_lhs products of
// fused_mlp.py:450-519). The sum runs over all P points for only K*N
// outputs, so the points are split across blocks and the partial tiles meet
// in dW by fp32 atomicAdd. Three mainloops, one rule
// (satnerf_siren_dense_wgrad below; ops/fused_mlp.py dense_mainloop mirrors
// it):
//  * wgmma (bf16, K and N multiples of 64, X, dY and slope 16-byte aligned:
//    every main-path launch with K > 0). wgrad_wgmma<G_SLOPE, 0>
//    (dense_bwd_wgmma.cuh, shared with the nerf variant's wgrad); it also
//    sums db. A block owns a 128 x 256 tile of dW^T (128 columns n of G, 256
//    columns k of X) and one range of `split` points; a producer warp keeps
//    four 32-point stages of dY, slope (32 x 32 fp32 boxes) and X (32 x 64
//    bf16 boxes) in flight, 48 KB a stage; the consumers form G^T in
//    registers down the columns of the swizzled tiles, sum db from the same
//    unrounded values, and run an RS m64n256k16 wgmma with an N-major B; the
//    epilogue adds the tile into dW with fp32 atomics. Blocks are numbered
//    split-major, so the tiles sharing a point range run side by side and X
//    and G come from L2 on their second read. What bounds it: G's two fp32
//    tensors, read once from device memory; at 512 x 512 and 65,536 points
//    335 MB, 0.101 ms, against 0.035 ms of products.
//  * wmma (bf16, K and N multiples of 8, the same pointers aligned): WMMA
//    fragments, G formed from its two fp32 operands on the way into shared
//    memory, 128 x 128 tiles of dW, WGRAD_SPLIT points a block (blockIdx.z).
//  * simt (fp32, and bf16 of other shapes): a register-tiled SIMT GEMM.
//
// The narrow gradients are what is too narrow for a GEMM tile: db[n] +=
// sum_p G[p, n] (unrounded, as the JAX kernel sums it) where the GEMM did
// not (wmma, simt, K = 0), dC[j, n] += sum_p E[p, j] * round(G[p, n]) for
// the layers with an E operand, and on request the per-ray gradient of E
// itself, dE[r, j] = sum_s sum_n round(G[p, n]) * C[j, n]: that is t_grad
// when the layer is beta_0 (fused_mlp.py:493,1633). Two bodies (the
// wrapper's `narrow=`):
//  * narrow_grads ("rays", the rule): its own launch, by the wrapper,
//    of one or more layers' jobs (the chain joins sky_0's with beta_0's dE);
//    on wgmma the wgrad's epilogue forms dC itself (the fold,
//    dense_bwd_wgmma.cuh), so it runs where there is no GEMM (layer 0,
//    sky_0), for dE, and beside wmma / simt. See below.
//  * small_grads ("walk", kept to compare), launched by the wgrad's C entry
//    after the GEMM: one thread a column over a chunk of SMALL_CHUNK points,
//    E rebuilt by every column's thread, one atomic a column a chunk. The
//    wrapper says whether it runs (SMALL_*), and the C entry refuses any
//    other answer.

constexpr int WGRAD_SPLIT = 2048;
constexpr int SMALL_THREADS = 128;
constexpr int SMALL_CHUNK = 64;

template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
wgrad_simt(const T* __restrict__ X, const float* __restrict__ dY,
           const float* __restrict__ slope, float* __restrict__ dW, int P, int N, int K) {
  __shared__ float As[SIMT_BK][BM];  // X^T tile: As[p][k]
  __shared__ float Bs[SIMT_BK][BN];  // G tile: Bs[p][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM;  // k
  const int col0 = blockIdx.y * BN;  // n
  const int p_begin = blockIdx.z * WGRAD_SPLIT;
  const int p_end = min(P, p_begin + WGRAD_SPLIT);
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
      const int gk = row0 + cb + i;
      As[pp][cb + i] = (q < p_end && gk < K) ? to_f32<T>(X[(size_t)q * K + gk]) : 0.f;
      const int gn = col0 + cb + i;
      float g = 0.f;
      if (q < p_end && gn < N) {
        const size_t idx = (size_t)q * N + gn;
        g = dY[idx];
        if (slope != nullptr) g *= slope[idx];
      }
      Bs[pp][cb + i] = round_to<T>(g);
    }
    __syncthreads();
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

__global__ void __launch_bounds__(DENSE_THREADS)
wgrad_wmma(const __nv_bfloat16* __restrict__ X, const float* __restrict__ dY,
           const float* __restrict__ slope, float* __restrict__ dW, int P, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 Xs[TC_BK][W_LD];  // X tile [p][k]
  __shared__ __align__(32) __nv_bfloat16 Gs[TC_BK][W_LD];  // G tile [p][n]
  __shared__ __align__(32) float Stage[DENSE_THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.x * BM;  // k
  const int col0 = blockIdx.y * BN;  // n
  const int p_begin = blockIdx.z * WGRAD_SPLIT;
  const int p_end = min(P, p_begin + WGRAD_SPLIT);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 rx[2];
  float4 rg[4];
  auto load_tiles = [&](int p0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int r = v / (BM / 8), c = (v % (BM / 8)) * 8;
      rx[i] = (p0 + r < p_end && row0 + c < K)
                  ? *reinterpret_cast<const uint4*>(X + (size_t)(p0 + r) * K + row0 + c)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + DENSE_THREADS * i;
      const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
      rg[i] = (p0 + r < p_end && col0 + c < N)
                  ? cotangent4(dY, slope, (size_t)(p0 + r) * N + col0 + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  load_tiles(p_begin);
  for (int p0 = p_begin; p0 < p_end; p0 += TC_BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + DENSE_THREADS * i;
      *reinterpret_cast<uint4*>(&Xs[v / (BM / 8)][(v % (BM / 8)) * 8]) = rx[i];
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &Xs[kk][wm * 32 + i * 16], W_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Gs[kk][wn * 64 + j * 16], W_LD);
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

// DB: db is summed here (the GEMM did not sum it); otherwise db is left out
// and only dC / dE are formed.
template <typename T, bool DB>
__global__ void __launch_bounds__(SMALL_THREADS)
small_grads(const float* __restrict__ dY, const float* __restrict__ slope, int P, int N,
            const float* __restrict__ rays, const float* __restrict__ z, int S,
            int extra_mode, int extra_off, int n_extra, const T* __restrict__ C,
            float* __restrict__ db, float* __restrict__ dC, float* __restrict__ dE) {
  const int n = blockIdx.y * SMALL_THREADS + threadIdx.x;
  const bool col_ok = n < N;  // no early return: the warp sums below need every lane
  const int lane = threadIdx.x % 32;
  const int p_begin = blockIdx.x * SMALL_CHUNK;
  const int p_end = min(P, p_begin + SMALL_CHUNK);

  float c[MAX_EXTRA], dc_acc[MAX_EXTRA], de_acc[MAX_EXTRA];
#pragma unroll
  for (int j = 0; j < MAX_EXTRA; ++j) {
    c[j] = (dE != nullptr && j < n_extra && col_ok) ? to_f32<T>(C[(size_t)j * N + n]) : 0.f;
    dc_acc[j] = 0.f;
    de_acc[j] = 0.f;
  }
  float db_acc = 0.f;

  auto flush_ray = [&](int ray) {
#pragma unroll
    for (int j = 0; j < MAX_EXTRA; ++j) {
      if (j < n_extra) {
        const float v = warp_sum(de_acc[j]);
        if (lane == 0) atomicAdd(dE + (size_t)ray * n_extra + j, v);
        de_acc[j] = 0.f;
      }
    }
  };

  int cur_ray = p_begin / S;
  for (int p = p_begin; p < p_end; ++p) {
    const int ray = p / S;
    if (dE != nullptr && ray != cur_ray) {
      flush_ray(cur_ray);
      cur_ray = ray;
    }
    float g = 0.f;
    if (col_ok) {
      const size_t idx = (size_t)p * N + n;
      g = dY[idx];
      if (slope != nullptr) g *= slope[idx];
    }
    if (DB) db_acc += g;
    const float gb = round_to<T>(g);
#pragma unroll
    for (int j = 0; j < MAX_EXTRA; ++j) {
      if (j < n_extra) {
        const float e = extra_value<T>(rays, z, S, extra_mode, extra_off, p, j);
        dc_acc[j] = fmaf(e, gb, dc_acc[j]);
        de_acc[j] = fmaf(gb, c[j], de_acc[j]);
      }
    }
  }
  if (dE != nullptr && p_begin < p_end) flush_ray(cur_ray);
  if (col_ok) {
    if (DB) atomicAdd(db + n, db_acc);
#pragma unroll
    for (int j = 0; j < MAX_EXTRA; ++j)
      if (j < n_extra) atomicAdd(dC + (size_t)j * N + n, dc_acc[j]);
  }
}

// --------------------------------------------------------------- narrow_grads
//
// A block owns a range of whole rays of one job and all of its N <= 512
// columns: 4 columns a thread (16-byte loads of dY and the slope), the
// threads of a row NR = 32, 64 or 128 (N up to 128, 256, 512) and 256 / NR
// rows side by side, four rows in flight a thread. E of a tile of 256 points
// is formed once, a point a thread, into shared memory. db and dC add up in
// registers over the whole range and meet in shared memory: one atomicAdd a
// column a block. dE: a thread's share of each point, sum_n round(G) C[j, n]
// over its 4 columns, adds up over the points of its current ray; when the
// ray changes the warp sums it and adds it into the ray's row in shared
// memory, and the block stores its rays' rows of dE, no atomics (it owns
// them). Bound by device memory: G's two fp32 tensors are read once (layer 0
// at 65,536 x 512: 268 MB, 0.080 ms at 3.35 TB/s); the grid is about one
// wave of resident blocks, NARROW_MIN_POINTS points a block at least.
// vec: N a multiple of 4, dY and the slope 16-byte aligned (else element
// loads).
struct NarrowJob {
  const float* dY;     // (P, N) fp32
  const float* slope;  // (P, N) fp32, or nullptr: a linear layer
  const float* rays;   // rays16 (R, 16)
  const float* z;      // (R, S), read for EXTRA_XYZ
  const void* C;       // (n_extra, N) in the compute dtype, read for dE
  float* db;           // (N,), nullptr: not asked
  float* dC;           // (n_extra, N), nullptr: not asked
  float* dE;           // (R, n_extra), nullptr: not asked
  int P, N, S, extra_mode, extra_off, n_extra;
  int rays_per_block, block0;  // a block's rays; the job's first block
};
constexpr int NARROW_MAX_JOBS = 4;
struct NarrowJobs {
  NarrowJob job[NARROW_MAX_JOBS];
  int n;
};
constexpr int NARROW_THREADS = 256;
constexpr int NARROW_TILE = 256;        // points whose E is formed at once
constexpr int NARROW_MAX_N = 512;
constexpr int NARROW_DE_FLOATS = 2048;  // a block's rows of dE
constexpr int NARROW_MIN_POINTS = 64;
constexpr int NARROW_UNROLL = 4;

// NE: the E columns the registers hold (every job's n_extra at most NE).
template <typename T, int NE>
__global__ void __launch_bounds__(NARROW_THREADS)
narrow_grads(const __grid_constant__ NarrowJobs jobs) {
  constexpr int NA = NE > 0 ? NE : 1;
  __shared__ float es[NARROW_TILE][NA];
  __shared__ float red[(1 + NA) * NARROW_MAX_N];  // db, then dC's rows
  __shared__ float de_s[NARROW_DE_FLOATS];
  int ji = 0;
  while (ji + 1 < jobs.n && (int)blockIdx.x >= jobs.job[ji + 1].block0) ++ji;
  const NarrowJob& jb = jobs.job[ji];
  const int N = jb.N, S = jb.S, ne = jb.n_extra;
  const int R = jb.P / S;
  const int r_begin = ((int)blockIdx.x - jb.block0) * jb.rays_per_block;
  const int r_end = min(R, r_begin + jb.rays_per_block);
  const int p_begin = r_begin * S, p_end = r_end * S;
  const int tid = threadIdx.x, lane = tid % 32;
  const int NR = N <= 128 ? 32 : N <= 256 ? 64 : 128;  // threads a row
  const int rows = NARROW_THREADS / NR;
  const int slot = tid / NR, n = (tid % NR) * 4;
  const bool col_ok = n < N;
  const bool vec = N % 4 == 0 && ((reinterpret_cast<uintptr_t>(jb.dY) |
                                   reinterpret_cast<uintptr_t>(jb.slope)) % 16 == 0);
  const bool want_db = jb.db != nullptr, want_dc = jb.dC != nullptr, want_de = jb.dE != nullptr;

  for (int i = tid; i < (1 + ne) * N; i += NARROW_THREADS) red[i] = 0.f;
  for (int i = tid; i < (r_end - r_begin) * ne; i += NARROW_THREADS) de_s[i] = 0.f;
  float c[NA][4];  // dE's weight at this thread's columns
#pragma unroll
  for (int j = 0; j < NE; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[j][i] = want_de && j < ne && n + i < N
                    ? to_f32<T>(static_cast<const T*>(jb.C)[(size_t)j * N + n + i])
                    : 0.f;
  float db_acc[4] = {0.f, 0.f, 0.f, 0.f}, dc_acc[NA][4], de_acc[NA];
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    de_acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) dc_acc[j][i] = 0.f;
  }
  int cur_ray = r_begin;
  // the warp's share of dE of its current ray into shared memory
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      if (j < ne) {
        const float v = warp_sum(de_acc[j]);
        if (lane == 0) atomicAdd(&de_s[(cur_ray - r_begin) * ne + j], v);
        de_acc[j] = 0.f;
      }
    }
  };

  for (int t0 = p_begin; t0 < p_end; t0 += NARROW_TILE) {
    const int t_end = min(p_end, t0 + NARROW_TILE);
    __syncthreads();  // the last tile's E is read; red and de_s are zeroed
    if (want_dc && t0 + tid < t_end) {
      for (int j = 0; j < ne; ++j)
        es[tid][j] = extra_value<T>(jb.rays, jb.z, S, jb.extra_mode, jb.extra_off, t0 + tid, j);
    }
    __syncthreads();
    for (int p0 = t0 + slot; p0 < t_end; p0 += rows * NARROW_UNROLL) {
      float4 dy[NARROW_UNROLL], sl[NARROW_UNROLL];
#pragma unroll
      for (int u = 0; u < NARROW_UNROLL; ++u) {
        const int p = p0 + u * rows;
        dy[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        sl[u] = make_float4(1.f, 1.f, 1.f, 1.f);
        if (p < t_end && col_ok) {
          const size_t idx = (size_t)p * N + n;
          if (vec) {
            dy[u] = *reinterpret_cast<const float4*>(jb.dY + idx);
            if (jb.slope != nullptr) sl[u] = *reinterpret_cast<const float4*>(jb.slope + idx);
          } else {
            float d[4] = {0.f, 0.f, 0.f, 0.f}, l[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (n + i < N) {
                d[i] = jb.dY[idx + i];
                if (jb.slope != nullptr) l[i] = jb.slope[idx + i];
              }
            }
            dy[u] = make_float4(d[0], d[1], d[2], d[3]);
            sl[u] = make_float4(l[0], l[1], l[2], l[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NARROW_UNROLL; ++u) {
        const int p = p0 + u * rows;
        if (p >= t_end) break;  // the same for every lane of the warp
        const float g[4] = {dy[u].x * sl[u].x, dy[u].y * sl[u].y, dy[u].z * sl[u].z,
                            dy[u].w * sl[u].w};
        float gb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          db_acc[i] += g[i];
          gb[i] = round_to<T>(g[i]);
        }
        if (want_dc) {
#pragma unroll
          for (int j = 0; j < NE; ++j) {
            if (j < ne) {
              const float e = es[p - t0][j];
#pragma unroll
              for (int i = 0; i < 4; ++i) dc_acc[j][i] = fmaf(e, gb[i], dc_acc[j][i]);
            }
          }
        }
        if (want_de) {
          const int ray = p / S;
          if (ray != cur_ray) {
            flush();
            cur_ray = ray;
          }
#pragma unroll
          for (int j = 0; j < NE; ++j) {
            if (j < ne) {
#pragma unroll
              for (int i = 0; i < 4; ++i) de_acc[j] = fmaf(gb[i], c[j][i], de_acc[j]);
            }
          }
        }
      }
    }
  }
  if (want_de) flush();

  // db and dC: the rows' sums meet in shared memory, then one atomic a column
  if (col_ok) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n + i >= N) break;
      if (want_db) atomicAdd(&red[n + i], db_acc[i]);
#pragma unroll
      for (int j = 0; j < NE; ++j)
        if (want_dc && j < ne) atomicAdd(&red[(1 + j) * N + n + i], dc_acc[j][i]);
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += NARROW_THREADS)
    if (want_db) atomicAdd(jb.db + i, red[i]);
  for (int i = tid; i < ne * N; i += NARROW_THREADS)
    if (want_dc) atomicAdd(jb.dC + i, red[N + i]);
  for (int i = tid; i < (r_end - r_begin) * ne; i += NARROW_THREADS)
    if (want_de) jb.dE[(size_t)r_begin * ne + i] = de_s[i];
}

// --------------------------------------------------------- composite_loss_bwd
//
// Replaces, of fused_mlp.py:1536: the narrow heads forward (_narrow_fwd
// :296), the compositor with sigma noise (_composite_tile :980), the loss
// sums and the per-ray loss cotangents (:1586-1611), the compositor adjoint
// (_composite_bwd_tile :1202) and the narrow heads' backward (narrow_bwd
// :432). One warp per ray, as heads_composite:
//
//   1. forward over the ray's S samples: the narrow heads as warp-reduced
//      dot products, the compositor in fp32; per-sample values go to shared
//      memory, the ray's rgb and beta integrals stay in registers
//   2. the ray's loss terms (added to loss_sums) and the cotangents of its
//      rgb (masked where the unclipped integral leaves [0, 1]) and beta
//   3. backward over the samples from the last to the first, carrying the
//      suffix sum of dw*w that the transparency adjoint needs: the narrow
//      pre-activation cotangents, rounded to the compute type before both of
//      their products, give the rows of dWn (kept in registers over the
//      warp's samples) and, times the narrow weights, the cotangents of h
//      (its sigma part), r, s2 and bh, written in fp32
//   4. sky is per ray: its cotangent sums over the samples before sky_1;
//      d_skyh comes out masked by relu
//
// loss_sums: [sum 0.5*sq/beta^2, sum log beta, sum sq] over the rays.
// g_rgb = diff * (wmix/beta^2 + (1-wmix)*2) / (3R), g_beta = wmix *
// (0.5/(R beta) - sq/(3R beta^3)), R the number of rays (every ray this
// kernel sees is valid: the ragged edge is masked by the warp's early exit,
// nothing is padded). Without the beta head (bh == nullptr) the loss is the
// MSE and wmix is ignored.
//
// The transparency adjoint divides the suffix sum by (1 - alpha + 1e-10) and
// multiplies by (1 - alpha): where alpha saturates (the last sample's delta
// is 1e10) the quotient is large but finite and the product is exactly 0.
//
// Bound by device memory: h, r, s2, bh are read twice (forward, backward)
// and four cotangent tensors are written in fp32.
//
// GIVEN instantiations are composite_bwd: stage 2 reads the ray's cotangent
// g (R, 16) in the layout of the products (rgb 0:3, depth 3, sun 4, sky 5:8,
// beta 8, albedo 9:12, opacity 12) where the loss instantiations derive
// theirs from gt, and stage 3 adds the terms of the five products the loss
// does not touch: dw += g_depth * z + g_op + sunv * g_sun + rgb . g_alb +
// sky . g_sky, d_sunv += w * g_sun, d_sky += w * g_sky, d_rgb += w * g_alb.
// They write no loss sums and no weights. The loss instantiations compile to
// the code they had before the template parameter.

constexpr int CLB_WARPS = 4;
constexpr int CLB_MAX_F = 512;            // widest trunk the register rows hold
constexpr int CLB_F_REGS = CLB_MAX_F / 32;
constexpr int CLB_H_REGS = CLB_F_REGS / 2;
constexpr int CLB_SAMPLE_VALS = 10;       // sigma, delta, 1-alpha, T, w, rgb_s x3, sunv, beta

template <typename T, bool GIVEN>
__global__ void __launch_bounds__(CLB_WARPS * 32)
composite_loss_bwd_kernel(const T* __restrict__ h, int F, const T* __restrict__ rf,
                          const T* __restrict__ s2, const T* __restrict__ bh,
                          const T* __restrict__ skyh, int Fh, const T* __restrict__ Wn,
                          const float* __restrict__ bn, const float* __restrict__ z,
                          const float* __restrict__ noise, const float* __restrict__ gt,
                          const float* __restrict__ g_ray, int R, int S, float rgb_padding,
                          float beta_min, float wmix,
                          float* __restrict__ loss_sums, float* __restrict__ weights,
                          float* __restrict__ d_h, float* __restrict__ d_r,
                          float* __restrict__ d_s2, float* __restrict__ d_bh,
                          float* __restrict__ d_skyh, float* __restrict__ dWn,
                          float* __restrict__ dbn) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int ray = blockIdx.x * CLB_WARPS + warp;
  if (ray >= R) return;  // the whole warp leaves together; no block barrier below
  float* sv = smem + (size_t)warp * CLB_SAMPLE_VALS * S;
  float* v_sigma = sv;          float* v_delta = sv + S;     float* v_oma = sv + 2 * S;
  float* v_trans = sv + 3 * S;  float* v_w = sv + 4 * S;     float* v_c0 = sv + 5 * S;
  float* v_c1 = sv + 6 * S;     float* v_c2 = sv + 7 * S;    float* v_sun = sv + 8 * S;
  float* v_beta = sv + 9 * S;

  const bool use_beta = bh != nullptr;
  const T* w_sig = Wn;
  const T* w_rgb = Wn + (size_t)1 * F;
  const T* w_sun = Wn + (size_t)4 * F;
  const T* w_sky = Wn + (size_t)5 * F;
  const T* w_beta = Wn + (size_t)8 * F;
  const float pad2 = 1.f + 2.f * rgb_padding;

  // ---- sky, once a ray
  float sky[3] = {0.f, 0.f, 0.f};
  {
    const T* x = skyh + (size_t)ray * Fh;
    for (int k = lane; k < Fh; k += 32) {
      const float v = to_f32<T>(x[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) sky[c] = fmaf(v, to_f32<T>(w_sky[(size_t)c * F + k]), sky[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) sky[c] = sigmoidf(warp_sum(sky[c]) + bn[5 + c]);
  }

  // ---- 1. forward
  const float* zr = z + (size_t)ray * S;
  float trans = 1.f, beta_acc = 0.f, rgb_acc[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const size_t q = (size_t)ray * S + s;
    float sig = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, sn = 0.f, bt = 0.f;
    const T* hq = h + q * F;
    for (int k = lane; k < F; k += 32) sig = fmaf(to_f32<T>(hq[k]), to_f32<T>(w_sig[k]), sig);
    const T* rq = rf + q * Fh;
    const T* sq = s2 + q * Fh;
    for (int k = lane; k < Fh; k += 32) {
      const float v = to_f32<T>(rq[k]);
      c0 = fmaf(v, to_f32<T>(w_rgb[k]), c0);
      c1 = fmaf(v, to_f32<T>(w_rgb[(size_t)F + k]), c1);
      c2 = fmaf(v, to_f32<T>(w_rgb[(size_t)2 * F + k]), c2);
      sn = fmaf(to_f32<T>(sq[k]), to_f32<T>(w_sun[k]), sn);
    }
    if (use_beta) {
      const T* bq = bh + q * Fh;
      for (int k = lane; k < Fh; k += 32) bt = fmaf(to_f32<T>(bq[k]), to_f32<T>(w_beta[k]), bt);
    }
    const float sigma = softplusf(warp_sum(sig) + bn[0]);
    const float cs[3] = {sigmoidf(warp_sum(c0) + bn[1]), sigmoidf(warp_sum(c1) + bn[2]),
                         sigmoidf(warp_sum(c2) + bn[3])};
    const float sunv = sigmoidf(warp_sum(sn) + bn[4]);
    const float beta = use_beta ? softplusf(warp_sum(bt) + bn[8]) : 0.f;

    const float zs = zr[s];
    const float delta = s < S - 1 ? zr[s + 1] - zs : 1e10f;
    const float sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    const float oma = expf(-delta * fmaxf(sigma_n, 0.f));  // 1 - alpha
    const float alpha = 1.f - oma;
    const float w = alpha * trans;
    if (lane == 0) {
      v_sigma[s] = sigma; v_delta[s] = delta; v_oma[s] = oma; v_trans[s] = trans;
      v_w[s] = w; v_c0[s] = cs[0]; v_c1[s] = cs[1]; v_c2[s] = cs[2];
      v_sun[s] = sunv; v_beta[s] = beta;
      if constexpr (!GIVEN) {
        if (weights != nullptr) weights[q] = w;
      }
    }
    trans *= 1.f - alpha + 1e-10f;
    beta_acc += w * beta;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb_acc[c] += w * (cs[c] * pad2 - rgb_padding) * (sunv + (1.f - sunv) * sky[c]);
  }
  __syncwarp();

  // ---- 2. the ray's cotangents: from the loss, or given
  float g_rgb[3], g_beta = 0.f;
  float g_alb[3] = {0.f, 0.f, 0.f}, g_sky[3] = {0.f, 0.f, 0.f};
  float g_depth = 0.f, g_sun = 0.f, g_op = 0.f;
  if constexpr (GIVEN) {
    const float* gr = g_ray + (size_t)ray * OUT_COLS;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool inside = rgb_acc[c] >= 0.f && rgb_acc[c] <= 1.f;  // the clip's adjoint
      g_rgb[c] = inside ? gr[c] : 0.f;
      g_sky[c] = gr[5 + c];
      g_alb[c] = gr[9 + c];
    }
    g_depth = gr[3];
    g_sun = gr[4];
    g_beta = use_beta ? gr[8] : 0.f;
    g_op = gr[12];
  } else {
    const float inv3n = 1.f / (3.f * (float)R), invn = 1.f / (float)R;
    float sq_err = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = fminf(fmaxf(rgb_acc[c], 0.f), 1.f) - gt[(size_t)ray * 3 + c];
      sq_err += diff * diff;
      g_rgb[c] = diff;
    }
    float s_sat = 0.f, s_logb = 0.f;
    float rgb_scale = 2.f * inv3n;
    if (use_beta) {
      const float beta_l = beta_acc + beta_min;
      const float inv_b2 = 1.f / (beta_l * beta_l);
      s_sat = 0.5f * sq_err * inv_b2;
      s_logb = logf(beta_l);
      rgb_scale = wmix * inv_b2 * inv3n + (1.f - wmix) * 2.f * inv3n;
      g_beta = wmix * (0.5f * invn / beta_l - sq_err * inv_b2 / beta_l * inv3n);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool inside = rgb_acc[c] >= 0.f && rgb_acc[c] <= 1.f;  // the clip's adjoint
      g_rgb[c] = inside ? g_rgb[c] * rgb_scale : 0.f;
    }
    if (lane == 0) {
      atomicAdd(loss_sums + 0, s_sat);
      atomicAdd(loss_sums + 1, s_logb);
      atomicAdd(loss_sums + 2, sq_err);
    }
  }

  // ---- 3. backward over the samples
  float a_sig[CLB_F_REGS];
  float a_rgb[3][CLB_H_REGS], a_sun[CLB_H_REGS], a_beta[CLB_H_REGS];
#pragma unroll
  for (int i = 0; i < CLB_F_REGS; ++i) a_sig[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CLB_H_REGS; ++i) {
    a_rgb[0][i] = a_rgb[1][i] = a_rgb[2][i] = a_sun[i] = a_beta[i] = 0.f;
  }
  float b_acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float d_sky[3] = {0.f, 0.f, 0.f};
  float suffix = 0.f;  // sum over later samples of dw * w

  for (int s = S - 1; s >= 0; --s) {
    const size_t q = (size_t)ray * S + s;
    const float sigma = v_sigma[s], delta = v_delta[s], oma = v_oma[s];
    const float tr = v_trans[s], w = v_w[s], sunv = v_sun[s], beta = v_beta[s];
    const float cs[3] = {v_c0[s], v_c1[s], v_c2[s]};
    float dw = beta * g_beta, d_sunv = 0.f, g_pre_rgb[3];
    if constexpr (GIVEN) {
      dw += g_depth * zr[s] + g_op + sunv * g_sun;
      d_sunv = w * g_sun;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = cs[c] * pad2 - rgb_padding;
      const float irr = sunv + (1.f - sunv) * sky[c];
      const float d_irr = w * rgb * g_rgb[c];
      dw += rgb * irr * g_rgb[c];
      d_sunv += d_irr * (1.f - sky[c]);
      d_sky[c] += d_irr * (1.f - sunv);
      if constexpr (GIVEN) {
        dw += rgb * g_alb[c] + sky[c] * g_sky[c];
        d_sky[c] += w * g_sky[c];
        g_pre_rgb[c] = w * (irr * g_rgb[c] + g_alb[c]) * pad2 * cs[c] * (1.f - cs[c]);
      } else {
        g_pre_rgb[c] = w * irr * g_rgb[c] * pad2 * cs[c] * (1.f - cs[c]);
      }
    }
    // the factor the forward multiplied the transparency by, formed the same way
    const float d_alpha = dw * tr - suffix / (1.f - (1.f - oma) + 1e-10f);
    suffix += dw * w;
    const float sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    const float d_sn = sigma_n > 0.f ? d_alpha * oma * delta : 0.f;
    // softplus' = 1 - exp(-softplus), by expm1: at the last sample (delta 1e10)
    // the only sigmas that leave 1 - alpha above 0 are below 1e-8, where
    // 1.f - expf(-sigma) is 0
    const float g_pre_sig = d_sn * -expm1f(-sigma);
    const float g_pre_sun = d_sunv * sunv * (1.f - sunv);
    const float g_pre_beta = use_beta ? w * g_beta * -expm1f(-beta) : 0.f;

    b_acc[0] += g_pre_sig;
    b_acc[1] += g_pre_rgb[0]; b_acc[2] += g_pre_rgb[1]; b_acc[3] += g_pre_rgb[2];
    b_acc[4] += g_pre_sun;
    b_acc[8] += g_pre_beta;
    const float gb_sig = round_to<T>(g_pre_sig), gb_sun = round_to<T>(g_pre_sun);
    const float gb_beta = round_to<T>(g_pre_beta);
    const float gb_rgb[3] = {round_to<T>(g_pre_rgb[0]), round_to<T>(g_pre_rgb[1]),
                             round_to<T>(g_pre_rgb[2])};

    const T* hq = h + q * F;
    float* dhq = d_h + q * F;
#pragma unroll
    for (int i = 0; i < CLB_F_REGS; ++i) {
      const int k = lane + 32 * i;
      if (k < F) {
        a_sig[i] = fmaf(gb_sig, to_f32<T>(hq[k]), a_sig[i]);
        dhq[k] = gb_sig * to_f32<T>(w_sig[k]);
      }
    }
    const T* rq = rf + q * Fh;
    const T* sq = s2 + q * Fh;
    const T* bq = use_beta ? bh + q * Fh : nullptr;
#pragma unroll
    for (int i = 0; i < CLB_H_REGS; ++i) {
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
        a_sun[i] = fmaf(gb_sun, to_f32<T>(sq[k]), a_sun[i]);
        d_s2[q * Fh + k] = gb_sun * to_f32<T>(w_sun[k]);
        if (use_beta) {
          a_beta[i] = fmaf(gb_beta, to_f32<T>(bq[k]), a_beta[i]);
          d_bh[q * Fh + k] = gb_beta * to_f32<T>(w_beta[k]);
        }
      }
    }
  }

  // ---- 4. sky_1 and relu of sky_0, once a ray
  float gb_sky[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = d_sky[c] * sky[c] * (1.f - sky[c]);
    b_acc[5 + c] = g;
    gb_sky[c] = round_to<T>(g);
  }
  {
    const T* x = skyh + (size_t)ray * Fh;
#pragma unroll
    for (int i = 0; i < CLB_H_REGS; ++i) {
      const int k = lane + 32 * i;
      if (k < Fh) {
        const float xv = to_f32<T>(x[k]);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          d = fmaf(gb_sky[c], to_f32<T>(w_sky[(size_t)c * F + k]), d);
          atomicAdd(dWn + (size_t)(5 + c) * F + k, gb_sky[c] * xv);
        }
        d_skyh[(size_t)ray * Fh + k] = xv > 0.f ? d : 0.f;
      }
    }
  }

  // ---- the ray's share of dWn and dbn
#pragma unroll
  for (int i = 0; i < CLB_F_REGS; ++i) {
    const int k = lane + 32 * i;
    if (k < F) atomicAdd(dWn + k, a_sig[i]);
  }
#pragma unroll
  for (int i = 0; i < CLB_H_REGS; ++i) {
    const int k = lane + 32 * i;
    if (k < Fh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(dWn + (size_t)(1 + c) * F + k, a_rgb[c][i]);
      atomicAdd(dWn + (size_t)4 * F + k, a_sun[i]);
      if (use_beta) atomicAdd(dWn + (size_t)8 * F + k, a_beta[i]);
    }
  }
  if (lane < 9 && (lane != 8 || use_beta)) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j)
      if (j == lane) v = b_acc[j];
    atomicAdd(dbn + lane, v);
  }
}

// --------------------------------------- composite_loss_bwd, a block a ray
//
// The contract of composite_loss_bwd_kernel above (the "warp" body, kept for
// comparison), laid out so that a ray's samples run side by side: one block
// of CLB2_THREADS a ray (the "block" body).
//   1. the narrow heads of every sample: warps take samples; a lane reads 16
//      bytes of h, r, s2 and bh at a time (coalesced rows), every chunk of a
//      sample before the products, against the narrow weights, staged once a
//      block in shared memory as floats, and the six dot products are
//      reduced within the warp into shared memory
//   2. a thread a sample: alpha; the transmittance as an exclusive block scan
//      of the product of (1 - alpha + 1e-10) (warp scans, then the warps'
//      totals); the rgb and beta integrals as block sums. A saturated sample
//      (the last one's delta is 1e10) stays as in the walk: its factor is
//      1e-10, and 4. divides the suffix sum by it (large, finite) and
//      multiplies the quotient by 1 - alpha (exactly 0)
//   3. every thread: the ray's loss terms and cotangents (or the given ones)
//      from the block sums; thread 0 adds the loss sums
//   4. a thread a sample: the compositor adjoint, its suffix sum of dw * w a
//      reverse exclusive block scan; the narrow pre-activation cotangents,
//      rounded to the compute type into shared memory; dbn's and d_sky's
//      block sums
//   5. the outer products by columns: an item is 16 bytes' worth of columns
//      of h, r, s2 or bh (8 bf16, 4 fp32) and one of eight ranges of the
//      ray's samples; a thread walks its items' rows, four (r: two) in
//      flight at a time, writing d_h = gb_sig w_sig (d_r = sum_c gb_c w_c,
//      d_s2, d_bh) as 16-byte fp32 stores and summing its columns of dWn in
//      registers; the items' sums meet in shared memory (a block-level
//      reduction), then one atomicAdd a column a ray
//   6. sky_1 and the relu of sky_0, once a ray, as in the walk.
// Bound by device memory, as the walk: h, r, s2 and bh are read twice (the
// second time mostly from L2) and four cotangents written in fp32 (PERF.md:
// 0.151 ms at 1,024 rays x 64 samples); the walk's serial chain of warp
// reductions kept it far from that. The sums run in another order than the
// walk's (scans, block sums), so the last bits differ. Any S whose shared
// memory fits the 227 KB a block may opt into: 2. and 4. take the samples
// in chunks of CLB2_THREADS, a sample a thread each (the ceil(S / 256)
// samples a thread), the scans carrying the product and the sum of the
// chunks before (after) them, the sums adding up over the chunks; above one
// chunk the transmittance of each sample is kept in shared memory from 2. to
// 4. At S <= CLB2_THREADS (one chunk) the launch runs the instantiation
// with MULTI false, the code it ran before chunks were added: its outputs
// are the same to the bit (ops/fused_mlp.py composite_max_samples gives the
// largest S).
// vec: F and Fh multiples of 16 bytes' worth and the row tensors 16-byte
// aligned (else element loads and stores).

// SATNERF_CLB_ABLATE is 0 unless tools/profile_render_torch.py --composite
// builds this file with it, to time the block body's parts alone: 1 drops the
// outer products (5.), 2 the heads' loads (1., dot products of nothing), 3
// both (the per-sample arithmetic, the scans and the block's barriers).
#ifndef SATNERF_CLB_ABLATE
#define SATNERF_CLB_ABLATE 0
#endif

constexpr int CLB2_THREADS = SCAN_THREADS;  // common.cuh: the block scans' width
constexpr int CLB2_WARPS = SCAN_WARPS;
constexpr int CLB2_SUMS = 9;  // block sums after the adjoint: dbn 0:5 and 8, d_sky 3
constexpr int CLB2_RANGES = 8;  // the outer products cut each column's samples in 8

// The shared memory of a block, in floats: the narrow weights (rows padded
// to Fp = F and Fhp = Fh rounded up to 8), the six per-sample head values and
// the six rounded cotangents (S each), the block sums' and scans' scratch,
// sky, the column sums of dWn's rows 0 .. 4 and 8, and above one chunk of
// samples the transmittance of each (S). ops/fused_mlp.py
// composite_max_samples mirrors it.
__host__ __device__ constexpr int clb2_smem_floats(int F, int Fh, int S) {
  return (F + 7) / 8 * 8 + 8 * ((Fh + 7) / 8 * 8) + 12 * S + CLB2_WARPS * CLB2_SUMS + 4 + F +
         5 * Fh + (S > CLB2_THREADS ? S : 0);
}

// Registers for 2 blocks an SM (at most 128 a thread, no spills): builds for
// 1 (174 registers) and 3 (80, with spills) ran slower, 0.613 and 0.425
// against 0.384 ms at 1,024 rays x 64 on an H100 (PERF.md section 6).
template <typename T, bool GIVEN, bool MULTI>
__global__ void __launch_bounds__(CLB2_THREADS, 2)
composite_loss_bwd_block(const T* __restrict__ h, int F, const T* __restrict__ rf,
                         const T* __restrict__ s2, const T* __restrict__ bh,
                         const T* __restrict__ skyh, int Fh, const T* __restrict__ Wn,
                         const float* __restrict__ bn, const float* __restrict__ z,
                         const float* __restrict__ noise, const float* __restrict__ gt,
                         const float* __restrict__ g_ray, int R, int S, float rgb_padding,
                         float beta_min, float wmix, int vec,
                         float* __restrict__ loss_sums, float* __restrict__ weights,
                         float* __restrict__ d_h, float* __restrict__ d_r,
                         float* __restrict__ d_s2, float* __restrict__ d_bh,
                         float* __restrict__ d_skyh, float* __restrict__ dWn,
                         float* __restrict__ dbn) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int ray = blockIdx.x;
  const int Fp = (F + 7) / 8 * 8, Fhp = (Fh + 7) / 8 * 8;
  float* w_sig = smem;                 // Fp
  float* w_rgb = w_sig + Fp;           // 3 x Fhp
  float* w_sun = w_rgb + 3 * Fhp;      // Fhp
  float* w_sky = w_sun + Fhp;          // 3 x Fhp
  float* w_beta = w_sky + 3 * Fhp;     // Fhp
  float* v_sig = w_beta + Fhp;         // the heads a sample: sigma, albedo x3, sun_v, beta
  float* v_c = v_sig + S;              // 3 x S
  float* v_sun = v_c + 3 * S;
  float* v_beta = v_sun + S;
  float* cot_sig = v_beta + S;         // the rounded cotangents a sample
  float* cot_rgb = cot_sig + S;        // 3 x S
  float* cot_sun = cot_rgb + 3 * S;
  float* cot_beta = cot_sun + S;
  float* scratch = cot_beta + S;       // CLB2_WARPS x CLB2_SUMS
  float* sky = scratch + CLB2_WARPS * CLB2_SUMS;  // 3, and a float of padding
  float* red = sky + 4;                // dWn rows 0 .. 4 and 8: F + 5 Fh
  float* v_tr = red + F + 5 * Fh;      // above one chunk: the transmittance a sample
  const bool use_beta = bh != nullptr;
  const int chunks = MULTI ? (S + CLB2_THREADS - 1) / CLB2_THREADS : 1;
  const float pad2 = 1.f + 2.f * rgb_padding;

  // ---- the narrow weights as floats, zero past F / Fh
  for (int i = tid; i < Fp; i += CLB2_THREADS) w_sig[i] = i < F ? to_f32<T>(Wn[i]) : 0.f;
  for (int i = tid; i < 8 * Fhp; i += CLB2_THREADS) {
    const int row = 1 + i / Fhp, k = i % Fhp;  // Wn rows 1 .. 8 in the order above
    w_rgb[i] = k < Fh && (row != 8 || use_beta) ? to_f32<T>(Wn[(size_t)row * F + k]) : 0.f;
  }
  for (int i = tid; i < F + 5 * Fh; i += CLB2_THREADS) red[i] = 0.f;
  __syncthreads();

  // ---- 1. the heads: warps take samples; warp 0 also sky, once a ray
  if (warp == 0) {
    const T* x = skyh + (size_t)ray * Fh;
    float sk[3] = {0.f, 0.f, 0.f};
    for (int k = lane; k < Fh; k += 32) {
      const float v = to_f32<T>(x[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) sk[c] = fmaf(v, w_sky[c * Fhp + k], sk[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = sigmoidf(warp_sum(sk[c]) + bn[5 + c]);
      if (lane == 0) sky[c] = v;
    }
  }
  // a lane holds at most CF 16-byte chunks of a sample's h and CH each of its
  // r, s2 and bh, all loaded before the products
  constexpr int CF = CLB_MAX_F / (32 * V), CH = CF / 2;
  for (int s = warp; s < S; s += CLB2_WARPS) {
    const size_t q = (size_t)ray * S + s;
    float part[6] = {};  // sigma, albedo x3, sun_v, beta
    if (!(SATNERF_CLB_ABLATE & 2)) {
#pragma unroll
      for (int ci = 0; ci < CF; ++ci) {
        const int k = (lane + 32 * ci) * V;
        if (k < F) {
          float x[V];
          row_chunk<T>(h + q * F, k, F, vec, x);
#pragma unroll
          for (int i = 0; i < V; ++i) part[0] = fmaf(x[i], w_sig[k + i], part[0]);
        }
      }
#pragma unroll
      for (int ci = 0; ci < CH; ++ci) {
        const int k = (lane + 32 * ci) * V;
        if (k < Fh) {
          float x[V], y[V], b[V];
          row_chunk<T>(rf + q * Fh, k, Fh, vec, x);
          row_chunk<T>(s2 + q * Fh, k, Fh, vec, y);
          if (use_beta) row_chunk<T>(bh + q * Fh, k, Fh, vec, b);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            part[1] = fmaf(x[i], w_rgb[k + i], part[1]);
            part[2] = fmaf(x[i], w_rgb[Fhp + k + i], part[2]);
            part[3] = fmaf(x[i], w_rgb[2 * Fhp + k + i], part[3]);
            part[4] = fmaf(y[i], w_sun[k + i], part[4]);
            if (use_beta) part[5] = fmaf(b[i], w_beta[k + i], part[5]);
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 6; ++v) part[v] = warp_sum(part[v]);
    if (lane == 0) {
      v_sig[s] = softplusf(part[0] + bn[0]);
      v_c[s] = sigmoidf(part[1] + bn[1]);
      v_c[S + s] = sigmoidf(part[2] + bn[2]);
      v_c[2 * S + s] = sigmoidf(part[3] + bn[3]);
      v_sun[s] = sigmoidf(part[4] + bn[4]);
      v_beta[s] = use_beta ? softplusf(part[5] + bn[8]) : 0.f;
    }
  }
  __syncthreads();

  // ---- 2. a thread a sample of each chunk: alpha, the transmittance, the
  // integrals. The last chunk's values stay in registers for 4.
  const float* zr = z + (size_t)ray * S;
  const float sk[3] = {sky[0], sky[1], sky[2]};
  bool mine;
  int s;
  size_t q;
  float sigma, sunv, beta, cs[3], delta, sigma_n, oma, alpha, tr, w;
  float acc4[4];
  float carry = 1.f;  // the product of the earlier chunks' factors
  for (int c = 0; c < chunks; ++c) {
    mine = c * CLB2_THREADS + tid < S;
    s = mine ? c * CLB2_THREADS + tid : 0;
    q = (size_t)ray * S + s;
    sigma = v_sig[s];
    sunv = v_sun[s];
    beta = v_beta[s];
    cs[0] = v_c[s]; cs[1] = v_c[S + s]; cs[2] = v_c[2 * S + s];
    delta = s < S - 1 ? zr[s + 1] - zr[s] : 1e10f;
    sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
    oma = expf(-delta * fmaxf(sigma_n, 0.f));  // 1 - alpha
    alpha = 1.f - oma;
    const float fac = mine ? 1.f - alpha + 1e-10f : 1.f;  // the walk's transparency factor
    float total;
    tr = block_exclusive_product(fac, scratch, chunks > 1 ? &total : nullptr);
    if (c > 0) tr = carry * tr;
    if (chunks > 1) {
      carry = carry * total;
      if (mine) v_tr[s] = tr;
    }
    w = mine ? alpha * tr : 0.f;
    if constexpr (!GIVEN) {
      if (mine && weights != nullptr) weights[q] = w;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = w * (cs[k] * pad2 - rgb_padding) * (sunv + (1.f - sunv) * sk[k]);
      acc4[k] = c > 0 ? acc4[k] + a : a;
    }
    acc4[3] = c > 0 ? acc4[3] + w * beta : w * beta;
  }
  block_sums<4>(acc4, scratch);
  const float rgb_acc[3] = {acc4[0], acc4[1], acc4[2]}, beta_acc = acc4[3];

  // ---- 3. the ray's cotangents: from the loss, or given
  float g_rgb_ray[3], g_beta_ray = 0.f;
  float g_alb[3] = {0.f, 0.f, 0.f}, g_sky[3] = {0.f, 0.f, 0.f};
  float g_depth = 0.f, g_sun = 0.f, g_op = 0.f;
  if constexpr (GIVEN) {
    const float* gr = g_ray + (size_t)ray * OUT_COLS;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool inside = rgb_acc[c] >= 0.f && rgb_acc[c] <= 1.f;  // the clip's adjoint
      g_rgb_ray[c] = inside ? gr[c] : 0.f;
      g_sky[c] = gr[5 + c];
      g_alb[c] = gr[9 + c];
    }
    g_depth = gr[3];
    g_sun = gr[4];
    g_beta_ray = use_beta ? gr[8] : 0.f;
    g_op = gr[12];
  } else {
    const float inv3n = 1.f / (3.f * (float)R), invn = 1.f / (float)R;
    float sq_err = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = fminf(fmaxf(rgb_acc[c], 0.f), 1.f) - gt[(size_t)ray * 3 + c];
      sq_err += diff * diff;
      g_rgb_ray[c] = diff;
    }
    float s_sat = 0.f, s_logb = 0.f;
    float rgb_scale = 2.f * inv3n;
    if (use_beta) {
      const float beta_l = beta_acc + beta_min;
      const float inv_b2 = 1.f / (beta_l * beta_l);
      s_sat = 0.5f * sq_err * inv_b2;
      s_logb = logf(beta_l);
      rgb_scale = wmix * inv_b2 * inv3n + (1.f - wmix) * 2.f * inv3n;
      g_beta_ray = wmix * (0.5f * invn / beta_l - sq_err * inv_b2 / beta_l * inv3n);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool inside = rgb_acc[c] >= 0.f && rgb_acc[c] <= 1.f;  // the clip's adjoint
      g_rgb_ray[c] = inside ? g_rgb_ray[c] * rgb_scale : 0.f;
    }
    if (tid == 0) {
      atomicAdd(loss_sums + 0, s_sat);
      atomicAdd(loss_sums + 1, s_logb);
      atomicAdd(loss_sums + 2, sq_err);
    }
  }

  // ---- 4. a thread a sample of each chunk, the last chunk first: the
  // compositor adjoint
  float b[CLB2_SUMS];
  float carry_s = 0.f;  // the sum of dw * w over the later chunks
  for (int c = chunks - 1; c >= 0; --c) {
    if (chunks > 1) {  // this chunk's values, as 2. formed them
      mine = c * CLB2_THREADS + tid < S;
      s = mine ? c * CLB2_THREADS + tid : 0;
      q = (size_t)ray * S + s;
      sigma = v_sig[s];
      sunv = v_sun[s];
      beta = v_beta[s];
      cs[0] = v_c[s]; cs[1] = v_c[S + s]; cs[2] = v_c[2 * S + s];
      delta = s < S - 1 ? zr[s + 1] - zr[s] : 1e10f;
      sigma_n = sigma + (noise != nullptr ? noise[q] : 0.f);
      oma = expf(-delta * fmaxf(sigma_n, 0.f));
      alpha = 1.f - oma;
      tr = mine ? v_tr[s] : 0.f;
      w = mine ? alpha * tr : 0.f;
    }
    float dw = beta * g_beta_ray, d_sunv = 0.f, g_pre_rgb[3], d_sky[3];
    if constexpr (GIVEN) {
      dw += g_depth * zr[s] + g_op + sunv * g_sun;
      d_sunv = w * g_sun;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float rgb = cs[k] * pad2 - rgb_padding;
      const float irr = sunv + (1.f - sunv) * sk[k];
      const float d_irr = w * rgb * g_rgb_ray[k];
      dw += rgb * irr * g_rgb_ray[k];
      d_sunv += d_irr * (1.f - sk[k]);
      d_sky[k] = d_irr * (1.f - sunv);
      if constexpr (GIVEN) {
        dw += rgb * g_alb[k] + sk[k] * g_sky[k];
        d_sky[k] += w * g_sky[k];
        g_pre_rgb[k] = w * (irr * g_rgb_ray[k] + g_alb[k]) * pad2 * cs[k] * (1.f - cs[k]);
      } else {
        g_pre_rgb[k] = w * irr * g_rgb_ray[k] * pad2 * cs[k] * (1.f - cs[k]);
      }
    }
    float total;
    float suffix = block_exclusive_suffix_sum(mine ? dw * w : 0.f, scratch,
                                              chunks > 1 ? &total : nullptr);
    if (c < chunks - 1) suffix = suffix + carry_s;
    if (chunks > 1) carry_s = carry_s + total;
    // the factor the forward multiplied the transparency by, formed the same way
    const float d_alpha = dw * tr - suffix / (1.f - (1.f - oma) + 1e-10f);
    const float d_sn = sigma_n > 0.f ? d_alpha * oma * delta : 0.f;
    // softplus' = 1 - exp(-softplus), by expm1 (see the walk above)
    float bc[CLB2_SUMS];
    bc[0] = d_sn * -expm1f(-sigma);
    bc[1] = g_pre_rgb[0];
    bc[2] = g_pre_rgb[1];
    bc[3] = g_pre_rgb[2];
    bc[4] = d_sunv * sunv * (1.f - sunv);
    bc[5] = use_beta ? w * g_beta_ray * -expm1f(-beta) : 0.f;
    bc[6] = d_sky[0];
    bc[7] = d_sky[1];
    bc[8] = d_sky[2];
    if (!mine) {
#pragma unroll
      for (int i = 0; i < CLB2_SUMS; ++i) bc[i] = 0.f;
    } else {
      cot_sig[s] = round_to<T>(bc[0]);
#pragma unroll
      for (int k = 0; k < 3; ++k) cot_rgb[k * S + s] = round_to<T>(bc[1 + k]);
      cot_sun[s] = round_to<T>(bc[4]);
      cot_beta[s] = round_to<T>(bc[5]);
    }
#pragma unroll
    for (int i = 0; i < CLB2_SUMS; ++i) b[i] = c < chunks - 1 ? b[i] + bc[i] : bc[i];
  }
  block_sums<CLB2_SUMS>(b, scratch);  // also makes the rounded cotangents visible

  // ---- 5. the outer products by columns: an item is a unit of columns and
  // one of CLB2_RANGES ranges of the samples, so that every thread has work;
  // the items' column sums meet in shared memory, then one atomicAdd a column
  constexpr int U1 = 4, U3 = 2;  // rows in flight: one head, and r's three
  const int nh = (F + V - 1) / V, nr = (Fh + V - 1) / V;
  const int units = (SATNERF_CLB_ABLATE & 1) ? 0 : nh + nr * (use_beta ? 3 : 2);
  const int per = (S + CLB2_RANGES - 1) / CLB2_RANGES;
  for (int it = tid; it < units * CLB2_RANGES; it += CLB2_THREADS) {
    const int u = it % units, j_begin = (it / units) * per;
    const int j_end = j_begin + per < S ? j_begin + per : S;
    if (u >= nh && u < nh + nr) {  // r: d_r = sum_c gb_c w_rgb_c, dWn rows 1 .. 3
      const int k = (u - nh) * V;
      float a[3][V] = {};
      for (int j0 = j_begin; j0 < j_end; j0 += U3) {
        float x[U3][V];
#pragma unroll
        for (int uu = 0; uu < U3; ++uu)
          if (j0 + uu < j_end)
            row_chunk<T>(rf + ((size_t)ray * S + j0 + uu) * Fh, k, Fh, vec, x[uu]);
#pragma unroll
        for (int uu = 0; uu < U3; ++uu) {
          const int j = j0 + uu;
          if (j >= j_end) break;
          const float gb[3] = {cot_rgb[j], cot_rgb[S + j], cot_rgb[2 * S + j]};
          float d[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            d[i] = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              a[c][i] = fmaf(gb[c], x[uu][i], a[c][i]);
              d[i] = fmaf(gb[c], w_rgb[c * Fhp + k + i], d[i]);
            }
          }
          store_chunk<V>(d_r + ((size_t)ray * S + j) * Fh, k, Fh, vec, d);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (k + i < Fh && j_begin < j_end) atomicAdd(red + F + c * Fh + k + i, a[c][i]);
    } else {  // one head: h (sigma, dWn row 0), s2 (sun_v, row 4), bh (beta, row 8)
      const int head = u < nh ? 0 : u < nh + 2 * nr ? 1 : 2;
      const int k = (head == 0 ? u : u - nh - head * nr) * V;
      const int n = head == 0 ? F : Fh;
      const T* src = head == 0 ? h : head == 1 ? s2 : bh;
      float* dst = head == 0 ? d_h : head == 1 ? d_s2 : d_bh;
      const float* gcol = head == 0 ? cot_sig : head == 1 ? cot_sun : cot_beta;
      const float* wrow = head == 0 ? w_sig : head == 1 ? w_sun : w_beta;
      float a[V] = {}, wv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) wv[i] = wrow[k + i];
      for (int j0 = j_begin; j0 < j_end; j0 += U1) {
        float x[U1][V];
#pragma unroll
        for (int uu = 0; uu < U1; ++uu)
          if (j0 + uu < j_end)
            row_chunk<T>(src + ((size_t)ray * S + j0 + uu) * n, k, n, vec, x[uu]);
#pragma unroll
        for (int uu = 0; uu < U1; ++uu) {
          const int j = j0 + uu;
          if (j >= j_end) break;
          const float gb = gcol[j];
          float d[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            a[i] = fmaf(gb, x[uu][i], a[i]);
            d[i] = gb * wv[i];
          }
          store_chunk<V>(dst + ((size_t)ray * S + j) * n, k, n, vec, d);
        }
      }
      float* rrow = red + (head == 0 ? 0 : F + (head == 1 ? 3 : 4) * Fh);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (k + i < n && j_begin < j_end) atomicAdd(rrow + k + i, a[i]);
    }
  }
  __syncthreads();
  // the block's column sums: dWn rows 0 .. 4 and 8, one atomicAdd a column
  for (int i = tid; i < F + (use_beta ? 5 : 4) * Fh; i += CLB2_THREADS) {
    const int row = i < F ? 0 : 1 + (i - F) / Fh, col = i < F ? i : (i - F) % Fh;
    atomicAdd(dWn + (size_t)(row == 5 ? 8 : row) * F + col, red[i]);
  }

  // ---- 6. sky_1 and relu of sky_0, once a ray
  float gb_sky[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gb_sky[c] = round_to<T>(b[6 + c] * sk[c] * (1.f - sk[c]));
  for (int k = tid; k < Fh; k += CLB2_THREADS) {
    const float xv = to_f32<T>(skyh[(size_t)ray * Fh + k]);
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d = fmaf(gb_sky[c], w_sky[c * Fhp + k], d);
      atomicAdd(dWn + (size_t)(5 + c) * F + k, gb_sky[c] * xv);
    }
    d_skyh[(size_t)ray * Fh + k] = xv > 0.f ? d : 0.f;
  }
  // dbn: rows 0 .. 4 and 8 from the sums above, 5 .. 7 sky's
  if (tid < 9 && (tid != 8 || use_beta)) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (j == tid) v = b[j];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (5 + c == tid) v = b[6 + c] * sk[c] * (1.f - sk[c]);
    if (tid == 8) v = b[5];
    atomicAdd(dbn + tid, v);
  }
}

}  // namespace

// ------------------------------------------------------------- C entry points
// Each returns cudaGetLastError() after its launches; the wrapper raises if
// it is not 0.

// The mainloop rule of a bf16 launch (mainloop = MAINLOOP_RULE);
// ops/fused_mlp.py dense_mainloop is the same rule in Python:
//   wgmma  N and K multiples of 64; dY, slope, W and dX 16-byte aligned
//   wmma   N a multiple of 8; dY, slope and W 16-byte aligned
//   simt   any other shape (and fp32 always)
// MAINLOOP_WMMA / MAINLOOP_WGMMA ask for one; a launch it cannot take is
// refused with cudaErrorInvalidValue, never sent to another mainloop.
extern "C" int satnerf_siren_dense_dgrad(int dtype, const void* dY, const void* slope,
                                         const void* W, void* dX, int accumulate, int P,
                                         int N, int K, int mainloop, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (mainloop < MAINLOOP_RULE || mainloop > MAINLOOP_WGMMA) return (int)cudaErrorInvalidValue;
  const bool in_ok = hopper::aligned16(dY) && (slope == nullptr || hopper::aligned16(slope)) &&
                     hopper::aligned16(W);
  const bool tc_ok = dtype == 1 && N % 8 == 0 && in_ok;
  const bool wg_ok = dtype == 1 && N % 64 == 0 && K % 64 == 0 && in_ok && hopper::aligned16(dX);
  if ((mainloop == MAINLOOP_WMMA && !tc_ok) || (mainloop == MAINLOOP_WGMMA && !wg_ok))
    return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_RULE)
    mainloop = wg_ok ? MAINLOOP_WGMMA : tc_ok ? MAINLOOP_WMMA : MAINLOOP_RULE;
  if (P == 0 || N == 0 || K == 0) return (int)cudaSuccess;
  const long long tiles = (long long)((P + BM - 1) / BM) * ((K + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = static_cast<const float*>(dY);
  const float* sl = static_cast<const float*>(slope);
  float* dx = static_cast<float*>(dX);
  if (dtype == 0) {
    dgrad_simt<float><<<grid, DENSE_THREADS, 0, st>>>(dy, sl, static_cast<const float*>(W), dx,
                                                      accumulate, P, N, K);
  } else if (mainloop == MAINLOOP_WGMMA) {
    return launch_dgrad_wgmma<G_SLOPE>(st, dy, sl, static_cast<const __nv_bfloat16*>(W), dx,
                                       accumulate, P, N, K);
  } else if (mainloop == MAINLOOP_WMMA) {
    dgrad_wmma<<<grid, DENSE_THREADS, 0, st>>>(dy, sl, static_cast<const __nv_bfloat16*>(W),
                                               dx, accumulate, P, N, K);
  } else {
    dgrad_simt<__nv_bfloat16><<<grid, DENSE_THREADS, 0, st>>>(
        dy, sl, static_cast<const __nv_bfloat16*>(W), dx, accumulate, P, N, K);
  }
  return (int)cudaGetLastError();
}

// The mainloop rule of a launch with K > 0 (mainloop = MAINLOOP_RULE);
// ops/fused_mlp.py dense_mainloop is the same rule in Python:
//   wgmma  bf16, K and N multiples of 64; X, dY and slope 16-byte aligned
//   wmma   bf16, K and N multiples of 8; the same pointers aligned
//   simt   any other shape (and fp32 always)
// MAINLOOP_WMMA / MAINLOOP_WGMMA ask for one; a launch it cannot take is
// refused with cudaErrorInvalidValue, never sent to another mainloop.
// split: points a block of the wgmma mainloop, a positive multiple of WGR_P
// (the wrapper's rule, ops/fused_mlp.py wgrad_split). small: whether the
// column walk small_grads runs after the GEMM (narrow="walk"), and sums db:
// SMALL_NO_DB on wgmma with an E operand, SMALL_DB on wmma, simt and K = 0;
// SMALL_NONE where it does not run (wgmma without E, or narrow="rays", whose
// narrow_grads the wrapper launches itself). fold: dC of the E operand
// formed by the wgmma mainloop's blocks of k tile 0 (narrow="rays" on wgmma
// with an E operand), then small must be SMALL_NONE. The wrapper's rule is
// ops/fused_mlp.py small_grads_mode; the C entry refuses what it does not
// allow.
enum { SMALL_NONE = 0, SMALL_NO_DB = 1, SMALL_DB = 2 };

extern "C" int satnerf_siren_dense_wgrad(int dtype, const void* X, int K, const void* dY,
                                         const void* slope, const void* rays, const void* z,
                                         int S, int extra_mode, int extra_off, int n_extra,
                                         const void* C, void* dW, void* db, void* dC,
                                         void* dE, int P, int N, int mainloop, int split,
                                         int small, int fold, void* stream) {
  if (n_extra > MAX_EXTRA || n_extra < 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (mainloop < MAINLOOP_RULE || mainloop > MAINLOOP_WGMMA) return (int)cudaErrorInvalidValue;
  if (dE != nullptr && n_extra == 0) return (int)cudaErrorInvalidValue;
  const bool in_ok = hopper::aligned16(X) && hopper::aligned16(dY) &&
                     (slope == nullptr || hopper::aligned16(slope));
  const bool tc_ok = dtype == 1 && K > 0 && K % 8 == 0 && N % 8 == 0 && in_ok;
  const bool wg_ok = dtype == 1 && K > 0 && K % 64 == 0 && N % 64 == 0 && in_ok;
  if ((mainloop == MAINLOOP_WMMA && !tc_ok) || (mainloop == MAINLOOP_WGMMA && !wg_ok))
    return (int)cudaErrorInvalidValue;
  if (mainloop == MAINLOOP_RULE)
    mainloop = wg_ok ? MAINLOOP_WGMMA : tc_ok ? MAINLOOP_WMMA : MAINLOOP_RULE;
  const bool db_in_gemm = mainloop == MAINLOOP_WGMMA;
  const int walk = db_in_gemm ? (n_extra > 0 ? SMALL_NO_DB : SMALL_NONE) : SMALL_DB;
  if (small != SMALL_NONE && small != walk) return (int)cudaErrorInvalidValue;
  if (fold && (!db_in_gemm || n_extra == 0 || small != SMALL_NONE))
    return (int)cudaErrorInvalidValue;
  if (db_in_gemm && (split <= 0 || split % WGR_P != 0)) return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dy = static_cast<const float*>(dY);
  const float* sl = static_cast<const float*>(slope);
  if (K > 0) {
    const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, (P + WGRAD_SPLIT - 1) / WGRAD_SPLIT);
    float* dw = static_cast<float*>(dW);
    if (dtype == 0) {
      wgrad_simt<float><<<grid, DENSE_THREADS, 0, st>>>(static_cast<const float*>(X), dy, sl,
                                                        dw, P, N, K);
    } else if (mainloop == MAINLOOP_WGMMA) {
      const int err =
          fold ? launch_wgrad_wgmma<G_SLOPE, 0, NoEncoding, FOLD_MAX>(
                     st, static_cast<const __nv_bfloat16*>(X), dy, sl, dw, static_cast<float*>(db),
                     static_cast<float*>(dC), NoEncoding{}, P, N, K, split,
                     FoldExtra{static_cast<const float*>(rays), static_cast<const float*>(z), S,
                               extra_mode, extra_off, n_extra})
               : launch_wgrad_wgmma<G_SLOPE, 0>(st, static_cast<const __nv_bfloat16*>(X), dy, sl,
                                                dw, static_cast<float*>(db), nullptr,
                                                NoEncoding{}, P, N, K, split);
      if (err != 0) return err;
    } else if (mainloop == MAINLOOP_WMMA) {
      wgrad_wmma<<<grid, DENSE_THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(X), dy, sl,
                                                 dw, P, N, K);
    } else {
      wgrad_simt<__nv_bfloat16><<<grid, DENSE_THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(X), dy, sl, dw, P, N, K);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (small == SMALL_NONE) return (int)cudaSuccess;
  const dim3 sgrid((P + SMALL_CHUNK - 1) / SMALL_CHUNK, (N + SMALL_THREADS - 1) / SMALL_THREADS);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0) {
    small_grads<float, true><<<sgrid, SMALL_THREADS, 0, st>>>(
        dy, sl, P, N, f(rays), f(z), S, extra_mode, extra_off, n_extra, f(C), o(db), o(dC), o(dE));
  } else {
    const auto* c = static_cast<const __nv_bfloat16*>(C);
    if (small == SMALL_DB)
      small_grads<__nv_bfloat16, true><<<sgrid, SMALL_THREADS, 0, st>>>(
          dy, sl, P, N, f(rays), f(z), S, extra_mode, extra_off, n_extra, c, o(db), o(dC), o(dE));
    else
      small_grads<__nv_bfloat16, false><<<sgrid, SMALL_THREADS, 0, st>>>(
          dy, sl, P, N, f(rays), f(z), S, extra_mode, extra_off, n_extra, c, nullptr, o(dC),
          o(dE));
  }
  return (int)cudaGetLastError();
}

// The narrow gradients of n_jobs layers in one launch of narrow_grads (the
// "rays" body): jobs holds NARROW_JOB_WORDS int64 a job, in the order of
// ops/fused_mlp.py narrow_grads: dY, slope, rays, z, C, db, dC, dE (pointers,
// 0 for none), P, N, S, extra_mode, extra_off, n_extra. A job's blocks own
// rays_per_block rays each: the rays cut into about as many ranges as there
// are resident blocks, at least NARROW_MIN_POINTS points a block, at most
// NARROW_DE_FLOATS values of dE a block.
constexpr int NARROW_JOB_WORDS = 14;

template <typename T, int NE>
static int launch_narrow(NarrowJobs& js, cudaStream_t st) {
  static const int resident = hopper::resident_blocks(narrow_grads<T, NE>, NARROW_THREADS, 0);
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  int blocks = 0;
  for (int i = 0; i < js.n; ++i) {
    NarrowJob& j = js.job[i];
    const int R = j.P / j.S;
    int per = std::max((R + resident - 1) / resident, (NARROW_MIN_POINTS + j.S - 1) / j.S);
    if (j.n_extra > 0) per = std::min(per, NARROW_DE_FLOATS / j.n_extra);
    j.rays_per_block = std::max(per, 1);
    j.block0 = blocks;
    blocks += (R + j.rays_per_block - 1) / j.rays_per_block;
  }
  if (blocks == 0) return (int)cudaSuccess;
  narrow_grads<T, NE><<<blocks, NARROW_THREADS, 0, st>>>(js);
  return (int)cudaGetLastError();
}

extern "C" int satnerf_narrow_grads(int dtype, int n_jobs, const long long* jobs, void* stream) {
  if ((dtype != 0 && dtype != 1) || n_jobs < 1 || n_jobs > NARROW_MAX_JOBS)
    return (int)cudaErrorInvalidValue;
  NarrowJobs js{};
  js.n = n_jobs;
  int ne_max = 0;
  for (int i = 0; i < n_jobs; ++i) {
    const long long* w = jobs + (size_t)i * NARROW_JOB_WORDS;
    NarrowJob& j = js.job[i];
    j.dY = reinterpret_cast<const float*>(w[0]);
    j.slope = reinterpret_cast<const float*>(w[1]);
    j.rays = reinterpret_cast<const float*>(w[2]);
    j.z = reinterpret_cast<const float*>(w[3]);
    j.C = reinterpret_cast<const void*>(w[4]);
    j.db = reinterpret_cast<float*>(w[5]);
    j.dC = reinterpret_cast<float*>(w[6]);
    j.dE = reinterpret_cast<float*>(w[7]);
    j.P = (int)w[8];
    j.N = (int)w[9];
    j.S = (int)w[10];
    j.extra_mode = (int)w[11];
    j.extra_off = (int)w[12];
    j.n_extra = (int)w[13];
    if (j.dY == nullptr || j.N < 1 || j.N > NARROW_MAX_N || j.S < 1 || j.P < 0 ||
        j.P % j.S != 0 || j.n_extra < 0 || j.n_extra > MAX_EXTRA ||
        ((j.dC != nullptr || j.dE != nullptr) && j.n_extra == 0) ||
        (j.dE != nullptr && j.C == nullptr))
      return (int)cudaErrorInvalidValue;
    ne_max = std::max(ne_max, j.n_extra);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return ne_max == 0  ? launch_narrow<float, 0>(js, st)
           : ne_max <= 4 ? launch_narrow<float, 4>(js, st)
                         : launch_narrow<float, MAX_EXTRA>(js, st);
  return ne_max == 0  ? launch_narrow<bf16, 0>(js, st)
         : ne_max <= 4 ? launch_narrow<bf16, 4>(js, st)
                       : launch_narrow<bf16, MAX_EXTRA>(js, st);
}

// The bodies of composite_loss_bwd and composite_bwd (the wrappers' `body=`):
// a block a ray (composite_loss_bwd_block) or a warp a ray
// (composite_loss_bwd_kernel, kept for comparison). Either is run as asked;
// one that cannot take the launch is refused, never swapped for the other.
enum { BODY_BLOCK = 0, BODY_WARP = 1 };

// Launch composite_loss_bwd_{block,kernel}<T, GIVEN>: GIVEN when a cotangent g
// is passed.
template <typename T>
static int launch_composite(const void* h, int F, const void* rf, const void* s2,
                            const void* bh, const void* skyh, int Fh, const void* Wn,
                            const void* bn, const void* z, const void* noise, const void* gt,
                            const void* g, int R, int S, float rgb_padding, float beta_min,
                            float wmix, void* loss_sums, void* weights, void* d_h, void* d_r,
                            void* d_s2, void* d_bh, void* d_skyh, void* dWn, void* dbn, int body,
                            void* stream) {
  if (F > CLB_MAX_F || Fh > CLB_MAX_F / 2 || S < 1) return (int)cudaErrorInvalidValue;
  if (body != BODY_BLOCK && body != BODY_WARP) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto t = [](const void* p) { return static_cast<const T*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (body == BODY_BLOCK) {
    // S past what shared memory holds is refused (cudaErrorInvalidValue)
    const long long smem = (long long)clb2_smem_floats(F, Fh, S) * sizeof(float);
    static int allowed[2] = {0, 0};  // what each instantiation has opted into
    if (smem > hopper::SMEM_OPTIN_BYTES) return (int)cudaErrorInvalidValue;
    const int err =
        g != nullptr ? hopper::allow_smem(composite_loss_bwd_block<T, true, true>, (int)smem,
                                          &allowed[1])
                     : hopper::allow_smem(composite_loss_bwd_block<T, false, true>, (int)smem,
                                          &allowed[0]);
    if (err != 0) return err;
    const bool multi = S > CLB2_THREADS;  // only MULTI launches pass 48 KB
    const int v = Vec16<T>::N;
    const bool vec = F % v == 0 && Fh % v == 0 && hopper::aligned16(h) &&
                     hopper::aligned16(rf) && hopper::aligned16(s2) &&
                     (bh == nullptr || hopper::aligned16(bh)) && hopper::aligned16(d_h) &&
                     hopper::aligned16(d_r) && hopper::aligned16(d_s2) &&
                     (d_bh == nullptr || hopper::aligned16(d_bh));
    auto given = multi ? composite_loss_bwd_block<T, true, true>
                       : composite_loss_bwd_block<T, true, false>;
    auto loss = multi ? composite_loss_bwd_block<T, false, true>
                      : composite_loss_bwd_block<T, false, false>;
    if (g != nullptr)
      given<<<R, CLB2_THREADS, smem, st>>>(
          t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), f(bn), f(z), f(noise), nullptr, f(g),
          R, S, rgb_padding, 0.f, 0.f, vec, nullptr, nullptr, o(d_h), o(d_r), o(d_s2), o(d_bh),
          o(d_skyh), o(dWn), o(dbn));
    else
      loss<<<R, CLB2_THREADS, smem, st>>>(
          t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), f(bn), f(z), f(noise), f(gt), nullptr,
          R, S, rgb_padding, beta_min, wmix, vec, o(loss_sums), o(weights), o(d_h), o(d_r),
          o(d_s2), o(d_bh), o(d_skyh), o(dWn), o(dbn));
    return (int)cudaGetLastError();
  }
  const int grid = (R + CLB_WARPS - 1) / CLB_WARPS;
  const long long smem = (long long)CLB_WARPS * CLB_SAMPLE_VALS * S * sizeof(float);
  static int allowed[2] = {0, 0};
  if (smem > hopper::SMEM_OPTIN_BYTES) return (int)cudaErrorInvalidValue;
  const int err =
      g != nullptr ? hopper::allow_smem(composite_loss_bwd_kernel<T, true>, (int)smem, &allowed[1])
                   : hopper::allow_smem(composite_loss_bwd_kernel<T, false>, (int)smem, &allowed[0]);
  if (err != 0) return err;
  if (g != nullptr) {
    composite_loss_bwd_kernel<T, true><<<grid, CLB_WARPS * 32, smem, st>>>(
        t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), f(bn), f(z), f(noise), nullptr, f(g),
        R, S, rgb_padding, 0.f, 0.f, nullptr, nullptr, o(d_h), o(d_r), o(d_s2), o(d_bh),
        o(d_skyh), o(dWn), o(dbn));
  } else {
    composite_loss_bwd_kernel<T, false><<<grid, CLB_WARPS * 32, smem, st>>>(
        t(h), F, t(rf), t(s2), t(bh), t(skyh), Fh, t(Wn), f(bn), f(z), f(noise), f(gt), nullptr,
        R, S, rgb_padding, beta_min, wmix, o(loss_sums), o(weights), o(d_h), o(d_r), o(d_s2),
        o(d_bh), o(d_skyh), o(dWn), o(dbn));
  }
  return (int)cudaGetLastError();
}

// body: BODY_BLOCK or BODY_WARP, as the wrapper's `body=` asks.
extern "C" int satnerf_composite_loss_bwd(int dtype, const void* h, int F, const void* rf,
                                          const void* s2, const void* bh, const void* skyh,
                                          int Fh, const void* Wn, const void* bn, const void* z,
                                          const void* noise, const void* gt, int R, int S,
                                          float rgb_padding, float beta_min, float wmix,
                                          void* loss_sums, void* weights, void* d_h, void* d_r,
                                          void* d_s2, void* d_bh, void* d_skyh, void* dWn,
                                          void* dbn, int body, void* stream) {
  if (gt == nullptr || loss_sums == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_composite<float>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, z, noise, gt, nullptr, R,
                                   S, rgb_padding, beta_min, wmix, loss_sums, weights, d_h, d_r,
                                   d_s2, d_bh, d_skyh, dWn, dbn, body, stream);
  if (dtype == 1)
    return launch_composite<__nv_bfloat16>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, z, noise, gt,
                                           nullptr, R, S, rgb_padding, beta_min, wmix, loss_sums,
                                           weights, d_h, d_r, d_s2, d_bh, d_skyh, dWn, dbn, body,
                                           stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int satnerf_composite_bwd(int dtype, const void* h, int F, const void* rf,
                                     const void* s2, const void* bh, const void* skyh, int Fh,
                                     const void* Wn, const void* bn, const void* z,
                                     const void* noise, const void* g, int R, int S,
                                     float rgb_padding, void* d_h, void* d_r, void* d_s2,
                                     void* d_bh, void* d_skyh, void* dWn, void* dbn, int body,
                                     void* stream) {
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_composite<float>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, z, noise, nullptr, g, R,
                                   S, rgb_padding, 0.f, 0.f, nullptr, nullptr, d_h, d_r, d_s2,
                                   d_bh, d_skyh, dWn, dbn, body, stream);
  if (dtype == 1)
    return launch_composite<__nv_bfloat16>(h, F, rf, s2, bh, skyh, Fh, Wn, bn, z, noise, nullptr,
                                           g, R, S, rgb_padding, 0.f, 0.f, nullptr, nullptr, d_h,
                                           d_r, d_s2, d_bh, d_skyh, dWn, dbn, body, stream);
  return (int)cudaErrorInvalidValue;
}

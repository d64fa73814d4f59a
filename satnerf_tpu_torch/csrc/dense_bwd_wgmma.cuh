// The wgmma mainloops of the backward's two dense kernels, shared by the
// SIREN variants (fused_train.cu: siren_dense_dgrad, siren_dense_wgrad) and
// the nerf variant (fused_nerf.cu: nerf_dense_dgrad, nerf_dense_wgrad).
//
// Both form the cotangent G = dY . mask in registers from TMA-loaded tiles,
// round it to bf16 and feed it as the register (A) operand of an RS wgmma.
// How the mask is formed is the template parameter GM:
//   G_SLOPE  an fp32 slope tile (a sine layer's w0 cos(w0 pre)): G = dY * slope
//   G_RELU   a bf16 tile of the layer's stored output Y: G = dY where Y > 0
//            (the relu's mask, read where the SIREN layers read their slope)
// and a layer without one (has_mask 0: a linear layer) loads neither. The
// SIREN instantiations run the code fused_train.cu had before the template
// parameter (ptxas gives them the same registers, stack and spills).
//
// dgrad_wgmma: dX[p, k] (+)= sum_n round(G[p, n]) W[k, n]. Persistent, one
//   block an SM walking 128 x 256 tiles of dX. A producer warp keeps the ring
//   full by TMA: the fp32 dY tile (128 x 32, 128-byte swizzle), the mask tile
//   (fp32 128 x 32, 128-byte swizzle; bf16 128 x 32, 64-byte swizzle) and W
//   (256 x 32 bf16, 64-byte swizzle): 48 KB a stage with a slope, 40 KB
//   with the bf16 mask, four stages. Two consumer warpgroups own 64
//   rows each: a thread reads its A-fragment pairs of dY and of the mask at
//   the same row and column pair, forms G, rounds and packs it, and issues an
//   m64n256k16 wgmma; the epilogue writes dX as 16-byte vectors (adding onto
//   out where asked: no atomics, the same result from run to run).
//
// wgrad_wgmma: dW^T[n][k] = sum_p G^T[n][p] X[p][k] and db[n] = sum_p G[p, n],
//   and where the layer has an encoding operand computed from the rays (the
//   nerf variant's positional encoding, E = 32 or 64 columns) also
//   dC^T[n][j] = sum_p G^T[n][p] enc[p][j] in the same launch. A block owns
//   128 columns n of G against 256 columns k of X, or against the encoding,
//   and one range of `split` points: a producer warp keeps four 32-point
//   stages in flight (dY and mask in boxes of 32 points x 32 columns, X in
//   boxes of 32 x 64); a thread's A fragment pairs two points at one column,
//   read down a column of the swizzled tiles, and the same unrounded G goes
//   into its two columns' bias sums. The encoding's blocks are a k tile of
//   their own past X's (beside a 256-column X tile its accumulator would not
//   fit the 168 registers a thread of a wgmma kernel of 288 threads gets):
//   they load dY and the mask alone, compute the encoding's tile (32 points
//   x E, bf16) into shared memory in the swizzled layout the B descriptor
//   reads (fence.proxy.async, then a barrier of both warpgroups; double
//   buffered, from positions loaded two stages ahead, the next tile while
//   this stage's products run) and issue an m64nEk16 wgmma. Partial tiles
//   meet in dW and dC by fp32 atomics; the blocks of the first k tile add
//   the bias sums. The SIREN layers with a small E operand (xyz, sun_dir or
//   t, at most FOLD_MAX columns, built from the rays) fold its gradient in
//   (NX > 0): dC[j][n] = sum_p E[p][j] round(G[p][n]). The consumers of
//   every block form E of the block's points (at most FOLD_SPLIT, rounded
//   to bf16) into shared memory once, before the stages, while the
//   producer's first loads fly; each consumer thread, which holds round(G)
//   of two columns at eight points of a stage in its A fragments, adds
//   E^T round(G) by FMAs before the stage's products, for the E columns
//   its k tile takes (j % k_tiles == kt: the blocks of a point range share
//   the work and keep in step, so G's second read stays in L2); its sums
//   meet across the quad's lanes, then fp32 atomics. So G is read once for
//   dW, db and dC.
//
// What bounds them: G arrives as fp32 (8 or 6 bytes of operand a value
// with the mask) and dX leaves in fp32; at the main paths' widths the bytes
// outweigh the products 3-8 to 1 (PERF.md).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum { G_SLOPE = 0, G_RELU = 1 };
template <int GM> struct GMask { using T = float; };  // G_SLOPE
template <> struct GMask<G_RELU> { using T = __nv_bfloat16; };

// Byte offset of element (r, c) of a 32-float (128-byte) row of a
// 128-byte-swizzled tile: its 16-byte chunk c / 4 lands at chunk
// (c / 4) ^ (r % 8) of the row.
__device__ __forceinline__ int swizzled_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Element (r, c) of a 32-bf16 (64-byte) row of a 64-byte-swizzled tile: its
// 16-byte chunk c / 8 lands at chunk (c / 8) ^ (r / 2 % 4) of the row.
__device__ __forceinline__ int swizzled_bf16(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
}

// Element (r, c) of a 64-bf16 (128-byte) row of a 128-byte-swizzled tile.
__device__ __forceinline__ int swizzled_bf16_128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// G at (r, c) and (r, c + 1) of a stage: dY from its fp32 tile, the mask
// from its own (both 32 columns wide).
template <int GM>
__device__ __forceinline__ float2 cotangent_pair(const uint8_t* dy, const uint8_t* mask, int r,
                                                 int c, int has_mask) {
  const int off = swizzled_f32(r, c);
  float2 v = *reinterpret_cast<const float2*>(dy + off);
  if (has_mask) {
    if constexpr (GM == G_SLOPE) {
      const float2 s = *reinterpret_cast<const float2*>(mask + off);
      v.x *= s.x;
      v.y *= s.y;
    } else {
      const __nv_bfloat162 y =
          *reinterpret_cast<const __nv_bfloat162*>(mask + swizzled_bf16(r, c));
      if (!(__low2float(y) > 0.f)) v.x = 0.f;
      if (!(__high2float(y) > 0.f)) v.y = 0.f;
    }
  }
  return v;
}

// G at (q, c) of a 32 x 32 box of dY and the matching box of the mask.
template <int GM>
__device__ __forceinline__ float cotangent_one(const uint8_t* dy, const uint8_t* mask, int q,
                                               int c, int has_mask) {
  float v = *reinterpret_cast<const float*>(dy + swizzled_f32(q, c));
  if (has_mask) {
    if constexpr (GM == G_SLOPE) {
      v *= *reinterpret_cast<const float*>(mask + swizzled_f32(q, c));
    } else {
      const __nv_bfloat16 y = *reinterpret_cast<const __nv_bfloat16*>(mask + swizzled_bf16(q, c));
      if (!(__bfloat162float(y) > 0.f)) v = 0.f;
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The TMA map of a (P, N) mask tensor: fp32 boxes with a 128-byte swizzle, or
// bf16 boxes with a 64-byte one (32 columns, 64-byte rows). Without a mask
// (a linear layer) the map stands on dY and is never read.
template <int GM>
int mask_map(CUtensorMap* map, const void* mask, const float* dY, int P, int N, int box_rows) {
  const void* base = mask != nullptr ? mask : dY;
  if constexpr (GM == G_SLOPE)
    return hopper::tensor_map_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, P, N, box_rows,
                                 32, CU_TENSOR_MAP_SWIZZLE_128B);
  else
    return hopper::tensor_map_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, P, N, box_rows,
                                 32, CU_TENSOR_MAP_SWIZZLE_64B);
}

// ------------------------------------------------------------------- dgrad

constexpr int DG_BM = 128, DG_BN = 256, DG_BK = 32;
constexpr int DG_WG_THREADS = 128;
constexpr int DG_THREADS = 2 * DG_WG_THREADS + 32;  // two consumer warpgroups, a producer warp
constexpr int DG_G_BYTES = DG_BM * DG_BK * 4;       // a dY tile, fp32
constexpr int DG_W_BYTES = DG_BN * DG_BK * 2;       // a W tile, bf16

// The ring's depth with the bf16 mask, whose stage is 8 KB smaller than the
// slope's: four, as with the slope. The room for a fifth did not pay (0.074
// against 0.067 ms a 256 x 256 layer at 65,536 points on an H100):
// tools/profile_render_torch.py --model nerf --wgrad builds 3 and 5 beside it.
#ifndef SATNERF_RELU_DG_STAGES
#define SATNERF_RELU_DG_STAGES 4
#endif

template <int GM>
struct DgradSmem {
  static constexpr int STAGES = GM == G_SLOPE ? 4 : SATNERF_RELU_DG_STAGES;
  float dy[STAGES][DG_BM * DG_BK];  // each tile 1024-byte aligned
  typename GMask<GM>::T mask[STAGES][DG_BM * DG_BK];
  __nv_bfloat16 w[STAGES][DG_BN * DG_BK];
  uint64_t full[STAGES], empty[STAGES];
};
template <int GM> constexpr int dgrad_smem() { return (int)sizeof(DgradSmem<GM>) + 1024; }

template <int GM>
__global__ void __launch_bounds__(DG_THREADS, 1)
dgrad_wgmma(const __grid_constant__ CUtensorMap map_dy, const __grid_constant__ CUtensorMap map_mask,
            const __grid_constant__ CUtensorMap map_w, int has_mask, float* __restrict__ dX,
            int accumulate, int P, int N, int K) {
  using namespace hopper;
  constexpr int STAGES = DgradSmem<GM>::STAGES;
  constexpr uint32_t MASK_BYTES = DG_BM * DG_BK * sizeof(typename GMask<GM>::T);
  extern __shared__ uint8_t smem_raw[];
  DgradSmem<GM>& sm = *reinterpret_cast<DgradSmem<GM>*>(align1024(smem_raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col_tiles = (K + DG_BN - 1) / DG_BN;
  const int tiles = ((P + DG_BM - 1) / DG_BM) * col_tiles;
  const int n_blocks = (N + DG_BK - 1) / DG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * DG_WG_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues every load
    if (lane == 0) {
      const uint32_t bytes = DG_G_BYTES + (has_mask ? MASK_BYTES : 0) + DG_W_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / col_tiles) * DG_BM, col0 = (tile % col_tiles) * DG_BN;
        for (int nb = 0; nb < n_blocks; ++nb) {
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&sm.full[stage], bytes);
          tma_load_2d(sm.dy[stage], &map_dy, &sm.full[stage], nb * DG_BK, row0);
          if (has_mask) tma_load_2d(sm.mask[stage], &map_mask, &sm.full[stage], nb * DG_BK, row0);
          tma_load_2d(sm.w[stage], &map_w, &sm.full[stage], nb * DG_BK, col0);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + wl * 16 + g;  // this thread's rows of the tile: r0, r0 + 8
  int stage = 0;
  uint32_t phase = 0;
  float acc[128];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / col_tiles) * DG_BM, col0 = (tile % col_tiles) * DG_BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int nb = 0; nb < n_blocks; ++nb) {
      mbar_wait(&sm.full[stage], phase);
      const uint8_t* dy = reinterpret_cast<const uint8_t*>(sm.dy[stage]);
      const uint8_t* mk = reinterpret_cast<const uint8_t*>(sm.mask[stage]);
      // A fragments of both 16-deep steps: register i of step s holds row
      // r0 + 8 (i % 2), columns 16 s + 8 (i / 2) + 2t and + 1, as bf16 of G
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = cotangent_pair<GM>(dy, mk, r0 + 8 * (i & 1),
                                              16 * s + 8 * (i >> 1) + 2 * t, has_mask);
          a[s][i] = pack_bf16x2(v.x, v.y);
        }
      }
      const uint8_t* w = reinterpret_cast<const uint8_t*>(sm.w[stage]);
      wgmma_fence();
      wgmma_m64n256k16_rs(acc, a[0], smem_desc(w, 16, 512, SWIZZLE_64B));
      wgmma_m64n256k16_rs(acc, a[1], smem_desc(w + 32, 16, 512, SWIZZLE_64B));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a[0]);
      fence_regs(a[1]);
      mbar_arrive(&sm.empty[stage]);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }

    // epilogue: rows q0, q0 + 8; columns 8j + 2t, + 1 of each 8-column block j
    const int q0 = row0 + r0, q1 = q0 + 8;
#pragma unroll
    for (int j = 0; j < DG_BN / 8; j += 2) {  // blocks j, j + 1 into one float4 a lane
      const float4 f0 = pair_exchange(make_float2(acc[4 * j], acc[4 * j + 1]),
                                      make_float2(acc[4 * j + 4], acc[4 * j + 5]), t);
      const float4 f1 = pair_exchange(make_float2(acc[4 * j + 2], acc[4 * j + 3]),
                                      make_float2(acc[4 * j + 6], acc[4 * j + 7]), t);
      const int k = col0 + 8 * (j + (t & 1)) + 2 * (t & ~1);
      if (k >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = h ? q1 : q0;
        if (q >= P) continue;
        float4 v = h ? f1 : f0;
        float4* out = reinterpret_cast<float4*>(dX + (size_t)q * K + k);
        if (accumulate) {
          const float4 o = *out;
          v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
        }
        *out = v;
      }
    }
  }
}

// dY (P, N) fp32, mask (P, N) of GM's type or nullptr, W (K, N) bf16, dX (P, K)
// fp32; N and K multiples of 64, every pointer 16-byte aligned.
template <int GM>
int launch_dgrad_wgmma(cudaStream_t st, const float* dY, const void* mask,
                       const __nv_bfloat16* W, float* dX, int accumulate, int P, int N, int K) {
  static const int resident =
      hopper::resident_blocks(dgrad_wgmma<GM>, DG_THREADS, dgrad_smem<GM>());
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_dy, map_mask, map_w;
  int err = hopper::tensor_map_2d(&map_dy, dY, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, P, N, DG_BM,
                                  DG_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = mask_map<GM>(&map_mask, mask, dY, P, N, DG_BM);
  if (err == 0)
    err = hopper::tensor_map_2d(&map_w, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, DG_BN,
                                DG_BK, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  const long long tiles = (long long)((P + DG_BM - 1) / DG_BM) * ((K + DG_BN - 1) / DG_BN);
  const int grid = (int)(tiles < resident ? tiles : resident);
  dgrad_wgmma<GM><<<grid, DG_THREADS, dgrad_smem<GM>(), st>>>(map_dy, map_mask, map_w,
                                                              mask != nullptr, dX, accumulate,
                                                              P, N, K);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- wgrad

constexpr int WGR_N = 128;  // columns n of a block's tile: two warpgroups' m64
constexpr int WGR_K = 256;  // columns k: the wgmma's n256
constexpr int WGR_P = 32;   // points a stage
constexpr int WGR_STAGES = 4;
constexpr int WGR_THREADS = 2 * DG_WG_THREADS + 32;
constexpr int WGR_CONSUMERS = 2 * DG_WG_THREADS;
constexpr int WGR_G_BOX = WGR_P * 32 * 4;  // 32 points x 32 columns, fp32: 4 KB
constexpr int WGR_X_BOX = WGR_P * 64 * 2;  // 32 points x 64 columns, bf16: 4 KB
constexpr int ENC_PC = 3 * WGR_P;          // (point, coordinate) pairs of a stage

// The encoding's two tiles and the positions they are computed from (E = 0:
// none).
template <int E> struct EncTiles {
  __nv_bfloat16 enc[2][WGR_P * E];
  float xs[2][ENC_PC];
};
template <> struct EncTiles<0> {};

// The fold of a small E operand: where to build it from (common.cuh
// extra_value), and E of a block's points (NX = 0: none).
constexpr int FOLD_MAX = 4;
constexpr int FOLD_SPLIT = 4096;  // the most points a folding block holds E of
struct FoldExtra {
  const float* rays;
  const float* z;
  int S, mode, off, n;
};
template <int NX> struct alignas(16) FoldTiles {
  __nv_bfloat16 es[FOLD_SPLIT][NX];  // E of the block's points, bf16 as rounded
};
template <> struct FoldTiles<0> {};

template <int GM, int E, int NX = 0>
struct WgradSmem {
  float dy[WGR_STAGES][WGR_P * WGR_N];  // four boxes a stage, each 1024-byte aligned
  typename GMask<GM>::T mask[WGR_STAGES][WGR_P * WGR_N];
  __nv_bfloat16 x[WGR_STAGES][WGR_P * WGR_K];
  EncTiles<E> e;
  FoldTiles<NX> f;
  uint64_t full[WGR_STAGES], empty[WGR_STAGES];
};
template <int GM, int E, int NX = 0> constexpr int wgrad_smem() {
  return (int)sizeof(WgradSmem<GM, E, NX>) + 1024;
}

// Byte offset of element (p, j) of an encoding tile: E = 64, 128-byte rows
// with the 128-byte swizzle (the X tile's layout); E = 32, 64-byte rows with
// the 64-byte swizzle. Both N-major B operands of their wgmma.
template <int E>
__device__ __forceinline__ int enc_tile_offset(int p, int j) {
  static_assert(E == 32 || E == 64, "an encoding tile is 32 or 64 columns wide");
  return E == 64 ? swizzled_bf16_128(p, j) : swizzled_bf16(p, j);
}

// A layer without an encoding operand.
struct NoEncoding {};

// One stage's tile of the positional encoding (fused_nerf.py _posenc: per
// frequency k the block [sin(2^k x) (3), cos(2^k x) (3)]) from the stage's
// positions xs[3 p + c], rounded to bf16: item (k, p, c) of the n_freq * 96
// falls to consumer thread (k * 96 + 3 p + c) % 256, all of a thread's items
// independent. The sines are libdevice's sincosf, written out without its
// branch (common.cuh sincosf_fast) where every argument of the thread lies
// below TRIG_FAST_LIMIT, so that the items run side by side; the argument
// reaches 512 |x|. The pad columns are not written.
template <int E>
__device__ __forceinline__ void enc_tile_fill(__nv_bfloat16* tile, const float* xs, int n_freq,
                                              int tid) {
  constexpr int ITEMS = (ENC_PC * (E / 6) + WGR_CONSUMERS - 1) / WGR_CONSUMERS;
  uint8_t* t = reinterpret_cast<uint8_t*>(tile);
  float arg[ITEMS], sn[ITEMS], cs[ITEMS];
  bool fast = true;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = tid + WGR_CONSUMERS * j;
    const int k = it / ENC_PC;
    arg[j] = k < n_freq ? xs[it - k * ENC_PC] * (float)(1 << k) : 0.f;
    fast = fast && !(fabsf(arg[j]) >= TRIG_FAST_LIMIT);
  }
  if (__builtin_expect(fast, 1)) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) sincosf_fast(arg[j], sn[j], cs[j]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) sincosf(arg[j], &sn[j], &cs[j]);
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = tid + WGR_CONSUMERS * j;
    const int k = it / ENC_PC, pc = it - k * ENC_PC;
    const int p = pc / 3, c = pc - 3 * p;
    if (k < n_freq) {
      *reinterpret_cast<__nv_bfloat16*>(t + enc_tile_offset<E>(p, 6 * k + c)) =
          __float2bfloat16_rn(sn[j]);
      *reinterpret_cast<__nv_bfloat16*>(t + enc_tile_offset<E>(p, 6 * k + 3 + c)) =
          __float2bfloat16_rn(cs[j]);
    }
  }
}

// A stage's A fragments, G^T of both 16-point steps: register r of step s
// holds column nl + 8 (r % 2), points 16 s + 8 (r / 2) + 2t and + 1, as bf16;
// the same unrounded values go into the two columns' bias sums.
template <int GM>
__device__ __forceinline__ void wgrad_fragments(uint32_t (&a)[2][4], const uint8_t* dy,
                                                const uint8_t* mk, int c0, int t, int has_mask,
                                                float& db0, float& db1) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + 8 * (r & 1), q = 16 * s + 8 * (r >> 1) + 2 * t;
      const float v0 = cotangent_one<GM>(dy, mk, q, c, has_mask);
      const float v1 = cotangent_one<GM>(dy, mk, q + 1, c, has_mask);
      if (r & 1) db1 += v0 + v1;
      else db0 += v0 + v1;
      a[s][r] = pack_bf16x2(v0, v1);
    }
  }
}

// E: the encoding's columns (0, 32 or 64). Its blocks are those of the k
// tile past X's (all of them at K = 0); `enc.coord(q, c)` gives coordinate c
// of the position point q is encoded from (0 past the last point), and
// enc.n_freq its frequencies. The blocks of the first k tile (the encoding's
// at K = 0) add the bias sums. NX > 0 (with K > 0 and E = 0): the fold of
// fx's fx.n <= NX columns into dC (n_extra, N).
template <int GM, int E, typename Enc, int NX = 0>
__global__ void __launch_bounds__(WGR_THREADS, 1)
wgrad_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_dy,
            const __grid_constant__ CUtensorMap map_mask, int has_mask, float* __restrict__ dW,
            float* __restrict__ db, float* __restrict__ dC, const Enc enc, int P, int N, int K,
            int split, const FoldExtra fx) {
  using namespace hopper;
  static_assert(NX == 0 || (E == 0 && NX == 4), "a fold holds 4 columns a point");
  constexpr int MASK_BOX = WGR_P * 32 * (int)sizeof(typename GMask<GM>::T);
  extern __shared__ uint8_t smem_raw[];
  WgradSmem<GM, E, NX>& sm = *reinterpret_cast<WgradSmem<GM, E, NX>*>(align1024(smem_raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x_tiles = (K + WGR_K - 1) / WGR_K;
  const int k_tiles = x_tiles + (E > 0 ? 1 : 0);
  const int tiles = ((N + WGR_N - 1) / WGR_N) * k_tiles;
  const int tile = blockIdx.x % tiles;
  const int n0 = (tile / k_tiles) * WGR_N, kt = tile % k_tiles, k0 = kt * WGR_K;
  const bool enc_block = E > 0 && kt == x_tiles;
  const int p_begin = (blockIdx.x / tiles) * split;
  const int steps = (min(P, p_begin + split) - p_begin + WGR_P - 1) / WGR_P;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WGR_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WGR_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues every load
    if (lane == 0) {
      // N and K are multiples of 64, so a box lies inside or outside whole;
      // those outside are not loaded (their rows and columns are not stored)
      const int n_boxes = min(WGR_N, N - n0) / 32;
      const int k_boxes = enc_block ? 0 : min(WGR_K, K - k0) / 64;
      const uint32_t bytes =
          n_boxes * (WGR_G_BOX + (has_mask ? MASK_BOX : 0)) + k_boxes * WGR_X_BOX;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < steps; ++i) {
        const int p0 = p_begin + i * WGR_P;
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&sm.full[stage], bytes);
        for (int b = 0; b < n_boxes; ++b) {
          tma_load_2d(sm.dy[stage] + b * WGR_P * 32, &map_dy, &sm.full[stage], n0 + 32 * b, p0);
          if (has_mask)
            tma_load_2d(sm.mask[stage] + b * WGR_P * 32, &map_mask, &sm.full[stage], n0 + 32 * b,
                        p0);
        }
        for (int b = 0; b < k_boxes; ++b)
          tma_load_2d(sm.x[stage] + b * WGR_P * 64, &map_x, &sm.full[stage], k0 + 64 * b, p0);
        if (++stage == WGR_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: this thread's columns of the tile are nl and nl + 8, both in
  // box nl / 32 of a stage's dY and mask tiles
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int nl = wg * 64 + wl * 16 + g;
  const int c0 = nl % 32;
  const int box = (nl / 32) * WGR_G_BOX, mbox = (nl / 32) * MASK_BOX;
  float db0 = 0.f, db1 = 0.f;
  int stage = 0;
  uint32_t phase = 0;

  if constexpr (E > 0) {
    if (enc_block) {
      // dC^T = G^T . enc. The positions of stage i + 2 are loaded (threads
      // 0 .. 95, one coordinate of one point each) while stage i runs and
      // stored at stage i + 1; stage i + 1's tile is computed from them while
      // stage i's products run: the sines wait on no load.
      float acc_e[E / 2];  // written by wgmma only: the first product starts the sum
      const int p = threadIdx.x / 3, c = threadIdx.x % 3;
      const bool loads = threadIdx.x < ENC_PC;
      constexpr uint32_t TILE = WGR_P * E * 2;  // one column block: lbo is not read
      constexpr uint32_t ROW = E * 2, SBO = 8 * ROW;
      constexpr uint64_t SW = E == 64 ? SWIZZLE_128B : SWIZZLE_64B;
      float x_next = 0.f;
      for (int i = threadIdx.x; i < WGR_P * E; i += WGR_CONSUMERS)  // the pads stay 0
        reinterpret_cast<uint32_t*>(sm.e.enc)[i] = 0u;
      if (loads) {
        sm.e.xs[0][threadIdx.x] = enc.coord(p_begin + p, c);
        if (steps > 1) sm.e.xs[1][threadIdx.x] = enc.coord(p_begin + WGR_P + p, c);
        if (steps > 2) x_next = enc.coord(p_begin + 2 * WGR_P + p, c);
      }
      bar_sync(1, WGR_CONSUMERS);
      enc_tile_fill<E>(sm.e.enc[0], sm.e.xs[0], enc.n_freq, threadIdx.x);
      fence_proxy_async();
      for (int i = 0; i < steps; ++i) {
        mbar_wait(&sm.full[stage], phase);
        uint32_t a[2][4];
        wgrad_fragments<GM>(a, reinterpret_cast<const uint8_t*>(sm.dy[stage]) + box,
                            reinterpret_cast<const uint8_t*>(sm.mask[stage]) + mbox, c0, t,
                            has_mask, db0, db1);
        bar_sync(1, WGR_CONSUMERS);  // stage i's tile, every share written and fenced
        const uint8_t* et = reinterpret_cast<const uint8_t*>(sm.e.enc[i & 1]);
        wgmma_fence();
        if constexpr (E == 64) {
          wgmma_m64n64k16_rs_tb(acc_e, a[0], smem_desc(et, TILE, SBO, SW), i > 0);
          wgmma_m64n64k16_rs_tb(acc_e, a[1], smem_desc(et + 16 * ROW, TILE, SBO, SW));
        } else {
          wgmma_m64n32k16_rs_tb(acc_e, a[0], smem_desc(et, TILE, SBO, SW), i > 0);
          wgmma_m64n32k16_rs_tb(acc_e, a[1], smem_desc(et + 16 * ROW, TILE, SBO, SW));
        }
        wgmma_commit();
        if (i + 1 < steps) {  // the next stage's tile, while the products run
          enc_tile_fill<E>(sm.e.enc[(i + 1) & 1], sm.e.xs[(i + 1) & 1], enc.n_freq,
                           threadIdx.x);
          fence_proxy_async();
        }
        if (loads) {
          if (i + 2 < steps) sm.e.xs[i & 1][threadIdx.x] = x_next;
          if (i + 3 < steps) x_next = enc.coord(p_begin + (i + 3) * WGR_P + p, c);
        }
        wgmma_wait<0>();
        fence_regs(acc_e);
        fence_regs(a[0]);
        fence_regs(a[1]);
        mbar_arrive(&sm.empty[stage]);
        if (++stage == WGR_STAGES) { stage = 0; phase ^= 1; }
      }
      // acc_e[4j + i] is dC^T at column n0 + nl + 8 (i / 2), row 8j + 2t + i % 2
#pragma unroll
      for (int j = 0; j < E / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + nl + 8 * (i >> 1), row = 8 * j + 2 * t + (i & 1);
          if (n < N) atomicAdd(dC + (size_t)row * N + n, acc_e[4 * j + i]);
        }
      }
    }
  }

  // the fold's sums: dC^T at columns nl (0) and nl + 8 (1), E column j.
  // Every block of a point range forms E and takes the E columns j with
  // j % k_tiles == kt: the blocks that share G's tiles through L2 keep in
  // step (the fold in the first k tile's blocks alone let the others run
  // ahead, and G's second read came from device memory).
  float dcx[2][NX > 0 ? NX : 1];
  if constexpr (NX > 0) {
#pragma unroll
    for (int j = 0; j < NX; ++j) dcx[0][j] = dcx[1][j] = 0.f;
    // E of the block's points, a point a thread at a time; 0 past P
    for (int q = threadIdx.x; q < steps * WGR_P; q += WGR_CONSUMERS) {
      __nv_bfloat16 v[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        v[j] = __float2bfloat16_rn(
            j < fx.n && p_begin + q < P
                ? extra_value<__nv_bfloat16>(fx.rays, fx.z, fx.S, fx.mode, fx.off, p_begin + q, j)
                : 0.f);
      *reinterpret_cast<uint2*>(&sm.f.es[q][0]) = *reinterpret_cast<const uint2*>(v);
    }
    bar_sync(1, WGR_CONSUMERS);
  }
  if (!enc_block) {  // dW^T = G^T . X
    float acc[128];  // written by wgmma only: the first product starts the sum
    for (int i = 0; i < steps; ++i) {
      mbar_wait(&sm.full[stage], phase);
      uint32_t a[2][4];
      wgrad_fragments<GM>(a, reinterpret_cast<const uint8_t*>(sm.dy[stage]) + box,
                          reinterpret_cast<const uint8_t*>(sm.mask[stage]) + mbox, c0, t,
                          has_mask, db0, db1);
      if constexpr (NX > 0) {  // dC^T += round(G)^T E: register r of step s
        // holds column nl + 8 (r % 2) at points 16 s + 8 (r / 2) + 2t and + 1
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = i * WGR_P + 16 * s + 8 * h + 2 * t;  // in the block's range
            // E rows of points q and q + 1: four bf16 each
            const uint2 u = *reinterpret_cast<const uint2*>(&sm.f.es[q][0]);
            const uint2 v = *reinterpret_cast<const uint2*>(&sm.f.es[q + 1][0]);
            const float e0[4] = {__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                 __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u)};
            const float e1[4] = {__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                                 __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u)};
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              // a bf16 pair: the low half is point q's, the high half q + 1's
              const uint32_t gp = a[s][2 * h + cc];
              const float g0 = __uint_as_float(gp << 16), g1 = __uint_as_float(gp & 0xffff0000u);
#pragma unroll
              for (int j = 0; j < NX; ++j)
                if (j % k_tiles == kt) dcx[cc][j] = fmaf(e1[j], g1, fmaf(e0[j], g0, dcx[cc][j]));
            }
          }
        }
      }
      const uint8_t* x = reinterpret_cast<const uint8_t*>(sm.x[stage]);
      wgmma_fence();
      wgmma_m64n256k16_rs_tb(acc, a[0], smem_desc(x, WGR_X_BOX, 1024, SWIZZLE_128B), i > 0);
      wgmma_m64n256k16_rs_tb(acc, a[1], smem_desc(x + 16 * 128, WGR_X_BOX, 1024, SWIZZLE_128B));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a[0]);
      fence_regs(a[1]);
      mbar_arrive(&sm.empty[stage]);
      if (++stage == WGR_STAGES) { stage = 0; phase ^= 1; }
    }
    // acc[4j + i] is dW^T at column n0 + nl + 8 (i / 2), row k0 + 8j + 2t + i % 2
#pragma unroll
    for (int j = 0; j < WGR_K / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + nl + 8 * (i >> 1), k = k0 + 8 * j + 2 * t + (i & 1);
        if (n < N && k < K) atomicAdd(dW + (size_t)k * N + n, acc[4 * j + i]);
      }
    }
  }
  if (kt == 0) {  // each column's bias sum once a point range
    db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
    db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
    if (t == 0 && n0 + nl < N) {
      atomicAdd(db + n0 + nl, db0);
      atomicAdd(db + n0 + nl + 8, db1);
    }
  }
  if constexpr (NX > 0) {  // the fold's sums, as the bias sums: across the quad, then atomics
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float v = dcx[cc][j];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && j < fx.n && j % k_tiles == kt && n0 + nl < N)
          atomicAdd(dC + (size_t)j * N + n0 + nl + 8 * cc, v);
      }
    }
  }
}

// X (P, K) bf16 (nullptr at K = 0), dY (P, N) fp32, mask (P, N) of GM's type
// or nullptr; dW (K, N), db (N,), dC (E, N) fp32, zeroed; N and K multiples of
// 64 (K = 0 only with an encoding); split a positive multiple of WGR_P. NX >
// 0: fx's E operand folded into dC (fx.n, N), fx.n <= NX.
template <int GM, int E, typename Enc, int NX = 0>
int launch_wgrad_wgmma(cudaStream_t st, const __nv_bfloat16* X, const float* dY, const void* mask,
                       float* dW, float* db, float* dC, const Enc& enc, int P, int N, int K,
                       int split, const FoldExtra& fx = FoldExtra{}) {
  static const int resident = hopper::resident_blocks(wgrad_wgmma<GM, E, Enc, NX>, WGR_THREADS,
                                                      wgrad_smem<GM, E, NX>());
  if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  if (K == 0 && E == 0) return (int)cudaErrorInvalidValue;
  if (NX > 0 && (K == 0 || fx.n < 1 || fx.n > NX || fx.S < 1 || split > FOLD_SPLIT))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_dy, map_mask;
  // without X (K = 0) its map stands on dY, 64 bf16 columns a row, and is never read
  int err = K > 0 ? hopper::tensor_map_2d(&map_x, X, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, P, K,
                                          WGR_P, 64, CU_TENSOR_MAP_SWIZZLE_128B)
                  : hopper::tensor_map_2d(&map_x, dY, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, P, 64,
                                          WGR_P, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hopper::tensor_map_2d(&map_dy, dY, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, P, N, WGR_P, 32,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = mask_map<GM>(&map_mask, mask, dY, P, N, WGR_P);
  if (err != 0) return err;
  const long long k_tiles = (K + WGR_K - 1) / WGR_K + (E > 0 ? 1 : 0);
  const long long blocks = (long long)((N + WGR_N - 1) / WGR_N) * k_tiles * ((P + split - 1) / split);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wgrad_wgmma<GM, E, Enc, NX><<<(int)blocks, WGR_THREADS, wgrad_smem<GM, E, NX>(), st>>>(
      map_x, map_dy, map_mask, mask != nullptr, dW, db, dC, enc, P, N, K, split, fx);
  return (int)cudaGetLastError();
}

}  // namespace

// The fp32 SIMT mainloop of the dense kernels (exact fp32 FFMA, no TF32),
// shared by siren_dense_sgemm (fused_render.cu), nerf_wgrad_sgemm
// (fused_nerf.cu) and dgrad_sgemm (below: siren_dense_dgrad of
// fused_train.cu, nerf_dense_dgrad of fused_nerf.cu): a 128 x 128 block tile
// of C = A . B, summed over the reduction in order, one fmaf chain an output.
//
// What bounds it: its operations. At 65,536 points and a 512 x 512 layer a
// launch does 34.4 GFLOP, 0.513 ms at the H100's 67 TFLOP/s of fp32 FMAs,
// against 0.16 ms of bytes (0.128 against 0.06 at 256 x 256). So the FMA
// pipes must not wait on loads, barriers or shared memory:
//  * a ring of SG_STAGES k tiles of SG_BK in dynamic shared memory, both
//    operands k-major ([k][m] and [k][n], rows padded by 4 floats); tile
//    kt + SG_STAGES - 1 is on its way while the FMAs run on tile kt, one
//    barrier a tile;
//  * an operand whose source is contiguous along the reduction (the
//    forward's X) is transposed in registers on the way in: 16-byte global
//    loads issued before the tile's FMAs, stored as scalars into the
//    k-major tile after them; an operand contiguous along its own columns
//    goes by 16-byte cp.async where it is an fp32 matrix (the forward's W,
//    the wgrad's X), else through registers the same way: a cotangent
//    G = round(dY * mask) is formed once an element on that way in, so the
//    FMAs read one operand, and the encoding of the points is computed
//    there;
//  * 8 warps of 16 x 128 outputs, a lane 8 x 8 in two 4-row and two
//    4-column groups 8 and 64 apart: a lane reads its fragments as four
//    16-byte shared loads a k, which a quarter warp takes without bank
//    conflicts (its A loads are two addresses, broadcast), double-buffered
//    in registers across k;
//  * any edge that cannot go 16 bytes at a time (ragged rows, a reduction
//    that is not a multiple of SG_BK, a width not a multiple of 4 or 8, a
//    pointer off 16 bytes) goes through scalar loads in the same kernel.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int SG_BM = 128, SG_BN = 128;  // the block tile (BM, BN of common.cuh)
constexpr int SG_BK = 16;                // reduction depth of a stage
constexpr int SG_STAGES = 4;             // the shared-memory ring
constexpr int SG_THREADS = 256;
constexpr int SG_MIN_BLOCKS = 2;         // blocks an SM the registers are cut for
constexpr int SG_WARP_M = 16;            // rows of a warp's tile: 16 x 128, 32 x 64, 64 x 32
constexpr int SG_LANES_M = SG_WARP_M / 8, SG_WARP_N = 32 / SG_LANES_M * 8;
constexpr int SG_WARPS_N = SG_BN / SG_WARP_N;
static_assert(SG_BM / SG_WARP_M * SG_WARPS_N * 32 == SG_THREADS, "8 warps a block tile");
constexpr int SG_LD = SG_BM + 4;         // padded row of a k-major tile
constexpr int SG_TILE = SG_BK * SG_LD;   // floats of one operand's stage
constexpr int SG_SMEM_BYTES = 2 * SG_STAGES * SG_TILE * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sources of an operand tile. A source hands the mainloop 16 raw bytes
// of V values at a time (V = 16 / sizeof(Elem)): raw(row, col, vec, left,
// s) holds values [col, col + V) of row `row` of its matrix, those from
// col + left on zero (left <= 0: all zero), as one 16-byte load where vec;
// values() turns the NSRC raw chunks into the fp32 values the FMAs read.
// SgSrc<T>: a row-major matrix of the compute type with leading dimension
// ld. Other sources (a cotangent formed from two tensors, an encoding
// computed from the rays) live beside the kernels that read them.
template <typename T> struct SgSrc {
  using Elem = T;
  static constexpr int NSRC = 1;
  const T* __restrict__ p;
  int ld;
  __device__ __forceinline__ uint4 raw(int row, int col, bool vec, int left, int) const {
    return row_chunk_raw<T>(p + (size_t)row * ld + col, 0, left, vec);
  }
  template <int V>
  __device__ __forceinline__ void values(const uint4 (&r)[1], float (&x)[V]) const {
    chunk_values<T>(r[0], x);
  }
};

// One operand of the mainloop, a SG_BK x 128 k-major tile a stage: its
// columns i0 .. i0 + 127 (`cols` of them in range) and the reduction's
// indices r0 + kt SG_BK .. (r_end of them in range).
//  ALONG_K: the source's rows are the tile's columns and hold the reduction
//    contiguously (X of the forward: row = point, col = k);
//  else:    the source's rows are the reduction and hold the tile's columns
//    contiguously (W of the forward, X and G of a wgrad); ASYNC sends the
//    full 16-byte chunks by cp.async (a memory source of fp32).
// Indices out of range are zeros. vec: a chunk the source holds whole may
// be one 16-byte load (its leading dimension a multiple of V, its base
// 16-byte aligned).
template <class Src, bool ALONG_K, bool ASYNC = false>
struct SgOperand {
  using Elem = typename Src::Elem;
  static constexpr int V = 16 / (int)sizeof(Elem);  // values a 16-byte chunk
  static constexpr int CHUNKS = SG_BK * SG_BM / V / SG_THREADS;
  static_assert(CHUNKS * V * SG_THREADS == SG_BK * SG_BM, "whole chunks a thread");
  static_assert(!ASYNC || (!ALONG_K && V == 4 && Src::NSRC == 1), "cp.async: fp32, rows");
  Src src;
  int i0, cols, r0, r_end;
  bool vec;
  uint4 raw[CHUNKS][Src::NSRC];

  // chunk c of the tile: (tile column i, reduction offset k)
  __device__ __forceinline__ void at(int c, int& i, int& k) const {
    if (ALONG_K) {
      i = c / (SG_BK / V);
      k = (c % (SG_BK / V)) * V;
    } else {
      k = c / (SG_BM / V);
      i = (c % (SG_BM / V)) * V;
    }
  }

  // the loads of tile kt into registers (ASYNC: into `tile` by cp.async,
  // the chunks it cannot send by 16-byte stores of what scalar loads read)
  __device__ __forceinline__ void load(int kt, float* tile) {
    const int rk = r0 + kt * SG_BK;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      int i, k;
      at(threadIdx.x + j * SG_THREADS, i, k);
      // the chunk's source row and column, and how many of its values lie
      // in range along that row
      const bool row_ok = ALONG_K ? i0 + i < cols : rk + k < r_end;
      const int row = ALONG_K ? i0 + i : rk + k, col = ALONG_K ? rk + k : i0 + i;
      const int left = !row_ok ? 0 : ALONG_K ? r_end - col : cols - col;
      const bool full = vec && left >= V;
      if constexpr (ASYNC) {
        float* dst = tile + k * SG_LD + i;
        if (full) {
          cp_async16(dst, reinterpret_cast<const float*>(src.p) + (size_t)row * src.ld + col);
        } else {
          const uint4 r = src.raw(row, col, false, left, 0);
          *reinterpret_cast<uint4*>(dst) = r;
        }
      } else {
#pragma unroll
        for (int s = 0; s < Src::NSRC; ++s) raw[j][s] = src.raw(row, col, full, left, s);
      }
    }
  }

  // the registers of the last load into `tile` (k-major); nothing for ASYNC
  __device__ __forceinline__ void store(float* tile) const {
    if constexpr (!ASYNC) {
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        int i, k;
        at(threadIdx.x + j * SG_THREADS, i, k);
        float x[V];
        src.template values<V>(raw[j], x);
        if (ALONG_K) {
#pragma unroll
          for (int e = 0; e < V; ++e) tile[(k + e) * SG_LD + i] = x[e];
        } else {
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(tile + k * SG_LD + i + e) =
                make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        }
      }
    }
  }
};

// The rows and columns of a thread's 8 x 8 outputs within the block tile:
// rows sg_row(r) for r < 8, columns sg_col(c) for c < 8. A warp's tile is
// SG_WARP_M x SG_WARP_N; its lanes SG_LANES_M (rows) by 32 / SG_LANES_M, a
// lane's 4-row and 4-column groups half the warp's tile apart.
__device__ __forceinline__ int sg_row(int r) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / SG_WARPS_N) * SG_WARP_M + (r / 4) * (SG_WARP_M / 2) +
         (lane % SG_LANES_M) * 4 + r % 4;
}
__device__ __forceinline__ int sg_col(int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % SG_WARPS_N) * SG_WARP_N + (c / 4) * (SG_WARP_N / 2) +
         (lane / SG_LANES_M) * 4 + c % 4;
}

// acc[r][c] += sum over the reduction of A[sg_row(r)][k] * B[k][sg_col(c)],
// k in order, over k_tiles tiles of SG_BK; smem: SG_SMEM_BYTES of dynamic
// shared memory. Ends with a barrier, so the caller may reuse smem.
template <class OpA, class OpB>
__device__ __forceinline__ void sgemm_mainloop(float (&acc)[8][8], int k_tiles, OpA& a_op,
                                               OpB& b_op, float* smem) {
  float* As = smem;
  float* Bs = smem + SG_STAGES * SG_TILE;
  const int a_at = sg_row(0), b_at = sg_col(0);
#pragma unroll
  for (int s = 0; s < SG_STAGES - 1; ++s) {
    if (s < k_tiles) {
      a_op.load(s, As + s * SG_TILE);
      b_op.load(s, Bs + s * SG_TILE);
      a_op.store(As + s * SG_TILE);
      b_op.store(Bs + s * SG_TILE);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<SG_STAGES - 2>();
    __syncthreads();  // tile kt in place; tile kt - 1's slot free
    const int nt = kt + SG_STAGES - 1;
    float* an = As + (nt % SG_STAGES) * SG_TILE;
    float* bn = Bs + (nt % SG_STAGES) * SG_TILE;
    if (nt < k_tiles) {
      a_op.load(nt, an);
      b_op.load(nt, bn);
    }
    cp_async_commit();
    const float* at = As + (kt % SG_STAGES) * SG_TILE + a_at;
    const float* bt = Bs + (kt % SG_STAGES) * SG_TILE + b_at;
    float4 fa[2][2], fb[2][2];
    constexpr int A2 = SG_WARP_M / 2, B2 = SG_WARP_N / 2;  // the second groups
    fa[0][0] = *reinterpret_cast<const float4*>(at);
    fa[0][1] = *reinterpret_cast<const float4*>(at + A2);
    fb[0][0] = *reinterpret_cast<const float4*>(bt);
    fb[0][1] = *reinterpret_cast<const float4*>(bt + B2);
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < SG_BK) {
        const int nx = cur ^ 1;
        fa[nx][0] = *reinterpret_cast<const float4*>(at + (kk + 1) * SG_LD);
        fa[nx][1] = *reinterpret_cast<const float4*>(at + (kk + 1) * SG_LD + A2);
        fb[nx][0] = *reinterpret_cast<const float4*>(bt + (kk + 1) * SG_LD);
        fb[nx][1] = *reinterpret_cast<const float4*>(bt + (kk + 1) * SG_LD + B2);
      }
      const float a[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z, fa[cur][0].w,
                          fa[cur][1].x, fa[cur][1].y, fa[cur][1].z, fa[cur][1].w};
      const float b[8] = {fb[cur][0].x, fb[cur][0].y, fb[cur][0].z, fb[cur][0].w,
                          fb[cur][1].x, fb[cur][1].y, fb[cur][1].z, fb[cur][1].w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (nt < k_tiles) {
      a_op.store(an);
      b_op.store(bn);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------------------ the dgrads
//
// dX[p, k] (+)= sum_n round(G[p, n]) * W[k, n]: the simt mainloop of
// siren_dense_dgrad (G = dY * slope, fused_train.cu SgSlopeG) and of
// nerf_dense_dgrad (G = dY * [Y > 0], fused_nerf.cu SgMaskedG), the rule's
// for fp32 and for bf16 of shapes no tensor-core mainloop takes. They serve
// the fp32 backward chains of the TPU kernels fused_train_loss_grads,
// fused_sc_loss_grads, fused_train_render_rays, fused_field_apply(_rays)
// (satnerf_tpu/ops/pallas/fused_mlp.py) and fused_nerf_train_loss_grads,
// fused_nerf_apply (fused_nerf.py): their _dot_t_rhs products.
//
// What bounds it: its operations, 2 P K N FLOPs (0.513 ms at the H100's 67
// TFLOP/s for 65,536 points at 512 x 512, 0.128 ms at 256 x 256) against
// 0.16 ms (0.06) of bytes. A is G, whose rows (points) are contiguous along
// the reduction n: it is transposed in registers on its way in, G formed and
// rounded once an element there, from 16-byte loads of dY and of the slope
// or mask. B is W^T: W (K, N) holds the reduction contiguously too, so it
// takes the same way (a transposed copy of W sent by cp.async, one launch
// more, was 1-2 % slower on the H100). 128 registers, no spills, at two
// blocks an SM. Each output is one fmaf chain over n in order from 0, on
// the same rounded G and W as the first SIMT body: dX is that body's to the
// bit. The grid is one-dimensional with the column tile fastest: the blocks
// that read a row tile of G run side by side and find it in L2.
template <class GSrc, typename T>
__global__ void __launch_bounds__(SG_THREADS, SG_MIN_BLOCKS)
dgrad_sgemm(GSrc g, const T* __restrict__ W, float* __restrict__ dX, int accumulate, int P,
            int N, int K, bool vec_g, bool vec_w, bool vec_x) {
  extern __shared__ __align__(16) float sg_smem[];
  const int col_tiles = (K + SG_BN - 1) / SG_BN;
  const int row0 = (blockIdx.x / col_tiles) * SG_BM;  // points
  const int col0 = (blockIdx.x % col_tiles) * SG_BN;  // k
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  SgOperand<GSrc, true> a{g, row0, P, 0, N, vec_g};
  SgOperand<SgSrc<T>, true> b{{W, N}, col0, K, 0, N, vec_w};
  sgemm_mainloop(acc, (N + SG_BK - 1) / SG_BK, a, b, sg_smem);
  // dX, added onto what is there where accumulate; vec_x: 4-column vector
  // loads and stores (K a multiple of 4, dX aligned)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = row0 + sg_row(r);
    if (q >= P) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = col0 + sg_col(4 * h);
      if (k >= K) continue;
      float* o = dX + (size_t)q * K + k;
      if (vec_x) {
        float4 v = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                               acc[r][4 * h + 3]);
        if (accumulate) {
          const float4 was = *reinterpret_cast<const float4*>(o);
          v = make_float4(was.x + v.x, was.y + v.y, was.z + v.z, was.w + v.w);
        }
        *reinterpret_cast<float4*>(o) = v;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k + c < K) o[c] = accumulate ? o[c] + acc[r][4 * h + c] : acc[r][4 * h + c];
      }
    }
  }
}

// dgrad_sgemm of dX (P x K) (+)= round(G) . W^T on its grid, its dynamic
// shared memory allowed first; g_vec: G's source may go 16 bytes at a time
// (N a multiple of 4, its pointers aligned).
template <class GSrc, typename T>
int launch_dgrad_sgemm(cudaStream_t st, GSrc g, bool g_vec, const T* W, float* dX,
                       int accumulate, int P, int N, int K) {
  static int allowed = 0;
  const int err = hopper::allow_smem(dgrad_sgemm<GSrc, T>, SG_SMEM_BYTES, &allowed);
  if (err != 0) return err;
  const long long tiles = (long long)((P + SG_BM - 1) / SG_BM) * ((K + SG_BN - 1) / SG_BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int v = 16 / (int)sizeof(T);
  const bool vec_w = N % v == 0 && hopper::aligned16(W);
  const bool vec_x = K % 4 == 0 && hopper::aligned16(dX);
  dgrad_sgemm<GSrc, T><<<(unsigned)tiles, SG_THREADS, SG_SMEM_BYTES, st>>>(
      g, W, dX, accumulate, P, N, K, g_vec, vec_w, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

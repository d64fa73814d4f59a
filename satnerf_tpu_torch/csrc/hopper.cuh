// Hopper (sm_90a) building blocks of the wgmma mainloops: siren_dense
// (fused_render.cu) and the backward's dgrad and wgrad (dense_bwd_wgmma.cuh,
// instantiated by fused_train.cu and fused_nerf.cu).
//
//  * TMA tensor maps, encoded on the host by cuTensorMapEncodeTiled, which
//    is looked up at run time (cudaGetDriverEntryPoint), so the library links
//    against the CUDA runtime only (no -lcuda).
//  * a ring of shared-memory stages, each with a "full" mbarrier (the
//    producer's TMA loads land; transaction bytes) and an "empty" one (every
//    consumer thread is done reading it);
//  * wgmma descriptors and the wgmma shapes the kernels use, as inline PTX;
//  * the store helpers that turn the accumulator's layout (a thread holds two
//    neighbouring columns of an 8-column block, for two rows) into 16-byte
//    stores by exchanging values inside a quad of lanes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, cols) matrix as a 2-D tensor map whose box is
// box_rows x box_cols. Reads past either edge fill zeros (the ragged edge of
// a tile). Returns a cudaError_t value, 0 on success.
inline int tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                         int elem_bytes, uint64_t rows, uint64_t cols, uint32_t box_rows,
                         uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// How many blocks of `kernel` are resident on the card at once, the size of
// its persistent grid; `smem` bytes of dynamic shared memory are allowed to
// it first. 0 when it cannot run. Launchers keep the answer in a static.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// The most dynamic shared memory a block may opt into on this card (H100:
// 227 KB, 232,448 bytes); a launch asking for more is refused.
constexpr int SMEM_OPTIN_BYTES = 232448;

// Let `kernel` take `smem` bytes of dynamic shared memory: above 48 KB a
// kernel has to opt in. Returns a cudaError_t value, 0 on success; the
// largest amount set so far is kept in `*allowed` (the caller's static), so
// a launch needing no more calls nothing.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int smem, int* allowed) {
  if (smem > SMEM_OPTIN_BYTES) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024 || smem <= *allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  *allowed = smem;
  return 0;
}

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary: the 128-byte
// swizzle repeats every 1024 bytes, and TMA and wgmma agree on it only from
// such a boundary. The launch asks for 1024 bytes more than it uses.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// lasts 10 s means the ring is broken: it traps, and the launch fails with
// an error (719, cudaErrorLaunchFailure) where it would otherwise hang the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint64_t since = 0;
  for (uint32_t spin = 1;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin % 1024 == 0) {
      const uint64_t now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 10000000000ull) __trap();
    }
  }
}

// One box of a 2-D tensor map into shared memory, completing on `bar`.
// c_col is the coordinate along the contiguous dimension.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c_col, int c_row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c_col), "r"(c_row)
      : "memory");
}

// Named barrier of `threads` threads (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the point where it stands: after wgmma_wait, the accumulators (and an
// A operand held in registers) are live until here, so no other value takes
// their registers while a wgmma may still read or write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

enum { SWIZZLE_128B = 1, SWIZZLE_64B = 2 };

// wgmma shared-memory matrix descriptor. K-major (the reduction dimension
// contiguous): sbo = bytes between groups of 8 rows; lbo unused. N-major:
// lbo = bytes between 64-element column blocks, sbo = bytes between groups
// of 8 rows of the reduction dimension.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (swizzle << 62);
}

// D (64 x 128) (+)= A (64 x 16, K-major, shared memory) . B (16 x 128,
// N-major, shared memory): scale-a 1, scale-b 1, A not transposed, B
// transposed; scale_d 0 ignores D's old value (the first product of a tile)
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float* d, uint64_t desc_a, uint64_t desc_b,
                                                       int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 256) (+)= A (64 x 16, registers) . B (16 x 256, shared memory):
// scale-a 1, scale-b 1; B K-major (TRANS_B 0) or N-major (TRANS_B 1, the
// layout of siren_dense's W); scale_d as above
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_rs_impl(float* d, const uint32_t* a,
                                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// B K-major: dgrad's W (256 rows of dX's columns, 32 of the reduction a stage)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                                    int scale_d = 1) {
  wgmma_m64n256k16_rs_impl<0>(d, a, desc_b, scale_d);
}

// B N-major ("transposed"): the wgrad's X tile, points by columns of X
__device__ __forceinline__ void wgmma_m64n256k16_rs_tb(float* d, const uint32_t* a,
                                                       uint64_t desc_b, int scale_d = 1) {
  wgmma_m64n256k16_rs_impl<1>(d, a, desc_b, scale_d);
}

// D (64 x 64) (+)= A (64 x 16, registers) . B (16 x 64, shared memory,
// N-major): the nerf wgrad's 64-column encoding tile (dC of the position)
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t* a,
                                                      uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32) (+)= A (64 x 16, registers) . B (16 x 32, shared memory,
// N-major): the 32-column encoding tile (dC of the view direction)
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float* d, const uint32_t* a,
                                                      uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Makes this thread's ordinary writes to shared memory visible to the async
// proxy (the wgmma that reads a tile the threads computed): each writer runs
// it after its stores and before the barrier the readers wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// Accumulator layout of a m64nN wgmma, for the thread of lane `lane` in warp
// w of its warpgroup: element 4j + i of its registers sits at row
// 16w + lane / 4 + 8 * (i / 2), column 8j + 2 * (lane % 4) + i % 2.

// acc[16 B .. 16 B + 15] with indices the compiler knows: a switch over B
// keeps acc in registers where acc[16 * b + i] would put it in local memory
// (the epilogues of siren_dense_wgmma and nerf_dense_wgmma).
template <int B>
__device__ __forceinline__ void take16(float (&a)[16], const float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = acc[16 * B + i];
}

// The four lanes of a quad each hold one 32-bit word of each of four
// 8-column blocks (columns 2t, 2t + 1 of block b in w[b], t = lane % 4).
// Afterwards lane t holds block t whole: w[c] = columns 2c, 2c + 1 of block t,
// 16 contiguous bytes of bf16.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
  if (odd) w[0] = r; else w[1] = r;
  r = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
  if (odd) w[2] = r; else w[3] = r;
  r = __shfl_xor_sync(0xffffffffu, high ? w[0] : w[2], 2);
  if (high) w[0] = r; else w[2] = r;
  r = __shfl_xor_sync(0xffffffffu, high ? w[1] : w[3], 2);
  if (high) w[1] = r; else w[3] = r;
}

// Two fp32 pairs a lane, columns 2t, 2t + 1 of blocks a and b, into four
// contiguous floats: an even lane returns columns 2t .. 2t + 3 of block a, an
// odd lane columns 2t - 2 .. 2t + 1 of block b (column_in_block gives which).
__device__ __forceinline__ float4 pair_exchange(float2 a, float2 b, int t) {
  const bool odd = t & 1;
  const float2 send = odd ? a : b;
  float2 got;
  got.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
  got.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
  return odd ? make_float4(got.x, got.y, b.x, b.y) : make_float4(a.x, a.y, got.x, got.y);
}

}  // namespace hopper

// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (conv_int8.cu, conv1_fused.cu) and the NMS scan's ring (nms.cu):
// mbarriers, bulk and TMA copies into shared memory, wgmma shared-memory
// descriptors, and the TMA map of an NHWC tensor
// (cuTensorMapEncodeTiled, fetched at run time: no -lcuda at link time).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Bulk copy (TMA, no tensor map) of `bytes` contiguous bytes into shared
// memory; the barrier's transaction count drops by them when they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: the box of `map` at (c0, c1, c2, c3) into shared memory, zeros where
// it leaves the tensor; the barrier's transaction count drops by its bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO = bytes
// between the two 16-byte core matrices along K, SBO = bytes between
// successive groups of 8 rows (M or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of an NHWC tensor [B, H, W, C] of `elem_bytes`-byte elements
// with boxes of `box_c` channels x `box_w` columns x `box_h` rows x 1 image,
// no swizzle (the wgmma no-swizzle layout), zeros out of bounds. Returns 0
// or a cudaError_t.
inline int nhwc_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes, const void* x,
                    int B, int H, int W, int C, int box_c, int box_w, int box_h) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t row = (cuuint64_t)C * elem_bytes;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, dtype, 4, const_cast<void*>(x), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

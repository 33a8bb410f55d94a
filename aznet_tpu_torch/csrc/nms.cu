// Exact greedy NMS for Hopper (sm_90a): B independent streams of N boxes.
//
// Replaces aznet_tpu/ops/pallas/nms_kernel.py::nms_pallas_batched (the
// bitonic-order path: _bitonic_sort6 -> _nms_kernel_nosub -> the bitonic
// unpermute). Same contract, bit for bit:
//   * order is score-descending with ties to the lower index; the score is
//     mapped to an integer key that folds +-0 and every subnormal into the
//     +0 key (_intkey_u32 in the Pallas file);
//   * a row is invalid when valid[] is false or its score is -inf; invalid
//     rows sort last, are never kept and never suppress;
//   * box i is suppressed when IoU > thresh against an earlier kept box;
//     widths carry +offset and IoU is 0 when the union is <= 0.
//
// Three kernels, launched back to back on the caller's stream:
//   1. sort_kernel: one block per stream. Bitonic sort, in shared memory, of
//      unique 64-bit keys (folded_key << 32 | index), padded to a power of
//      two; then a gather of the sorted boxes.
//   2. mask_kernel: one block per (column tile, row tile, stream), 64 x 64
//      boxes. Bit j of word (i, tile) is set when sorted box j comes after
//      sorted box i and their IoU exceeds the threshold.
//   3. scan_kernel: one block per stream. The sequential greedy pass over the
//      sorted rows, 64 rows at a time: one thread resolves the 64 rows of a
//      word from the diagonal word, then the block ORs the kept rows' masks
//      into the later words of the `removed` bitset in shared memory, one
//      (row, word) pair per thread. It writes the keep flag straight to the
//      box's original slot, so no unpermute pass.
//
// What bounds it on the card: the mask pass writes N*N/64 words per stream
// (N = 2048: 512 KB; N = 4096: 2 MB) and computes N*N/2 IoUs, and the scan
// is a serial chain of N steps per stream (three block barriers per 64 rows).
// The design keeps both simple: the mask is embarrassingly parallel over
// tiles (upper-triangle tiles only), and the serial chain runs out of
// registers and shared memory.
//
// Exactness: compile without --use_fast_math (subnormal flush and
// approximate division would move IoUs at the threshold) and with
// --fmad=false; the IoU arithmetic below also spells out every rounding
// with __f*_rn intrinsics, so (area_i + area_j) - inter is never contracted
// into an FMA, matching the reference's separate multiply and subtract.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxN = 8192;
constexpr int kTile = 64;
constexpr int kScanThreads = 1024;          // >= kTile
constexpr uint32_t kKeyNegInf = 0xFF800000u;  // folded key of -inf

// uint32 key whose ascending order is score-descending (_intkey_u32).
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7F800000u) == 0u) u = 0u;  // +-0 and subnormals: one key
  uint32_t sign = u >> 31;
  uint32_t key = u ^ (sign * 0x7FFFFFFFu + 0x80000000u);
  return ~key;
}

__device__ __forceinline__ float box_area(float4 b, float offset) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), offset),
                   __fadd_rn(__fsub_rn(b.w, b.y), offset));
}

__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 c,
                                          float area_c, float offset,
                                          float thresh) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), offset);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), offset);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thresh;
}

__global__ void sort_kernel(const float4* __restrict__ boxes,
                            const float* __restrict__ scores,
                            const uint8_t* __restrict__ valid, int n,
                            int n_pad, int32_t* __restrict__ sorted_idx,
                            float4* __restrict__ sorted_boxes,
                            uint8_t* __restrict__ sorted_valid) {
  extern __shared__ u64 keys[];  // n_pad entries
  const int b = blockIdx.x;
  const size_t in_base = (size_t)b * n;
  const size_t out_base = (size_t)b * n_pad;

  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    uint32_t k = kKeyNegInf;  // padding rows sort after every real row
    if (i < n) k = score_key(valid[in_base + i] ? scores[in_base + i] : -INFINITY);
    keys[i] = ((u64)k << 32) | (uint32_t)i;
  }
  __syncthreads();

  // Keys are unique (the index is in the low word), so the network's result
  // is the stable order.
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n_pad / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const u64 a = keys[lo];
        const u64 c = keys[hi];
        if ((a > c) == ascending) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    const u64 kv = keys[i];
    const int idx = (int)(uint32_t)kv;
    const bool real = idx < n;
    sorted_idx[out_base + i] = idx;
    sorted_boxes[out_base + i] =
        real ? boxes[in_base + idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    sorted_valid[out_base + i] = real && (uint32_t)(kv >> 32) != kKeyNegInf;
  }
}

__global__ void mask_kernel(const float4* __restrict__ sorted_boxes, int n_pad,
                            float thresh, float offset,
                            u64* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const int b = blockIdx.z;
  if (col_tile < row_tile) return;  // words left of the diagonal are never read
  const int n_words = n_pad / kTile;
  const float4* base = sorted_boxes + (size_t)b * n_pad;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  const float4 c = base[col_tile * kTile + t];
  col_box[t] = c;
  col_area[t] = box_area(c, offset);
  __syncthreads();

  const int i = row_tile * kTile + t;
  const float4 r = base[i];
  const float r_area = box_area(r, offset);
  u64 bits = 0;
  for (int j = (col_tile == row_tile) ? t + 1 : 0; j < kTile; ++j) {
    if (iou_above(r, r_area, col_box[j], col_area[j], offset, thresh))
      bits |= 1ull << j;
  }
  mask[((size_t)b * n_pad + i) * n_words + col_tile] = bits;
}

__global__ void scan_kernel(const u64* __restrict__ mask,
                            const int32_t* __restrict__ sorted_idx,
                            const uint8_t* __restrict__ sorted_valid, int n,
                            int n_pad, uint8_t* __restrict__ keep) {
  const int b = blockIdx.x;
  const int n_words = n_pad / kTile;
  const u64* m = mask + (size_t)b * n_pad * n_words;
  const size_t row_base = (size_t)b * n_pad;

  __shared__ u64 removed[kMaxN / kTile];
  __shared__ u64 diag[kTile];
  __shared__ uint8_t row_valid[kTile];
  __shared__ u64 kept_word;

  for (int w = threadIdx.x; w < n_words; w += blockDim.x) removed[w] = 0;
  __syncthreads();

  for (int wb = 0; wb < n_words; ++wb) {
    const int t = threadIdx.x;
    if (t < kTile) {
      const int row = wb * kTile + t;
      diag[t] = m[(size_t)row * n_words + wb];
      row_valid[t] = sorted_valid[row_base + row];
    }
    __syncthreads();
    if (t == 0) {  // the serial greedy chain over this word's 64 rows
      u64 gone = removed[wb];
      u64 kw = 0;
      for (int r = 0; r < kTile; ++r) {
        if (!((gone >> r) & 1ull) && row_valid[r]) {
          kw |= 1ull << r;
          gone |= diag[r];
        }
      }
      kept_word = kw;
    }
    __syncthreads();
    const u64 kw = kept_word;
    if (t < kTile) {
      const int idx = sorted_idx[row_base + wb * kTile + t];
      if (idx < n) keep[(size_t)b * n + idx] = (uint8_t)((kw >> t) & 1ull);
    }
    // OR the kept rows' mask words right of the diagonal into `removed`:
    // one (row, word) pair per thread, consecutive threads on consecutive
    // words of a row (coalesced, and independent loads in flight at once).
    const int rest = n_words - wb - 1;
    for (int p = t; p < kTile * rest; p += blockDim.x) {
      const int r = p / rest;
      if ((kw >> r) & 1ull) {
        const int w = wb + 1 + (p - r * rest);
        atomicOr(&removed[w], m[(size_t)(wb * kTile + r) * n_words + w]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Keep mask of B streams. boxes [B, n, 4] f32, scores [B, n] f32, valid
// [B, n] u8; n_pad is a power of two in [64, 8192], >= n. Scratch:
// sorted_idx [B, n_pad] i32, sorted_boxes [B, n_pad, 4] f32, sorted_valid
// [B, n_pad] u8, mask [B, n_pad, n_pad / 64] u64. Output: keep [B, n] u8 in
// original order. Returns the cudaError_t of the launches (0 = cudaSuccess).
int aznet_nms_launch(const void* boxes, const void* scores, const void* valid,
                     int batch, int n, int n_pad, float thresh, float offset,
                     void* sorted_idx, void* sorted_boxes, void* sorted_valid,
                     void* mask, void* keep, void* stream) {
  if (batch <= 0 || n <= 0 || n > n_pad || n_pad > kMaxN || n_pad < kTile ||
      (n_pad & (n_pad - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)n_pad * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sort_threads = n_pad / 2 < 1024 ? n_pad / 2 : 1024;
  sort_kernel<<<batch, sort_threads, smem, s>>>(
      (const float4*)boxes, (const float*)scores, (const uint8_t*)valid, n,
      n_pad, (int32_t*)sorted_idx, (float4*)sorted_boxes,
      (uint8_t*)sorted_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(n_pad / kTile, n_pad / kTile, batch);
  mask_kernel<<<grid, kTile, 0, s>>>((const float4*)sorted_boxes, n_pad,
                                     thresh, offset, (u64*)mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  scan_kernel<<<batch, kScanThreads, 0, s>>>(
      (const u64*)mask, (const int32_t*)sorted_idx,
      (const uint8_t*)sorted_valid, n, n_pad, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

const char* aznet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

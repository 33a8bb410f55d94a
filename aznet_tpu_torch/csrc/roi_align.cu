// Fused ROI align for Hopper (sm_90a): feat [H, W, C] (bf16 or f32, NHWC)
// and rois [R, 4] f32 image coordinates -> out [R, P, P, C] in feat's dtype.
//
// Replaces aznet_tpu/ops/pallas/roi_kernel.py: roi_align_pallas (the
// whole-map, H-first kernel) and its large-map tilings roi_align_pallas_big
// and roi_align_pallas_big_v2 (W-first). The three compute one function in
// two contraction orders; here they are one kernel with a w_first flag. The
// TPU's roi, h and channel tiles (VMEM budget, 128 lanes) are not carried.
//
// Numerics, per roi and axis (the plain version in ops/roi_pool.py repeats
// every step; the build has --fmad=false and every f32 step is spelled with
// a _rn intrinsic, so the two agree bit for bit):
//   lo = roi * scale, size = max(hi - lo, 1);
//   sample i of 2P: pos = clip(lo + ((i + 0.5) / 2P) * size, 0, extent - 1);
//   bin p weighs cell c by (tri(pos_2p, c) + tri(pos_2p+1, c)) * 0.5, with
//   tri(pos, c) = max(1 - |pos - c|, 0), rounded to the feature dtype. The
//   weight is nonzero only on floor(pos) and floor(pos) + 1 of its two
//   samples: four tap slots per bin, in ascending cell order (a slot that
//   repeats a cell or leaves the map is empty).
//   H-first: rows[p, w] = sum over y taps of wy * feat[h, w], an f32 sum
//   rounded to the feature dtype; out[p, q] = sum over x taps of wx *
//   rows[p, w] in f32, rounded to the feature dtype. W-first swaps the axes.
// Empty and zero-weight slots are skipped: adding w * f = +-0 to an f32 sum
// leaves it unchanged, so the sums equal the plain version's, which adds
// every slot.
//
// Design: one block per (roi, 128-channel tile, bin i of the first axis), one
// thread per channel, so the feature loads of a warp are contiguous. The
// block first tabulates the taps of both axes in shared memory; then each
// thread computes the first contraction of bin i only at the cells the second
// one reads (at most 4 per bin of the second axis) into its column of shared
// memory, and the second contraction from there: one row (H-first) or column
// (W-first) of the roi's P x P outputs. What bounds it on this card:
// each output value reads at most 16 feature values, from a map that sits in
// L2 (1.9 MB at 38 x 50 x 512 bf16), so memory latency and the launch, not
// bandwidth or arithmetic; no tensor cores are needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kMaxPool = 16;   // bins per axis the tap tables hold
constexpr int kSlots = 4;      // tap slots per bin

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// f32 value of v rounded to T (round to nearest even for bf16).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float tri(float pos, int cell) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)cell))), 0.0f);
}

// The four tap slots of bin `bin` of one axis.
template <typename T>
__device__ void bin_taps(float lo, float size, int extent, int pool, int bin,
                         int* cell, float* weight) {
  const float n = (float)(2 * pool);
  const float hi_clip = (float)(extent - 1);
  float pos[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float grid = __fdiv_rn(__fadd_rn((float)(2 * bin + s), 0.5f), n);
    pos[s] = fminf(fmaxf(__fadd_rn(lo, __fmul_rn(grid, size)), 0.0f), hi_clip);
  }
  const int f0 = (int)floorf(pos[0]);
  const int f1 = (int)floorf(pos[1]);
  const int cells[kSlots] = {f0, f0 + 1, f1, f1 + 1};
  const bool live[kSlots] = {true, f0 + 1 < extent, f1 > f0 + 1, f1 > f0 && f1 + 1 < extent};
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    cell[k] = min(cells[k], extent - 1);
    weight[k] = live[k] ? round_to<T>(__fmul_rn(
                              __fadd_rn(tri(pos[0], cells[k]), tri(pos[1], cells[k])), 0.5f))
                        : 0.0f;
  }
}

// Grid: (R, ceil(C / 128), pool): one block per roi, channel tile and bin of
// the first axis. Axis 0 is y (H), axis 1 is x (W).
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois, int H,
                 int W, int C, float scale, int pool, int w_first, T* __restrict__ out) {
  __shared__ int s_cell[2][kMaxPool][kSlots];
  __shared__ float s_w[2][kMaxPool][kSlots];
  extern __shared__ float s_mid[];  // first contraction: [pool * kSlots][kThreads]

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int ch = blockIdx.y * kThreads + t;
  if (t < 2 * pool) {
    const int axis = t / pool;
    const int bin = t - axis * pool;
    const float* roi = rois + (size_t)r * 4;
    const float lo = __fmul_rn(roi[1 - axis], scale);  // y1 or x1
    const float hi = __fmul_rn(roi[3 - axis], scale);  // y2 or x2
    bin_taps<T>(lo, fmaxf(__fsub_rn(hi, lo), 1.0f), axis ? W : H, pool, bin,
                s_cell[axis][bin], s_w[axis][bin]);
  }
  __syncthreads();
  if (ch >= C) return;

  const int fa = w_first ? 1 : 0;  // contracted first
  const int sa = 1 - fa;           // contracted second
  const int i = blockIdx.z;        // this block's bin of the first axis
  for (int j = 0; j < pool; ++j) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (s_w[sa][j][k] == 0.0f) continue;
      const int sc = s_cell[sa][j][k];
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSlots; ++kk) {
        const float wv = s_w[fa][i][kk];
        if (wv == 0.0f) continue;
        const int fc = s_cell[fa][i][kk];
        const int y = fa == 0 ? fc : sc;
        const int x = fa == 0 ? sc : fc;
        acc = __fadd_rn(acc, __fmul_rn(wv, to_f32(feat[((size_t)y * W + x) * C + ch])));
      }
      s_mid[(j * kSlots + k) * kThreads + t] = round_to<T>(acc);
    }
  }
  for (int j = 0; j < pool; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float wv = s_w[sa][j][k];
      if (wv == 0.0f) continue;
      acc = __fadd_rn(acc, __fmul_rn(wv, s_mid[(j * kSlots + k) * kThreads + t]));
    }
    const int p = fa == 0 ? i : j;
    const int q = fa == 0 ? j : i;
    out[(((size_t)r * pool + p) * pool + q) * C + ch] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* feat, const void* rois, int R, int H, int W, int C, float scale,
           int pool, int w_first, void* out, void* stream) {
  if (R <= 0 || H <= 0 || W <= 0 || C <= 0 || pool < 1 || pool > kMaxPool)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(R, (C + kThreads - 1) / kThreads, pool);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)pool * kSlots * kThreads * sizeof(float);  // <= 32 KB
  roi_align_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)feat, (const float*)rois, H, W, C, scale, pool, w_first, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feat [H, W, C] (bf16 when is_bf16, else f32), rois [R, 4] f32 -> out
// [R, pool, pool, C] in feat's dtype. Returns the cudaError_t of the launch.
int aznet_roi_align(const void* feat, const void* rois, int R, int H, int W, int C,
                    float scale, int pool, int w_first, int is_bf16, void* out,
                    void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(feat, rois, R, H, W, C, scale, pool, w_first, out, stream);
  return launch<float>(feat, rois, R, H, W, C, scale, pool, w_first, out, stream);
}

}  // extern "C"

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
// What bounds it on this card: each output value needs up to 16 feature
// values, from a map that sits in L2 (1.9 MB at 38 x 50 x 512 bf16, 16.7 MB
// at 68 x 120 x 1024), so the L2 traffic, the latency of dependent loads and
// the instruction count, not HBM bandwidth or arithmetic; no tensor cores.
//
// Design: one block per (roi, channel slab, group of second-axis bins), with
// P x S threads: thread (i, g) owns bin i of the first axis and 8
// consecutive channels, so a feature load or an output store is 16 bytes a
// thread (two for f32) and a warp moves 512 bytes at once. The block works
// out the roi's tap tables once (one barrier). A thread then walks its
// second-axis bins in order and computes the first contraction once per
// distinct cell they read (neighbouring bins share cells: on the 38 x 50
// map a roi's 17.6 live slots cover 9.1 cells), keeping the last two cells'
// intermediates in registers; a cell's live taps are loaded together, so
// up to four independent 16-byte loads are in flight. A cell's intermediate
// is the same value whichever slot reads it, so the reuse keeps the result
// bit for bit. The host (ops/cuda/roi_align_kernel.py::launch_plan) splits
// the P second-axis bins over blocks only as far as needed to give every SM
// two blocks at small R. C that is not a multiple of 8 (or a buffer that is
// not 16-byte aligned) takes the same kernel with element-wise, masked loads
// and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPool = 16;         // bins per axis the tap tables hold
constexpr int kSlots = 4;            // tap slots per bin
constexpr int kVec = 8;              // channels per thread
constexpr int kMaxSlabThreads = 32;  // threads per bin of the first axis

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

// 8 channels at p as f32: one 16-byte load (bf16) or two (f32) when kVecIO,
// else `n` (< 8 at the tail) element loads and zeros.
template <typename T, bool kVecIO>
__device__ __forceinline__ void load8(const T* p, int n, float* v) {
  if constexpr (kVecIO) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bf16 -> f32 is exact: the bits move up
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
      }
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = e < n ? to_f32(p[e]) : 0.0f;
  }
}

template <typename T, bool kVecIO>
__device__ __forceinline__ void store8(T* p, int n, const float* v) {
  if constexpr (kVecIO) {
    if constexpr (sizeof(T) == 2) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e]));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e + 1]));
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (e < n) p[e] = from_f32<T>(v[e]);
  }
}

// Grid: (R, slabs * groups); block: pool * slab_threads threads. Block (r,
// slab * groups + grp) covers roi r, channels [slab * slab_threads * 8, +
// slab_threads * 8) and second-axis bins [grp * per, grp * per + per);
// thread t takes first-axis bin t / slab_threads and the 8 channels of lane
// t % slab_threads. Axis 0 is y (H), axis 1 is x (W).
template <typename T, bool kVecIO>
__global__ void __launch_bounds__(kMaxPool * kMaxSlabThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois, int H, int W, int C,
                 float scale, int pool, int w_first, int slab_threads, int per, int groups,
                 T* __restrict__ out) {
  __shared__ int s_cell[2][kMaxPool][kSlots];
  __shared__ float s_w[2][kMaxPool][kSlots];

  const int r = blockIdx.x;
  for (int e = threadIdx.x; e < 2 * pool; e += blockDim.x) {
    const int axis = e / pool;
    const int bin = e - axis * pool;
    const float* roi = rois + (size_t)r * 4;
    const float lo = __fmul_rn(roi[1 - axis], scale);  // y1 or x1
    const float hi = __fmul_rn(roi[3 - axis], scale);  // y2 or x2
    bin_taps<T>(lo, fmaxf(__fsub_rn(hi, lo), 1.0f), axis ? W : H, pool, bin, s_cell[axis][bin],
                s_w[axis][bin]);
  }
  __syncthreads();

  const int i = threadIdx.x / slab_threads;  // this thread's bin of the first axis
  const int slab = blockIdx.y / groups;
  const int grp = blockIdx.y - slab * groups;
  const int ch = (slab * slab_threads + threadIdx.x - i * slab_threads) * kVec;
  if (ch >= C) return;
  const int n = min(kVec, C - ch);

  const int fa = w_first ? 1 : 0;  // contracted first
  const int sa = 1 - fa;           // contracted second
  // Element strides of a cell step along the first and the second axis.
  const size_t stride_f = fa == 0 ? (size_t)W * C : (size_t)C;
  const size_t stride_s = fa == 0 ? (size_t)C : (size_t)W * C;
  size_t f_off[kSlots];
  float f_w[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    f_off[k] = (size_t)s_cell[fa][i][k] * stride_f;
    f_w[k] = s_w[fa][i][k];
  }
  const T* base = feat + ch;
  T* dst = out + (size_t)r * pool * pool * C + ch;

  // The last two distinct second-axis cells and their intermediates.
  int c_last = -1, c_prev = -1;
  float m_last[kVec], m_prev[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) m_last[e] = m_prev[e] = 0.0f;

  const int j_end = min(pool, (grp + 1) * per);
  for (int j = grp * per; j < j_end; ++j) {
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float wv = s_w[sa][j][k];
      if (wv == 0.0f) continue;
      const int c = s_cell[sa][j][k];
      if (c != c_last && c != c_prev) {
        // First contraction at cell c: its live taps' loads issued together.
        float v[kSlots][kVec];
        const T* col = base + (size_t)c * stride_s;
#pragma unroll
        for (int kk = 0; kk < kSlots; ++kk)
          if (f_w[kk] != 0.0f) load8<T, kVecIO>(col + f_off[kk], n, v[kk]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float m = 0.0f;
#pragma unroll
          for (int kk = 0; kk < kSlots; ++kk)
            if (f_w[kk] != 0.0f) m = __fadd_rn(m, __fmul_rn(f_w[kk], v[kk][e]));
          m_prev[e] = m_last[e];
          m_last[e] = round_to<T>(m);
        }
        c_prev = c_last;
        c_last = c;
      }
      const bool last = c == c_last;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(wv, last ? m_last[e] : m_prev[e]));
    }
    const int p = fa == 0 ? i : j;
    const int q = fa == 0 ? j : i;
    store8<T, kVecIO>(dst + ((size_t)p * pool + q) * C, n, acc);
  }
}

template <typename T>
int launch(const void* feat, const void* rois, int R, int H, int W, int C, float scale, int pool,
           int w_first, int slab_threads, int per, void* out, void* stream) {
  if (R <= 0 || H <= 0 || W <= 0 || C <= 0 || pool < 1 || pool > kMaxPool ||
      slab_threads < 1 || slab_threads > kMaxSlabThreads || per < 1 || per > pool)
    return (int)cudaErrorInvalidValue;
  const int groups = (pool + per - 1) / per;
  const long long slabs = ((long long)C + slab_threads * kVec - 1) / (slab_threads * kVec);
  if (slabs * groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(R, (unsigned)(slabs * groups));
  const bool vec = C % kVec == 0 && (uintptr_t)feat % 16 == 0 && (uintptr_t)out % 16 == 0;
  auto kernel = vec ? roi_align_kernel<T, true> : roi_align_kernel<T, false>;
  kernel<<<grid, pool * slab_threads, 0, (cudaStream_t)stream>>>(
      (const T*)feat, (const float*)rois, H, W, C, scale, pool, w_first, slab_threads, per,
      groups, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feat [H, W, C] (bf16 when is_bf16, else f32), rois [R, 4] f32 -> out
// [R, pool, pool, C] in feat's dtype. slab_threads (1..32) and per (second-
// axis bins per block, 1..pool) are the launch plan. Returns the
// cudaError_t of the launch.
int aznet_roi_align(const void* feat, const void* rois, int R, int H, int W, int C, float scale,
                    int pool, int w_first, int is_bf16, int slab_threads, int per, void* out,
                    void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(feat, rois, R, H, W, C, scale, pool, w_first, slab_threads, per,
                                 out, stream);
  return launch<float>(feat, rois, R, H, W, C, scale, pool, w_first, slab_threads, per, out,
                       stream);
}

}  // extern "C"

// One level of the zoom search after the head, for Hopper (sm_90a): the
// candidates' decode, the 5-way division and the frontier's top-k in one
// launch.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it inside its compiled search loop; eager PyTorch runs it as about 95
// separate small kernels a level (aznet_tpu_torch/search/propose.py::
// level_step, the plain version), and the host's time to dispatch them, not
// the card, bounded the search. This kernel is one launch a level, and the
// head's call before it stays a Python call.
//
// One block a call (one image, one level), 512 threads:
// 1. Frontier keys: child i of region i / 5 gets the priority sigmoid(zoom)
//    where its region is valid, passes ZOOM_THRESH and the child's shorter
//    side is at least MIN_SIZE, else NEG_INF; positions from 5R up to the
//    sort width are NEG_INF with zero boxes (the plain version's pad). The
//    key is the float32 total-order image of the priority in the high half
//    and ~i in the low half, so the keys are distinct and a descending sort
//    puts ties at the lower index first, as ops/topk.py::top_k orders them.
// 2. Candidates: for each (region, template) the anchor, the decode (dw, dh
//    clamped to BBOX_XFORM_CLIP before expf), the clip to the valid extent
//    and the score (sigmoid of the logit, NEG_INF for an invalid region),
//    written straight into the search's candidate buffer at this level's
//    rows. The head's outputs are read through their strides.
// 3. A bitonic sort of the keys in shared memory (the next power of two of
//    max(5R, next_cap) keys, at most kMaxKeys), then the first next_cap keys
//    become the next frontier: the child's box (recomputed, the same bits)
//    or zeros, and valid = priority > NEG_INF.
//
// Exactness: the plain version's every step, in its order, each rounded
// once: __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (never contracted into
// an FMA, and the file is built with --fmad=false and without fast math),
// expf for exp and for the sigmoid's 1 / (1 + exp(-x)) as PyTorch's float
// kernels compute them, and PyTorch's NaN rules for clamp and minimum.
// A card test (tests/test_torch_search_level.py) includes this file in a
// probe of its own and holds sigmoid_f32 and expf against torch.sigmoid and
// torch.exp over every float32.
//
// What bounds it: latency. At R = 128 and K = 11 it reads about 40 KB and
// writes about 25 KB; the block's 105 sort stages of __syncthreads at a sort
// width of 1024 keys are most of its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTemplates = 16;
constexpr int kDivisions = 5;
constexpr int kMaxKeys = 16384;  // 128 KB of keys in shared memory
constexpr size_t kStaticSmem = 48 * 1024;

struct LevelArgs {
  const float* zoom;  // [R], stride zoom_s
  long long zoom_s;
  const float* adj;  // [R, K] logits
  long long adj_sr, adj_sk;
  const float* delta;  // [R, K, 4]
  long long delta_sr, delta_sk, delta_sc;
  const float4* f_boxes;          // [R, 4], contiguous
  const unsigned char* f_valid;   // [R]
  const float* extent;            // the valid (h, w)
  float4* cand_boxes;             // this level's first candidate row
  float* cand_scores;
  float4* next_boxes;             // [next_cap, 4]
  unsigned char* next_valid;      // [next_cap]
  int r, k, next_cap, width;
  float zoom_thresh, min_size, clip, offset, neg_inf;
  float templates[kMaxTemplates * 4];
  float divisions[kDivisions * 4];
};

__device__ __forceinline__ float sigmoid_f32(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_f32(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float minimum_f32(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// ops/boxes.py::_clip: torch.minimum(v.clamp(min=0), hi).
__device__ __forceinline__ float clip_f32(float v, float hi) {
  return minimum_f32(isnan(v) ? v : fmaxf(v, 0.0f), hi);
}

// search/templates.py::_apply_normalized for one box and one table row.
__device__ __forceinline__ float4 apply_normalized(float4 b, const float* t, float offset) {
  const float w = __fadd_rn(__fsub_rn(b.z, b.x), offset);
  const float h = __fadd_rn(__fsub_rn(b.w, b.y), offset);
  return make_float4(__fadd_rn(b.x, __fmul_rn(t[0], w)), __fadd_rn(b.y, __fmul_rn(t[1], h)),
                     __fsub_rn(__fadd_rn(b.x, __fmul_rn(t[2], w)), offset),
                     __fsub_rn(__fadd_rn(b.y, __fmul_rn(t[3], h)), offset));
}

// ops/boxes.py::bbox_transform_inv for one anchor and its (dx, dy, dw, dh).
__device__ __forceinline__ float4 decode(float4 a, float4 d, float clip, float offset) {
  const float w = __fadd_rn(__fsub_rn(a.z, a.x), offset);
  const float h = __fadd_rn(__fsub_rn(a.w, a.y), offset);
  const float cx = __fadd_rn(a.x, __fmul_rn(0.5f, w));
  const float cy = __fadd_rn(a.y, __fmul_rn(0.5f, h));
  const float pcx = __fadd_rn(__fmul_rn(d.x, w), cx);
  const float pcy = __fadd_rn(__fmul_rn(d.y, h), cy);
  const float half_w = __fmul_rn(0.5f, __fmul_rn(expf(clamp_f32(d.z, -clip, clip)), w));
  const float half_h = __fmul_rn(0.5f, __fmul_rn(expf(clamp_f32(d.w, -clip, clip)), h));
  return make_float4(__fsub_rn(pcx, half_w), __fsub_rn(pcy, half_h), __fadd_rn(pcx, half_w),
                     __fadd_rn(pcy, half_h));
}

// Ascending in the float32 total order (ops/topk.py::_total_order_key).
__device__ __forceinline__ uint32_t order_key(float p) {
  const uint32_t u = __float_as_uint(p);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
search_level_kernel(const __grid_constant__ LevelArgs a) {
  extern __shared__ unsigned long long keys[];
  const int tid = threadIdx.x;
  const int children = a.r * kDivisions;

  // 1. Frontier keys.
  for (int i = tid; i < a.width; i += kThreads) {
    float p = a.neg_inf;
    if (i < children) {
      const int reg = i / kDivisions;
      const float zp = sigmoid_f32(a.zoom[reg * a.zoom_s]);
      if (a.f_valid[reg] && zp > a.zoom_thresh) {
        const float4 c = apply_normalized(a.f_boxes[reg],
                                          a.divisions + (i - reg * kDivisions) * 4, a.offset);
        const float cw = __fadd_rn(__fsub_rn(c.z, c.x), a.offset);
        const float ch = __fadd_rn(__fsub_rn(c.w, c.y), a.offset);
        if (minimum_f32(cw, ch) >= a.min_size) p = zp;
      }
    }
    keys[i] = (static_cast<unsigned long long>(order_key(p)) << 32) | (0xFFFFFFFFu - i);
  }

  // 2. Candidates, while the keys settle.
  const float hi_x = __fsub_rn(a.extent[1], a.offset);
  const float hi_y = __fsub_rn(a.extent[0], a.offset);
  for (int j = tid; j < a.r * a.k; j += kThreads) {
    const int reg = j / a.k;
    const int t = j - reg * a.k;
    const float* d = a.delta + reg * a.delta_sr + t * a.delta_sk;
    const float4 delta = make_float4(d[0], d[a.delta_sc], d[2 * a.delta_sc], d[3 * a.delta_sc]);
    const float4 b = decode(apply_normalized(a.f_boxes[reg], a.templates + t * 4, a.offset),
                            delta, a.clip, a.offset);
    a.cand_boxes[j] = make_float4(clip_f32(b.x, hi_x), clip_f32(b.y, hi_y),
                                  clip_f32(b.z, hi_x), clip_f32(b.w, hi_y));
    const float s = sigmoid_f32(a.adj[reg * a.adj_sr + t * a.adj_sk]);
    a.cand_scores[j] = a.f_valid[reg] ? s : a.neg_inf;
  }
  __syncthreads();

  // 3. Bitonic sort, descending, then the first next_cap keys.
  for (int size = 2; size <= a.width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (a.width >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long x = keys[i], y = keys[i + stride];
        if ((x < y) == ((i & size) == 0)) {
          keys[i] = y;
          keys[i + stride] = x;
        }
      }
      __syncthreads();
    }
  }
  const uint32_t invalid = order_key(a.neg_inf);
  for (int j = tid; j < a.next_cap; j += kThreads) {
    const unsigned long long key = keys[j];
    const int i = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < children) {
      const int reg = i / kDivisions;
      c = apply_normalized(a.f_boxes[reg], a.divisions + (i - reg * kDivisions) * 4, a.offset);
    }
    a.next_boxes[j] = c;
    a.next_valid[j] = static_cast<uint32_t>(key >> 32) > invalid;
  }
}

}  // namespace

extern "C" {

// One level (see the top of the file). templates [k, 4] and divisions [5, 4]
// are host arrays, passed to the kernel by value; cand_boxes / cand_scores
// point at this level's first candidate row. Returns a cudaError_t.
int aznet_search_level(const float* zoom, long long zoom_s, const float* adj, long long adj_sr,
                       long long adj_sk, const float* delta, long long delta_sr,
                       long long delta_sk, long long delta_sc, const float* f_boxes,
                       const unsigned char* f_valid, const float* extent,
                       const float* templates, int k, const float* divisions, int r,
                       int next_cap, float zoom_thresh, float min_size, float clip,
                       float offset, float neg_inf, float* cand_boxes, float* cand_scores,
                       float* next_boxes, unsigned char* next_valid, cudaStream_t stream) {
  if (r < 1 || k < 1 || k > kMaxTemplates || next_cap < 1) return cudaErrorInvalidValue;
  const int need = r * kDivisions > next_cap ? r * kDivisions : next_cap;
  int width = 1;
  while (width < need) width <<= 1;
  if (width > kMaxKeys) return cudaErrorInvalidValue;
  LevelArgs a;
  a.zoom = zoom;
  a.zoom_s = zoom_s;
  a.adj = adj;
  a.adj_sr = adj_sr;
  a.adj_sk = adj_sk;
  a.delta = delta;
  a.delta_sr = delta_sr;
  a.delta_sk = delta_sk;
  a.delta_sc = delta_sc;
  a.f_boxes = reinterpret_cast<const float4*>(f_boxes);
  a.f_valid = f_valid;
  a.extent = extent;
  a.cand_boxes = reinterpret_cast<float4*>(cand_boxes);
  a.cand_scores = cand_scores;
  a.next_boxes = reinterpret_cast<float4*>(next_boxes);
  a.next_valid = next_valid;
  a.r = r;
  a.k = k;
  a.next_cap = next_cap;
  a.width = width;
  a.zoom_thresh = zoom_thresh;
  a.min_size = min_size;
  a.clip = clip;
  a.offset = offset;
  a.neg_inf = neg_inf;
  std::memset(a.templates, 0, sizeof(a.templates));
  std::memcpy(a.templates, templates, sizeof(float) * 4 * k);
  std::memcpy(a.divisions, divisions, sizeof(a.divisions));
  const size_t smem = sizeof(unsigned long long) * width;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        search_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  search_level_kernel<<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"

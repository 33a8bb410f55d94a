// The zoom search's bookkeeping around its levels, for Hopper (sm_90a): the
// seed frontier before the first head call, and the selection after the last
// level (the CAND_BUF cap before NMS, the top NUM_PROPOSALS after it).
//
// Replaces no TPU kernel. The JAX package leaves this to XLA, which fuses it
// into its compiled search; eager PyTorch ran it as about 60 small kernels an
// image (aznet_tpu_torch/search/propose.py: seed_plain, which calls
// init_frontier, and select_plain, which calls ops/nms.py::nms_topk), and the
// host's time to dispatch them, not the card, was the cost. Three kernels, one
// launch each a search:
//
// 1. search_seed_kernel: the seed frontier (the whole image and SEED_LEVELS
//    of its 5-way divisions, padded to the first level's rows) and its valid
//    flags, the level kernel's extent [2] (h, w) as float32, and the
//    candidate buffer's fill (zero boxes, NEG_INF scores). A seed row walks
//    from the whole image down its base-5 digits, most significant first,
//    which is the order in which init_frontier concatenates each level's
//    divisions. The extents arrive by pointer (int32 or float32 on the
//    card) or by value.
// 2. search_cap_kernel: where the buffer holds more than CAND_BUF rows, its
//    top CAND_BUF by score in ops/topk.py::top_k's order (the float32 total
//    order descending, ties to the lower index), their boxes gathered; else
//    the rows in their order. For each, final = score >= CONF_THRESH ? score
//    : NEG_INF and live = final > NEG_INF: the inputs of the NMS kernel.
// 3. search_topk_kernel: after NMS (csrc/nms.cu, unchanged, in its own
//    folded-key order), the kept rows ranked by final in the total order
//    descending, ties to the lower index, the first k written as boxes,
//    scores and valid flags, the rest of the k rows zero: nms_topk's output.
//
// Both selections rank by counting, spread over the grid: a row's place is
// the number of rows whose 64-bit key (the score's total-order image above
// ~index) is larger, so places are distinct and no sort width bounds the row
// count. A block ranks 64 rows, 4 a thread against a sixteenth of each chunk
// of keys staged in shared memory, the 16 partial counts of a row summed by
// shuffles. What bounds them: the rows x rows compares (56 M at ResNet-50's
// 7480 candidates), a few tens of microseconds of the card beside the NMS
// kernel's; the host's time to launch them is what the search pays.
//
// Exactness: the seed's boxes are init_frontier's float32 steps in its order,
// each rounded once (__fadd_rn / __fsub_rn / __fmul_rn, never contracted; the
// file is built with --fmad=false and without fast math); the rest moves or
// compares bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                // rows a block ranks
constexpr int kParts = 16;               // threads sharing a group of rows
constexpr int kRowsPerThread = kRows * kParts / kThreads;  // 4
constexpr int kChunk = 2048;             // keys in shared memory at a time (16 KB)
constexpr int kDivisions = 5;
constexpr int kFillBlocks = 132;         // the seed's grid at most: about one a SM

// How an extent arrives (search_select_kernel.py::EXTENT_KINDS).
enum ExtentKind { kByValue = 0, kF32 = 1, kI32 = 2 };

struct SeedArgs {
  const void* h_ptr;
  const void* w_ptr;
  int h_kind, w_kind;
  float h_value, w_value;
  float divisions[kDivisions * 4];
  int n_seed;  // 1 + 5 + ... + 5^SEED_LEVELS
  int cap;     // frontier rows
  long long total;  // candidate rows
  float offset, neg_inf;
  float* extent;
  float4* f_boxes;
  unsigned char* f_valid;
  float4* cand_boxes;
  float* cand_scores;
};

// As torch casts to float32: round to nearest.
__device__ __forceinline__ float read_extent(const void* p, int kind, float value) {
  if (kind == kF32) return *static_cast<const float*>(p);
  if (kind == kI32) return __int2float_rn(*static_cast<const int*>(p));
  return value;
}

// search/templates.py::_apply_normalized for one box and one table row.
__device__ __forceinline__ float4 apply_normalized(float4 b, const float* t, float offset) {
  const float w = __fadd_rn(__fsub_rn(b.z, b.x), offset);
  const float h = __fadd_rn(__fsub_rn(b.w, b.y), offset);
  return make_float4(__fadd_rn(b.x, __fmul_rn(t[0], w)), __fadd_rn(b.y, __fmul_rn(t[1], h)),
                     __fsub_rn(__fadd_rn(b.x, __fmul_rn(t[2], w)), offset),
                     __fsub_rn(__fadd_rn(b.y, __fmul_rn(t[3], h)), offset));
}

__global__ void __launch_bounds__(kThreads) search_seed_kernel(const __grid_constant__ SeedArgs a) {
  const float h = read_extent(a.h_ptr, a.h_kind, a.h_value);
  const float w = read_extent(a.w_ptr, a.w_kind, a.w_value);
  const long long n = a.total > a.cap ? a.total : a.cap;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += step) {
    if (i < a.total) {
      a.cand_boxes[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a.cand_scores[i] = a.neg_inf;
    }
    if (i < a.cap) {
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int row = static_cast<int>(i);
      if (row < a.n_seed) {
        int first = 0, count = 1;  // the row's level: its first row and width
        while (row >= first + count) {
          first += count;
          count *= kDivisions;
        }
        const int j = row - first;
        b = make_float4(0.0f, 0.0f, __fsub_rn(w, a.offset), __fsub_rn(h, a.offset));
        for (count /= kDivisions; count > 0; count /= kDivisions)
          b = apply_normalized(b, a.divisions + 4 * ((j / count) % kDivisions), a.offset);
      }
      a.f_boxes[i] = b;
      a.f_valid[i] = row < a.n_seed;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.extent[0] = h;
    a.extent[1] = w;
  }
}

// Ascending in the float32 total order (ops/topk.py::_total_order_key).
__device__ __forceinline__ uint32_t order_key(float p) {
  const uint32_t u = __float_as_uint(p);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Larger for a higher score, and for the lower index among equal scores.
__device__ __forceinline__ unsigned long long rank_key(float s, int j) {
  return (static_cast<unsigned long long>(order_key(s)) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(j));
}

// Places of this block's rows among n: out[r] = the number of j < n with
// key(j) > mine[r], for the thread's kRowsPerThread rows (row group tid /
// kParts). load(j) gives row j's key and is called for every j once per
// block, by one thread.
template <typename Load>
__device__ __forceinline__ void count_above(int n, const unsigned long long* mine, int* out,
                                            Load load) {
  __shared__ unsigned long long keys[kChunk];
  const int tid = threadIdx.x, part = tid % kParts;
  int cnt[kRowsPerThread] = {};
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = n - c0 < kChunk ? n - c0 : kChunk;
    __syncthreads();
    for (int j = tid; j < len; j += kThreads) keys[j] = load(c0 + j);
    __syncthreads();
    for (int j = part; j < len; j += kParts) {
      const unsigned long long k = keys[j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) cnt[r] += k > mine[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int m = kParts / 2; m > 0; m >>= 1) cnt[r] += __shfl_xor_sync(0xFFFFFFFFu, cnt[r], m);
    out[r] = cnt[r];
  }
}

struct CapArgs {
  const float4* boxes;  // [n]
  const float* scores;  // [n]
  int n, cap;           // cap < n: rank; else keep the order
  float thresh, neg_inf;
  float4* out_boxes;    // [cap] where ranked
  float* out_final;     // [min(n, cap)]
  unsigned char* out_live;
};

__global__ void __launch_bounds__(kThreads) search_cap_kernel(const __grid_constant__ CapArgs a) {
  if (a.n <= a.cap) {  // no cap: the rows in their order
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n; i += gridDim.x * kThreads) {
      const float s = a.scores[i];
      const float f = s >= a.thresh ? s : a.neg_inf;
      a.out_final[i] = f;
      a.out_live[i] = f > a.neg_inf;
    }
    return;
  }
  const int row0 = blockIdx.x * kRows + (threadIdx.x / kParts) * kRowsPerThread;
  unsigned long long mine[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    mine[r] = row0 + r < a.n ? rank_key(a.scores[row0 + r], row0 + r) : ~0ull;
  int place[kRowsPerThread];
  count_above(a.n, mine, place, [&](int j) { return rank_key(a.scores[j], j); });
  const int part = threadIdx.x % kParts;
  if (part < kRowsPerThread) {
    const int i = row0 + part;
    const int p = place[part];
    if (i < a.n && p < a.cap) {
      const float s = a.scores[i];
      const float f = s >= a.thresh ? s : a.neg_inf;
      a.out_boxes[p] = a.boxes[i];
      a.out_final[p] = f;
      a.out_live[p] = f > a.neg_inf;
    }
  }
}

struct TopkArgs {
  const unsigned char* keep;  // [n], NMS's keep mask: kept rows are live
  const float* final_scores;  // [n]
  const float4* boxes;        // [n]
  int n, k;
  float4* out_boxes;          // [k]
  float* out_scores;
  unsigned char* out_valid;
};

__global__ void __launch_bounds__(kThreads) search_topk_kernel(const __grid_constant__ TopkArgs a) {
  __shared__ int kept_total;
  if (threadIdx.x == 0) kept_total = 0;
  const int row0 = blockIdx.x * kRows + (threadIdx.x / kParts) * kRowsPerThread;
  unsigned long long mine[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r;
    mine[r] = i < a.n && a.keep[i] ? rank_key(a.final_scores[i], i) : ~0ull;
  }
  int kept = 0;  // rows this thread loaded that are kept
  int place[kRowsPerThread];
  count_above(a.n, mine, place, [&](int j) {
    const bool on = a.keep[j] != 0;
    kept += on;
    return on ? rank_key(a.final_scores[j], j) : 0ull;  // below every kept row's key
  });
  for (int m = 16; m > 0; m >>= 1) kept += __shfl_xor_sync(0xFFFFFFFFu, kept, m);
  if (threadIdx.x % 32 == 0) atomicAdd(&kept_total, kept);
  const int part = threadIdx.x % kParts;
  if (part < kRowsPerThread) {
    const int i = row0 + part;
    const int p = place[part];
    if (i < a.n && a.keep[i] && p < a.k) {
      a.out_boxes[p] = a.boxes[i];
      a.out_scores[p] = a.final_scores[i];
      a.out_valid[p] = 1;
    }
  }
  __syncthreads();
  // The rows past the kept ones: zeros, as nms_topk pads them.
  for (int p = kept_total + blockIdx.x * kThreads + threadIdx.x; p < a.k;
       p += gridDim.x * kThreads) {
    a.out_boxes[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a.out_scores[p] = 0.0f;
    a.out_valid[p] = 0;
  }
}

int blocks_of(long long rows, int per_block) {
  return static_cast<int>((rows + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// The seed (kernel 1 above). Each extent is a card pointer of kind h_kind /
// w_kind (ExtentKind) or, for kind 0, the value; divisions [5, 4] is a host
// array, passed to the kernel by value. Writes extent [2], f_boxes [cap, 4],
// f_valid [cap], cand_boxes [total, 4] and cand_scores [total]. Returns a
// cudaError_t.
int aznet_search_seed(const void* h_ptr, int h_kind, float h_value, const void* w_ptr,
                      int w_kind, float w_value, const float* divisions, int n_seed, int cap,
                      long long total, float offset, float neg_inf, float* extent,
                      float* f_boxes, unsigned char* f_valid, float* cand_boxes,
                      float* cand_scores, cudaStream_t stream) {
  if (cap < 1 || n_seed < 1 || n_seed > cap || total < 0 || h_kind < kByValue ||
      h_kind > kI32 || w_kind < kByValue || w_kind > kI32 || (h_kind && !h_ptr) ||
      (w_kind && !w_ptr))
    return cudaErrorInvalidValue;
  SeedArgs a;
  a.h_ptr = h_ptr;
  a.w_ptr = w_ptr;
  a.h_kind = h_kind;
  a.w_kind = w_kind;
  a.h_value = h_value;
  a.w_value = w_value;
  std::memcpy(a.divisions, divisions, sizeof(a.divisions));
  a.n_seed = n_seed;
  a.cap = cap;
  a.total = total;
  a.offset = offset;
  a.neg_inf = neg_inf;
  a.extent = extent;
  a.f_boxes = reinterpret_cast<float4*>(f_boxes);
  a.f_valid = f_valid;
  a.cand_boxes = reinterpret_cast<float4*>(cand_boxes);
  a.cand_scores = cand_scores;
  int blocks = blocks_of(total > cap ? total : cap, kThreads);
  if (blocks > kFillBlocks) blocks = kFillBlocks;
  search_seed_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The cap (kernel 2). boxes [n, 4] 16-byte aligned, scores [n]; for n > cap
// writes out_boxes [cap, 4], out_final [cap], out_live [cap], else
// out_final [n] and out_live [n] (out_boxes unused). Returns a cudaError_t.
int aznet_search_cap(const float* boxes, const float* scores, int n, int cap, float thresh,
                     float neg_inf, float* out_boxes, float* out_final, unsigned char* out_live,
                     cudaStream_t stream) {
  if (n < 1 || cap < 1) return cudaErrorInvalidValue;
  const CapArgs a{reinterpret_cast<const float4*>(boxes), scores, n, cap, thresh, neg_inf,
                  reinterpret_cast<float4*>(out_boxes), out_final, out_live};
  const int blocks = blocks_of(n, n > cap ? kRows : kThreads);
  search_cap_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The top k after NMS (kernel 3). keep [n] u8, final_scores [n], boxes [n, 4]
// 16-byte aligned; writes out_boxes [k, 4], out_scores [k], out_valid [k].
// Returns a cudaError_t.
int aznet_search_topk(const unsigned char* keep, const float* final_scores, const float* boxes,
                      int n, int k, float* out_boxes, float* out_scores,
                      unsigned char* out_valid, cudaStream_t stream) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  const TopkArgs a{keep, final_scores, reinterpret_cast<const float4*>(boxes), n, k,
                   reinterpret_cast<float4*>(out_boxes), out_scores, out_valid};
  const int blocks = blocks_of(n, kRows);
  search_topk_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"

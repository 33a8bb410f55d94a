// Tiled IoU matrix for Hopper (sm_90a): out[i, j] = IoU(boxes[i], query[j]).
//
// Replaces aznet_tpu/ops/pallas/iou_kernel.py::bbox_overlaps_pallas (body
// _iou_tile_kernel). Same function, bit for bit with the plain PyTorch
// version (aznet_tpu_torch/ops/iou.py::bbox_overlaps), for finite inputs:
//   iw    = (min(x2_i, x2_j) - max(x1_i, x1_j)) + offset, ih the same in y;
//   inter = max(iw, 0) * max(ih, 0);
//   area  = ((x2 - x1) + offset) * ((y2 - y1) + offset) for each box;
//   union = (area_i + area_j) - inter;
//   out   = union > 0 ? inter / union : 0.
// Every f32 step is spelled __fsub_rn / __fadd_rn / __fmul_rn / __fdiv_rn
// and the file is compiled with --fmad=false and without fast math, so no
// step is contracted into an FMA and the division is IEEE. Where iw <= 0 or
// ih <= 0 (disjoint boxes: most pairs) inter is +0, and +0 / union is +0
// for union > 0, so the kernel writes +0 there without the product, the
// union or the division: the same bits.
//
// What bounds it on the card: the N*K*4 bytes of output (4096 x 4096: 67.1
// MB, 20.07 us at 3.35 TB/s). The instructions issued per pair come next,
// so the design spends few on anything but the pair's own arithmetic:
// - The matrix is cut into column tiles of 128 boxes, and each tile into its
//   N rows: tiles * N row slices, column tile major. Each warp of the grid
//   takes an even, contiguous share of the slices (the host splits them:
//   shares differ by at most one row). While its share stays in one column
//   tile, each lane keeps 4 column boxes and their areas in registers and
//   walks the rows; a row box is one float4 that all 32 lanes read from one
//   address, asked for one row ahead (the first before the column boxes, so
//   a small matrix waits for one load, not two). One row a trip keeps the
//   loop's code small: a small matrix runs it once, from a cold instruction
//   cache.
// - Vector body (K % 4 == 0): lane l owns columns 4l .. 4l+3 of the tile and
//   writes a row's 4 IoUs with one 16-byte streaming store (the output is
//   written once and never read back), 512 contiguous bytes a warp.
//   Element-wise body (K % 4 != 0: rows do not start on 16 bytes): lane l
//   owns columns l, l+32, l+64, l+96 and writes 4 4-byte stores, each 128
//   contiguous bytes across the warp.
// - Persistent warps: blocks of 8 warps, 4 an SM. A matrix whose slices
//   all fit in those warps at once takes one 32-thread block a slice on a
//   (row, tile) grid instead, so its warps find their slice without a
//   division: a small matrix waits on the prologue, not on bytes. The host
//   picks the grid and the shares (ops/cuda/iou_kernel.py::launch_plan, which
//   a CPU test walks); this entry checks that they cover the matrix. N and K
//   have no cap: indices are 64-bit where N * K comes within two tiles of
//   2^31, else 32-bit (on an H100 small matrices finish 0.05-0.15 us sooner).

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kLanes = 32;
constexpr int kPerLane = 4;                   // column boxes a lane keeps
constexpr int kTileCols = kLanes * kPerLane;  // column boxes of a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;

__device__ __forceinline__ float box_area(float4 b, float offset) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), offset),
                   __fadd_rn(__fsub_rn(b.w, b.y), offset));
}

__device__ __forceinline__ float pair_iou(float4 r, float r_area, float4 c, float c_area,
                                          float offset) {
  const float iw = __fadd_rn(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), offset);
  const float ih = __fadd_rn(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), offset);
  float iou = 0.0f;
  if (iw > 0.0f && ih > 0.0f) {
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(r_area, c_area), inter);
    if (uni > 0.0f) iou = __fdiv_rn(inter, uni);
  }
  return iou;
}

template <bool kVec, typename Index>
__global__ void __launch_bounds__(kThreads, 4)
iou_kernel(const float4* __restrict__ boxes, const float4* __restrict__ query, Index n, Index k,
           float offset, Index share, Index extra, float* __restrict__ out) {
  constexpr int kStep = kVec ? 1 : kLanes;  // between a lane's columns
  const int lane = threadIdx.x % kLanes;
  // This warp's slices: `left` of them from row r0 of column tile `tile`.
  Index left, tile, r0;
  if (share == 0) {  // one block a slice: (row, tile) = (blockIdx.x, blockIdx.y)
    left = 1;
    tile = blockIdx.y;
    r0 = blockIdx.x;
  } else {  // from slice f; the first `extra` warps take share + 1
    const Index warp = (Index)blockIdx.x * kWarps + threadIdx.x / kLanes;
    left = share + (warp < extra);
    const Index f = warp * share + (warp < extra ? warp : extra);
    tile = f / n;
    r0 = f - tile * n;
  }
  for (; left > 0; ++tile, r0 = 0) {
    const int rows = (int)(left < n - r0 ? left : n - r0);
    left -= rows;
    const float4* row = boxes + r0;
    float4 next = __ldg(row);
    const Index col = tile * kTileCols + (kVec ? lane * kPerLane : lane);
    const Index rem = k - col;  // columns from this lane's first to K
    float4 c[kPerLane];
    float c_area[kPerLane];
    bool live[kPerLane];
#pragma unroll
    for (int s = 0; s < kPerLane; ++s) {
      live[s] = s * kStep < rem;
      c[s] = __ldg(live[s] ? query + col + s * kStep : query);
      c_area[s] = box_area(c[s], offset);
    }
    float* dst = out + r0 * k + col;
#pragma unroll 1
    for (int r = 0; r < rows; ++r, dst += k) {
      const float4 rb = next;
      if (r + 1 < rows) next = __ldg(row + r + 1);
      const float r_area = box_area(rb, offset);
      float v[kPerLane];
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) v[s] = pair_iou(rb, r_area, c[s], c_area[s], offset);
      if constexpr (kVec) {
        if (live[0]) __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int s = 0; s < kPerLane; ++s)
          if (live[s]) __stcs(dst + s * kLanes, v[s]);
      }
    }
  }
}

template <typename Index>
int launch(const float4* boxes, const float4* query, Index n, Index k, float offset, int blocks,
           Index share, Index extra, float* out, cudaStream_t stream) {
  void (*kernel)(const float4*, const float4*, Index, Index, float, Index, Index, float*) =
      k % 4 == 0 ? iou_kernel<true, Index> : iou_kernel<false, Index>;
  const Index tiles = (k + kTileCols - 1) / kTileCols;
  const Index warps = (Index)blocks * kWarps;
  if (share == 0) {  // one 32-thread block a slice
    if (n != blocks / tiles || blocks % tiles || tiles > 65535) return cudaErrorInvalidValue;
    kernel<<<dim3(n, tiles), kLanes, 0, stream>>>(boxes, query, n, k, offset, 0, 0, out);
  } else {  // share * warps + extra == n * tiles slices; a share's rows fit an int
    if (n > std::numeric_limits<Index>::max() / tiles || extra >= warps ||
        share >= INT32_MAX || share != (n * tiles - extra) / warps ||
        (n * tiles - extra) % warps) {
      return cudaErrorInvalidValue;
    }
    kernel<<<blocks, kThreads, 0, stream>>>(boxes, query, n, k, offset, share, extra, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// IoU matrix. boxes [n, 4] and query [k, 4] f32, contiguous; out [n, k] f32;
// all three 16-byte aligned. The launch is what the host planned
// (ops/cuda/iou_kernel.py::launch_plan): share == 0, one 32-thread block per
// (row, tile) slice, `blocks` = n * tiles of them; else `blocks` blocks of
// 256 threads whose warps take `share` slices each, the first `extra` one
// more. 64-bit indices when `wide`, which n * k > 2^31 - 1 - 2 * 128 requires.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int aznet_iou_launch(const void* boxes, const void* query, long long n, long long k,
                     float offset, int blocks, long long share, long long extra, int wide,
                     void* out, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(boxes) |
                         reinterpret_cast<uintptr_t>(query) | reinterpret_cast<uintptr_t>(out);
  if (n <= 0 || k <= 0 || blocks <= 0 || share < 0 || extra < 0 || (addr & 15) ||
      k > INT64_MAX - kTileCols || (!wide && n > (INT32_MAX - 2 * kTileCols) / k)) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* b = (const float4*)boxes;
  const float4* q = (const float4*)query;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? launch<int64_t>(b, q, n, k, offset, blocks, share, extra, (float*)out, s)
                    : launch<int32_t>(b, q, n, k, offset, blocks, (int32_t)share,
                                      (int32_t)extra, (float*)out, s));
}

}  // extern "C"

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
// step is contracted into an FMA and the division is IEEE.
//
// Design: one block of 256 threads per tile of 32 row boxes x 128 column
// boxes. The block stages the tile's boxes and their areas in shared memory
// (each area computed once per tile, not once per pair), then thread t
// computes column t % 128 of rows t / 128, t / 128 + 2, ...: a warp writes
// 32 consecutive floats of one output row per store (128 coalesced bytes).
//
// What bounds it on the card: the output. It writes N*K*4 bytes and reads
// (N + K) * 16; its ~15 f32 operations per pair are a few times less than
// the store time at 3.35 TB/s (4096 x 4096: 67.1 MB, about 20 us).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 128;   // column boxes per tile (one per thread of a row pass)
constexpr int kRows = 32;    // row boxes per tile
constexpr int kThreads = 256;
constexpr int kRowPasses = kThreads / kCols;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2,
                                          float offset) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), offset),
                   __fadd_rn(__fsub_rn(y2, y1), offset));
}

__global__ void __launch_bounds__(kThreads)
iou_kernel(const float* __restrict__ boxes, const float* __restrict__ query,
           int n, int k, float offset, float* __restrict__ out) {
  __shared__ float4 col_box[kCols];
  __shared__ float col_area[kCols];
  __shared__ float4 row_box[kRows];
  __shared__ float row_area[kRows];

  const int t = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  if (t < kCols) {
    const int j = col0 + t;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < k) {
      const float* q = query + (size_t)j * 4;
      c = make_float4(q[0], q[1], q[2], q[3]);
    }
    col_box[t] = c;
    col_area[t] = box_area(c.x, c.y, c.z, c.w, offset);
  } else if (t < kCols + kRows) {
    const int i = row0 + (t - kCols);
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
      const float* b = boxes + (size_t)i * 4;
      r = make_float4(b[0], b[1], b[2], b[3]);
    }
    row_box[t - kCols] = r;
    row_area[t - kCols] = box_area(r.x, r.y, r.z, r.w, offset);
  }
  __syncthreads();

  const int c = t % kCols;
  const int j = col0 + c;
  if (j >= k) return;
  const float4 cb = col_box[c];
  const float ca = col_area[c];
  for (int r = t / kCols; r < kRows && row0 + r < n; r += kRowPasses) {
    const float4 rb = row_box[r];
    const float iw = __fadd_rn(__fsub_rn(fminf(rb.z, cb.z), fmaxf(rb.x, cb.x)), offset);
    const float ih = __fadd_rn(__fsub_rn(fminf(rb.w, cb.w), fmaxf(rb.y, cb.y)), offset);
    const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
    const float uni = __fsub_rn(__fadd_rn(row_area[r], ca), inter);
    out[(size_t)(row0 + r) * k + j] = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  }
}

}  // namespace

extern "C" {

// IoU matrix. boxes [n, 4] f32, query [k, 4] f32, contiguous; out [n, k] f32.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int aznet_iou_launch(const void* boxes, const void* query, int n, int k,
                     float offset, void* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((k + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  iou_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)query, n, k, offset, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

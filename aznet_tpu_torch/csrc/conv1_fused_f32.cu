// VGG-16 conv1_2 + bias + ReLU + 2x2/2 max-pool (pool1) fused, float32, for
// Hopper (sm_90a): y [B, H, W, C] f32 (conv1_1's ReLU output, NHWC) ->
// out [B, H/2, W/2, Co] f32.
//
// Replaces aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool (its
// _kernel / _fused_impl) where the Pallas kernel runs in float32 (dt =
// y.dtype there: f32 operands, f32 sums, f32 bias). The bf16 wgmma kernel
// (conv1_fused.cu) cannot serve it: float32 in this port is true float32,
// never TF32 (utils/precision.py), so this kernel multiplies on the CUDA
// cores with __fmaf_rn.
//
// What bounds it on this card: at VGG-16's conv1_2 (C = Co = 64, b = 2,
// 608 x 800) 71.7 GFLOP on the f32 CUDA cores (1.070 ms at 67 TFLOP/s)
// against 311 MB of device memory (0.093 ms at 3.35 TB/s): operations.
//
// Computation: a direct convolution on the CUDA cores, simple by design.
//   * Persistent blocks (as many as fit at once: one an SM at C = 64) walk
//     tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...; a tile is one row
//     pair (one pool window high) x 64 columns of one image x all Co.
//   * Shared memory: the whole weight tensor, loaded once per block, in the
//     layout ops/conv1_fused.py::kernel_layout_f32 packs, [9][C][64] (tap,
//     input channel, output channel zero-padded to 64), and the tile's halo
//     patch, 4 rows x 66 columns x C, stored a channel plane at a time with
//     even and odd columns apart (plane pitch 265 floats, so that the 4 x 16
//     B the fill writes per pixel spread over the banks). Zeros outside the
//     image are the SAME padding. At C = 64: 147,456 + 67,840 bytes.
//   * Thread (warp w, lane l): output channels 8w..8w+7 and pool window l of
//     the tile, i.e. its four pre-pool pixels, so 32 accumulators. Per tap
//     and input channel: four conflict-free patch loads (lane l reads word l
//     or l + 1 of a plane row), two broadcast 16-byte weight loads, 32 FMAs.
//   * Summation order, the plain version's: per tap a partial sum over the
//     input channels in order, then the nine partials added in tap order
//     (ops/conv1_fused.py::conv1_2_pool_reference sums nine f32 tap matmuls).
//     The order inside a tap's matmul is cuBLAS's there, so the two agree to
//     float32 rounding, not bit for bit.
//   * Epilogue (the build has --fmad=false): max of the four pixels, + bias
//     in f32 (__fadd_rn; rounding is monotone, so adding after the max
//     equals adding before it), ReLU, two 16-byte stores. W is even, so a
//     pool window never straddles the ragged last tile of a row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;           // 8 warps; warp w: output channels 8w..8w+7
constexpr int kCols = 64;               // pre-pool columns per tile; lane l: pool window l
constexpr int kInCols = kCols + 2;      // halo patch columns
constexpr int kHalf = kInCols / 2;      // 33 columns of one parity
constexpr int kPlane = 4 * 2 * kHalf + 1;  // 265 floats: one channel's 4 rows x 2 parities x 33
constexpr int kCoPad = 64;              // output channels of the weight layout
constexpr int kMaxC = 64;               // largest C and Co

size_t smem_bytes(int C) { return (size_t)C * (9 * kCoPad + kPlane) * sizeof(float); }

__global__ void __launch_bounds__(kThreads, 1)
    conv1_fused_f32_kernel(const float* __restrict__ y, const float* __restrict__ w,
                           const float* __restrict__ bias, int H, int W, int C, int Co,
                           int tiles, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [9][C][64]
  float* ys = ws + 9 * C * kCoPad;              // [C][row 4][parity 2][33], plane pitch kPlane
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int co0 = 8 * warp;

  for (int i = tid; i < 9 * C * kCoPad / 4; i += kThreads)
    smem4[i] = __ldg(reinterpret_cast<const float4*>(w) + i);

  const int segs = (W + kCols - 1) / kCols;
  const int pairs = H / 2;
  const int c4n = C / 4;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int seg = t % segs;
    const int pair = (t / segs) % pairs;
    const int b = t / segs / pairs;
    const int col0 = seg * kCols;
    __syncthreads();  // the last tile's reads of the patch are done (first tile: weights in)
    for (int i = tid; i < 4 * kInCols * c4n; i += kThreads) {
      const int c4 = i % c4n;
      const int pix = i / c4n;
      const int pc = pix % kInCols, pr = pix / kInCols;
      const int gr = 2 * pair - 1 + pr, gc = col0 - 1 + pc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        v = __ldg(reinterpret_cast<const float4*>(y + (((size_t)b * H + gr) * W + gc) * C) + c4);
      float* dst = ys + 4 * c4 * kPlane + (2 * pr + (pc & 1)) * kHalf + (pc >> 1);
      dst[0] = v.x;
      dst[kPlane] = v.y;
      dst[2 * kPlane] = v.z;
      dst[3 * kPlane] = v.w;
    }
    __syncthreads();
    if (co0 >= Co) continue;

    // acc[2i + p][k]: pre-pool pixel (row 2*pair + i, column col0 + 2*lane + p),
    // output channel co0 + k.
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[q][k] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // pixel (i, p) reads patch row i + dy, patch column 2*lane + p + dx
      const float* yq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = q >> 1, pc = (q & 1) + dx;
        yq[q] = ys + (2 * (i + dy) + (pc & 1)) * kHalf + lane + (pc >> 1);
      }
      const float* wt = ws + tap * C * kCoPad + co0;
      float part[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k) part[q][k] = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 wa = *reinterpret_cast<const float4*>(wt + c * kCoPad);
        const float4 wb = *reinterpret_cast<const float4*>(wt + c * kCoPad + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = yq[q][c * kPlane];
#pragma unroll
          for (int k = 0; k < 8; ++k) part[q][k] = __fmaf_rn(v, wv[k], part[q][k]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[q][k] = __fadd_rn(acc[q][k], part[q][k]);
    }

    const int pcol = seg * (kCols / 2) + lane;
    if (2 * pcol < W) {
      float r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float m = fmaxf(fmaxf(acc[0][k], acc[1][k]), fmaxf(acc[2][k], acc[3][k]));
        r[k] = fmaxf(__fadd_rn(m, __ldg(bias + co0 + k)), 0.f);
      }
      float4* o = reinterpret_cast<float4*>(
          out + (((size_t)b * pairs + pair) * (W / 2) + pcol) * Co + co0);
      o[0] = make_float4(r[0], r[1], r[2], r[3]);
      o[1] = make_float4(r[4], r[5], r[6], r[7]);
    }
  }
}

}  // namespace

extern "C" {

// y [B, H, W, C] f32 (H, W even; C % 8 == 0, C <= 64), w the layout
// [9, C, 64] f32, bias [Co] f32 (Co % 8 == 0, Co <= 64) -> out [B, H/2, W/2,
// Co] f32. y, w and out 16-byte aligned. The grid is as many blocks as fit on
// the current device at once, at most one per tile. Returns the cudaError_t
// of the launch (0 = cudaSuccess).
int aznet_conv1_fused_f32(const void* y, const void* w, const void* bias, int batch, int H,
                          int W, int C, int Co, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || W % 2 != 0 || C <= 0 || C > kMaxC ||
      C % 8 != 0 || Co <= 0 || Co > kMaxC || Co % 8 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch * (H / 2) * ((W + kCols - 1) / kCols);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(conv1_fused_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv1_fused_f32_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  conv1_fused_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w, (const float*)bias, H, W, C, Co, (int)tiles,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

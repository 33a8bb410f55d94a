// VGG-16 conv1_2 + bias + ReLU + 2x2/2 max-pool (pool1) fused, bf16, for
// Hopper (sm_90a): y [B, H, W, C] bf16 (conv1_1's ReLU output, NHWC) ->
// out [B, H/2, W/2, Co] bf16.
//
// Replaces aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool (its
// _kernel / _fused_impl; conv1_1 stays outside, as there). The TPU kernel's
// 128-lane channel padding, 8-row strips and strip DMA exist for Mosaic's
// alignment rules and are not carried: y is compact NHWC and TMA zero-fills
// the taps outside the image. It replaces, in place, this port's first
// kernel for the same function (mma.sync m16n8k16, 2x64-pixel tiles that each
// reloaded all weights, one buffer, no copy/compute overlap: 515.9 us of
// device time at b=2 on the 608x800 canvas on an H100, 14% of the bf16 peak).
//
// What bounds it on this card: at VGG-16's conv1_2 (C = Co = 64, b = 2,
// 608 x 800) 71.7 GFLOP against 155 MB of device memory: the bf16 tensor
// cores (72.5 us at 989 TFLOP/s) over bytes (46 us at 3.35 TB/s).
//
// Computation: an implicit GEMM with the output channels as M and the pixels
// as N, out^T = W^T . patch, K = 9 taps x C in chunks of 16 channels.
//   * Tile: 2 output rows (one pool window) x 128 columns x all Co (zero-
//     padded to M = 64), owned by one consumer warpgroup as two accumulators
//     of 64 x 128 f32 (one per row, 64 registers each).
//   * Tensor cores through wgmma.mma_async m64n128k16 .f32.bf16.bf16, both
//     operands from shared memory through no-swizzle descriptors, both
//     K-major. A = the weights of one tap and chunk: 64 output channels x 16
//     bytes per 8-channel half, LBO = 1,024 bytes (the other half), SBO = 128
//     (8 channels further). B = one patch row: 128 pixels of 16 bytes per
//     8-channel plane, LBO = one plane, SBO = 128 (8 pixels further). A tap
//     (dy, dx) is then +16*dx bytes and dy patch rows on B's start address,
//     so one staged halo patch feeds all 9 taps with no copy per tap.
//     Shared-memory reads per wgmma: 2 KB of A + 4 KB of B in 64 tensor-core
//     cycles, 96 B/cycle against the SM's 128 (with pixels as M and Co = 64
//     as N it would be 4 KB in 32 cycles, 128 B/cycle: the tensor cores would
//     wait on shared memory).
//   * Weights resident: each block loads the whole tiled weight tensor once,
//     by one bulk copy on a barrier of its own (9 x 64 x 64 bf16 = 73,728
//     bytes at C = 64), in the layout ops/conv1_fused.py::kernel_layout packs,
//     [Cp/16, 9, 2, 64, 8]: chunk, tap, 8-channel half, output channel,
//     channel. Channels past C and output channels past Co are zeros there.
//   * The patch by TMA into a ring of 8 stages under full/empty mbarriers,
//     filled by one producer thread: a stage is one 16-channel chunk of a
//     tile's halo patch, 4 rows x 130 columns, as two 4D boxes of 8 channels
//     (16 bytes a pixel) over [B, H, W, C] that start at row - 1 and column
//     - 1. TMA's zero fill outside the tensor is the SAME padding, and the
//     zero channels past C (C = 8 or 24: a box wholly past C is all zeros).
//   * Persistent: about one block per SM (the host picks the grid); block x
//     walks tiles x, x + G, x + 2G, ..., tile t = (image, row pair, 128-column
//     segment) with the segment fastest, so neighbouring row pairs, which
//     share halo rows, run at the same time and meet in L2. The block's k-th
//     tile goes to consumer warpgroup k % 2, so one warpgroup's epilogue
//     overlaps the other's wgmmas and the producer's loads of the next tiles.
//     The ring's stage and phase follow the block's chunk sequence
//     (k * chunks + i), across tiles.
//   * Epilogue (the build has --fmad=false): thread (warp w, lane l) holds
//     output channels 16w + l/4 (+8) and pixel columns 2(l%4) and 2(l%4)+1 of
//     every 8-column group, in both rows, so a pool window is four of its own
//     registers: max of the four, + bias[co] in f32 (__fadd_rn; rounding is
//     monotone, so adding after the max equals adding before it), ReLU, one
//     __float2bfloat16_rn. The pooled tile is transposed through shared
//     memory and stored 16 bytes a thread (channels are contiguous in NHWC).
//     The f32 sums run in another order than the plain version's nine tap
//     products, so the two agree to about one bf16 ulp, not bit for bit.
//     Columns past W (the ragged last segment) are zeros in the patch and
//     are never stored; W is even, so no pool window straddles the edge.

#include <cuda_bf16.h>

#include "hopper.cuh"  // mbarriers, bulk/TMA copies, descriptors, the tensor-map encoder

namespace {

constexpr int kCols = 128;                        // output columns per tile = wgmma N
constexpr int kM = 64;                            // output channels, zero-padded = wgmma M
constexpr int kKc = 16;                           // input channels per stage = wgmma K
constexpr int kMaxC = 64;                         // largest C (and Co) the kernel takes
constexpr int kInCols = kCols + 2;                // halo patch columns
constexpr int kPlane = 4 * kInCols * 16;          // one 8-channel plane of a stage: 8,320 bytes
constexpr int kStageBytes = 2 * kPlane;           // 16,640
constexpr int kStages = 8;
constexpr int kWHalf = kM * 16;                   // one tap's 8-channel half of A: 1,024 bytes
constexpr int kWChunk = 9 * 2 * kWHalf;           // weights per 16-channel chunk: 18,432 bytes
constexpr int kWBytesMax = kMaxC / kKc * kWChunk;  // 73,728
constexpr int kOutPitch = kM * 2 + 16;            // staged bytes per pooled pixel (+16: banks)
constexpr int kOutBytes = kCols / 2 * kOutPitch;  // 9,216 per consumer warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kBarBytes = 256;                    // full[kStages], empty[kStages], weights
// [barriers][weights][ring][epilogue staging]; the ring starts 128-byte aligned.
constexpr int kSmemBytes = kBarBytes + kWBytesMax + kStages * kStageBytes + kConsumers * kOutBytes;
static_assert((kBarBytes + kWBytesMax) % 128 == 0 && kPlane % 128 == 0, "TMA alignment");
static_assert(kSmemBytes <= 232448, "one block's shared memory");

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] += A[64x16] . B[128x16]^T, bf16 x bf16 -> f32; accumulator
// element 4j + e of thread (warp w, lane l) is row (output channel) 16w + l/4
// + 8*(e >> 1), column (pixel) 8j + 2*(l % 4) + (e & 1).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Named barrier of one consumer warpgroup (id 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// y through `y_map` ([B, H, W, C] bf16, boxes of 8 channels x 130 columns x
// 4 rows); w: the tiled layout [chunks, 9, 2, 64, 8] bf16; bias [Co] f32 ->
// out [B, H/2, W/2, Co] bf16. `tiles` = B * H/2 * ceil(W / 128); any grid.
__global__ void __launch_bounds__(kThreads, 1)
conv1_fused_kernel(const __grid_constant__ CUtensorMap y_map, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, int H, int W, int Co, int chunks, int tiles,
                   __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t w_bar = full0 + 16 * kStages;
  const uint32_t w_s = full0 + kBarBytes;
  const uint32_t ring0 = w_s + kWBytesMax;
  const int tid = threadIdx.x;
  const int segs = (W + kCols - 1) / kCols;
  const int pairs = H >> 1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4);  // the four warps of the consuming warpgroup
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // Producer: the weights once, then chunk i of the block's k-th tile into
    // stage (k * chunks + i) % kStages once its consumers released it.
    if (tid != 128 * kConsumers) return;
    const uint32_t w_bytes = chunks * kWChunk;
    mbar_arrive_expect_tx(w_bar, w_bytes);
    bulk_load(w_s, w, w_bytes, w_bar);
    int seq = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int seg = t % segs;
      const int pair = (t / segs) % pairs;
      const int b = t / segs / pairs;
      for (int i = 0; i < chunks; ++i, ++seq) {
        const int s = seq % kStages;
        if (seq >= kStages) mbar_wait(empty0 + 8 * s, ((seq / kStages) & 1) ^ 1);
        const uint32_t st = ring0 + s * kStageBytes;
        const uint32_t full = full0 + 8 * s;
        mbar_arrive_expect_tx(full, kStageBytes);
        // Rows 2*pair-1 .. 2*pair+2, columns seg*128-1 .. seg*128+128,
        // channels 16i .. 16i+15 as two planes [row][column][8 channels].
        tma_load_4d(st, &y_map, i * kKc, seg * kCols - 1, 2 * pair - 1, b, full);
        tma_load_4d(st + kPlane, &y_map, i * kKc + 8, seg * kCols - 1, 2 * pair - 1, b, full);
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes the block's tiles k = wg, wg + 2, ...
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int ho = H >> 1;
  const int wo = W >> 1;
  unsigned char* stage_out =
      smem + kBarBytes + kWBytesMax + kStages * kStageBytes + wg * kOutBytes;
  float bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = 16 * warp + (lane >> 2) + 8 * h;
    bi[h] = co < Co ? bias[co] : 0.0f;
  }
  float acc[2][64];
  mbar_wait(w_bar, 0);

  for (int k = wg; blockIdx.x + k * gridDim.x < tiles; k += kConsumers) {
    const int t = blockIdx.x + k * gridDim.x;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[r][i] = 0.0f;

    for (int i = 0; i < chunks; ++i) {
      const int seq = k * chunks + i;
      const int s = seq % kStages;
      mbar_wait(full0 + 8 * s, (seq / kStages) & 1);
      const uint32_t st = ring0 + s * kStageBytes;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap - dy * 3;
        const uint64_t da = smem_desc(w_s + (i * 9 + tap) * 2 * kWHalf, kWHalf, 128);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wgmma_bf16(acc[r], da, smem_desc(st + ((r + dy) * kInCols + dx) * 16, kPlane, 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // Keep this stage's group in flight; the previous one is done: release it.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((seq - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((k * chunks + chunks - 1) % kStages));

    // Epilogue: pool in registers, stage [64 pooled columns][64 channels],
    // copy out 16 bytes a thread.
    warpgroup_sync(wg);  // the previous tile's copy-out has read stage_out
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int pc = 4 * j + (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * j + 2 * h;
        const float m = fmaxf(fmaxf(acc[0][e], acc[0][e + 1]), fmaxf(acc[1][e], acc[1][e + 1]));
        const int co = 16 * warp + (lane >> 2) + 8 * h;
        *reinterpret_cast<__nv_bfloat16*>(stage_out + pc * kOutPitch + co * 2) =
            __float2bfloat16_rn(fmaxf(__fadd_rn(m, bi[h]), 0.0f));
      }
    }
    warpgroup_sync(wg);
    const int seg = t % segs;
    const int prow = (t / segs) % pairs;
    const int b = t / segs / pairs;
    const int pieces = Co >> 3;  // 16-byte pieces per pooled pixel
    for (int idx = tid & 127; idx < kCols / 2 * pieces; idx += 128) {
      const int pc = idx / pieces;
      const int q = idx - pc * pieces;
      const int pcol = seg * (kCols / 2) + pc;
      if (pcol < wo)
        *reinterpret_cast<uint4*>(out + (((size_t)b * ho + prow) * wo + pcol) * Co + 8 * q) =
            *reinterpret_cast<const uint4*>(stage_out + pc * kOutPitch + 16 * q);
    }
  }
}

}  // namespace

extern "C" {

// y [B, H, W, C] bf16 (H, W even; C % 8 == 0, C <= 64), w the tiled layout
// [ceil(C/16), 9, 2, 64, 8] bf16, bias [Co] f32 (Co % 8 == 0, Co <= 64) ->
// out [B, H/2, W/2, Co] bf16; `grid` blocks (the host: about one per SM).
// y, w and out 16-byte aligned. Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int aznet_conv1_fused(const void* y, const void* w, const void* bias, int batch, int H, int W,
                      int C, int Co, int grid, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || W % 2 != 0 || C <= 0 || C > kMaxC ||
      C % 8 != 0 || Co <= 0 || Co > kM || Co % 8 != 0 || grid <= 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch * (H / 2) * ((W + kCols - 1) / kCols);
  if (tiles > 0x7fffffffLL || grid > tiles) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv1_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap y_map = {};
  const int map_err = nhwc_map(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, batch, H, W, C,
                               8, kInCols, 4);
  if (map_err != 0) return map_err;
  conv1_fused_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      y_map, (const __nv_bfloat16*)w, (const float*)bias, H, W, Co, (C + kKc - 1) / kKc,
      (int)tiles, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Int8 3x3/SAME convolution + ReLU (+ fused 2x2/2 max-pool) for Hopper
// (sm_90a): the VGG-16 trunk from conv2_2 to conv5_3 in int8 mode.
//
// Replaces two TPU kernels with one kernel and two entry points:
//   * aznet_tpu/ops/pallas/conv_int8_chain.py::conv3x3_int8_chain (the chain
//     walk; its fused pool) -> aznet_conv3x3_int8_chain;
//   * aznet_tpu/ops/pallas/conv_int8_kernel.py::conv3x3_int8_pallas (the
//     per-layer strip kernel, no pool) -> aznet_conv3x3_int8_strip.
// Chain and strip differ only in whether the 2x2 pool runs in the epilogue.
// The TPU's haloed layout and row strips are alignment devices and are not
// carried: activations are compact NHWC int8 [B, H, W, C] between layers and
// the copies zero-fill the taps outside the image.
//
// What bounds it on this card: the int8 tensor-core operations, 2*9*C*Co per
// output pixel (VGG-16 at b=2 on a 608x800 canvas: 0.1087 ms for the chain
// entry's 3 layers and 0.1359 ms for the strip entry's 7 layers at 1,979
// TOP/s); the bytes are a few MB a layer.
//
// Computation, per block: an implicit GEMM over a tile of R output rows x 64
// output columns x 128 output channels, R = 4 (or 2 on small maps, chosen by
// the host), K = 9 taps x C in chunks of 32 input channels.
//   * Tensor cores through wgmma.mma_async m64n128k32 .s32.s8.s8, both
//     operands from shared memory through descriptors. One wgmma is one
//     output row (M = 64 pixels) of one tap. Both operands use the
//     no-swizzle layout: a core matrix is 8 rows of 16 bytes, contiguous, so
//     each 16-channel half of a staged pixel (or weight row) is 16 bytes and
//     the pixels of a patch row follow one another. A tap's shift by dx
//     pixels is then +16*dx bytes on A's start address and dy rows are
//     +16*66*dy: one staged halo patch, (R+2) x 66 x 32 channels, feeds all
//     9 taps with no copy per tap (a swizzled layout would break under a
//     one-pixel shift; A from registers would need ldmatrix per tap).
//   * A ring of 4 stages in shared memory, each one chunk of 32 input
//     channels, filled by asynchronous copies from one producer thread and
//     handed over by mbarriers: full (the copies' bytes) and empty (one
//     arrival per consumer warp once its wgmmas of the stage are done). Two
//     consumer warpgroups own R/2 rows each and keep one wgmma group in
//     flight while they wait for the next stage.
//       - The weight chunk, 9 x 128 x 32, is one contiguous 36,864-byte
//         piece of the tiled layout the host packs at build time
//         (ops/conv_int8.py::kernel_layout), moved by one bulk copy (TMA
//         without a tensor map).
//       - The patch comes by TMA: two 4D boxes over [B, H, W, C] (16
//         channels x 66 columns x R+2 rows each) whose start may be -1; TMA
//         writes zeros outside the tensor, which is the SAME padding and the
//         Cp padding. TMA needs 16-byte strides, so for C % 16 != 0 (or an
//         x not 16-byte aligned) two producer warps copy the patch with
//         8-byte cp.async and zero-fill instead (every C % 8 == 0 is taken).
//       - On the H100, 16-byte cp.asyncs (and a tensor map cutting the
//         weights into 2,304 rows of 16 bytes) could not keep up with the
//         tensor cores; the bulk copy and the patch's TMA boxes can.
//   * Each block re-reads its weight chunk from L2 once per 256 (or 128)
//     output pixels, not per 64 as the mma.sync tile did.
//   * The epilogue writes the block's codes to shared memory (pitch padded
//     by 16 bytes against bank conflicts) and copies them out in 16-byte
//     stores (8 where Co * size % 16 != 0); the 2x2 pool takes the max of the
//     four int8 codes there, which equals requantizing the max of y since
//     requantization is monotone.
// Numerics, rounded as the reference (the build has --fmad=false and every
// f32 step is spelled with a _rn intrinsic); the int32 sum is exact in any
// order:
//   y = relu(float(acc) * (f32(s_x) * s_w[co]) + bias[co])
//   pool: max over the 2x2 window;
//   int8: clip(__float2int_rn(y * inv_s_out), -127, 127), half to even,
//         inv_s_out = float32(1.0 / s_out) computed in double on the host;
//   bf16: __float2bfloat16_rn(y) (the trunk's exit, conv5_3).

#include <cuda_bf16.h>

#include "hopper.cuh"  // mbarriers, bulk/TMA copies, descriptors, the tensor-map encoder

namespace {

constexpr int kCols = 64;              // output columns per block = wgmma M
constexpr int kCoTile = 128;           // output channels per block = wgmma N
constexpr int kKc = 32;                // input channels per stage = wgmma K
constexpr int kStages = 4;
constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kProducerThreads = 64;   // two warps (the cp.async patch; TMA needs one thread)
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kInCols = kCols + 2;
constexpr int kWPlane = 9 * kCoTile * 16;  // one 16-channel half of a weight chunk
constexpr int kWBytes = 2 * kWPlane;       // a weight chunk: one piece of the tiled layout
constexpr int kBarBytes = 128;             // full[kStages], empty[kStages]

template <int kRowsPerWG>
struct Tile {
  static constexpr int kRows = 2 * kRowsPerWG;
  static constexpr int kInBox = (kRows + 2) * kInCols * 16;  // one half of the patch
  static constexpr int kInPlane = (kInBox + 127) / 128 * 128;  // TMA writes 128-byte aligned
  static constexpr int kStageBytes = 2 * kInPlane + kWBytes;
  static constexpr int kSmemBytes = kBarBytes + kStages * kStageBytes;
};

// The barrier counts this thread's arrival once all its cp.asyncs so far land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Copies 8 bytes, or writes zeros when !ok (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64x128] += A[64x32] . B[128x32]^T, s8 x s8 -> s32; accumulator element
// 4j + e of thread (warp w, lane l) is row 16w + l/4 + 8*(e >> 1), column
// 8j + 2*(l % 4) + (e & 1).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ int8_t requant(float y, float inv_s_out) {
  int q = __float2int_rn(__fmul_rn(y, inv_s_out));
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return (int8_t)q;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

// x [B, H, W, C] int8; w [Co/128, Cp/32, 2, 9, 128, 16] int8; s_w, bias [Co] f32.
// out: kPool -> int8 [B, H/2, W/2, Co]; else int8 or (kBf16) bf16 [B, H, W, Co].
// Grid: (ceil(W / 64), ceil(H / R), B * ceil(Co / 128)), R = 2 * kRowsPerWG.
template <bool kPool, bool kBf16, int kRowsPerWG>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const __grid_constant__ CUtensorMap x_map,
                    const int8_t* __restrict__ w, const float* __restrict__ s_w,
                    const float* __restrict__ bias, int H, int W, int C, int Cp, int Co,
                    int co_tiles, int tma_patch, float s_x, float inv_s_out,
                    void* __restrict__ out) {
  using T = Tile<kRowsPerWG>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + kBarBytes;
  const uint32_t full0 = smem_u32(smem);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t ring0 = smem_u32(ring);

  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * T::kRows;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z - b * co_tiles) * kCoTile;
  const int tid = threadIdx.x;
  const int nchunks = Cp / kKc;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The copies' expect_tx, and each cp.async producer's arrival.
      mbar_init(full0 + 8 * s, tma_patch ? 1 : kProducerThreads + 1);
      mbar_init(empty0 + 8 * s, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producers: chunk i into stage i % kStages once its consumers released
    // it. With the patch by TMA, one thread issues everything.
    const int p = tid - kConsumerThreads;
    if (tma_patch && p != 0) return;
    const int8_t* xb = x + (size_t)b * H * W * C;
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t st = ring0 + s * T::kStageBytes;
      const uint32_t full = full0 + 8 * s;
      const int kc = i * kKc;
      // Patch: rows row0-1 .. row0+R, columns col0-1 .. col0+64, channels
      // kc .. kc+31, stored [half][row][column][16 bytes]; zeros outside the
      // image and past C (the SAME padding).
      if (p == 0) {
        mbar_arrive_expect_tx(full, kWBytes + (tma_patch ? 2 * T::kInBox : 0));
        if (tma_patch) {
          tma_load_4d(st, &x_map, kc, col0 - 1, row0 - 1, b, full);
          tma_load_4d(st + T::kInPlane, &x_map, kc + 16, col0 - 1, row0 - 1, b, full);
        }
        // Weights: the chunk's contiguous piece of the tiled layout, already
        // [half][tap][n][16 bytes] (output channels past Co are zeros there).
        bulk_load(st + 2 * T::kInPlane, w + ((size_t)(co0 / kCoTile) * nchunks + i) * kWBytes,
                  kWBytes, full);
      }
      if (!tma_patch) {
        for (int r = 0; r < T::kRows + 2; ++r) {
          const int gr = row0 - 1 + r;
          const bool row_ok = gr >= 0 && gr < H;
          for (int j = p; j < kInCols * 4; j += kProducerThreads) {
            const int c = j >> 2;
            const int q = j & 3;
            const int gc = col0 - 1 + c;
            const int ch = kc + 8 * q;
            const bool ok = row_ok && gc >= 0 && gc < W && ch < C;
            const int8_t* src = ok ? xb + ((size_t)gr * W + gc) * C + ch : x;
            cp_async8(st + (q >> 1) * T::kInPlane + (r * kInCols + c) * 16 + (q & 1) * 8, src,
                      ok);
          }
        }
        cp_async_arrive(full);
      }
    }
    if (!tma_patch) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumers: warpgroup wg owns tile rows wg*kRowsPerWG .. +kRowsPerWG-1.
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  int acc[kRowsPerWG][64];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWG; ++rr)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[rr][i] = 0;

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % kStages;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    // The patch's cp.async writes came through the generic proxy; wgmma
    // reads through the async proxy (as the TMA writes).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t st = ring0 + s * T::kStageBytes;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWG; ++rr) fence_regs(acc[rr]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      const uint64_t db = smem_desc(st + 2 * T::kInPlane + tap * kCoTile * 16, kWPlane, 128);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWG; ++rr) {
        const int r = wg * kRowsPerWG + rr + dy;
        wgmma_s8(acc[rr], smem_desc(st + (r * kInCols + dx) * 16, T::kInPlane, 128), db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // Keep this stage's group in flight; the previous one is done: release it.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int rr = 0; rr < kRowsPerWG; ++rr) fence_regs(acc[rr]);
    if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int rr = 0; rr < kRowsPerWG; ++rr) fence_regs(acc[rr]);
  consumer_sync();  // both warpgroups are done with the ring: it holds the output now

  constexpr int kEs = kBf16 ? 2 : 1;                // output bytes per channel
  constexpr int kPitch = kCoTile * kEs + 16;        // staged bytes per pixel
  unsigned char* stage_out = ring;                  // [R][64][kPitch]
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * (lane & 3);
    const int co = co0 + n;
    float sc0 = 0.0f, sc1 = 0.0f, bi0 = 0.0f, bi1 = 0.0f;
    if (co < Co) {  // Co % 8 == 0, so co + 1 < Co too
      sc0 = __fmul_rn(s_x, s_w[co]);
      sc1 = __fmul_rn(s_x, s_w[co + 1]);
      bi0 = bias[co];
      bi1 = bias[co + 1];
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWG; ++rr)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * warp + (lane >> 2) + 8 * half;
        const float y0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[rr][4 * j + 2 * half]), sc0), bi0), 0.0f);
        const float y1 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[rr][4 * j + 2 * half + 1]), sc1), bi1), 0.0f);
        unsigned char* dst = stage_out + ((wg * kRowsPerWG + rr) * kCols + m) * kPitch + n * kEs;
        if (kBf16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(y0);
          v.y = __float2bfloat16_rn(y1);
          *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        } else {
          char2 q;
          q.x = requant(y0, inv_s_out);
          q.y = requant(y1, inv_s_out);
          *reinterpret_cast<char2*>(dst) = q;
        }
      }
  }
  consumer_sync();

  // Copy-out in 16-byte pieces (8 where Co * kEs % 16 != 0).
  const bool wide = (Co * kEs) % 16 == 0;
  const int piece = wide ? 16 : 8;
  const int pieces = kCoTile * kEs / piece;
  if (kPool) {
    const int ho = H >> 1;
    const int wo = W >> 1;
    constexpr int kPr = T::kRows / 2;
    constexpr int kPc = kCols / 2;
    for (int idx = tid; idx < kPr * kPc * pieces; idx += kConsumerThreads) {
      const int k = idx % pieces;
      const int pix = idx / pieces;
      const int pc = pix % kPc;
      const int pr = pix / kPc;
      const int prow = (row0 >> 1) + pr;
      const int pcol = (col0 >> 1) + pc;
      const int co = co0 + k * piece;
      if (prow >= ho || pcol >= wo || co >= Co) continue;
      const unsigned char* s00 = stage_out + (2 * pr * kCols + 2 * pc) * kPitch + k * piece;
      const unsigned char* s10 = s00 + kCols * kPitch;
      int8_t* dst = reinterpret_cast<int8_t*>(out) + (((size_t)b * ho + prow) * wo + pcol) * Co + co;
      if (wide) {
        const uint4* a = reinterpret_cast<const uint4*>(s00);
        const uint4* c = reinterpret_cast<const uint4*>(s10);
        *reinterpret_cast<uint4*>(dst) =
            vmax4(vmax4(a[0], *reinterpret_cast<const uint4*>(s00 + kPitch)),
                  vmax4(c[0], *reinterpret_cast<const uint4*>(s10 + kPitch)));
      } else {
        const uint2 a = *reinterpret_cast<const uint2*>(s00);
        const uint2 a1 = *reinterpret_cast<const uint2*>(s00 + kPitch);
        const uint2 c = *reinterpret_cast<const uint2*>(s10);
        const uint2 c1 = *reinterpret_cast<const uint2*>(s10 + kPitch);
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(__vmaxs4(__vmaxs4(a.x, a1.x), __vmaxs4(c.x, c1.x)),
                       __vmaxs4(__vmaxs4(a.y, a1.y), __vmaxs4(c.y, c1.y)));
      }
    }
  } else {
    for (int idx = tid; idx < T::kRows * kCols * pieces; idx += kConsumerThreads) {
      const int k = idx % pieces;
      const int pix = idx / pieces;
      const int c = pix % kCols;
      const int r = pix / kCols;
      const int row = row0 + r;
      const int col = col0 + c;
      const int co = co0 + k * piece / kEs;
      if (row >= H || col >= W || co >= Co) continue;
      const unsigned char* src = stage_out + pix * kPitch + k * piece;
      unsigned char* dst = reinterpret_cast<unsigned char*>(out) +
                           ((((size_t)b * H + row) * W + col) * Co + co) * kEs;
      if (wide)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
  }
}

// The TMA map of x [B, H, W, C] int8 (C % 16 == 0) with boxes of 16
// channels x 66 columns x `rows` rows x 1 image.
int patch_map(CUtensorMap* map, const void* x, int B, int H, int W, int C, int rows) {
  return nhwc_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H, W, C, 16, kInCols, rows);
}

template <bool kPool, bool kBf16, int kRowsPerWG>
int launch_tile(const void* x, const void* w, const void* s_w, const void* bias, int batch,
                int H, int W, int C, int Cp, int Co, float s_x, float inv_s_out, void* out,
                void* stream) {
  using T = Tile<kRowsPerWG>;
  const int co_tiles = (Co + kCoTile - 1) / kCoTile;
  const dim3 grid((W + kCols - 1) / kCols, (H + T::kRows - 1) / T::kRows, batch * co_tiles);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_int8_kernel<kPool, kBf16, kRowsPerWG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // The patch by TMA where its rules allow (16-byte strides and base), else
  // by 8-byte cp.async.
  const int tma_patch = C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap x_map = {};
  if (tma_patch) {
    const int map_err = patch_map(&x_map, x, batch, H, W, C, T::kRows + 2);
    if (map_err != 0) return map_err;
  }
  kernel<<<grid, kThreads, T::kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)x, x_map, (const int8_t*)w, (const float*)s_w, (const float*)bias, H, W, C,
      Cp, Co, co_tiles, tma_patch, s_x, inv_s_out, out);
  return (int)cudaGetLastError();
}

template <bool kPool, bool kBf16>
int launch(const void* x, const void* w, const void* s_w, const void* bias, int batch, int H,
           int W, int C, int Cp, int Co, int rows, float s_x, float inv_s_out, void* out,
           void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 || Co % 8 != 0 ||
      Cp % kKc != 0 || Cp < C || Cp - C >= kKc || (rows != 2 && rows != 4) ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (kPool && (H % 2 != 0 || W % 2 != 0)) return (int)cudaErrorInvalidValue;
  if (rows == 4)
    return launch_tile<kPool, kBf16, 2>(x, w, s_w, bias, batch, H, W, C, Cp, Co, s_x,
                                        inv_s_out, out, stream);
  return launch_tile<kPool, kBf16, 1>(x, w, s_w, bias, batch, H, W, C, Cp, Co, s_x, inv_s_out,
                                      out, stream);
}

}  // namespace

extern "C" {

// Chain entry: conv + ReLU + fused 2x2/2 max-pool, requantized to int8.
// x [B, H, W, C] int8 (H, W even), w [Co/128, Cp/32, 2, 9, 128, 16] int8
// (the tiled layout; Cp = C rounded up to 32, zero-padded), s_w/bias [Co] f32 -> out [B, H/2, W/2, Co] int8; rows =
// output rows per block (4, or 2 for small maps). Returns the cudaError_t of
// the launch (0 = cudaSuccess).
int aznet_conv3x3_int8_chain(const void* x, const void* w, const void* s_w, const void* bias,
                             int batch, int H, int W, int C, int Cp, int Co, int rows,
                             float s_x, float inv_s_out, void* out, void* stream) {
  return launch<true, false>(x, w, s_w, bias, batch, H, W, C, Cp, Co, rows, s_x, inv_s_out,
                             out, stream);
}

// Strip entry: conv + ReLU, no pool -> out [B, H, W, Co], int8 requantized
// at inv_s_out, or bf16 when out_bf16 != 0 (inv_s_out unused).
int aznet_conv3x3_int8_strip(const void* x, const void* w, const void* s_w, const void* bias,
                             int batch, int H, int W, int C, int Cp, int Co, int rows,
                             float s_x, float inv_s_out, int out_bf16, void* out,
                             void* stream) {
  if (out_bf16)
    return launch<false, true>(x, w, s_w, bias, batch, H, W, C, Cp, Co, rows, s_x, inv_s_out,
                               out, stream);
  return launch<false, false>(x, w, s_w, bias, batch, H, W, C, Cp, Co, rows, s_x, inv_s_out,
                              out, stream);
}

}  // extern "C"

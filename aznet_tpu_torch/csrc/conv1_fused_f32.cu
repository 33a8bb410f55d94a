// VGG-16 conv1_2 + bias + ReLU + 2x2/2 max-pool (pool1) fused, float32, for
// Hopper (sm_90a): y [B, H, W, C] f32 (conv1_1's ReLU output, NHWC) ->
// out [B, H/2, W/2, Co] f32.
//
// Replaces aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool (its
// _kernel / _fused_impl) where the Pallas kernel runs in float32 (dt =
// y.dtype there: f32 operands, f32 sums, f32 bias). It replaces, in place,
// this port's first kernel for the same function (__fmaf_rn on the CUDA
// cores, the weights and a halo patch in shared memory: 2145-2192 us of
// device time at b=2 on the 608x800 canvas on an H100, under half of the
// 1.070 ms that 71.7 GFLOP take at the f32 CUDA-core peak of 67 TFLOP/s).
//
// Float32, not TF32: 3xTF32. Each operand x is split into two TF32 values,
// hi = rna(x) and lo = rna(x - hi) (round to nearest, ties away, to TF32's
// 10 mantissa bits), and each product is taken as lo_w.hi_y + hi_w.lo_y +
// hi_w.hi_y on the tensor cores (lo.lo, about 2^-22 of the product, is
// dropped). The tensor cores' f32 accumulator truncates (on the H100 a sum
// of 1 + 0.75 ulp came back as 1), which over a long sum drifts far past
// float32's error, so a tensor-core sum never holds more than two k8 steps
// (six products of one tap): it is then promoted into float32 partial sums
// on the CUDA cores, one partial per kernel row dy, and the three partials
// are added in dy order. A truncation drops 2^-24 |acc| / (2 ln 2) on
// average, about 2^-23 |acc| over a two-step sum, so such a sum is promoted
// as acc * (1 + 2^-23) in one rounding (__fmaf_rn), which gives it back on
// average: max-pooling picks the pixels whose sums agree in sign, where the
// truncations add up (a one-step sum, at C = 8 or C's last 8 channels, gets
// the factor on its dx = 2 tap only). The result is held to
// ops/conv1_fused.py::float64_errors, the gate the CUDA-core kernel met: at
// most twice the plain float32 version's largest error against float64,
// and within 1e-5 of max|plain|. tests/test_torch_conv1.py models this
// arithmetic on the CPU (without the correction a 3 x 2 x 70 x 16 -> 8 case
// breaks the gate at 2.13 times the plain version's error, as an earlier
// form of this kernel did on the card).
//
// What bounds it on this card: at VGG-16's conv1_2 (C = Co = 64, b = 2,
// 608 x 800) 3 x 71.7 GFLOP on the TF32 tensor cores (0.435 ms at 495
// TFLOP/s) over 311 MB of device memory (0.093 ms at 3.35 TB/s) and the
// promotions' 2.4 G FFMA/FADD on the CUDA cores (0.073 ms at 33.5 T a
// second), so operations on the tensor cores. What holds it near half of that: the
// wgmma shape. With the CUDA cores' work taken out (no splits, no
// promotions) the same loop of wgmmas took 852 us on an H100; m64n64k8
// wgmmas in two dependent chains per warpgroup keep the tensor cores about
// half busy, and a wider N would need the registers that the partials take.
//
// Computation: an implicit GEMM with the output channels as M and the pixels
// as N, out^T = W^T . patch, K = 9 taps x C in k8 steps of 8 channels.
//   * Tile: 2 output rows (one pool window) x 64 columns x all Co (zero-
//     padded to M = 64), owned by one consumer warpgroup: per row a
//     tensor-core accumulator, the dy partial and the total, 64 x 64 f32
//     each (32 registers a thread each, 192 in all). The block is the two
//     consumer warpgroups and nothing else: 8 warps, 2 on each quarter of
//     the SM, may hold 255 registers a thread, where a ninth warp (a
//     producer) caps them at 168 (16K registers a quarter over 3 warps);
//     setmaxnreg did not lift ptxas's allocation above that cap.
//   * Tensor cores through wgmma.mma_async m64n64k8 .f32.tf32.tf32, A (the
//     weights) from registers, B (the patch) from shared memory through a
//     no-swizzle K-major descriptor: a core matrix is 8 pixels x 4 channels
//     (16 bytes a pixel), LBO = one 4-channel plane, SBO = 128 bytes (8
//     pixels further). Tap (dy, dx) is +16*dx bytes on B's start address,
//     row r + 66 pixels. The two rows' chains are issued interleaved.
//   * Shared memory sets where each operand lives. The weights as hi and lo
//     would take 2 x 147,456 bytes, more than a block's 232,448, so A comes
//     from registers: the f32 weights are resident in shared memory, one
//     bulk copy per block of the layout ops/conv1_fused.py::kernel_layout_f32
//     packs, [9, C/8, 128, 4] (tap, k8 step, consumer thread, value): each
//     thread loads its wgmma A fragment of a step as one 16-byte word and
//     splits it in registers, once for both rows.
//   * The patch by TMA, in stages of 2 rows x 66 columns x 16 channels (one
//     4D box over [B, H, W, C] at row 2*pair + dy - 1 and column - 1: 8,448
//     bytes), into a ring of 3 stages per consumer warpgroup under full
//     mbarriers. The warpgroup's first thread keeps its ring full: it issues
//     the first 3 loads, and the load 3 stages ahead into each slot as soon
//     as the slot is split. TMA's zero fill outside the tensor is the SAME
//     padding, and the zero channels past C. The consumers split a landed
//     stage into hi and lo planes of their own (4-channel planes
//     [row][column][4]), fence.proxy.async, a named barrier, then run the
//     wgmmas on the planes. hi is rounded by two integer instructions (the
//     same bits as cvt.rna.tf32.f32 for any finite value), lo by
//     cvt.rna.tf32.f32, so a NaN or infinite input leaves a NaN in lo.
//   * Byte budget at C = 64: barriers 256 + weights 147,456 + per consumer
//     warpgroup 3 x 8,448 ring + 16,896 planes = 232,192 of 232,448. The
//     epilogue stages its pooled tile in the warpgroup's planes.
//   * Order, per tile: for dy in 0..2, for each 16-channel chunk (stage),
//     for dx in 0..2: one promotion group, the chunk's k8 steps of tap (dy,
//     dx), each step lo_w.hi_y, hi_w.lo_y, hi_w.hi_y into the accumulator,
//     zeroed by the first; wait; partial += accumulator (x (1 + 2^-23) as
//     above). After each dy, total += partial.
//     (ops/cuda/conv1_kernel.py::f32_promotions is this order in Python.)
//   * Persistent: about one block per SM (the host picks the grid); block x
//     walks tiles x, x + G, ..., tile t = (image, row pair, 64-column
//     segment), segment fastest; the block's k-th tile goes to consumer
//     warpgroup k % 2, so one warpgroup's splits, promotions and epilogue
//     overlap the other's wgmmas.
//   * Epilogue (the build has --fmad=false): thread (warp w, lane l) holds
//     output channels 16w + l/4 (+8) and pixel columns 2(l%4), 2(l%4)+1 of
//     every 8-column group in both rows, so a pool window is four of its own
//     registers: max of the four, + bias[co] (__fadd_rn; rounding is
//     monotone, so adding after the max equals adding before it), ReLU; the
//     pooled tile is staged through shared memory and stored 16 bytes a
//     thread. Columns past W (the ragged last segment) are zeros in the patch
//     and are never stored; W is even, so no pool window straddles the edge.

#include "hopper.cuh"  // mbarriers, bulk/TMA copies, descriptors, the tensor-map encoder

namespace {

constexpr int kCols = 64;                          // output columns per tile = wgmma N
constexpr int kM = 64;                             // output channels, zero-padded = wgmma M
constexpr int kKc = 16;                            // input channels per stage (two k8 steps)
constexpr int kMaxC = 64;                          // largest C (and Co) the kernel takes
constexpr int kInCols = kCols + 2;                 // halo patch columns
constexpr int kStageBytes = 2 * kInCols * kKc * 4;  // 2 rows x 66 columns x 16 f32: 8,448
constexpr int kStages = 3;                         // raw stages per consumer warpgroup
constexpr int kPlane = 2 * kInCols * 16;           // a 4-channel plane [row][column][4]: 2,112
constexpr int kPlanes = 2 * (kKc / 4) * kPlane;    // hi and lo planes of a stage: 16,896
constexpr int kWStep = 128 * 16;                   // one (tap, k8 step) of A: 2,048 bytes
constexpr int kWBytesMax = 9 * (kMaxC / 8) * kWStep;  // 147,456
constexpr int kOutPitch = kM + 8;                  // floats per staged pooled pixel (banks)
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * kConsumers;         // 8 warps: 2 a quarter of the SM
constexpr int kBarBytes = 256;                     // full[2][3], weights
constexpr int kRing0 = kBarBytes + kWBytesMax;     // rings, then planes
constexpr int kPlanes0 = kRing0 + kConsumers * kStages * kStageBytes;
constexpr int kSmemBytes = kPlanes0 + kConsumers * kPlanes;  // 232,192
static_assert(kRing0 % 128 == 0 && kStageBytes % 128 == 0, "TMA alignment");
static_assert(kCols / 2 * kOutPitch * 4 <= kPlanes, "the epilogue's staging fits the planes");
static_assert(kSmemBytes <= 232448, "one block's shared memory");
static_assert(8 * kConsumers * kStages + 8 <= kBarBytes, "barriers");

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define AZNET_WGMMA_D                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36"
#define AZNET_WGMMA_OUT(c)                                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),   \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),         \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),         \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define AZNET_W(x) "=f"(x)
#define AZNET_RW(x) "+f"(x)

// d[64x64] = A[64x8] . B[64x8]^T (first) or d += A . B^T, tf32 x tf32 ->
// f32. A from registers: a[0..3] of thread (warp w, lane l) are rows 16w +
// l/4 (+8 for a[1], a[3]), columns l%4 (+4 for a[2], a[3]) (CUTLASS's
// ALayout_64x8). Accumulator element 4j + e is row 16w + l/4 + 8*(e >> 1),
// column 8j + 2*(l % 4) + (e & 1).
__device__ __forceinline__ void wgmma_tf32_first(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " AZNET_WGMMA_D ", p, 1, 1;\n}\n"
               : AZNET_WGMMA_OUT(AZNET_W)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " AZNET_WGMMA_D ", p, 1, 1;\n}\n"
               : AZNET_WGMMA_OUT(AZNET_RW)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 |x|, hi and lo TF32 values (low 13 bits zero),
// both rounded to nearest, ties away from zero: hi by integer operations
// (cvt.rna.tf32.f32 for every finite x, in two instructions), lo by
// cvt.rna.tf32.f32, so a NaN or infinite x leaves a NaN in lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// Named barrier of one consumer warpgroup (id 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One promotion group: the NS k8 steps of one tap and stage, each step's
// products lo_w.hi_y, hi_w.lo_y, hi_w.hi_y for both rows (the rows'
// chains interleaved) into acc[r], the first from zero; then part[r] +=
// acc[r], as acc * (1 + 2^-23) in one rounding where `unbias`. `w_s`: the
// weights of the tap and the stage's first step, thread ct's word; `b`:
// the tap's column offset in the stage's hi planes.
template <int NS>
__device__ __forceinline__ void promotion_group(float (&acc)[2][32], float (&part)[2][32],
                                                const unsigned char* w_s, uint32_t b,
                                                bool unbias) {
  uint32_t ahi[NS][4], alo[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(w_s + j * kWStep);
    split_tf32(w.x, ahi[j][0], alo[j][0]);
    split_tf32(w.y, ahi[j][1], alo[j][1]);
    split_tf32(w.z, ahi[j][2], alo[j][2]);
    split_tf32(w.w, ahi[j][3], alo[j][3]);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint64_t d = smem_desc(b + 2 * j * kPlane + r * kInCols * 16, kPlane, 128);
      if (j == 0)
        wgmma_tf32_first(acc[r], alo[j], d);
      else
        wgmma_tf32(acc[r], alo[j], d);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      wgmma_tf32(acc[r], ahi[j],
                 smem_desc(b + (2 * j + 4) * kPlane + r * kInCols * 16, kPlane, 128));
#pragma unroll
    for (int r = 0; r < 2; ++r)
      wgmma_tf32(acc[r], ahi[j], smem_desc(b + 2 * j * kPlane + r * kInCols * 16, kPlane, 128));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const float k = unbias ? __int_as_float(0x3F800001) : 1.0f;  // 1 + 2^-23
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fence_acc(acc[r]);
#pragma unroll
    for (int e = 0; e < 32; ++e) part[r][e] = __fmaf_rn(acc[r][e], k, part[r][e]);
  }
}

// y through `y_map` ([B, H, W, C] f32, boxes of 16 channels x 66 columns x
// 2 rows); w: the layout [9, steps, 128, 4] f32 (steps = C / 8); bias [Co]
// f32 -> out [B, H/2, W/2, Co] f32. `tiles` = B * H/2 * ceil(W / 64); any
// grid.
__global__ void __launch_bounds__(kThreads, 1)
conv1_fused_f32_kernel(const __grid_constant__ CUtensorMap y_map, const float* __restrict__ w,
                       const float* __restrict__ bias, int H, int W, int Co, int steps, int tiles,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem);  // full[wg][s]: + 8 * (wg * kStages + s)
  const uint32_t w_bar = full0 + 8 * kConsumers * kStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ct = tid & 127;
  const int warp = ct >> 5;
  const int lane = tid & 31;
  const int chunks = (steps + 1) >> 1;
  const int segs = (W + kCols - 1) / kCols;
  const int pairs = H >> 1;
  const int ho = H >> 1;
  const int wo = W >> 1;
  const uint32_t ring_s = full0 + kRing0 + wg * kStages * kStageBytes;
  const unsigned char* ring = smem + kRing0 + wg * kStages * kStageBytes;
  unsigned char* planes = smem + kPlanes0 + wg * kPlanes;  // hi planes 0..3, lo planes 4..7
  const uint32_t planes_s = full0 + kPlanes0 + wg * kPlanes;

  if (tid == 0) {
    for (int s = 0; s < kConsumers * kStages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup's first thread loads its stages in the order it takes
  // them (its k-th tile, kernel row dy, chunk i) into ring slot n % kStages:
  // the first kStages at once, then one as each slot is split. (lt, ldy, li)
  // is the next stage to load, ln its number; (lseg, lpair, lb) lt's place.
  int lt = blockIdx.x + wg * gridDim.x, ldy = 0, li = 0, ln = 0;
  int lseg = lt % segs, lpair = (lt / segs) % pairs, lb = lt / segs / pairs;
  auto load_next = [&]() {
    if (lt >= tiles) return;
    const uint32_t full = full0 + 8 * (wg * kStages + ln % kStages);
    mbar_arrive_expect_tx(full, kStageBytes);
    // Rows 2*pair + dy - 1 .. 2*pair + dy, columns seg*64-1 .. seg*64+64,
    // channels 16i .. 16i+15, as [row][column][16 channels].
    tma_load_4d(ring_s + (ln % kStages) * kStageBytes, &y_map, li * kKc, lseg * kCols - 1,
                2 * lpair + ldy - 1, lb, full);
    ++ln;
    if (++li < chunks) return;
    li = 0;
    if (++ldy < 3) return;
    ldy = 0;
    lt += kConsumers * gridDim.x;
    lseg = lt % segs, lpair = (lt / segs) % pairs, lb = lt / segs / pairs;
  };
  if (ct == 0) {
    if (wg == 0) {
      const uint32_t w_bytes = 9 * steps * kWStep;
      mbar_arrive_expect_tx(w_bar, w_bytes);
      bulk_load(full0 + kBarBytes, w, w_bytes, w_bar);
    }
    for (int n = 0; n < kStages; ++n) load_next();
  }
  float bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = 16 * warp + (lane >> 2) + 8 * h;
    bi[h] = co < Co ? bias[co] : 0.0f;
  }
  // acc: the tensor cores' sums of one promotion group; part: the dy
  // partials; tot: the totals. [r]: output row 2*pair + r.
  float acc[2][32], part[2][32], tot[2][32];
  const unsigned char* w_thread = smem + kBarBytes + ct * 16;
  mbar_wait(w_bar, 0);

  // Warpgroup wg takes the block's tiles k = wg, wg + 2, ...
  int n = 0;
  for (int k = wg; blockIdx.x + k * gridDim.x < tiles; k += kConsumers) {
    const int t = blockIdx.x + k * gridDim.x;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 32; ++e) tot[r][e] = 0.0f;
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 32; ++e) part[r][e] = 0.0f;
      for (int i = 0; i < chunks; ++i, ++n) {
        const int s = n % kStages;
        mbar_wait(full0 + 8 * (wg * kStages + s), (n / kStages) & 1);
        warpgroup_sync(wg);  // the planes' last readers (wgmma, the epilogue) are done
        // Split the stage into hi and lo planes: pixel q/4, channels 4(q%4)..+3.
        const float4* raw = reinterpret_cast<const float4*>(ring + s * kStageBytes);
        for (int q = ct; q < 2 * kInCols * kKc / 4; q += 128) {
          const float4 v = raw[q];
          uint4 hi, lo;
          split_tf32(v.x, hi.x, lo.x);
          split_tf32(v.y, hi.y, lo.y);
          split_tf32(v.z, hi.z, lo.z);
          split_tf32(v.w, hi.w, lo.w);
          unsigned char* dst = planes + (q & 3) * kPlane + (q >> 2) * 16;
          *reinterpret_cast<uint4*>(dst) = hi;
          *reinterpret_cast<uint4*>(dst + 4 * kPlane) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // planes -> wgmma
        warpgroup_sync(wg);
        if (ct == 0) load_next();  // the slot is read: refill it

        const unsigned char* w_s = w_thread + (3 * dy * steps + 2 * i) * kWStep;
        const int tap_bytes = steps * kWStep;
        if (2 * i + 1 < steps) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            promotion_group<2>(acc, part, w_s + dx * tap_bytes, planes_s + dx * 16, true);
        } else {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            promotion_group<1>(acc, part, w_s + dx * tap_bytes, planes_s + dx * 16, dx == 2);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 32; ++e) tot[r][e] = __fadd_rn(tot[r][e], part[r][e]);
    }

    // Epilogue: pool in registers, stage [32 pooled columns][64 channels] in
    // the planes, copy out 16 bytes a thread.
    warpgroup_sync(wg);  // every warp's wgmmas have read the planes
    float* stage_out = reinterpret_cast<float*>(planes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pc = 4 * j + (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * j + 2 * h;
        const float m = fmaxf(fmaxf(tot[0][e], tot[0][e + 1]), fmaxf(tot[1][e], tot[1][e + 1]));
        stage_out[pc * kOutPitch + 16 * warp + (lane >> 2) + 8 * h] =
            fmaxf(__fadd_rn(m, bi[h]), 0.0f);
      }
    }
    warpgroup_sync(wg);
    const int seg = t % segs;
    const int prow = (t / segs) % pairs;
    const int b = t / segs / pairs;
    const int pieces = Co >> 2;  // 16-byte pieces per pooled pixel
    for (int idx = ct; idx < kCols / 2 * pieces; idx += 128) {
      const int pc = idx / pieces;
      const int q = idx - pc * pieces;
      const int pcol = seg * (kCols / 2) + pc;
      if (pcol < wo)
        *reinterpret_cast<float4*>(out + (((size_t)b * ho + prow) * wo + pcol) * Co + 4 * q) =
            *reinterpret_cast<const float4*>(stage_out + pc * kOutPitch + 4 * q);
    }
  }
}

}  // namespace

extern "C" {

// y [B, H, W, C] f32 (H, W even; C % 8 == 0, C <= 64), w the layout
// [9, C/8, 128, 4] f32, bias [Co] f32 (Co % 8 == 0, Co <= 64) -> out [B,
// H/2, W/2, Co] f32; `grid` blocks (the host: about one per SM). y, w and
// out 16-byte aligned. Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int aznet_conv1_fused_f32(const void* y, const void* w, const void* bias, int batch, int H,
                          int W, int C, int Co, int grid, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || W % 2 != 0 || C <= 0 || C > kMaxC ||
      C % 8 != 0 || Co <= 0 || Co > kM || Co % 8 != 0 || grid <= 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch * (H / 2) * ((W + kCols - 1) / kCols);
  if (tiles > 0x7fffffffLL - kConsumers * (long long)grid || grid > tiles)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      conv1_fused_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap y_map = {};
  const int map_err = nhwc_map(&y_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, batch, H, W, C,
                               kKc, kInCols, 2);
  if (map_err != 0) return map_err;
  conv1_fused_f32_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      y_map, (const float*)w, (const float*)bias, H, W, Co, C / 8, (int)tiles, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

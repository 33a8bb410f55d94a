// VGG-16 conv1_2 + bias + ReLU + 2x2/2 max-pool (pool1) fused, bf16, for
// Hopper (sm_90a): y [B, H, W, C] bf16 (conv1_1's ReLU output, NHWC) ->
// out [B, H/2, W/2, Co] bf16.
//
// Replaces aznet_tpu/ops/pallas/conv1_kernel.py::fused_conv1_pool (its
// _kernel / _fused_impl; conv1_1 stays outside, as there). The TPU kernel's
// 128-lane channel padding, 8-row strips and strip DMA exist for Mosaic's
// alignment rules and are not carried: y is compact NHWC and the kernel
// zero-fills the taps outside the image.
//
// Computation: an implicit GEMM on the bf16 tensor cores (mma.sync
// m16n8k16, f32 accumulation) over a tile of 2 output rows (one pool
// window) x 64 output columns (M = 128 pixels) x 64 output channels (N),
// K = 9 taps x C. For each chunk of 16 input channels the block stages in
// shared memory the input patch (4 rows x 66 columns) and the weight chunk
// (9 taps x 64 output channels x 16 channels, from the [9, Co, C] layout the
// host packs: k-contiguous per output channel, as the mma B operand wants).
// 8 warps: warp (mw, nw) owns columns mw*16..+15 of BOTH rows and output
// channels nw*32..+31, so a pool window's two rows sit in one thread and its
// two columns in lanes 4 apart (one __shfl_xor_sync). Staged rows are padded
// from 32 to 48 bytes, so the fragment loads are free of bank conflicts.
// This is the tile of conv_int8.cu with the element type changed: 16 bf16
// channels fill the 32 bytes that 32 int8 channels filled there, and the
// m16n8k16 bf16 fragments sit at the same byte offsets as m16n8k32 s8's.
//
// Epilogue (the build has --fmad=false): y = max(acc + bias[co], 0) in f32,
// the bias added before any rounding; the max over the 2x2 window; one
// rounding to bf16 (__float2bfloat16_rn, monotone, so pooling before or
// after it is the same). The f32 sum inside mma runs in another order than
// the plain version's nine f32 tap products, so the two agree to about one
// bf16 ulp, not bit for bit.
//
// What bounds it on this card: at VGG-16's conv1_2 (C = Co = 64, b = 2,
// 608 x 800) 71.7 GFLOP against 155 MB of device memory traffic: compute
// (72 us at 989 TFLOP/s) over bytes (46 us at 3.35 TB/s). mma.sync reaches a
// fraction of the wgmma peak, and the design has one buffer, two
// __syncthreads per 16-channel chunk and no copy/compute overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;         // output rows per block (one pool window)
constexpr int kCols = 64;        // output columns per block
constexpr int kCoTile = 64;      // output channels per block
constexpr int kKc = 16;          // input channels per staged chunk (= mma K)
constexpr int kPitch = 48;       // bytes per staged pixel / weight row (32 of data)
constexpr int kInRows = kRows + 2;
constexpr int kInCols = kCols + 2;
constexpr int kThreads = 256;    // 8 warps: 4 (columns) x 2 (channels)
constexpr int kInBytes = kInRows * kInCols * kPitch;
constexpr int kWBytes = 9 * kCoTile * kPitch;
constexpr int kSmemBytes = kInBytes + kWBytes;  // 40,320 bytes

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// y [B, H, W, C] bf16; w [9, Co, C] bf16; bias [Co] f32 -> out [B, H/2, W/2,
// Co] bf16. Grid: (ceil(W / 64), H / 2, B * ceil(Co / 64)).
__global__ void __launch_bounds__(kThreads)
conv1_fused_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, int H, int W, int C, int Co,
                   int co_tiles, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  unsigned char* s_in = smem;
  unsigned char* s_wt = smem + kInBytes;

  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z - b * co_tiles) * kCoTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: pixel row of the fragment
  const int t = lane & 3;   // thread in group: k pair / output column pair
  const int mw = warp & 3;
  const int nw = warp >> 2;
  const int co_w = co0 + nw * 32;  // first output channel of this warp

  float acc[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[r][n][f] = 0.0f;

  const __nv_bfloat16* yb = y + (size_t)b * H * W * C;
  for (int kc = 0; kc < C; kc += kKc) {
    // Input patch: rows row0-1 .. row0+2, columns col0-1 .. col0+64,
    // channels kc .. kc+15, in 8-byte units (4 channels); zero outside.
    for (int i = tid; i < kInRows * kInCols * 4; i += kThreads) {
      const int q = i & 3;
      const int pix = i >> 2;
      const int r = pix / kInCols;
      const int c = pix - r * kInCols;
      const int gr = row0 - 1 + r;
      const int gc = col0 - 1 + c;
      uint2 v = make_uint2(0u, 0u);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        v = *reinterpret_cast<const uint2*>(yb + ((size_t)gr * W + gc) * C + kc + q * 4);
      *reinterpret_cast<uint2*>(s_in + pix * kPitch + q * 8) = v;
    }
    // Weight chunk: 9 taps x 64 output channels x 16 channels, 16-byte units.
    for (int i = tid; i < 9 * kCoTile * 2; i += kThreads) {
      const int h = i & 1;
      const int row = i >> 1;  // tap * kCoTile + n
      const int tap = row / kCoTile;
      const int co = co0 + row - tap * kCoTile;
      int4 v = make_int4(0, 0, 0, 0);
      if (co < Co)
        v = *reinterpret_cast<const int4*>(w + ((size_t)tap * Co + co) * C + kc + h * 8);
      *reinterpret_cast<int4*>(s_wt + row * kPitch + h * 16) = v;
    }
    __syncthreads();

    if (co_w < Co) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap - dy * 3;
        uint32_t a[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // m16 tile r: output row r, columns mw*16 + g (fragment rows 0-7)
          // and mw*16 + g + 8 (rows 8-15); k = 2t, 2t+1 and 2t+8, 2t+9.
          const unsigned char* p0 =
              s_in + ((r + dy) * kInCols + mw * 16 + g + dx) * kPitch + t * 4;
          const unsigned char* p1 = p0 + 8 * kPitch;
          a[r][0] = lds32(p0);
          a[r][1] = lds32(p1);
          a[r][2] = lds32(p0 + 16);
          a[r][3] = lds32(p1 + 16);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (co_w + n * 8 >= Co) break;  // warp-uniform: Co % 16 == 0
          const unsigned char* pb =
              s_wt + (tap * kCoTile + nw * 32 + n * 8 + g) * kPitch + t * 4;
          const uint32_t b0 = lds32(pb);
          const uint32_t b1 = lds32(pb + 16);
          mma_bf16(acc[0][n], a[0], b0, b1);
          mma_bf16(acc[1][n], a[1], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue. Fragment f of tile (r, n): pixel column mw*16 + g + (f >= 2 ?
  // 8 : 0) of row r, output channel co_w + n*8 + 2t + (f & 1).
  const int ho = H >> 1;
  const int wo = W >> 1;
  const int prow = row0 >> 1;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int co = co_w + n * 8 + 2 * t;
    if (co_w + n * 8 >= Co) break;  // warp-uniform, so the shuffle below is safe
    const float bi0 = bias[co];
    const float bi1 = bias[co + 1];
    float p[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float bi = (f & 1) ? bi1 : bi0;
      const float v = fmaxf(fmaxf(__fadd_rn(acc[0][n][f], bi), 0.0f),
                            fmaxf(__fadd_rn(acc[1][n][f], bi), 0.0f));  // the two rows
      p[f] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));            // columns g, g^1
    }
    if ((g & 1) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pcol = (col0 + mw * 16 + g + half * 8) >> 1;
        if (pcol < wo) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(p[2 * half]);
          v.y = __float2bfloat16_rn(p[2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              out + (((size_t)b * ho + prow) * wo + pcol) * Co + co) = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// y [B, H, W, C] bf16 (H, W even), w [9, Co, C] bf16 (tap = dy*3 + dx),
// bias [Co] f32 -> out [B, H/2, W/2, Co] bf16. C and Co multiples of 16.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int aznet_conv1_fused(const void* y, const void* w, const void* bias, int batch, int H,
                      int W, int C, int Co, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % kKc != 0 ||
      Co % 16 != 0 || H % 2 != 0 || W % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int co_tiles = (Co + kCoTile - 1) / kCoTile;
  const dim3 grid((W + kCols - 1) / kCols, H / kRows, batch * co_tiles);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  conv1_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)y, (const __nv_bfloat16*)w, (const float*)bias, H, W, C, Co,
      co_tiles, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

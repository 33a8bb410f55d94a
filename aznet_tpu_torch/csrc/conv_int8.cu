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
// the kernel zero-fills the taps outside the image with predicated loads.
//
// Computation, per block: an implicit GEMM over a tile of 2 output rows x 32
// output columns (M = 64 pixels) x 128 output channels (N), K = 9 taps x C.
// For each chunk of 32 input channels the block stages in shared memory
//   * the input patch: 4 rows x 34 columns (the tile plus a 1-pixel border),
//   * the weight chunk: 9 taps x 128 output channels x 32 channels, from the
//     [9, Co, Cp] layout the host packs at build time (k-contiguous per
//     output channel, as the mma B operand wants it),
// and 8 warps run mma.sync m16n8k32 s8.s8.s32: warp (mw, nw) owns columns
// mw*16..+15 of BOTH rows and output channels nw*32..+31, so the two rows of
// a pool window sit in one thread and the two columns in lanes 4 apart.
// Each staged pixel and weight row is padded from 32 to 48 bytes, which makes
// the fragment loads free of shared-memory bank conflicts.
//
// Epilogue, rounded as the reference (the build has --fmad=false and every
// f32 step is spelled with a _rn intrinsic):
//   y = relu(float(acc) * (f32(s_x) * s_w[co]) + bias[co])
//   pool: max over the 2x2 window of y (requantization is monotone, so this
//         equals pooling the int8 codes);
//   int8: clip(__float2int_rn(y * inv_s_out), -127, 127), half to even,
//         inv_s_out = float32(1.0 / s_out) computed in double on the host;
//   bf16: __float2bfloat16_rn(y) (the trunk's exit, conv5_3).
//
// What bounds it on this card: at VGG widths (C, Co in 128..512) the int8
// tensor-core work is 2*9*C*Co MACs per pixel; the staged weight chunk is
// re-read from L2 by every block (9*C*128 bytes per 64 pixels), which at
// C = 512 is ~9 KB of L2 traffic per output pixel and the likely limit, with
// two __syncthreads per 32-channel chunk and no copy/compute overlap. The
// design keeps it simple and exact: one buffer, plain 8/16-byte loads, no
// TMA, wgmma or warp specialisation (work for a later change).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;         // output rows per block (one pool window)
constexpr int kCols = 32;        // output columns per block
constexpr int kCoTile = 128;     // output channels per block
constexpr int kKc = 32;          // input channels per staged chunk (= mma K)
constexpr int kPitch = kKc + 16; // bytes per staged pixel / weight row
constexpr int kInRows = kRows + 2;
constexpr int kInCols = kCols + 2;
constexpr int kThreads = 256;    // 8 warps: 2 (columns) x 4 (channels)
constexpr int kInBytes = kInRows * kInCols * kPitch;
constexpr int kWBytes = 9 * kCoTile * kPitch;
constexpr int kSmemBytes = kInBytes + kWBytes;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int8_t requant(float y, float inv_s_out) {
  int q = __float2int_rn(__fmul_rn(y, inv_s_out));
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return (int8_t)q;
}

// x [B, H, W, C] int8; w [9, Co, Cp] int8; s_w, bias [Co] f32.
// out: kPool -> int8 [B, H/2, W/2, Co]; else int8 or (kBf16) bf16 [B, H, W, Co].
// Grid: (ceil(W / 32), ceil(H / 2), B * ceil(Co / 128)).
template <bool kPool, bool kBf16>
__global__ void __launch_bounds__(kThreads)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s_w,
                    const float* __restrict__ bias, int H, int W, int C,
                    int Cp, int Co, int co_tiles, float s_x, float inv_s_out,
                    void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int t = lane & 3;   // thread in group: k quad / output column pair
  const int mw = warp & 1;
  const int nw = warp >> 1;
  const int co_w = co0 + nw * 32;  // first output channel of this warp

  int acc[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[r][n][f] = 0;

  const int8_t* xb = x + (size_t)b * H * W * C;
  for (int kc = 0; kc < Cp; kc += kKc) {
    // Input patch: rows row0-1 .. row0+2, columns col0-1 .. col0+32,
    // channels kc .. kc+31, in 8-byte units; zero outside the image and C.
    for (int i = tid; i < kInRows * kInCols * 4; i += kThreads) {
      const int q = i & 3;
      const int pix = i >> 2;
      const int r = pix / kInCols;
      const int c = pix - r * kInCols;
      const int gr = row0 - 1 + r;
      const int gc = col0 - 1 + c;
      const int ch = kc + q * 8;
      uint2 v = make_uint2(0u, 0u);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && ch < C)
        v = *reinterpret_cast<const uint2*>(xb + ((size_t)gr * W + gc) * C + ch);
      *reinterpret_cast<uint2*>(s_in + pix * kPitch + q * 8) = v;
    }
    // Weight chunk: 9 taps x 128 output channels x 32 channels, 16-byte units.
    for (int i = tid; i < 9 * kCoTile * 2; i += kThreads) {
      const int h = i & 1;
      const int row = i >> 1;  // tap * kCoTile + n
      const int tap = row / kCoTile;
      const int co = co0 + row - tap * kCoTile;
      int4 v = make_int4(0, 0, 0, 0);
      if (co < Co)
        v = *reinterpret_cast<const int4*>(w + ((size_t)tap * Co + co) * Cp + kc + h * 16);
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
          // m16 tile r: output row r, columns mw*16 + g (frag rows 0-7) and
          // mw*16 + g + 8 (frag rows 8-15); k = t*4.. and 16 + t*4..
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
          if (co_w + n * 8 >= Co) break;  // warp-uniform: Co % 8 == 0
          const unsigned char* pb =
              s_wt + (tap * kCoTile + nw * 32 + n * 8 + g) * kPitch + t * 4;
          const uint32_t b0 = lds32(pb);
          const uint32_t b1 = lds32(pb + 16);
          mma_s8(acc[0][n], a[0], b0, b1);
          mma_s8(acc[1][n], a[1], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue. Fragment f of tile (r, n): pixel column mw*16 + g + (f >= 2 ? 8
  // : 0) of row r, output channel co_w + n*8 + 2t + (f & 1).
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int co = co_w + n * 8 + 2 * t;
    if (co_w + n * 8 >= Co) break;  // warp-uniform, so the shuffle below is safe
    const float sc0 = __fmul_rn(s_x, s_w[co]);
    const float sc1 = __fmul_rn(s_x, s_w[co + 1]);
    const float bi0 = bias[co];
    const float bi1 = bias[co + 1];
    float y[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[r][n][f]), (f & 1) ? sc1 : sc0),
                                  (f & 1) ? bi1 : bi0);
        y[r][f] = fmaxf(v, 0.0f);
      }
    if (kPool) {
      const int ho = H >> 1;
      const int wo = W >> 1;
      const int prow = row0 >> 1;
      float p[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float v = fmaxf(y[0][f], y[1][f]);            // the two rows
        p[f] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));  // columns g, g^1
      }
      if ((g & 1) == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pcol = (col0 + mw * 16 + g + half * 8) >> 1;
          if (pcol < wo && prow < ho) {
            char2 q;
            q.x = requant(p[2 * half], inv_s_out);
            q.y = requant(p[2 * half + 1], inv_s_out);
            int8_t* o = reinterpret_cast<int8_t*>(out);
            *reinterpret_cast<char2*>(o + (((size_t)b * ho + prow) * wo + pcol) * Co + co) = q;
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = col0 + mw * 16 + g + half * 8;
          if (row >= H || col >= W) continue;
          const size_t off = (((size_t)b * H + row) * W + col) * Co + co;
          if (kBf16) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16_rn(y[r][2 * half]);
            v.y = __float2bfloat16_rn(y[r][2 * half + 1]);
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + off) = v;
          } else {
            char2 q;
            q.x = requant(y[r][2 * half], inv_s_out);
            q.y = requant(y[r][2 * half + 1], inv_s_out);
            *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(out) + off) = q;
          }
        }
      }
    }
  }
}

template <bool kPool, bool kBf16>
int launch(const void* x, const void* w, const void* s_w, const void* bias,
           int batch, int H, int W, int C, int Cp, int Co, float s_x,
           float inv_s_out, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 ||
      Co % 8 != 0 || Cp % kKc != 0 || Cp < C || Cp - C >= kKc)
    return (int)cudaErrorInvalidValue;
  if (kPool && (H % 2 != 0 || W % 2 != 0)) return (int)cudaErrorInvalidValue;
  const int co_tiles = (Co + kCoTile - 1) / kCoTile;
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, batch * co_tiles);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_int8_kernel<kPool, kBf16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)s_w,
      (const float*)bias, H, W, C, Cp, Co, co_tiles, s_x, inv_s_out, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Chain entry: conv + ReLU + fused 2x2/2 max-pool, requantized to int8.
// x [B, H, W, C] int8 (H, W even), w [9, Co, Cp] int8 (Cp = C rounded up to
// 32, zero-padded), s_w/bias [Co] f32 -> out [B, H/2, W/2, Co] int8.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int aznet_conv3x3_int8_chain(const void* x, const void* w, const void* s_w,
                             const void* bias, int batch, int H, int W, int C,
                             int Cp, int Co, float s_x, float inv_s_out,
                             void* out, void* stream) {
  return launch<true, false>(x, w, s_w, bias, batch, H, W, C, Cp, Co, s_x,
                             inv_s_out, out, stream);
}

// Strip entry: conv + ReLU, no pool -> out [B, H, W, Co], int8 requantized
// at inv_s_out, or bf16 when out_bf16 != 0 (inv_s_out unused).
int aznet_conv3x3_int8_strip(const void* x, const void* w, const void* s_w,
                             const void* bias, int batch, int H, int W, int C,
                             int Cp, int Co, float s_x, float inv_s_out,
                             int out_bf16, void* out, void* stream) {
  if (out_bf16)
    return launch<false, true>(x, w, s_w, bias, batch, H, W, C, Cp, Co, s_x,
                               inv_s_out, out, stream);
  return launch<false, false>(x, w, s_w, bias, batch, H, W, C, Cp, Co, s_x,
                              inv_s_out, out, stream);
}

}  // extern "C"

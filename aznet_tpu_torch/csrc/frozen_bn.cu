// Frozen BatchNorm's epilogue after a ResNet convolution, for Hopper (sm_90a):
// the per-channel affine, the residual add and the ReLU in one pass over a
// channels-last activation, written back into the convolution's output.
//
// Replaces no TPU kernel: XLA fuses the JAX package's FrozenBN
// (aznet_tpu/models/resnet.py) into its convolutions' epilogues. Eager PyTorch
// ran the same arithmetic as two to six elementwise kernels after each conv
// (139 a ResNet-50 trunk call); this is one launch after each (40).
//
// Three forms (Form below), each relu(...) of:
//   kAffineRelu           y*s + b                    (bn1, bn2, the stem)
//   kAffineAddRelu        (y*s + b) + r              (bn3 plus the block input)
//   kAffineAffineAddRelu  (y*s + b) + (r*sr + br)    (bn3 plus the downsample's)
// with y [rows, C], r [rows, C] and s, b, sr, br [C], all in one dtype
// (bf16 or float32), C a multiple of 8.
//
// The numbers are PyTorch's own, bit for bit: each step is one PyTorch
// operation of the plain version (ops/frozen_bn.py::frozen_bn_relu_reference),
// which computes in float32 and, in bf16, rounds to bf16 after each: bf16(x*s),
// bf16(. + b), bf16(. + r), each float step spelled __fmul_rn / __fadd_rn (the
// library is built with --fmad=false and without fast math, so none is
// contracted into an FMA and subnormals stay). The rounding to bf16 is
// cvt.rn.bf16x2.f32, the instruction c10::BFloat16(float) uses on sm_80+.
// ReLU is torch.relu's clamp_min(v, 0): NaN passes as it is, else
// fmaxf(v, 0). In float32 the same steps run without the roundings to bf16.
//
// What bounds it on the card: bytes. A form reads y (and r) and writes y: two
// or three elements moved for each one computed, with 2 to 7 float operations,
// under one operation a byte, far from the card's 20 float32 operations a
// byte. At batch 4 on a 1088x1920 canvas a trunk call's 40 launches move
// 7.79 GB in bf16, 2.32 ms at 3.35 TB/s.
// The design:
// - One thread handles 16 bytes at a time (8 bf16 or 4 float32 channels), a
//   load and a store of 16 bytes each; consecutive threads take consecutive
//   16-byte vectors, so a warp reads 512 contiguous bytes.
// - A grid-stride loop whose stride is a multiple of the C/8 (bf16) or C/4
//   vectors of a row: a thread's vectors all hold the same channels, so it
//   loads its channels' scales and biases once, into registers (as loaded:
//   in bf16 two a register), and its loop reads nothing but y and r.
// - Each trip issues the loads of kUnroll vectors before it computes, so
//   enough bytes are in flight to cover the memory's latency with a few
//   blocks an SM (the host sizes the grid: ops/cuda/frozen_bn_kernel.py).
// - The result goes back into y: the conv output is read once and written
//   once, and no new buffer is allocated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread (per input)

enum Form : int { kAffineRelu = 0, kAffineAddRelu = 1, kAffineAffineAddRelu = 2 };

struct alignas(16) Vec {
  uint32_t w[4];
};

// A 16-byte vector as pairs of float values, and back; round() rounds a pair
// to the type and widens it again (exactly).
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int kPerVec = 4;
  __device__ static float2 get(const Vec& v, int p) {
    return make_float2(__uint_as_float(v.w[2 * p]), __uint_as_float(v.w[2 * p + 1]));
  }
  __device__ static void put(Vec& v, int p, float2 f) {
    v.w[2 * p] = __float_as_uint(f.x);
    v.w[2 * p + 1] = __float_as_uint(f.y);
  }
  __device__ static float2 round(float2 f) { return f; }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ static float2 widen(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  __device__ static uint32_t narrow(float2 f) {  // .x in the low half, as in memory
    __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static float2 get(const Vec& v, int p) { return widen(v.w[p]); }
  __device__ static void put(Vec& v, int p, float2 f) { v.w[p] = narrow(f); }
  __device__ static float2 round(float2 f) { return widen(narrow(f)); }
};

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// One pair of channels: the form's PyTorch operations, each rounded to T.
template <typename T, int kForm>
__device__ __forceinline__ float2 epilogue(float2 y, float2 s, float2 b, float2 r, float2 sr,
                                           float2 br) {
  using L = Lanes<T>;
  float2 v = L::round(add2(L::round(mul2(y, s)), b));
  if (kForm == kAffineAffineAddRelu) r = L::round(add2(L::round(mul2(r, sr)), br));
  if (kForm != kAffineRelu) v = L::round(add2(v, r));
  return make_float2(relu(v.x), relu(v.y));
}

// y, r: `total` 16-byte vectors, `vecs_per_row` of them a row of C channels.
// Threads at or past `stride` (the grid's threads rounded down to whole rows)
// have no work.
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
frozen_bn_epilogue(T* y, const T* __restrict__ s, const T* __restrict__ b,
                   const T* __restrict__ r, const T* __restrict__ sr, const T* __restrict__ br,
                   long long total, int vecs_per_row, long long stride) {
  using L = Lanes<T>;
  constexpr int kPairs = L::kPerVec / 2;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= stride) return;
  // This thread's channels' scales and biases, kept as loaded (bf16 pairs
  // take half the registers of floats) and widened where used.
  const int c0 = (int)(t % vecs_per_row) * L::kPerVec;
  const Vec s_v = *reinterpret_cast<const Vec*>(s + c0);
  const Vec b_v = *reinterpret_cast<const Vec*>(b + c0);
  Vec sr_v = s_v, br_v = b_v;
  if (kForm == kAffineAffineAddRelu) {
    sr_v = *reinterpret_cast<const Vec*>(sr + c0);
    br_v = *reinterpret_cast<const Vec*>(br + c0);
  }
  Vec* yv = reinterpret_cast<Vec*>(y);
  const Vec* rv = reinterpret_cast<const Vec*>(r);
  for (long long i = t; i < total; i += kUnroll * stride) {
    Vec ya[kUnroll], ra[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      if (j < total) {
        ya[k] = yv[j];
        if (kForm != kAffineRelu) ra[k] = rv[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      if (j < total) {
        Vec out;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const float2 rp = kForm != kAffineRelu ? L::get(ra[k], p) : make_float2(0.f, 0.f);
          L::put(out, p, epilogue<T, kForm>(L::get(ya[k], p), L::get(s_v, p), L::get(b_v, p), rp,
                                            L::get(sr_v, p), L::get(br_v, p)));
        }
        yv[j] = out;
      }
    }
  }
}

template <typename T>
cudaError_t launch(int form, void* y, const void* s, const void* b, const void* r,
                   const void* sr, const void* br, long long total, int vecs_per_row,
                   int blocks, long long stride, cudaStream_t stream) {
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>((T*)y, (const T*)s, (const T*)b, (const T*)r,
                                            (const T*)sr, (const T*)br, total, vecs_per_row,
                                            stride);
  };
  if (form == kAffineRelu) {
    go(frozen_bn_epilogue<T, kAffineRelu>);
  } else if (form == kAffineAddRelu) {
    go(frozen_bn_epilogue<T, kAffineAddRelu>);
  } else {
    go(frozen_bn_epilogue<T, kAffineAffineAddRelu>);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// relu of the form's sum, written into y. dtype: 0 bf16, 1 float32. y and r
// [rows, channels] with channels contiguous; s, b, sr, br [channels]; r is
// read by forms 1 and 2, sr and br by form 2 (others may be null). Every
// pointer read 16-byte aligned, channels a multiple of 8, rows >= 1; `sms`
// the device's SM count. Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int aznet_frozen_bn_launch(int dtype, int form, void* y, const void* r, const void* s,
                           const void* b, const void* sr, const void* br, long long rows,
                           int channels, int sms, void* stream) {
  uintptr_t addr = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(s) |
                   reinterpret_cast<uintptr_t>(b);
  if (form != kAffineRelu) addr |= reinterpret_cast<uintptr_t>(r);
  if (form == kAffineAffineAddRelu) {
    addr |= reinterpret_cast<uintptr_t>(sr) | reinterpret_cast<uintptr_t>(br);
  }
  const bool ptrs = y && s && b && (form == kAffineRelu || r) &&
                    (form != kAffineAffineAddRelu || (sr && br));
  if ((dtype != 0 && dtype != 1) || form < kAffineRelu || form > kAffineAffineAddRelu ||
      !ptrs || (addr & 15) || rows < 1 || channels < 8 || channels % 8 || sms < 1 ||
      rows > INT64_MAX / channels) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_vec = dtype == 0 ? Lanes<__nv_bfloat16>::kPerVec : Lanes<float>::kPerVec;
  const int vecs_per_row = channels / per_vec;
  const long long total = rows * vecs_per_row;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (long long)sms * kBlocksPerSm ? want : sms * kBlocksPerSm);
  // The grid's threads rounded down to whole rows: at least one row, since an
  // uncapped grid covers all `total` >= vecs_per_row vectors and a capped one
  // holds sms * 1024 threads, more than a row of any C under a million.
  const long long stride = (long long)blocks * kThreads / vecs_per_row * vecs_per_row;
  if (stride < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch<__nv_bfloat16>(form, y, s, b, r, sr, br, total, vecs_per_row,
                                                  blocks, stride, st)
                          : launch<float>(form, y, s, b, r, sr, br, total, vecs_per_row,
                                          blocks, stride, st));
}

}  // extern "C"

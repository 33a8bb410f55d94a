// Exact greedy NMS for Hopper (sm_90a): B independent streams of N boxes.
//
// Replaces aznet_tpu/ops/pallas/nms_kernel.py::nms_pallas_batched (the
// bitonic-order path: _bitonic_sort6 -> _nms_kernel_nosub -> the bitonic
// unpermute). Same contract, bit for bit:
//   * order is score-descending with ties to the lower index; the score is
//     mapped to an integer key that folds +-0 and every subnormal into the
//     +0 key (_intkey_u32 in the Pallas file);
//   * a row is invalid when valid[] is false or its score is -inf; invalid
//     rows sort last, are never kept and never suppress;
//   * box i is suppressed when IoU > thresh against an earlier kept box;
//     widths carry +offset and IoU is 0 when the union is <= 0.
//
// Three kernels, launched back to back on the caller's stream:
//   1. sort_kernel: the stable order of the folded keys by counting, one
//      block per 64 rows of a stream (n_pad padded to a power of two): a
//      row's position is the number of rows with a smaller (key, index), 8
//      threads a pair of rows over the stream's keys in shared memory, so
//      one stream spreads over n_pad / 64 SMs (a bitonic network in one
//      block, in registers and shuffles with 20 barriers at 2048, took 15.5
//      us at 1 x 2048 on the H100). Each row then writes its index and box
//      to its position.
//   2. mask_kernel: one block per 64 x 64 tile of the upper triangle (a
//      linear block index mapped to (row tile, column tile)), 4 threads a
//      row, 16 IoUs a thread (columns q, q + 4, ..., so the 4 lanes of a row
//      read 4 adjacent boxes), the row's word ORed across the 4 lanes. Bit j
//      of word (i, tile) is set when the IoU of sorted boxes i and j exceeds
//      the threshold; diagonal words hold both sides (the IoU is symmetric
//      bit for bit), the others only the later boxes.
//   3. scan_kernel: one block per stream, the greedy pass over 64-row word
//      blocks. Block wb's 64 rows (contiguous in the mask) arrive by one bulk
//      copy into a shared-memory ring under mbarriers, several blocks ahead.
//      Per word block, three roles run side by side between two barriers:
//      warp 0 resolves block wb: the kept set is the fixpoint of keep = cand
//      & ~(suppressors & keep), one pair of ballots an iteration (as many as
//      the longest suppression chain inside the block, plus one), from the
//      diagonal words in registers, where cand = valid & ~removed; it ORs the
//      kept rows' next words itself (the carry into block wb+1). Warp 1
//      loads the diagonal and next columns of block wb+2 from global memory
//      (L2) into registers and stores block wb+1's for warp 0 (read from the
//      ring, a column would stride the banks). The other warps OR block
//      wb-1's kept rows into the later words of `removed`, 16 rows a thread
//      into 4 partial words (no atomics; all 16 loads issued before the ORs);
//      the block's last thread waits for the ring's next block and issues the
//      copies. Keep flags go straight to the boxes' original slots at the
//      end, so no unpermute pass.
//
// Above N = 8192 (n_pad 16384 .. 65536) the shared-memory arithmetic of
// passes 1 and 3 no longer fits a block (the keys are 4 bytes a row, one
// 64-row stage of the ring 64 x n_pad / 8 bytes), so a second route takes
// those sizes, picked by n_pad on the host side of this file:
//   1. sort_kernel_large: the same counting, over the stream's keys in
//      chunks of kChunk keys staged through shared memory (the block's 64
//      rows lie inside one chunk, since kChunk is a multiple of 64);
//   2. mask_kernel, as above (nothing in it is sized by N);
//   3. scan_kernel_large: the same three roles without the ring: warp 1
//      loads the diagonal and next columns from global memory as before,
//      and the OR threads load only the kept rows of block wb-1 at the
//      words right of block wb, straight from global memory, 16 rows of a
//      word a thread with their loads in flight together.
// No speed is claimed for this route: the scan is one block per stream and
// reads N * N / 16 bytes of mask through one SM.
//
// What bounds it on the card: the mask pass's IoUs (N*N/2 per stream, an
// f32 division for each pair that overlaps) and the scan's serial chain
// over N/64 word blocks per stream; at one stream the card is nearly idle,
// so latency and the launches. The design spreads the sort over the card,
// takes the mask off idle blocks and long threads, and the scan's chain off
// global memory (the ring) and off a one-row-a-step loop.
//
// Exactness: compile without --use_fast_math (subnormal flush and
// approximate division would move IoUs at the threshold) and with
// --fmad=false; the IoU arithmetic below also spells out every rounding
// with __f*_rn intrinsics, so (area_i + area_j) - inter is never contracted
// into an FMA, matching the reference's separate multiply and subtract.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kMaxN = 8192;                   // the shared-memory route's largest n_pad
constexpr int kMaxNLarge = 65536;             // the large route's
constexpr int kTile = 64;
constexpr int kMaxWords = kMaxN / kTile;
constexpr int kMaxWordsLarge = kMaxNLarge / kTile;
constexpr int kChunk = 8192;                  // keys a chunk of sort_kernel_large (32 KB)
constexpr int kRowThreads = 4;                // mask threads a row: 16 columns each
constexpr int kRankParts = 8;                 // sort threads a pair of rows
constexpr int kScanThreads = 512;             // warp 0 resolves, warp 1 feeds, the rest OR
constexpr int kGroups = 4;                    // row groups of the OR (16 rows each)
constexpr int kOrWords = (kScanThreads - 64) / kGroups;  // words a group's threads take at once
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 200 * 1024;        // >= 3 stages at N = 8192
constexpr uint32_t kKeyNegInf = 0xFF800000u;  // folded key of -inf

// uint32 key whose ascending order is score-descending (_intkey_u32).
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7F800000u) == 0u) u = 0u;  // +-0 and subnormals: one key
  uint32_t sign = u >> 31;
  uint32_t key = u ^ (sign * 0x7FFFFFFFu + 0x80000000u);
  return ~key;
}

__device__ __forceinline__ float box_area(float4 b, float offset) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), offset),
                   __fadd_rn(__fsub_rn(b.w, b.y), offset));
}

__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 c,
                                          float area_c, float offset,
                                          float thresh) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), offset);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), offset);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  // Divide only where the quotient can be other than +-0: disjoint boxes
  // (inter = 0, most pairs) skip the division and compare 0 as it would.
  float iou = uni > 0.0f && inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thresh;
}

__device__ __forceinline__ u64 lds64(const u64* p) {
  u64 v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

// Scratch of one call, in this order: mask [B, n_pad, n_pad / 64] u64,
// sorted_boxes [B, n_pad] float4, sorted_idx [B, n_pad] i32 (the row's
// index, its one's complement for an invalid row), each piece a multiple
// of 16 bytes.
struct Scratch {
  u64* mask;
  float4* boxes;
  int32_t* idx;
};

inline Scratch carve(void* base, int batch, int n_pad) {
  const size_t words = (size_t)batch * n_pad / kTile;
  char* p = (char*)base;
  Scratch s;
  s.mask = (u64*)p;
  p += words * n_pad * sizeof(u64);
  s.boxes = (float4*)p;
  p += (size_t)batch * n_pad * sizeof(float4);
  s.idx = (int32_t*)p;
  return s;
}

// The sorted position of every row, by counting: row i's rank is the
// number of rows whose (key, index) is smaller, i.e. key_j < key_i, or key_j
// == key_i and j < i: the stable order of the folded keys. Block (tile, b)
// ranks rows 64 tile .. + 63 of stream b: thread (pair, part) ranks rows
// 64 tile + pair and + 32 over every 8th group of 4 keys (one 16-byte load
// compared with both rows), summed across the 8 parts' lanes. Rows j below
// the tile all come before i (key_j <= key_i counts), rows above after
// (key_j < key_i); only the tile itself needs the index. Padding rows (i >=
// n) take the key of -inf and rank after every real row. Then row i goes to
// its position: its index (one's complement when the row is invalid, so
// the scan needs no other flag) and its box.
__global__ void __launch_bounds__(kTile * kRankParts / 2)
sort_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
            const uint8_t* __restrict__ valid, int n, int n_pad, Scratch out) {
  extern __shared__ __align__(16) uint32_t keys[];  // n_pad folded keys
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const size_t in_base = (size_t)b * n;
  // All of a thread's loads in flight at once (the valid flag and the score
  // are loaded apart, not one after the other).
  for (int j0 = t; j0 < n_pad; j0 += 8 * blockDim.x) {
    float sc[8];
    uint8_t ok[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * blockDim.x;
      sc[u] = j < n ? scores[in_base + j] : 0.0f;
      ok[u] = j < n ? valid[in_base + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * blockDim.x;  // padding rows sort after every real row
      if (j < n_pad) keys[j] = j < n ? score_key(ok[u] ? sc[u] : -INFINITY) : kKeyNegInf;
    }
  }
  __syncthreads();

  const int i0 = blockIdx.x * kTile;
  const int part = t % kRankParts;
  const int ia = i0 + t / kRankParts;  // and ia + 32
  const uint32_t ka = keys[ia], kb = keys[ia + 32];
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  int ca = 0, cb = 0;
  for (int c = part; c < i0 / 4; c += kRankParts) {  // rows before the tile
    const uint4 v = k4[c];
    ca += (v.x <= ka) + (v.y <= ka) + (v.z <= ka) + (v.w <= ka);
    cb += (v.x <= kb) + (v.y <= kb) + (v.z <= kb) + (v.w <= kb);
  }
  for (int j = i0 + part; j < i0 + kTile; j += kRankParts) {  // the tile
    const uint32_t kj = keys[j];
    ca += kj < ka || (kj == ka && j < ia);
    cb += kj < kb || (kj == kb && j < ia + 32);
  }
  for (int c = (i0 + kTile) / 4 + part; c < n_pad / 4; c += kRankParts) {  // rows after it
    const uint4 v = k4[c];
    ca += (v.x < ka) + (v.y < ka) + (v.z < ka) + (v.w < ka);
    cb += (v.x < kb) + (v.y < kb) + (v.z < kb) + (v.w < kb);
  }
#pragma unroll
  for (int m = 1; m < kRankParts; m <<= 1) {
    ca += __shfl_xor_sync(0xFFFFFFFFu, ca, m);
    cb += __shfl_xor_sync(0xFFFFFFFFu, cb, m);
  }
  if (part < 2) {  // part 0 places row ia, part 1 row ia + 32
    const int i = part ? ia + 32 : ia;
    const uint32_t ki = part ? kb : ka;
    const size_t at = (size_t)b * n_pad + (part ? cb : ca);
    const bool real = i < n;
    out.idx[at] = real && ki != kKeyNegInf ? i : ~i;
    out.boxes[at] = real ? boxes[in_base + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// sort_kernel for n_pad > kMaxN: the same ranks, the stream's keys taken in
// chunks of kChunk through shared memory. Within a chunk the rows before
// the block's tile count with <=, the tile's rows by (key, index), the rows
// after it with <; the tile lies inside one chunk.
__global__ void __launch_bounds__(kTile * kRankParts / 2)
sort_kernel_large(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  const uint8_t* __restrict__ valid, int n, int n_pad, Scratch out) {
  __shared__ __align__(16) uint32_t keys[kChunk];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const size_t in_base = (size_t)b * n;
  auto key_of = [&](int j) {
    return j < n ? score_key(valid[in_base + j] ? scores[in_base + j] : -INFINITY) : kKeyNegInf;
  };
  const int i0 = blockIdx.x * kTile;
  const int part = t % kRankParts;
  const int ia = i0 + t / kRankParts;  // and ia + 32
  const uint32_t ka = key_of(ia), kb = key_of(ia + 32);
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  int ca = 0, cb = 0;
  for (int c0 = 0; c0 < n_pad; c0 += kChunk) {
    for (int j0 = t; j0 < kChunk; j0 += 8 * blockDim.x) {  // kChunk is a multiple of 8 x 256
      float sc[8];
      uint8_t ok[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = c0 + j0 + u * blockDim.x;
        sc[u] = j < n ? scores[in_base + j] : 0.0f;
        ok[u] = j < n ? valid[in_base + j] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = c0 + j0 + u * blockDim.x;
        keys[j0 + u * blockDim.x] = j < n ? score_key(ok[u] ? sc[u] : -INFINITY) : kKeyNegInf;
      }
    }
    __syncthreads();
    const int before = (i0 < c0 + kChunk ? i0 : c0 + kChunk) - c0;  // chunk rows before the tile
    for (int c = part; c < before / 4; c += kRankParts) {
      const uint4 v = k4[c];
      ca += (v.x <= ka) + (v.y <= ka) + (v.z <= ka) + (v.w <= ka);
      cb += (v.x <= kb) + (v.y <= kb) + (v.z <= kb) + (v.w <= kb);
    }
    if (i0 >= c0 && i0 < c0 + kChunk) {  // the tile
      for (int j = i0 + part; j < i0 + kTile; j += kRankParts) {
        const uint32_t kj = keys[j - c0];
        ca += kj < ka || (kj == ka && j < ia);
        cb += kj < kb || (kj == kb && j < ia + 32);
      }
    }
    const int after = (i0 + kTile > c0 ? i0 + kTile : c0) - c0;  // first chunk row after it
    for (int c = after / 4 + part; c < kChunk / 4; c += kRankParts) {
      const uint4 v = k4[c];
      ca += (v.x < ka) + (v.y < ka) + (v.z < ka) + (v.w < ka);
      cb += (v.x < kb) + (v.y < kb) + (v.z < kb) + (v.w < kb);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 1; m < kRankParts; m <<= 1) {
    ca += __shfl_xor_sync(0xFFFFFFFFu, ca, m);
    cb += __shfl_xor_sync(0xFFFFFFFFu, cb, m);
  }
  if (part < 2) {  // part 0 places row ia, part 1 row ia + 32
    const int i = part ? ia + 32 : ia;
    const uint32_t ki = part ? kb : ka;
    const size_t at = (size_t)b * n_pad + (part ? cb : ca);
    const bool real = i < n;
    out.idx[at] = real && ki != kKeyNegInf ? i : ~i;
    out.boxes[at] = real ? boxes[in_base + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Tile (row_tile, col_tile), row_tile <= col_tile, of linear block index
// col_tile * (col_tile + 1) / 2 + row_tile.
__device__ __forceinline__ void triangle_tile(int blk, int& row_tile, int& col_tile) {
  int c = (int)((sqrtf(8.0f * (float)blk + 1.0f) - 1.0f) * 0.5f);
  while (c * (c + 1) / 2 > blk) --c;
  while ((c + 1) * (c + 2) / 2 <= blk) ++c;
  col_tile = c;
  row_tile = blk - c * (c + 1) / 2;
}

__global__ void __launch_bounds__(kTile * kRowThreads)
mask_kernel(const Scratch s, int n_pad, float thresh, float offset) {
  const int n_tiles = n_pad / kTile;
  int row_tile, col_tile;
  triangle_tile(blockIdx.x, row_tile, col_tile);
  const int b = blockIdx.y;
  const float4* base = s.boxes + (size_t)b * n_pad;

  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  if (t < kTile) {
    const float4 c = base[col_tile * kTile + t];
    col_box[t] = c;
    col_area[t] = box_area(c, offset);
  }
  __syncthreads();

  const int rl = t / kRowThreads;  // row in the tile
  const int q = t % kRowThreads;   // this thread's columns: q, q + 4, ...
  const int i = row_tile * kTile + rl;
  const float4 r = base[i];
  const float r_area = box_area(r, offset);
  const int skip = col_tile == row_tile ? rl : kTile;  // a box against itself
  u64 bits = 0;
#pragma unroll 4
  for (int j = q; j < kTile; j += kRowThreads) {
    if (j != skip && iou_above(r, r_area, col_box[j], col_area[j], offset, thresh))
      bits |= 1ull << j;
  }
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 2);
  if (q == 0) s.mask[((size_t)b * n_pad + i) * n_tiles + col_tile] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const Scratch s, int n, int n_pad, int stages, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) u64 ring[];  // stages x 64 rows x n_words
  __shared__ u64 part[kGroups][kMaxWords];      // removed = OR of the 4 partial words
  __shared__ u64 valid_w[kMaxWords];
  __shared__ u64 kept[kMaxWords];
  __shared__ u64 cols[2][2][kTile];  // [block parity][diagonal, next word][row]
  __shared__ __align__(8) u64 full[kMaxStages];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_words = n_pad / kTile;
  const u64* m = s.mask + (size_t)b * n_pad * n_words;

  for (int w = t; w < n_words; w += blockDim.x)
    for (int g = 0; g < kGroups; ++g) part[g][w] = 0;
  // The valid rows' bits (an invalid row's index is negative): the loads
  // first, then one ballot per 32 rows (whole warps: n_pad is a multiple of 64).
  for (int e0 = t; e0 < n_pad; e0 += 4 * blockDim.x) {
    int idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      idx[u] = e < n_pad ? s.idx[(size_t)b * n_pad + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, idx[u] >= 0);
      if (lane == 0 && e < n_pad) reinterpret_cast<uint32_t*>(valid_w)[e / 32] = bits;
    }
  }
  if (t == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(smem_u32(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The last thread brings word block `wb`'s 64 rows into stage `st`.
  const uint32_t block_bytes = kTile * n_words * sizeof(u64);
  auto fetch = [&](int wb, int st) {
    const uint32_t bar = smem_u32(&full[st]);
    mbar_arrive_expect_tx(bar, block_bytes);
    bulk_load(smem_u32(ring + (size_t)st * kTile * n_words), m + (size_t)wb * kTile * n_words,
              block_bytes, bar);
  };
  // Warp 1: block wb's diagonal and next columns (rows lane and lane + 32)
  // from global memory, and their store for warp 0.
  u64 col_d0 = 0, col_d1 = 0, col_n0 = 0, col_n1 = 0;
  auto load_columns = [&](int wb) {
    if (wb >= n_words) return;
    const int nx = wb + 1 < n_words ? wb + 1 : wb;  // the last block has no next word
    const u64* r0 = m + (size_t)(wb * kTile + lane) * n_words;
    const u64* r1 = r0 + (size_t)32 * n_words;
    col_d0 = r0[wb];
    col_d1 = r1[wb];
    col_n0 = r0[nx];
    col_n1 = r1[nx];
  };
  auto store_columns = [&](int wb) {
    cols[wb & 1][0][lane] = col_d0;
    cols[wb & 1][0][lane + 32] = col_d1;
    cols[wb & 1][1][lane] = col_n0;
    cols[wb & 1][1][lane + 32] = col_n1;
  };
  const int fetcher = blockDim.x - 1;
  if (t == fetcher) {
    for (int wb = 0; wb < stages - 2 && wb < n_words; ++wb) fetch(wb, wb);
    mbar_wait(smem_u32(&full[0]), 0);
  }
  if (warp == 1) {
    load_columns(0);
    store_columns(0);
    load_columns(1);
  }
  __syncthreads();

  u64 carry = 0;  // warp 0: block wb-1's kept rows ORed at word wb
  // Stage and phase parity of block wb (wb % stages, wb / stages & 1), and
  // the stage of block wb-1, kept as counters: no division in the loop.
  int st_cur = 0, ph_cur = 0, st_prev = stages - 1;
  for (int wb = 0; wb < n_words; ++wb) {
    if (warp == 0) {
      const u64 d_lo = cols[wb & 1][0][lane], d_hi = cols[wb & 1][0][lane + 32];
      u64 removed = carry;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) removed |= part[g][wb];
      const u64 cand = valid_w[wb] & ~removed;
      const u64 sup_lo = d_lo & ((1ull << lane) - 1);         // earlier rows of the block
      const u64 sup_hi = d_hi & ((1ull << (lane + 32)) - 1);  // that overlap this one
      u64 kw = cand;
      while (true) {
        const uint32_t lo = __ballot_sync(0xFFFFFFFFu, (sup_lo & kw) != 0);
        const uint32_t hi = __ballot_sync(0xFFFFFFFFu, (sup_hi & kw) != 0);
        const u64 next = cand & ~(((u64)hi << 32) | lo);
        if (next == kw) break;
        kw = next;
      }
      const u64 c = (((kw >> lane) & 1ull) ? cols[wb & 1][1][lane] : 0ull) |
                    (((kw >> (lane + 32)) & 1ull) ? cols[wb & 1][1][lane + 32] : 0ull);
      carry = ((u64)__reduce_or_sync(0xFFFFFFFFu, (uint32_t)(c >> 32)) << 32) |
              __reduce_or_sync(0xFFFFFFFFu, (uint32_t)c);
      if (lane == 0) kept[wb] = kw;
    } else if (warp == 1) {
      if (wb + 1 < n_words) store_columns(wb + 1);
      load_columns(wb + 2);
    } else {
      if (t == fetcher) {
        // Block wb-2's stage is free (last read in the previous step). Block
        // wb+1, which the OR reads in the next step, has landed once this
        // thread has seen its barrier; the step's barrier orders the rest.
        if (wb + stages - 2 < n_words) fetch(wb + stages - 2, st_cur >= 2 ? st_cur - 2 : st_cur + stages - 2);
        if (wb + 1 < n_words) {
          const bool wrap = st_cur + 1 == stages;
          mbar_wait(smem_u32(&full[wrap ? 0 : st_cur + 1]), ph_cur ^ (int)wrap);
        }
      }
      // Block wb-1's kept rows into words wb+1 ..: thread (g, w) ORs rows
      // 16g .. 16g+15 of word w into part[g][w], which only it writes; its
      // 16 loads are issued before any OR (volatile: the compiler kept one
      // load in flight at a time).
      const int rest = n_words - wb - 1;
      const int h = t - 64;
      const int g = h / kOrWords;
      if (wb >= 1 && g < kGroups) {
        const u64* rows = ring + (size_t)st_prev * kTile * n_words + (size_t)(16 * g) * n_words;
        const uint32_t sel = (uint32_t)(kept[wb - 1] >> (16 * g)) & 0xFFFFu;
        for (int wi = h - g * kOrWords; wi < rest; wi += kOrWords) {
          const u64* col = rows + wb + 1 + wi;
          u64 v[16];
#pragma unroll
          for (int r = 0; r < 16; ++r) v[r] = lds64(col + r * n_words);
          u64 acc = 0;
#pragma unroll
          for (int r = 0; r < 16; ++r) acc |= v[r] & (0ull - ((sel >> r) & 1u));
          part[g][wb + 1 + wi] |= acc;
        }
      }
    }
    __syncthreads();
    st_prev = st_cur;
    if (++st_cur == stages) {
      st_cur = 0;
      ph_cur ^= 1;
    }
  }

  // Keep flags to the original slots: all index loads first, then the stores.
  for (int e0 = t; e0 < n_pad; e0 += 8 * blockDim.x) {
    int idx[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      idx[u] = e < n_pad ? s.idx[(size_t)b * n_pad + e] : n;
      if (idx[u] < 0) idx[u] = ~idx[u];  // an invalid row: never kept
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      if (idx[u] < n) keep[(size_t)b * n + idx[u]] = (uint8_t)((kept[e / kTile] >> (e % kTile)) & 1ull);
    }
  }
}

// scan_kernel for n_pad > kMaxN, without the ring: the same roles and
// step, warp 0 and warp 1 as there; the OR threads read block wb-1's kept
// rows from global memory. Shared memory (dynamic, sized by n_words):
// the 4 partial words, the valid bits and the kept bits of every word.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel_large(const Scratch s, int n, int n_pad, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 words[];  // part [kGroups][n_words], valid_w, kept
  __shared__ u64 cols[2][2][kTile];  // [block parity][diagonal, next word][row]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_words = n_pad / kTile;
  u64* part = words;  // part[g * n_words + w]
  u64* valid_w = words + kGroups * n_words;
  u64* kept = valid_w + n_words;
  const u64* m = s.mask + (size_t)b * n_pad * n_words;

  for (int w = t; w < kGroups * n_words; w += blockDim.x) part[w] = 0;
  for (int e0 = t; e0 < n_pad; e0 += 4 * blockDim.x) {
    int idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      idx[u] = e < n_pad ? s.idx[(size_t)b * n_pad + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, idx[u] >= 0);
      if (lane == 0 && e < n_pad) reinterpret_cast<uint32_t*>(valid_w)[e / 32] = bits;
    }
  }

  u64 col_d0 = 0, col_d1 = 0, col_n0 = 0, col_n1 = 0;
  auto load_columns = [&](int wb) {
    if (wb >= n_words) return;
    const int nx = wb + 1 < n_words ? wb + 1 : wb;
    const u64* r0 = m + (size_t)(wb * kTile + lane) * n_words;
    const u64* r1 = r0 + (size_t)32 * n_words;
    col_d0 = r0[wb];
    col_d1 = r1[wb];
    col_n0 = r0[nx];
    col_n1 = r1[nx];
  };
  auto store_columns = [&](int wb) {
    cols[wb & 1][0][lane] = col_d0;
    cols[wb & 1][0][lane + 32] = col_d1;
    cols[wb & 1][1][lane] = col_n0;
    cols[wb & 1][1][lane + 32] = col_n1;
  };
  if (warp == 1) {
    load_columns(0);
    store_columns(0);
    load_columns(1);
  }
  __syncthreads();

  u64 carry = 0;
  for (int wb = 0; wb < n_words; ++wb) {
    if (warp == 0) {
      const u64 d_lo = cols[wb & 1][0][lane], d_hi = cols[wb & 1][0][lane + 32];
      u64 removed = carry;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) removed |= part[g * n_words + wb];
      const u64 cand = valid_w[wb] & ~removed;
      const u64 sup_lo = d_lo & ((1ull << lane) - 1);
      const u64 sup_hi = d_hi & ((1ull << (lane + 32)) - 1);
      u64 kw = cand;
      while (true) {
        const uint32_t lo = __ballot_sync(0xFFFFFFFFu, (sup_lo & kw) != 0);
        const uint32_t hi = __ballot_sync(0xFFFFFFFFu, (sup_hi & kw) != 0);
        const u64 next = cand & ~(((u64)hi << 32) | lo);
        if (next == kw) break;
        kw = next;
      }
      const u64 c = (((kw >> lane) & 1ull) ? cols[wb & 1][1][lane] : 0ull) |
                    (((kw >> (lane + 32)) & 1ull) ? cols[wb & 1][1][lane + 32] : 0ull);
      carry = ((u64)__reduce_or_sync(0xFFFFFFFFu, (uint32_t)(c >> 32)) << 32) |
              __reduce_or_sync(0xFFFFFFFFu, (uint32_t)c);
      if (lane == 0) kept[wb] = kw;
    } else if (warp == 1) {
      if (wb + 1 < n_words) store_columns(wb + 1);
      load_columns(wb + 2);
    } else {
      // Block wb-1's kept rows into words wb+1 ..: thread (g, w) ORs the
      // kept ones of rows 16g .. 16g+15 of word w into part[g][w], which
      // only it writes; its loads are all issued before any OR.
      const int rest = n_words - wb - 1;
      const int h = t - 64;
      const int g = h / kOrWords;
      if (wb >= 1 && g < kGroups) {
        const uint32_t sel = (uint32_t)(kept[wb - 1] >> (16 * g)) & 0xFFFFu;
        const u64* rows = m + ((size_t)(wb - 1) * kTile + 16 * g) * n_words + wb + 1;
        for (int wi = h - g * kOrWords; sel != 0 && wi < rest; wi += kOrWords) {
          u64 v[16];
#pragma unroll
          for (int r = 0; r < 16; ++r)
            v[r] = (sel >> r) & 1u ? __ldg(rows + (size_t)r * n_words + wi) : 0ull;
          u64 acc = 0;
#pragma unroll
          for (int r = 0; r < 16; ++r) acc |= v[r];
          part[g * n_words + wb + 1 + wi] |= acc;
        }
      }
    }
    __syncthreads();
  }

  for (int e0 = t; e0 < n_pad; e0 += 8 * blockDim.x) {
    int idx[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      idx[u] = e < n_pad ? s.idx[(size_t)b * n_pad + e] : n;
      if (idx[u] < 0) idx[u] = ~idx[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      if (idx[u] < n) keep[(size_t)b * n + idx[u]] = (uint8_t)((kept[e / kTile] >> (e % kTile)) & 1ull);
    }
  }
}

}  // namespace

extern "C" {

// Keep mask of B streams. boxes [B, n, 4] f32, scores [B, n] f32, valid
// [B, n] u8; n_pad is a power of two in [64, 65536], >= n (above 8192 the
// large route); scratch holds scratch_bytes >= B * n_pad * (n_pad / 8 + 20)
// bytes (see Scratch), 16-byte aligned. Output: keep [B, n] u8 in original
// order. Returns the cudaError_t of the launches (0 = cudaSuccess).
int aznet_nms_launch(const void* boxes, const void* scores, const void* valid, int batch, int n,
                     int n_pad, float thresh, float offset, void* scratch, size_t scratch_bytes,
                     void* keep, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > n_pad || n_pad > kMaxNLarge ||
      n_pad < kTile || (n_pad & (n_pad - 1)) != 0 || (uintptr_t)scratch % 16 != 0 ||
      scratch_bytes < (size_t)batch * n_pad * (n_pad / 8 + 20))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = carve(scratch, batch, n_pad);
  const bool large = n_pad > kMaxN;

  // The scans' shared-memory limits, raised once per device: the ring, and
  // the large route's word arrays.
  static bool raised[64] = {}, raised_large[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!large && !raised[device]) {
    err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  if (large && !raised_large[device]) {
    err = cudaFuncSetAttribute(scan_kernel_large, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (kGroups + 2) * kMaxWordsLarge * (int)sizeof(u64));
    if (err != cudaSuccess) return (int)err;
    raised_large[device] = true;
  }

  const int n_tiles = n_pad / kTile;
  if (large)
    sort_kernel_large<<<dim3(n_tiles, batch), kTile * kRankParts / 2, 0, st>>>(
        (const float4*)boxes, (const float*)scores, (const uint8_t*)valid, n, n_pad, s);
  else
    sort_kernel<<<dim3(n_tiles, batch), kTile * kRankParts / 2, n_pad * sizeof(uint32_t), st>>>(
        (const float4*)boxes, (const float*)scores, (const uint8_t*)valid, n, n_pad, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  mask_kernel<<<dim3(n_tiles * (n_tiles + 1) / 2, batch), kTile * kRowThreads, 0, st>>>(
      s, n_pad, thresh, offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (large) {
    scan_kernel_large<<<batch, kScanThreads, (kGroups + 2) * n_tiles * sizeof(u64), st>>>(
        s, n, n_pad, (uint8_t*)keep);
    return (int)cudaGetLastError();
  }
  const int stage_bytes = kTile * n_tiles * (int)sizeof(u64);
  const int stages = kRingBytes / stage_bytes < kMaxStages ? kRingBytes / stage_bytes : kMaxStages;
  scan_kernel<<<batch, kScanThreads, stages * stage_bytes, st>>>(s, n, n_pad, stages,
                                                               (uint8_t*)keep);
  return (int)cudaGetLastError();
}

const char* aznet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Shared-memory tiles of f32 rows for the 3xTF32 attention kernels, shared by
// the forward (flash_attn_fwd_tf32.cu: K1 / K1c in f32) and the backward
// (flash_attn_bwd_tf32.cu: K2 / K2c in f32): the two loaders of the cp.async
// pipelines and the split of a staged tile into TF32 hi / lo tiles.
//
// A tile holds R rows of a view at a row stride of DP + 4 floats (DP, the
// padded head dim, a multiple of 8): an odd number of 16-byte units, so
// ldmatrix on it is free of bank conflicts, and 4 mod 8 floats, so the 32-bit
// loads of rows 2t, 2t + 1 at column g (the B operand of P V and its kin) hit
// 32 distinct banks.  Columns d..DP come out zero, as do rows past seq_len.
// kThreads threads (the whole block) share each copy.

#pragma once

#include <stdint.h>

#include "flash_fwd.cuh"
#include "mma.cuh"

namespace {

template <int DP>
__host__ __device__ constexpr int tile_stride() {
  return DP + 4;
}

// R rows of a tile of f32 (padding included) split in place: hi over x, lo
// into xl; the block's threads share the rows, 4 floats a time.
template <int DP, int R, int kThreads>
__device__ __forceinline__ void split_tile(float* x, float* xl) {
  constexpr int kVecs = DP / 4, kN = (R * kVecs + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kN * kThreads != R * kVecs && idx >= R * kVecs) break;
    const int r = idx / kVecs, off = r * tile_stride<DP>() + 4 * (idx - r * kVecs);
    const uint4 raw = *reinterpret_cast<const uint4*>(x + off);
    uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w}, hi[4], lo[4];
    split_tf32(v, hi, lo);
    *reinterpret_cast<uint4*>(x + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// cp.async copies of rows [t0, t0 + R) of a view into a tile of R rows, 16
// bytes (4 floats) each; rows >= seq_len and columns >= d are zero-filled.
// Copy i of a thread is index threadIdx.x + i * kThreads of the tile's
// row-major 16-byte units.  Where kThreads is a multiple of the units per
// row, a thread keeps one column and its rows step by kThreads / kVecs, so
// only its first copy is stored; otherwise each copy's row and column are
// worked out once.  One object serves every tile of one shape.
template <int DP, int R, int kThreads>
struct AsyncTileF {
  static constexpr int kVecs = DP / 4;  // 16-byte units per row
  static constexpr int kN = (R * kVecs + kThreads - 1) / kThreads;
  static constexpr bool kFixed = kThreads % kVecs == 0;
  static constexpr int kRowStep = kThreads / kVecs;  // kFixed: rows between copies
  int row[kFixed ? 1 : kN], col[kFixed ? 1 : kN];

  __device__ __forceinline__ AsyncTileF() {
#pragma unroll
    for (int i = 0; i < (kFixed ? 1 : kN); ++i) {
      const int idx = threadIdx.x + i * kThreads;
      row[i] = idx / kVecs;
      col[i] = 4 * (idx - row[i] * kVecs);
    }
  }

  __device__ __forceinline__ void copy(float* tile, const Rows<float>& x, int t0, int seq_len,
                                       int d) const {
    const float* base = x.p + t0 * x.st;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int r = kFixed ? row[0] + i * kRowStep : row[i];
      const int c = kFixed ? col[0] : col[i];
      if (kN * kThreads != R * kVecs && r >= R) continue;  // an idle slot
      const bool in = t0 + r < seq_len && c < d;
      cp_async16(tile + r * tile_stride<DP>() + c, in ? base + r * x.st + c : x.p, in);
    }
  }
};

// The element gather: cp.async copies of 4 bytes, element (r, e) of rows
// [t0, t0 + R) of any view (any element and row stride) into a tile of R
// rows, consecutive threads on consecutive elements of a row; zero past
// seq_len and d.  Nothing waits in registers, so it runs in the cp.async
// pipeline.  Where kThreads is a multiple of DP a thread keeps one column
// and its rows step by kThreads / DP, so a copy costs a pointer step and a
// row test; otherwise each copy works out its row and column.
template <int DP, int R, int kThreads>
struct ElemTileF {
  static constexpr int kN = R * DP / kThreads;  // copies a thread
  static constexpr bool kFixed = kThreads % DP == 0;
  static constexpr int kRowStep = kThreads / DP;  // kFixed: rows between copies
  static_assert(kN * kThreads == R * DP, "a tile is whole rounds of the block");

  __device__ __forceinline__ void copy(float* tile, const Rows<float>& x, int t0, int seq_len,
                                       int d) const {
    if constexpr (kFixed) {
      const int r = threadIdx.x / DP, e = threadIdx.x - r * DP;
      const bool col = e < d;
      const float* src = x.p + (t0 + r) * x.st + e * x.se;
      const long long step = kRowStep * x.st;
      float* dst = tile + r * tile_stride<DP>() + e;
#pragma unroll 4
      for (int i = 0; i < kN; ++i) {
        const bool in = col && t0 + r + i * kRowStep < seq_len;
        cp_async4(dst + i * kRowStep * tile_stride<DP>(), in ? src : x.p, in);
        src += step;
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kN; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / DP, e = idx - r * DP;
        const bool in = t0 + r < seq_len && e < d;
        cp_async4(tile + r * tile_stride<DP>() + e,
                  in ? x.p + (t0 + r) * x.st + e * x.se : x.p, in);
      }
    }
  }
};

}  // namespace

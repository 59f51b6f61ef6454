// Flash-attention forward in f32 for sm_90a on the tensor cores: kernel K1 in
// f32 (multi-head layout; K1b at head dims < 128) and kernel K1c (flat
// layout), in 3xTF32.
//
// They replace diff_sampler_tpu/ops/pallas_attention.py::_attn_kernel_mh,
// its packed twin ::_attn_kernel_mh_packed (both launched by
// _flash_fwd_mh_res) and ::_attn_kernel (launched by _flash_fwd_res), in f32;
// flash_attn_fwd.cu holds the bf16 kernel and the layouts, which are the
// same here.  Same math as the TPU kernels: f32 logits, the scale applied to
// the f32 q.k product, an online softmax in f32, P kept in f32 for P V (l
// summed from the same p), f32 accumulation; out in f32 and the per-row
// log-sum-exp; ragged T: keys >= T masked, query rows >= T never stored.
//
// 3xTF32.  The tensor cores take f32 operands as TF32 (10 explicit mantissa
// bits), which alone keeps about three decimal digits, too few for the f32
// gates (out and lse within 1e-5 of the plain version).  Every operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to nearest),
// and each product a b is summed as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)
// into the same f32 accumulator, the small terms first; lo lo (2^-22 of a b)
// is dropped.  That keeps about 21 bits of each product, against f32's 24:
// an error near 1e-6 of the logits' scale.  mma.sync m16n8k8 (TF32 in, f32
// accumulators), three per product tile.
//
// Structure: FlashAttention-2's, as the bf16 kernel (flash_attn_fwd.cu):
// a block owns a tile of 128 query rows, 8 warps of one m-tile (16 rows)
// each; K / V tiles of kBK keys are staged in shared memory by three load
// modes, as in bf16: cp.async where every view takes 16-byte copies; the
// gather from the qkv rows (SpanTileF: one projection's interleaved (c, qkv)
// channels, 16 bytes of a row at a time, split in registers), double
// buffered; and for any other view the element gather, here 4-byte cp.async
// copies (ElemTileF), which runs in the cp.async pipeline (three stages where
// they fit, two otherwise) and holds no tile in registers (ElemTileF,
// AsyncTileF and split_tile are in tf32_tiles.cuh, shared with the f32
// backward).  Fragments of m16n8k8.tf32 (g = lane / 4, t = lane % 4): A
// 16x8 a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B 8x8 b0
// (k = t, n = g), b1 (k = t + 4, n = g); C as in bf16.
//   * S = Q K^T: ldmatrix.x4 on f32 rows seen as pairs of b16 gives a lane
//     the 32-bit word t of row g of each 8x4-float matrix, which is the A
//     layout for Q and the "col" B layout for K (two n-tiles a load).
//   * the online softmax runs on the S accumulators (softmax_tile, shared
//     with bf16: exp2 of log2(e)-prescaled logits, the running max moved
//     only when a row would pass it by more than 2^8).
//   * O += P V without moving P: the contraction index of each 8-key step is
//     permuted, key 2t at A's column t and key 2t + 1 at column t + 4, so P's
//     C fragment (c0, c2, c1, c3) is the A fragment, and V's rows 2t and
//     2t + 1 (column g) are b0 and b1: two 32-bit shared-memory loads, which
//     hit 32 distinct banks because a row is DP + 4 floats (4 mod 8).
//   * rows of DP + 4 floats are also an odd number of 16-byte units, so
//     ldmatrix on Q and K is free of bank conflicts.
// Splits: up to DP = 160 each K / V tile is split once, by the whole block,
// into a hi tile (in place) and a lo tile in shared memory, and up to 80 Q
// once per block, so the warps load both halves with ldmatrix and split
// nothing; past that they do not fit beside Q and each warp splits its
// fragments in registers.  P is split in registers.  Partial sums: the
// tensor cores truncate as they accumulate, so products go into fresh
// accumulators of at most 8 k-steps, added to S or O in f32.  Head dims: d
// is padded to DP, the next of 16, 32, 40, 64, 80, 128, 160, 256 (k-steps of
// 8: d = 40 runs unpadded), the padding zero-filled; DP = 256 takes 16-key
// tiles so that Q and two K / V stages fit.
// Bound: the tensor cores' operations, 3 x 4 B H T^2 d flops at 495 TFLOP/s
// (TF32, dense), which mma.sync does not reach; the splits, V's scalar
// loads and the softmax take issue slots beside the products.
// Deterministic: no atomics, no split over keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd.cuh"
#include "mma.cuh"
#include "tf32_tiles.cuh"

namespace {

// Tiles of the padded head dim DP (mirrored by ops/attention.py::fwd_route):
// 8 warps of one m-tile (16 query rows) each.  Up to DP = 160, K and V are
// split once per tile into hi / lo tiles in shared memory (hi in place of
// the f32 tile), and up to 80 Q once per block; past that they do not fit
// beside Q, and each warp splits its fragments in registers.
template <int DP>
struct Tf {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;                            // query rows per block
  static constexpr int kBK = DP <= 40 ? 64 : DP <= 128 ? 32 : 16;  // keys per tile
  static constexpr bool kSplitKV = DP <= 160;
  static constexpr bool kSplitQ = DP <= 80;
  static constexpr int kStride = DP + 4;       // floats per shared-memory row
  static constexpr int kTile = kBK * kStride;  // one K or V tile (hi, lo or f32)
  static constexpr int kQTiles = kSplitQ ? 2 : 1;
  static constexpr int kStageTiles = kSplitKV ? 4 : 2;  // K and V, each hi and lo
  // stages: three for the cp.async pipelines (cp.async and the element
  // gather: two tiles in flight) where they fit, two otherwise
  __host__ __device__ static constexpr int stages(int mode) {
    return mode != kLoadSpan && DP <= 80 ? 3 : 2;
  }
  __host__ __device__ static constexpr size_t smem_bytes(int mode) {  // span: plus raw
    return sizeof(float) * (kQTiles * kBQ * kStride + stages(mode) * kStageTiles * kTile +
                            (mode == kLoadSpan ? kBK * 3 * DP : 0));
  }
  static_assert(DP % 8 == 0, "k-steps of 8");
};

// The span mode's head dims: rows of DP / 4 units of 4 columns that split
// into 32-unit groups, and a raw stage that fits beside the tiles.
__host__ __device__ constexpr bool tf32_span_dim(int dp) {
  return dp == 32 || dp == 64;
}

// Tiles of rows [t0, t0 + R) out of the interleaved (c, qkv) rows of one qkv
// projection: q at element 3 c, k at 3 c + 1, v at 3 c + 2 of a row that
// starts at span = q (16-byte aligned, as are its row strides).  A unit of
// 4 columns is 12 contiguous floats, three 16-byte chunks.  The units of a
// tile are numbered row by row and dealt to the warps in groups of 32; a
// warp copies its groups' chunks with cp.async into a raw stage, lane l
// taking chunks l, l + 32 and l + 64 of a group, and after the copies have
// landed lane l splits unit l of each group in registers into one 16-byte
// store to each tile.  A warp reads only the raw slots it copied, so
// __syncwarp orders them.  Rows >= seq_len come out zero, columns >= d zero.
template <int DP, int R>
struct SpanTileF {
  static constexpr int kUnits = DP / 4;  // per row
  static constexpr int kRaw = 3 * DP;    // raw stage row, in floats
  static constexpr int kGroups = R * kUnits / (32 * Tf<DP>::kWarps);  // per warp
  static constexpr int kGroupRows = 32 / kUnits;
  static_assert(kUnits <= 32 && 32 % kUnits == 0 && kGroups >= 1 &&
                    kGroups * 32 * Tf<DP>::kWarps == R * kUnits,
                "units of 4 columns fill whole rows and 32-unit groups");
  long long off[3];  // chunk c's element offset in the span from row t0, group 0
  int row[3];        // its row in the tile, group 0; 1 << 30 in a padding unit
  int first;         // this warp's first row
  int col;           // column of the unit this lane splits

  __device__ __forceinline__ SpanTileF(long long st, int d) {
    const int lane = threadIdx.x & 31;
    first = (threadIdx.x >> 5) * kGroups * kGroupRows;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int chunk = lane + 32 * c, unit = chunk / 3, part = chunk - 3 * unit;
      const int r = first + unit / kUnits, u = unit % kUnits;
      off[c] = r * st + 12 * u + 4 * part;
      row[c] = 4 * u < d ? r : 1 << 30;
    }
    col = 4 * (lane % kUnits);
  }

  __device__ __forceinline__ void copy(float* stage, const float* span, long long st, int t0,
                                       int seq_len) const {
    const int lane = threadIdx.x & 31;
    const float* base = span + t0 * st;
    float* raw = stage + first * kRaw + 4 * lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int r = row[c] + g * kGroupRows;
        if (row[c] == 1 << 30) continue;
        const bool in = t0 + r < seq_len;
        cp_async16(raw + g * 32 * 12 + c * 128, in ? base + off[c] + g * kGroupRows * st : span,
                   in);
      }
  }

  // after this warp's copies have landed: the q (PART 0), k (1) or v (2) of
  // each unit into tile x; PART < 0: k into tk and v into tv
  __device__ __forceinline__ void split(const float* stage, float* tk, float* tv, int d) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = first + g * kGroupRows + lane / kUnits;
      float4 ko = make_float4(0.f, 0.f, 0.f, 0.f), vo = ko;
      if (col < d) {
        const float4* p = reinterpret_cast<const float4*>(stage + r * kRaw + 3 * col);
        const float4 a = p[0], b = p[1], c = p[2];  // q0 k0 v0 q1 | k1 v1 q2 k2 | v2 q3 k3 v3
        ko = make_float4(a.y, b.x, b.w, c.z);
        vo = make_float4(a.z, b.y, c.x, c.w);
      }
      *reinterpret_cast<float4*>(tk + r * Tf<DP>::kStride + col) = ko;
      *reinterpret_cast<float4*>(tv + r * Tf<DP>::kStride + col) = vo;
    }
  }

  __device__ __forceinline__ void split_q(const float* stage, float* tq, int d) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = first + g * kGroupRows + lane / kUnits;
      float4 qo = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < d) {
        const float4* p = reinterpret_cast<const float4*>(stage + r * kRaw + 3 * col);
        const float4 a = p[0], b = p[1], c = p[2];
        qo = make_float4(a.x, a.w, b.z, c.y);
      }
      *reinterpret_cast<float4*>(tq + r * Tf<DP>::kStride + col) = qo;
    }
  }
};

struct NoSpanF {
  __device__ __forceinline__ NoSpanF(long long, int) {}
  __device__ __forceinline__ void copy(float*, const float*, long long, int, int) const {}
  __device__ __forceinline__ void split(const float*, float*, float*, int) const {}
  __device__ __forceinline__ void split_q(const float*, float*, int) const {}
};

// One 128-query tile of one (batch, head): out row t at o[t * ost], its lse
// at lse[t].
template <int DP, int MODE>
__device__ __forceinline__ void attend_tf32(Rows<float> q, Rows<float> k, Rows<float> v,
                                            float* __restrict__ o, long long ost,
                                            float* __restrict__ lse, int seq_len, int d,
                                            float scale, int q0) {
  using C = Tf<DP>;
  constexpr int S = C::kStride, BK = C::kBK;
  constexpr int kKSteps = DP / 8;    // k-steps of Q K^T
  constexpr int kKeyTiles = BK / 8;  // n-tiles of S, and k-steps of P V
  constexpr int kDTiles = DP / 8;    // n-tiles of O
  constexpr int kStages = C::stages(MODE);
  constexpr int kAhead = kStages - 1;  // cp.async: tiles in flight
  // The tensor cores add into their f32 accumulators with truncation, so a
  // sum carried through many mma.sync drifts toward zero (about half an ulp
  // of the sum per product; 3 T / 8 of them in P V).  Partial sums of at
  // most 3 x 8 products go into fresh accumulators, which are added to S or
  // O in f32 (round to nearest): S takes its k-steps in runs of kFoldQK (all
  // of them where there are at most 5), O each key tile's at once.  Single
  // k-steps where K is split in registers too (DP = 256: a run's A
  // fragments stay live beside the accumulators, and two would spill).
  constexpr int kFoldQK = kKSteps <= 5 ? kKSteps : C::kSplitKV ? 4 : 1;
  // the copies of the cp.async pipelines (cp.async, the element gather)
  using Copies = std::conditional_t<MODE == kLoadGather, ElemTileF<DP, BK, C::kThreads>,
                                  AsyncTileF<DP, BK, C::kThreads>>;
  using QCopies =
      std::conditional_t<MODE == kLoadGather, ElemTileF<DP, C::kBQ, C::kThreads>,
                         AsyncTileF<DP, C::kBQ, C::kThreads>>;

  // Q (f32, or hi and then lo), then per stage K, V (f32 or hi) and, split,
  // K lo, V lo, then the span mode's raw stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sQl = sQ + C::kBQ * S;
  float* sK = sQ + C::kQTiles * C::kBQ * S;
  float* sRaw = sK + kStages * C::kStageTiles * C::kTile;
  auto k_tile = [&](int stage) { return sK + stage * C::kStageTiles * C::kTile; };
  // v, k lo and v lo of a stage are 1, 2 and 3 tiles past its k

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (seq_len + BK - 1) / BK;

  // Q and the first K / V tiles, in f32
  const Copies kv_copies;
  const std::conditional_t<MODE == kLoadSpan, SpanTileF<DP, BK>, NoSpanF> span(q.st, d);
  const float* span0 = q.p;  // span mode: the rows q, k and v share, stride q.st
  if constexpr (MODE != kLoadSpan) {
    QCopies().copy(sQ, q, q0, seq_len, d);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < n_tiles) {
        kv_copies.copy(k_tile(i), k, i * BK, seq_len, d);
        kv_copies.copy(k_tile(i) + C::kTile, v, i * BK, seq_len, d);
      }
      cp_async_commit();  // one group per tile, empty or not, keeps the count
    }
  } else {  // span: Q, BK rows at a time, then K and V
#pragma unroll 1
    for (int r0 = 0; r0 <= C::kBQ; r0 += BK) {
      span.copy(sRaw, span0, q.st, r0 < C::kBQ ? q0 + r0 : 0, seq_len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (r0 < C::kBQ)
        span.split_q(sRaw, sQ + r0 * S, d);
      else
        span.split(sRaw, k_tile(0), k_tile(0) + C::kTile, d);
      __syncwarp();  // the raw slots are read before they are copied again
    }
  }

  // this lane's ldmatrix offsets: Q as A (k-step kk at + 8 kk), K as B (keys
  // + 16 per pair of n-tiles); V's rows 2t, 2t + 1 of an 8-key step, column g
  const int q_off = (warp * 16 + (lane & 15)) * S + (lane >> 4) * 4;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 4;
  const int v_off = 2 * t4 * S + g;

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // rows g (r = 0: fragment elements 0, 1) and g + 8 (r = 1: elements 2, 3);
  // m in log2 units, l this lane's partial sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // logits sl2 * s in log2 units: the scale multiplies once, in the
  // exponent's fused multiply-add
  const float sl2 = scale * kLog2e;
  const bool up = sl2 > 0.f;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (MODE != kLoadSpan) cp_async_wait<kAhead - 1>();  // tile j has landed
    __syncthreads();  // tile j is in place; tile j - 1's stage is free
    float* cK = k_tile(j % kStages);
    float *cV = cK + C::kTile, *cKl = cK + 2 * C::kTile, *cVl = cK + 3 * C::kTile;
    float* nK = k_tile((j + 1) % kStages);  // span: tile j + 1
    float* nV = nK + C::kTile;
    const int k0 = j * BK, k1 = k0 + BK;
    const bool more = j + 1 < n_tiles;
    if constexpr (MODE != kLoadSpan) {  // tile j + kAhead into tile j - 1's stage
      const int ahead = j + kAhead;
      if (ahead < n_tiles) {
        kv_copies.copy(k_tile(ahead % kStages), k, ahead * BK, seq_len, d);
        kv_copies.copy(k_tile(ahead % kStages) + C::kTile, v, ahead * BK, seq_len, d);
      }
      cp_async_commit();
    } else {
      if (more) {
        span.copy(sRaw, span0, q.st, k1, seq_len);
        cp_async_commit();
      }
    }
    if constexpr (C::kSplitKV) {  // hi / lo of tile j (and of Q, once)
      if constexpr (C::kSplitQ) {
        if (j == 0) split_tile<DP, C::kBQ, C::kThreads>(sQ, sQl);
      }
      split_tile<DP, BK, C::kThreads>(cK, cKl);
      split_tile<DP, BK, C::kThreads>(cV, cVl);
      __syncthreads();
    }
    // S = Q K^T in runs of kFoldQK k-steps
    float s[kKeyTiles][4];
#pragma unroll
    for (int k0s = 0; k0s < kKSteps; k0s += kFoldQK) {
      uint32_t ah[kFoldQK][4], al[kFoldQK][4];
#pragma unroll
      for (int f = 0; f < kFoldQK && k0s + f < kKSteps; ++f) {
        const int kk = k0s + f;
        if constexpr (C::kSplitQ) {
          ldmatrix_x4(ah[f], sQ + q_off + 8 * kk);
          ldmatrix_x4(al[f], sQl + q_off + 8 * kk);
        } else {
          uint32_t r[4];
          ldmatrix_x4(r, sQ + q_off + 8 * kk);
          split_tf32(r, ah[f], al[f]);
        }
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        if constexpr (kFoldQK == 1) {  // DP = 256: one n-tile's partial at a time
          const int off = np * 16 * S + k_off + 8 * k0s;
          uint32_t b[4], bh[4], bl[4];
          ldmatrix_x4(b, cK + off);
          split_tf32(b, bh, bl);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(part, ah[0], al[0], bh + 2 * h, bl + 2 * h);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              s[2 * np + h][i] = k0s == 0 ? part[i] : s[2 * np + h][i] + part[i];
          }
        } else {
          float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int f = 0; f < kFoldQK && k0s + f < kKSteps; ++f) {
            const int off = np * 16 * S + k_off + 8 * (k0s + f);
            uint32_t bh[4], bl[4];
            if constexpr (C::kSplitKV) {
              ldmatrix_x4(bh, cK + off);
              ldmatrix_x4(bl, cKl + off);
            } else {
              uint32_t b[4];
              ldmatrix_x4(b, cK + off);
              split_tf32(b, bh, bl);
            }
            mma_3xtf32(part[0], ah[f], al[f], bh, bl);
            mma_3xtf32(part[1], ah[f], al[f], bh + 2, bl + 2);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[2 * np][i] = k0s == 0 ? part[0][i] : s[2 * np][i] + part[0][i];
            s[2 * np + 1][i] = k0s == 0 ? part[1][i] : s[2 * np + 1][i] + part[1][i];
          }
        }
      }
    }

    // online softmax on the accumulators (uniform branches: the sign of the
    // scale, and whether this is the ragged last tile)
    const int key0 = k0 + 2 * t4;
    if (k1 <= seq_len) {
      if (up)
        softmax_tile<true, false>(s, acc, m, l, sl2, key0, seq_len);
      else
        softmax_tile<false, false>(s, acc, m, l, sl2, key0, seq_len);
    } else {
      if (up)
        softmax_tile<true, true>(s, acc, m, l, sl2, key0, seq_len);
      else
        softmax_tile<false, true>(s, acc, m, l, sl2, key0, seq_len);
    }

    // O += P V over 8-key steps: P's C fragment (c0, c2, c1, c3) is the A
    // fragment of the permuted keys (2t, 2t, 2t + 1, 2t + 1), V's rows 2t and
    // 2t + 1 the B fragment; each n-tile of O sums the tile in a fresh
    // accumulator
    uint32_t ph[kKeyTiles][4], pl[kKeyTiles][4];
#pragma unroll
    for (int kk = 0; kk < kKeyTiles; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKeyTiles; ++kk) {
        const int off = kk * 8 * S + v_off + 8 * n;
        uint32_t bh[2], bl[2];
        if constexpr (C::kSplitKV) {
          bh[0] = __float_as_uint(cV[off]);
          bh[1] = __float_as_uint(cV[off + S]);
          bl[0] = __float_as_uint(cVl[off]);
          bl[1] = __float_as_uint(cVl[off + S]);
        } else {
          split_tf32(cV[off], bh[0], bl[0]);
          split_tf32(cV[off + S], bh[1], bl[1]);
        }
        mma_3xtf32(part, ph[kk], pl[kk], bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
    }
    if constexpr (MODE == kLoadSpan) {
      if (more) {
        cp_async_wait<0>();
        __syncwarp();
        span.split(sRaw, nK, nV, d);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= seq_len) continue;
    float* orow = o + t * ost;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < d)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r] / sum, acc[n][2 * r + 1] / sum);
    if (t4 == 0) lse[t] = (m[r] + log2f(sum)) * kLn2;
  }
}

// K1 in f32: grid (query tiles, heads, batch).
template <int DP, int MODE>
__global__ void __launch_bounds__(Tf<DP>::kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int seq_len, int num_heads, int d, Strides sq,
                      Strides sk, Strides sv, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * num_heads + h;
  attend_tf32<DP, MODE>(Rows<float>{q + b * sq.b + h * sq.h, sq.t, sq.e},
                        Rows<float>{k + b * sk.b + h * sk.h, sk.t, sk.e},
                        Rows<float>{v + b * sv.b + h * sv.h, sv.t, sv.e},
                        o + (static_cast<long long>(b) * seq_len * num_heads + h) * d,
                        static_cast<long long>(num_heads) * d, lse + bh * seq_len, seq_len, d,
                        scale, blockIdx.x * Tf<DP>::kBQ);
}

// K1c in f32: grid (query tiles, batch * heads) over the flat layout.
template <int DP, int MODE>
__global__ void __launch_bounds__(Tf<DP>::kThreads, 1)
flash_fwd_tf32_flat_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int seq_len, int d, Strides sq, Strides sk,
                           Strides sv, float scale) {
  const long long bh = blockIdx.y;
  attend_tf32<DP, MODE>(Rows<float>{q + bh * sq.b, sq.t, sq.e},
                        Rows<float>{k + bh * sk.b, sk.t, sk.e},
                        Rows<float>{v + bh * sv.b, sv.t, sv.e}, o + bh * seq_len * d, d,
                        lse + bh * seq_len, seq_len, d, scale, blockIdx.x * Tf<DP>::kBQ);
}

template <int DP, int MODE>
cudaError_t run_tf32(const Args& a) {
  using C = Tf<DP>;
  constexpr size_t smem = C::smem_bytes(MODE);
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
  const unsigned tiles = (a.seq_len + C::kBQ - 1) / C::kBQ;
  cudaError_t err;
  if (a.num_heads == 0) {  // the flat layout reads no qkv rows
    if constexpr (MODE == kLoadSpan) {
      return cudaErrorInvalidValue;
    } else {
      auto kernel = &flash_fwd_tf32_flat_kernel<DP, MODE>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<dim3(tiles, a.batch), C::kThreads, smem, a.stream>>>(
          q, k, v, o, a.lse, a.seq_len, a.d, a.sq, a.sk, a.sv, a.scale);
    }
  } else {
    auto kernel = &flash_fwd_tf32_kernel<DP, MODE>;
    if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(tiles, a.num_heads, a.batch), C::kThreads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.seq_len, a.num_heads, a.d, a.sq, a.sk, a.sv, a.scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_tf32(const Args& a, const Route& r) {
  using C = Tf<DP>;
  if (r.block_q != C::kBQ || r.block_k != C::kBK) return cudaErrorInvalidValue;
  switch (r.load) {
    case kLoadAsync:
      if (!(aligned16<float>(a.q, a.sq, a) && aligned16<float>(a.k, a.sk, a) &&
            aligned16<float>(a.v, a.sv, a)))
        return cudaErrorInvalidValue;
      return run_tf32<DP, kLoadAsync>(a);
    case kLoadGather:
      return run_tf32<DP, kLoadGather>(a);
    case kLoadSpan:
      if constexpr (tf32_span_dim(DP)) {
        if (!qkv_span<float>(a)) return cudaErrorInvalidValue;
        return run_tf32<DP, kLoadSpan>(a);
      }
      break;
  }
  return cudaErrorInvalidValue;
}

int forward_tf32(const Args& a, int dtype, const Route& r) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != 0 || a.d < 8 || a.d % 8 != 0 || a.d > r.padded_d) return static_cast<int>(err);
  switch (r.padded_d) {  // the padded dims of the f32 kernel
    case 16: err = launch_tf32<16>(a, r); break;
    case 32: err = launch_tf32<32>(a, r); break;
    case 40: err = launch_tf32<40>(a, r); break;
    case 64: err = launch_tf32<64>(a, r); break;
    case 80: err = launch_tf32<80>(a, r); break;
    case 128: err = launch_tf32<128>(a, r); break;
    case 160: err = launch_tf32<160>(a, r); break;
    case 256: err = launch_tf32<256>(a, r); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// K1 in f32, the signature of dst_flash_attn_fwd (dtype must be 0: float32;
// load 1: cp.async, 2: gather, 3: gather from the qkv rows).  A route that
// does not match this kernel's tables is refused.  Returns the cudaError_t
// of the launch.
extern "C" int dst_flash_attn_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int batch, int seq_len, int num_heads,
                                       int head_dim, long long qsb, long long qst, long long qsh,
                                       long long qse, long long ksb, long long kst,
                                       long long ksh, long long kse, long long vsb,
                                       long long vst, long long vsh, long long vse, float scale,
                                       int dtype, int padded_d, int load, int block_q,
                                       int block_k, void* stream) {
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, num_heads, head_dim,
               Strides{qsb, qst, qsh, qse}, Strides{ksb, kst, ksh, kse},
               Strides{vsb, vst, vsh, vse}, scale, static_cast<cudaStream_t>(stream)};
  return forward_tf32(a, dtype, Route{padded_d, load, block_q, block_k});
}

// K1c in f32, the signature of dst_flash_attn_fwd_flat (cp.async or gather).
extern "C" int dst_flash_attn_fwd_tf32_flat(const void* q, const void* k, const void* v,
                                            void* o, void* lse, int batch, int seq_len,
                                            int head_dim, long long qsb, long long qst,
                                            long long qse, long long ksb, long long kst,
                                            long long kse, long long vsb, long long vst,
                                            long long vse, float scale, int dtype, int padded_d,
                                            int load, int block_q, int block_k, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, 0, head_dim,
               Strides{qsb, qst, 0, qse}, Strides{ksb, kst, 0, kse}, Strides{vsb, vst, 0, vse},
               scale, static_cast<cudaStream_t>(stream)};
  return forward_tf32(a, dtype, Route{padded_d, load, block_q, block_k});
}

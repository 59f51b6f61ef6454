// Flash-attention backward in f32 for sm_90a on the tensor cores: kernel K2
// in f32 (multi-head layout; K2p and K2b at head dims < 128) and kernel K2c
// (flat layout), each a dQ kernel and a dK/dV kernel, in 3xTF32.
//
// They replace diff_sampler_tpu/ops/pallas_attention.py::_bwd_dq_kernel_mh
// and ::_bwd_dkv_kernel_mh, their packed twins ::_bwd_dq_kernel_mh_packed
// and ::_bwd_dkv_kernel_mh_packed, their streamed twins
// ::_bwd_dq_kernel_mh_stream and ::_bwd_dkv_kernel_mh_stream, and the flat
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel, in f32; flash_attn_bwd.cu holds
// the bf16 kernels (CUDA cores), whose layouts and math are the same.  Per
// (batch, head), from the forward's output and log-sum-exp:
//   * delta = rowsum(dO * out) in f32, computed by the caller;
//   * P  = exp(scale * q.k^T - lse), recomputed in f32, never stored;
//   * dP = dO.v^T;  dS = P * (dP - delta);
//   * dQ = scale * dS.k (dQ kernel: a block of query rows loops over keys);
//   * dV = P^T.dO, dK = scale * dS^T.q (dK/dV kernel: a block of key rows
//     loops over queries, k-major as _bwd_dkv_kernel_mh);
//   * every sum in f32; ragged T: keys >= T drop out of the dQ kernel and
//     queries >= T out of the dK/dV kernel (P = 0), rows >= T are never
//     stored.  No atomics and a fixed order of every sum: deterministic.
//
// One tile body serves both kernels.  A block keeps kRows "resident" rows
// in shared memory (dQ: Q and dO; dK/dV: K and V) and streams the other
// side in tiles of kBC rows (dQ: K and V; dK/dV: Q and dO), and each tile is
//   X = RA . CA^T and Y = RB . CB^T  (dQ: S = Q K^T, dP = dO V^T; dK/dV: the
//       transposed S^T = K Q^T and dP^T = V dO^T, keys as rows),
//   P = exp(scale X - lse), dS = P (Y - delta)  (lse and delta are per row
//       in the dQ kernel, in registers; per column in the dK/dV kernel, read
//       from a row of shared memory staged with the tile),
//   dQ += dS . CA, or dV += P . CB and dK += dS . CA.
// Neither kernel transposes anything: X and Y come out in the mma C layout
// with the resident rows as rows, and under the forward's permutation of
// each 8-step of the contraction (index 2t at A's column t, 2t + 1 at t + 4)
// a C fragment (c0, c2, c1, c3) is the A fragment of the next product, whose
// B fragment is rows 2t and 2t + 1 of the streamed tile at column g (two
// 32-bit shared-memory loads).  X and Y read RA / RB as A operands with
// ldmatrix and CA / CB as "col" B operands with ldmatrix, as the forward
// reads Q and K (mma.cuh: the fragment layouts).
//
// 3xTF32, as the forward (flash_attn_fwd_tf32.cu): every operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and each product summed
// as lo hi + hi lo + hi hi (lo lo dropped), about 21 bits of each product.
// The tensor cores truncate as they accumulate, so every product goes into a
// fresh accumulator of at most 8 k-steps (X and Y: runs of kFold k-steps
// over d; the accumulating products: one tile of kBC / 8 k-steps), added to
// its sum in f32.  Streamed tiles are split once per tile by the block into
// hi (in place) and lo tiles where they fit (padded d <= 160), resident
// tiles once per block where they fit (<= 128); elsewhere each warp splits
// its fragments in registers.  P and dS are split in registers.
//
// Warps: 8, each owning one m-tile (16 resident rows) and, below padded d
// 128, all of d: 128 resident rows per block.  From padded d 128 up two
// warps share an m-tile, each over half of d (64 rows per block): each
// computes the partial X and Y over its half, the pair adds the two through
// shared memory (a named barrier for the pair; both add in the same order,
// so both hold the same bits), and each accumulates its half of the output
// columns.  That halves the accumulators (the dK/dV kernel holds two d-wide
// ones: 2 x DP / 2 registers a thread) and duplicates no product.  Streamed
// tiles are 64 rows up to padded d 40, 32 at 64 and 16 above: the dK/dV
// kernel at 80 holds its 80 accumulator registers beside 16-row tiles' P
// and dS without spilling (32-row tiles spill it).
// Loads (tf32_tiles.cuh), double buffered in the cp.async pipeline: 16-byte
// cp.async where q, k, v and dO all take it (the LDM's legacy split, SD's
// projections, the flat copies) up to padded d 160, else the element gather
// (4-byte cp.async),
// which reads any view (the interleaved qkv split, an unaligned or strided
// dO).  Head dims: d is padded to DP, the next of 16,
// 32, 40, 64, 80, 128, 160, 256, the padding zero-filled.
// Bound: the tensor cores' operations, 3 products (dQ kernel) or 4 (dK/dV)
// of 2 B H T^2 d flops, three TF32 products each at 495 TFLOP/s (dense),
// which mma.sync does not reach; the splits, the exponentials and the
// 32-bit B loads take issue slots beside the products.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd.cuh"
#include "mma.cuh"
#include "tf32_tiles.cuh"

namespace {

// Tiles of the padded head dim DP (mirrored by ops/attention.py::bwd_route),
// the same for both kernels.
template <int DP>
struct Bt {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSplitD = DP >= 128 ? 2 : 1;     // warps per m-tile
  static constexpr int kHalf = DP / kSplitD;            // columns of d per warp
  static constexpr int kRows = 16 * kWarps / kSplitD;   // resident rows per block
  static constexpr int kBC = DP <= 40 ? 64 : DP <= 64 ? 32 : 16;  // streamed rows per tile
  static constexpr bool kSplitR = DP <= 128;  // resident tiles split once into hi / lo
  static constexpr bool kSplitC = DP <= 160;  // streamed tiles split once per tile
  // k-steps of X and Y per fresh accumulator: all of them up to 5, else runs
  // of 4, of 2 at padded d 256 (the A fragments of a run stay live beside
  // the accumulators: runs of 4 spill the dQ kernel there)
  static constexpr int kFold = kHalf / 8 <= 5 ? kHalf / 8 : DP == 256 ? 2 : 4;
  static constexpr int kStride = tile_stride<DP>();
  static constexpr int kRTile = kRows * kStride;
  static constexpr int kCTile = kBC * kStride;
  static constexpr int kStages = 2;
  // a stage: CA, CB (f32 or hi), CA lo, CB lo where split, then the dK/dV
  // kernel's lse and delta of its kBC columns
  static constexpr int kStageFloats = (kSplitC ? 4 : 2) * kCTile + 2 * kBC;
  static constexpr int kXchgWarp = 2 * (kBC / 8) * 4 * 32;  // a warp's partial X and Y
  static constexpr int kXchg = kSplitD == 2 ? kWarps * kXchgWarp : 0;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kSplitR ? 4 : 2) * kRTile + kStages * kStageFloats + kXchg);
  // cp.async up to padded d 160; at 256 its copy state spills the dQ kernel
  // (and no tier's view at d = 256 takes 16-byte copies)
  static constexpr bool kAsync = DP <= 160;
  static_assert(kHalf % 8 == 0 && kBC % 16 == 0, "k-steps of 8, n-tiles in pairs");
  static_assert(kSmemBytes <= 232448, "one block fits the SM's shared memory");
};

__device__ __forceinline__ void pair_barrier(int id) {  // the two warps of one m-tile
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// x = RA . CA^T over this warp's kHalf columns: x[n] is n-tile n (8
// streamed rows) of the warp's 16 resident rows.  ra / ral: the resident
// tile (hi and lo where split) at this lane's A offset; ca / cal the
// streamed tile at its B offset.  Runs of kFold k-steps each sum into fresh
// accumulators, added to x in f32; each A fragment is loaded once a tile.
template <int DP>
__device__ __forceinline__ void scores(float (&x)[Bt<DP>::kBC / 8][4], const float* ra,
                                       const float* ral, const float* ca, const float* cal) {
  using C = Bt<DP>;
  constexpr int S = C::kStride;
  constexpr int kKSteps = C::kHalf / 8, kFold = C::kFold;
#pragma unroll
  for (int k0 = 0; k0 < kKSteps; k0 += kFold) {
    uint32_t ah[kFold][4], al[kFold][4];
#pragma unroll
    for (int f = 0; f < kFold && k0 + f < kKSteps; ++f) {
      const int kk = k0 + f;
      if constexpr (C::kSplitR) {
        ldmatrix_x4(ah[f], ra + 8 * kk);
        ldmatrix_x4(al[f], ral + 8 * kk);
      } else {
        uint32_t r[4];
        ldmatrix_x4(r, ra + 8 * kk);
        split_tf32(r, ah[f], al[f]);
      }
    }
#pragma unroll
    for (int np = 0; np < C::kBC / 16; ++np) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int f = 0; f < kFold && k0 + f < kKSteps; ++f) {
        const int off = np * 16 * S + 8 * (k0 + f);
        uint32_t bh[4], bl[4];
        if constexpr (C::kSplitC) {
          ldmatrix_x4(bh, ca + off);
          ldmatrix_x4(bl, cal + off);
        } else {
          uint32_t b[4];
          ldmatrix_x4(b, ca + off);
          split_tf32(b, bh, bl);
        }
        mma_3xtf32(part[0], ah[f], al[f], bh, bl);
        mma_3xtf32(part[1], ah[f], al[f], bh + 2, bl + 2);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * np][i] = k0 == 0 ? part[0][i] : x[2 * np][i] + part[0][i];
        x[2 * np + 1][i] = k0 == 0 ? part[1][i] : x[2 * np + 1][i] + part[1][i];
      }
    }
  }
}

// acc += p . CB over this tile: p (the C fragments of P or dS, the warp's 16
// resident rows by kBC streamed rows) as the A operand under the
// permutation, CB's rows 2t and 2t + 1 of each 8-row step at column g of
// each of the warp's n-tiles as B (cb / cbl at this lane's offset).  Each
// n-tile sums the tile in a fresh accumulator, added to acc in f32.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[Bt<DP>::kHalf / 8][4],
                                           const float (&p)[Bt<DP>::kBC / 8][4], const float* cb,
                                           const float* cbl) {
  using C = Bt<DP>;
  constexpr int S = C::kStride;
  constexpr int kSteps = C::kBC / 8;
  uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    split_tf32(p[kk][0], ah[kk][0], al[kk][0]);
    split_tf32(p[kk][2], ah[kk][1], al[kk][1]);
    split_tf32(p[kk][1], ah[kk][2], al[kk][2]);
    split_tf32(p[kk][3], ah[kk][3], al[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < C::kHalf / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int off = kk * 8 * S + 8 * n;
      uint32_t bh[2], bl[2];
      if constexpr (C::kSplitC) {
        bh[0] = __float_as_uint(cb[off]);
        bh[1] = __float_as_uint(cb[off + S]);
        bl[0] = __float_as_uint(cbl[off]);
        bl[1] = __float_as_uint(cbl[off + S]);
      } else {
        split_tf32(cb[off], bh[0], bl[0]);
        split_tf32(cb[off + S], bh[1], bl[1]);
      }
      mma_3xtf32(part, ah[kk], al[kk], bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
  }
}

// Rows r0 + 16 m-tile + g (+ 8) (< seq_len) of an output (row t at out + t *
// ost), this warp's columns below d, times mul.
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out, long long ost,
                                           const float (&acc)[Bt<DP>::kHalf / 8][4], float mul,
                                           int row0, int col0, int seq_len, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + g + 8 * r;
    if (t >= seq_len) continue;
    float* orow = out + t * ost + col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < Bt<DP>::kHalf / 8; ++n)
      if (col0 + 8 * n < d)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(mul * acc[n][2 * r], mul * acc[n][2 * r + 1]);
  }
}

// One block: resident rows [r0, r0 + kRows) of one (batch, head) against
// every streamed tile.  dQ kernel (DKV false): ra = Q, rb = dO, ca = K, cb =
// V, lse / delta of the queries, o0 = dq.  dK/dV kernel: ra = K, rb = V, ca
// = Q, cb = dO, lse / delta of the queries (the streamed rows), o0 = dk, o1 =
// dv.  Output row t at o[t * ost]; lse and delta at the head's token 0.
template <int DP, bool DKV, int MODE>
__device__ __forceinline__ void bwd_tile_tf32(Rows<float> ra, Rows<float> rb, Rows<float> ca,
                                              Rows<float> cb, const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              float* __restrict__ o0, float* __restrict__ o1,
                                              long long ost, int seq_len, int d, float scale,
                                              int r0) {
  using C = Bt<DP>;
  constexpr int S = C::kStride, BC = C::kBC;
  constexpr int kCTiles = BC / 8;         // n-tiles of X and Y
  constexpr int kDTiles = C::kHalf / 8;  // n-tiles of each accumulator
  // the copies of the cp.async pipeline: 16 bytes, or the element gather
  using RCopies = std::conditional_t<MODE == kLoadAsync, AsyncTileF<DP, C::kRows, C::kThreads>,
                                     ElemTileF<DP, C::kRows, C::kThreads>>;
  using CCopies = std::conditional_t<MODE == kLoadAsync, AsyncTileF<DP, BC, C::kThreads>,
                                     ElemTileF<DP, BC, C::kThreads>>;

  // RA, RB (f32 or hi), RA lo, RB lo where split; the stages; the exchange
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sRA = reinterpret_cast<float*>(smem_raw);
  float* sRB = sRA + C::kRTile;
  float* sRAl = sRB + C::kRTile;
  float* sRBl = sRAl + C::kRTile;
  float* sC = sRA + (C::kSplitR ? 4 : 2) * C::kRTile;
  float* sXchg = sC + C::kStages * C::kStageFloats;
  // in a stage: CA at 0, CB at kCTile, their lo tiles 2 and 3 tiles in, the
  // column statistics after the tiles
  constexpr int kStats = (C::kSplitC ? 4 : 2) * C::kCTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp / C::kSplitD;            // this warp's m-tile
  const int col0 = (warp % C::kSplitD) * C::kHalf;  // and its first column of d
  const int n_tiles = (seq_len + BC - 1) / BC;

  const CCopies c_copies;
  auto copy_stage = [&](int j) {
    float* st = sC + (j % C::kStages) * C::kStageFloats;
    const int c0 = j * BC;
    c_copies.copy(st, ca, c0, seq_len, d);
    c_copies.copy(st + C::kCTile, cb, c0, seq_len, d);
    if constexpr (DKV) {  // lse, then delta, of the tile's queries
      if (threadIdx.x < 2 * BC) {
        const int r = threadIdx.x % BC;
        const float* src = threadIdx.x < BC ? lse : delta;
        const bool in = c0 + r < seq_len;
        cp_async4(st + kStats + threadIdx.x, in ? src + c0 + r : src, in);
      }
    }
  };
  {
    const RCopies r_copies;
    r_copies.copy(sRA, ra, r0, seq_len, d);
    r_copies.copy(sRB, rb, r0, seq_len, d);
  }
  copy_stage(0);
  cp_async_commit();

  // this lane's offsets: A (ldmatrix, k-step kk at + 8 kk), B "col"
  // (ldmatrix, streamed rows + 16 per pair of n-tiles), and the B rows 2t,
  // 2t + 1 of an 8-row step at column g; each within this warp's columns
  const int a_off = (mt * 16 + (lane & 15)) * S + (lane >> 4) * 4 + col0;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 4 + col0;
  const int v_off = 2 * t4 * S + g + col0;

  // the dQ kernel's row statistics (rows g and g + 8), lse in log2 units
  const float sl2 = scale * kLog2e;
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + mt * 16 + g + 8 * r;
      if (t < seq_len) {
        row_lse[r] = lse[t] * kLog2e;
        row_delta[r] = delta[t];
      }
    }
  }

  float acc0[kDTiles][4], acc1[DKV ? kDTiles : 1][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < (DKV ? kDTiles : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[n][i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // tile j (and, at j = 0, the resident tiles) has landed
    __syncthreads();     // for every thread; tile j - 1's stage is free
    if (j + 1 < n_tiles) copy_stage(j + 1);
    cp_async_commit();
    float* st = sC + (j % C::kStages) * C::kStageFloats;
    float *cA = st, *cB = st + C::kCTile, *cAl = st + 2 * C::kCTile, *cBl = st + 3 * C::kCTile;
    if constexpr (C::kSplitR) {
      if (j == 0) {
        split_tile<DP, C::kRows, C::kThreads>(sRA, sRAl);
        split_tile<DP, C::kRows, C::kThreads>(sRB, sRBl);
      }
    }
    if constexpr (C::kSplitC) {
      split_tile<DP, BC, C::kThreads>(cA, cAl);
      split_tile<DP, BC, C::kThreads>(cB, cBl);
    }
    if constexpr (C::kSplitR || C::kSplitC) __syncthreads();

    float x[kCTiles][4], y[kCTiles][4];
    scores<DP>(x, sRA + a_off, sRAl + a_off, cA + b_off, cAl + b_off);
    scores<DP>(y, sRB + a_off, sRBl + a_off, cB + b_off, cBl + b_off);
    if constexpr (C::kSplitD == 2) {  // add the pair's partials over the two halves of d
      float* mine = sXchg + warp * C::kXchgWarp + lane;
      const float* theirs = sXchg + (warp ^ 1) * C::kXchgWarp + lane;
#pragma unroll
      for (int n = 0; n < kCTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mine[(n * 4 + i) * 32] = x[n][i];
          mine[((kCTiles + n) * 4 + i) * 32] = y[n][i];
        }
      pair_barrier(1 + mt);
#pragma unroll
      for (int n = 0; n < kCTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[n][i] += theirs[(n * 4 + i) * 32];
          y[n][i] += theirs[((kCTiles + n) * 4 + i) * 32];
        }
    }

    // P into x, dS into y; streamed rows >= seq_len drop out
    const int c0 = j * BC;
#pragma unroll
    for (int n = 0; n < kCTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t4 + (i & 1);  // the streamed row in the tile
        float l2, dl;
        if constexpr (DKV) {
          l2 = st[kStats + c] * kLog2e;
          dl = st[kStats + BC + c];
        } else {
          l2 = row_lse[i >> 1];
          dl = row_delta[i >> 1];
        }
        const float p = c0 + c < seq_len ? ex2(fmaf(x[n][i], sl2, -l2)) : 0.f;
        x[n][i] = p;
        y[n][i] = p * (y[n][i] - dl);
      }

    if constexpr (DKV) {
      accumulate<DP>(acc1, x, cB + v_off, cBl + v_off);  // dV += P^T dO
      accumulate<DP>(acc0, y, cA + v_off, cAl + v_off);  // dK += dS^T Q
    } else {
      accumulate<DP>(acc0, y, cA + v_off, cAl + v_off);  // dQ += dS K
    }
  }

  const int row0 = r0 + mt * 16;
  store_rows<DP>(o0, ost, acc0, scale, row0, col0, seq_len, d);
  if constexpr (DKV) store_rows<DP>(o1, ost, acc1, 1.f, row0, col0, seq_len, d);
}

// K2 in f32: grid (resident tiles, heads, batch); lse and delta [B, H, T],
// outputs contiguous [B, T, H, d].
#define DST_TF32_MH_HEAD                                                              \
  const int h = blockIdx.y, b = blockIdx.z;                                            \
  const long long bh = static_cast<long long>(b) * num_heads + h;                      \
  const long long out0 = (static_cast<long long>(b) * seq_len * num_heads + h) * d;    \
  const long long ost = static_cast<long long>(num_heads) * d;                         \
  const Rows<float> rq{q + b * sq.b + h * sq.h, sq.t, sq.e};                            \
  const Rows<float> rk{k + b * sk.b + h * sk.h, sk.t, sk.e};                            \
  const Rows<float> rv{v + b * sv.b + h * sv.h, sv.t, sv.e};                            \
  const Rows<float> rdo{dout + b * sdo.b + h * sdo.h, sdo.t, sdo.e}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bt<DP>::kThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int seq_len, int num_heads, int d, Strides sq,
                         Strides sk, Strides sv, Strides sdo, float scale) {
  DST_TF32_MH_HEAD;
  bwd_tile_tf32<DP, false, MODE>(rq, rdo, rk, rv, lse + bh * seq_len, delta + bh * seq_len,
                                 dq + out0, nullptr, ost, seq_len, d, scale,
                                 blockIdx.x * Bt<DP>::kRows);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bt<DP>::kThreads, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int seq_len,
                          int num_heads, int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                          float scale) {
  DST_TF32_MH_HEAD;
  bwd_tile_tf32<DP, true, MODE>(rk, rv, rq, rdo, lse + bh * seq_len, delta + bh * seq_len,
                                dk + out0, dv + out0, ost, seq_len, d, scale,
                                blockIdx.x * Bt<DP>::kRows);
}

// K2c in f32: grid (resident tiles, batch * heads) over the flat layout;
// lse and delta [B, T], outputs contiguous [B, T, d].
#define DST_TF32_FLAT_HEAD                                       \
  const long long bh = blockIdx.y;                                \
  const Rows<float> rq{q + bh * sq.b, sq.t, sq.e};                \
  const Rows<float> rk{k + bh * sk.b, sk.t, sk.e};                \
  const Rows<float> rv{v + bh * sv.b, sv.t, sv.e};                \
  const Rows<float> rdo{dout + bh * sdo.b, sdo.t, sdo.e}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bt<DP>::kThreads, 1)
flash_bwd_dq_tf32_flat_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int seq_len, int d, Strides sq,
                              Strides sk, Strides sv, Strides sdo, float scale) {
  DST_TF32_FLAT_HEAD;
  bwd_tile_tf32<DP, false, MODE>(rq, rdo, rk, rv, lse + bh * seq_len, delta + bh * seq_len,
                                 dq + bh * seq_len * d, nullptr, d, seq_len, d, scale,
                                 blockIdx.x * Bt<DP>::kRows);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bt<DP>::kThreads, 1)
flash_bwd_dkv_tf32_flat_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int seq_len,
                               int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                               float scale) {
  DST_TF32_FLAT_HEAD;
  bwd_tile_tf32<DP, true, MODE>(rk, rv, rq, rdo, lse + bh * seq_len, delta + bh * seq_len,
                                dk + bh * seq_len * d, dv + bh * seq_len * d, d, seq_len, d,
                                scale, blockIdx.x * Bt<DP>::kRows);
}

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *d0, *d1;                    // dq, or dk and dv
  int batch, seq_len, num_heads, d;  // num_heads 0: the flat layout
  Strides sq, sk, sv, sdo;
  float scale;
  cudaStream_t stream;
};

template <int DP, int MODE>
cudaError_t run_bwd_tf32(const BwdArgs& a) {
  using C = Bt<DP>;
  constexpr size_t smem = C::kSmemBytes;
  const bool dkv = a.d1 != nullptr;
  const unsigned tiles = (a.seq_len + C::kRows - 1) / C::kRows;
  cudaError_t err;
  if (a.num_heads == 0) {
    const dim3 grid(tiles, a.batch);
    if (dkv) {
      auto kernel = &flash_bwd_dkv_tf32_flat_kernel<DP, MODE>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, C::kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.d0,
                                                    a.d1, a.seq_len, a.d, a.sq, a.sk, a.sv,
                                                    a.sdo, a.scale);
    } else {
      auto kernel = &flash_bwd_dq_tf32_flat_kernel<DP, MODE>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, C::kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.d0,
                                                    a.seq_len, a.d, a.sq, a.sk, a.sv, a.sdo,
                                                    a.scale);
    }
  } else {
    const dim3 grid(tiles, a.num_heads, a.batch);
    if (dkv) {
      auto kernel = &flash_bwd_dkv_tf32_kernel<DP, MODE>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, C::kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.d0,
                                                    a.d1, a.seq_len, a.num_heads, a.d, a.sq,
                                                    a.sk, a.sv, a.sdo, a.scale);
    } else {
      auto kernel = &flash_bwd_dq_tf32_kernel<DP, MODE>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, C::kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.d0,
                                                    a.seq_len, a.num_heads, a.d, a.sq, a.sk,
                                                    a.sv, a.sdo, a.scale);
    }
  }
  return cudaGetLastError();
}

// The route names this kernel's tiles and a load mode: cp.async only where
// q, k, v and dO all take 16-byte copies (checked again here: a misaligned
// cp.async faults) and the padded d has it, the element gather for any view.
template <int DP>
cudaError_t launch_bwd_tf32(const BwdArgs& a, const Route& r) {
  using C = Bt<DP>;
  if (r.block_q != C::kRows || r.block_k != C::kBC) return cudaErrorInvalidValue;
  switch (r.load) {
    case kLoadAsync:
      if constexpr (C::kAsync) {
        if (!(aligned16<float>(a.q, a.sq, a) && aligned16<float>(a.k, a.sk, a) &&
              aligned16<float>(a.v, a.sv, a) && aligned16<float>(a.dout, a.sdo, a)))
          return cudaErrorInvalidValue;
        return run_bwd_tf32<DP, kLoadAsync>(a);
      }
      break;
    case kLoadGather:
      return run_bwd_tf32<DP, kLoadGather>(a);
  }
  return cudaErrorInvalidValue;
}

int backward_tf32(const BwdArgs& a, int dtype, const Route& r) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != 0 || a.d < 8 || a.d % 8 != 0 || a.d > r.padded_d) return static_cast<int>(err);
  switch (r.padded_d) {  // the padded dims of the f32 backward
    case 16: err = launch_bwd_tf32<16>(a, r); break;
    case 32: err = launch_bwd_tf32<32>(a, r); break;
    case 40: err = launch_bwd_tf32<40>(a, r); break;
    case 64: err = launch_bwd_tf32<64>(a, r); break;
    case 80: err = launch_bwd_tf32<80>(a, r); break;
    case 128: err = launch_bwd_tf32<128>(a, r); break;
    case 160: err = launch_bwd_tf32<160>(a, r); break;
    case 256: err = launch_bwd_tf32<256>(a, r); break;
  }
  return static_cast<int>(err);
}

BwdArgs mh_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* d0, void* d1, int batch, int seq_len, int num_heads,
                int head_dim, const long long* st, float scale, void* stream) {
  return BwdArgs{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(dout),
                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                 static_cast<float*>(d0), static_cast<float*>(d1), batch, seq_len, num_heads,
                 head_dim, Strides{st[0], st[1], st[2], st[3]},
                 Strides{st[4], st[5], st[6], st[7]}, Strides{st[8], st[9], st[10], st[11]},
                 Strides{st[12], st[13], st[14], st[15]}, scale,
                 static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K2 in f32: the arguments of dst_flash_attn_bwd_dq / _dkv (dtype must be 0:
// float32), then the route (padded d, load mode 1: cp.async, 2: the element
// gather, the resident rows per block, the streamed rows per tile).  A route that does
// not match this kernel's tables is refused.  Returns the cudaError_t of
// the launch.
#define DST_STRIDE_ARGS                                                                       \
  long long qsb, long long qst, long long qsh, long long qse, long long ksb, long long kst,    \
      long long ksh, long long kse, long long vsb, long long vst, long long vsh, long long vse, \
      long long gsb, long long gst, long long gsh, long long gse
#define DST_STRIDES \
  { qsb, qst, qsh, qse, ksb, kst, ksh, kse, vsb, vst, vsh, vse, gsb, gst, gsh, gse }
#define DST_FLAT_STRIDE_ARGS                                                                  \
  long long qsb, long long qst, long long qse, long long ksb, long long kst, long long kse,   \
      long long vsb, long long vst, long long vse, long long gsb, long long gst, long long gse
#define DST_FLAT_STRIDES \
  { qsb, qst, 0, qse, ksb, kst, 0, kse, vsb, vst, 0, vse, gsb, gst, 0, gse }

extern "C" int dst_flash_attn_bwd_dq_tf32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int batch, int seq_len, int num_heads,
                                          int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                          int padded_d, int load, int block_rows, int tile_rows,
                                          void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return backward_tf32(mh_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len,
                               num_heads, head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

extern "C" int dst_flash_attn_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int batch, int seq_len,
                                           int num_heads, int head_dim, DST_STRIDE_ARGS,
                                           float scale, int dtype, int padded_d, int load,
                                           int block_rows, int tile_rows, void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1 || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward_tf32(mh_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, num_heads,
                               head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

// K2c in f32, the flat layout: strides (batch, token, channel) for q, k, v
// and dO; lse and delta [B, T]; then the route, as above.
extern "C" int dst_flash_attn_bwd_dq_tf32_flat(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dq, int batch,
                                               int seq_len, int head_dim, DST_FLAT_STRIDE_ARGS,
                                               float scale, int dtype, int padded_d, int load,
                                               int block_rows, int tile_rows, void* stream) {
  const long long st[16] = DST_FLAT_STRIDES;
  return backward_tf32(mh_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len, 0,
                               head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

extern "C" int dst_flash_attn_bwd_dkv_tf32_flat(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dk, void* dv, int batch,
                                                int seq_len, int head_dim, DST_FLAT_STRIDE_ARGS,
                                                float scale, int dtype, int padded_d, int load,
                                                int block_rows, int tile_rows, void* stream) {
  const long long st[16] = DST_FLAT_STRIDES;
  if (dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward_tf32(mh_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, 0, head_dim,
                               st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

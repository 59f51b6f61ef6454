// Flash-attention backward in bf16 for sm_90a on the tensor cores: kernel K2
// (multi-head layout; K2p and K2b at head dims < 128) and kernel K2c (flat
// layout, served as one head), each a dQ kernel and a dK/dV kernel, on
// mma.sync m16n8k16 with bf16 operands and f32 accumulators.
//
// They replace diff_sampler_tpu/ops/pallas_attention.py::_bwd_dq_kernel_mh
// and ::_bwd_dkv_kernel_mh, their packed twins ::_bwd_dq_kernel_mh_packed
// and ::_bwd_dkv_kernel_mh_packed, their streamed twins
// ::_bwd_dq_kernel_mh_stream and ::_bwd_dkv_kernel_mh_stream, and the flat
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel, in bf16; flash_attn_bwd_tf32.cu
// holds the f32 kernels (3xTF32), whose layouts, tile body and math are the
// same.  Per (batch, head), from the forward's output and log-sum-exp:
//   * delta = rowsum(dO * out) in f32, computed by the caller;
//   * S = scale q.k^T and dP = dO.v^T, summed in f32 from bf16 operands;
//   * P = exp(S - lse) and dS = P (dP - delta) in f32, never stored;
//   * P and dS rounded to bf16 before their products, as the JAX kernels
//     round ds.astype(k.dtype), p_t.astype(do.dtype) and ds_t.astype(q.dtype);
//   * dQ = scale dS.k (dQ kernel: a block of query rows loops over keys);
//   * dV = P^T.dO, dK = scale dS^T.q (dK/dV kernel: a block of key rows
//     loops over queries, k-major as _bwd_dkv_kernel_mh);
//   * every sum in f32, the outputs stored in bf16; ragged T: keys >= T drop
//     out of the dQ kernel and queries >= T out of the dK/dV kernel (P = 0),
//     rows >= T are never stored.  No atomics and a fixed order of every
//     sum: deterministic.
//
// Layouts: q, k, v and dO are logical [B, T, H, d] with arbitrary element
// strides; lse and delta contiguous [B, H, T] f32; dq, dk, dv contiguous
// [B, T, H, d].  The flat layout ([B, T, d], lse and delta [B, T]) is the
// same with one head, as the bf16 forward serves K1c.
//
// One tile body serves both kernels, as in flash_attn_bwd_tf32.cu.  A block
// keeps kRows "resident" rows in shared memory (dQ: Q and dO; dK/dV: K and
// V) and streams the other side in tiles of kBC rows (dQ: K and V; dK/dV: Q
// and dO), and each tile is
//   X = RA . CA^T and Y = RB . CB^T  (dQ: S = Q K^T, dP = dO V^T; dK/dV: the
//       transposed S^T = K Q^T and dP^T = V dO^T, keys as rows),
//   P = exp(scale X - lse), dS = P (Y - delta)  (lse and delta are per row
//       in the dQ kernel, in registers; per column in the dK/dV kernel, read
//       from a row of shared memory staged with the tile),
//   dQ += dS . CA, or dV += P . CB and dK += dS . CA.
// Nothing is transposed: X and Y read RA / RB as A operands and CA / CB as
// "col" B operands with ldmatrix, as the forward reads Q and K; the C
// fragments of two adjacent n8 tiles of P or dS, rounded to nearest even
// and packed to bf16x2 in registers, are the A fragment of the next product
// (a k-step of 16 streamed rows), whose B fragment is CA / CB through
// ldmatrix.trans, as the forward reads V.  The tensor cores take the bf16
// operands as they are, so the rounding of P and dS costs one cvt a pair.
//
// Warps: 8, each owning one m-tile (16 resident rows) and, below padded d
// 128, all of d: 128 resident rows per block.  From padded d 128 up two
// warps share an m-tile, each over half of d (64 rows per block): each
// computes the partial X and Y over its half, the pair adds the two through
// shared memory (a named barrier for the pair; both add in the same order,
// so both hold the same bits), and each accumulates its half of the output
// columns.  That halves the accumulators (the dK/dV kernel holds two d-wide
// ones: 2 x DP / 2 registers a thread at 256).  Streamed tiles are 64 rows
// up to padded d 64 and 32 above; shared-memory rows are padded by 8 bf16,
// an odd number of 16-byte units, so ldmatrix is free of bank conflicts.
// Head dims: d is padded to DP, the next of 16, 32, 48, 64, 80, 128, 160,
// 256, the padding zero-filled.
// Loads, double buffered: streamed tile j + 1 is in flight while tile j is
// multiplied.
//   * cp.async: 16-byte copies straight into the tiles where q, k, v and dO
//     all take them (the LDM's legacy split, SD's projections, the flat
//     copies, contiguous tensors);
//   * from the qkv rows (Span): q, k, v are one projection's interleaved
//     (c, qkv) channels (SongUNet, DhariwalUNet) at padded d 32 / 64 / 128 /
//     256, and dO takes 16-byte copies: 16-byte cp.async of the rows q, k
//     and v share into a raw stage, split into Q, K and V tiles by byte
//     permutes in registers (flash_fwd.cuh), dO with cp.async;
//   * gather: any other view (an unaligned or transposed dO).  Element
//     loads through registers into the next stage before tile j's products.
// Bound: the tensor cores' operations, 3 products (dQ kernel) or 4 (dK/dV)
// of 2 B H T^2 d flops at 989 TFLOP/s (dense), which mma.sync does not
// reach; the exponentials (B H T^2 in each kernel on the 16 MUFU lanes per
// SM per clock), the packing of P and dS and the ldmatrix loads take
// scheduler cycles beside the products.  Not done yet: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Tiles of the padded head dim DP (mirrored by ops/attention.py::bwd_route),
// the same for both kernels.
template <int DP>
struct Bb {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSplitD = DP >= 128 ? 2 : 1;    // warps per m-tile
  static constexpr int kHalf = DP / kSplitD;           // columns of d per warp
  static constexpr int kRows = 16 * kWarps / kSplitD;  // resident rows per block
  static constexpr int kBC = DP <= 64 ? 64 : 32;       // streamed rows per tile
  static constexpr int kStride = DP + 8;               // bf16 per shared-memory row
  static constexpr int kRTile = kRows * kStride;
  static constexpr int kCTile = kBC * kStride;
  static constexpr int kStages = 2;
  // a stage: CA, CB, then the dK/dV kernel's lse and delta of its kBC columns
  static constexpr int kStageBytes = 2 * 2 * kCTile + 2 * 4 * kBC;
  static constexpr int kXchgWarp = 2 * (kBC / 8) * 4 * 32;  // floats: a warp's partial X, Y
  static constexpr int kXchg = kSplitD == 2 ? kWarps * kXchgWarp : 0;
  static constexpr int kRaw = 3 * DP;  // bf16 per row of the span mode's raw stage
  __host__ __device__ static constexpr size_t smem_bytes(int mode) {
    return 2 * 2 * kRTile + kStages * kStageBytes + 4 * kXchg +
           (mode == kLoadSpan ? 2 * kBC * kRaw : 0);
  }
  static_assert(kHalf % 16 == 0 && kBC % 16 == 0, "k-steps of 16, n-tiles in pairs");
};

// cp.async copies of rows [t0, t0 + R) of x into a tile of R rows, 16 bytes
// (8 bf16) each, consecutive threads on consecutive 16 bytes of a row; rows
// >= seq_len and columns >= d zero-filled.
template <int DP, int R>
__device__ __forceinline__ void copy_async(bf16* tile, const Rows<bf16>& x, int t0, int seq_len,
                                           int d) {
  constexpr int kVecs = DP / 8, kThreads = Bb<DP>::kThreads;
  constexpr int kN = (R * kVecs + kThreads - 1) / kThreads;
  const bf16* base = x.p + t0 * x.st;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kN * kThreads != R * kVecs && idx >= R * kVecs) break;
    const int r = idx / kVecs, c = 8 * (idx - r * kVecs);
    const bool in = t0 + r < seq_len && c < d;
    cp_async16(tile + r * Bb<DP>::kStride + c, in ? base + r * x.st + c : x.p, in);
  }
}

// Element loads of rows [t0, t0 + R) of any view into a tile of R rows,
// consecutive threads on consecutive elements of a row, kChunk loads in
// flight a thread; zero past seq_len and d.
template <int DP, int R>
__device__ __forceinline__ void copy_gather(bf16* tile, const Rows<bf16>& x, int t0, int seq_len,
                                            int d) {
  constexpr int kThreads = Bb<DP>::kThreads, kN = R * DP / kThreads;
  constexpr int kChunk = kN % 8 == 0 ? 8 : kN % 4 == 0 ? 4 : 2;
  static_assert(kN * kThreads == R * DP && kN % kChunk == 0, "whole rounds of the block");
  const unsigned short* src = reinterpret_cast<const unsigned short*>(x.p);
  unsigned short* dst = reinterpret_cast<unsigned short*>(tile);
#pragma unroll 1
  for (int i0 = 0; i0 < kN; i0 += kChunk) {
    unsigned short v[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      const int r = idx / DP, e = idx - r * DP;
      v[i] = t0 + r < seq_len && e < d ? __ldg(src + (t0 + r) * x.st + e * x.se) : 0;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      const int r = idx / DP, e = idx - r * DP;
      dst[r * Bb<DP>::kStride + e] = v[i];
    }
  }
}

// The span mode: kBC rows [t0, t0 + kBC) of one qkv projection's
// interleaved (c, qkv) rows (q of row t at span + t * st, k and v one and
// two elements on; 16-byte aligned) into a raw stage of kBC rows of 3 DP
// bf16, then split into Q, or K and V, tiles.  A unit of 8 columns is 24
// contiguous elements, three 16-byte chunks; the units of the kBC rows are
// numbered row by row and dealt to the warps in groups of 32 (whole rows,
// DP / 8 a power of two), lane l copying chunks l, l + 32 and l + 64 of each
// of its warp's groups and splitting unit l of each once they have landed.
// A warp reads only the raw rows it copied, so __syncwarp orders them and no
// barrier guards the raw stage.  Units at columns >= d are not copied and
// split to zero; rows >= seq_len come out zero.
template <int DP>
struct Span {
  static constexpr int kUnits = DP / 8;
  static constexpr int kRaw = Bb<DP>::kRaw;
  static constexpr int kGroups = Bb<DP>::kBC * kUnits / (32 * Bb<DP>::kWarps);  // per warp
  static constexpr int kGroupRows = 32 / kUnits;
  static_assert(kUnits <= 32 && 32 % kUnits == 0 && kGroups >= 1 &&
                    kGroups * 32 * Bb<DP>::kWarps == Bb<DP>::kBC * kUnits,
                "units of 8 columns fill whole rows and 32-unit groups");

  __device__ static __forceinline__ int first_row() {
    return (threadIdx.x >> 5) * kGroups * kGroupRows;
  }

  __device__ static __forceinline__ void copy(bf16* raw, const bf16* span, long long st, int t0,
                                              int seq_len, int d) {
    const int lane = threadIdx.x & 31, first = first_row();
    const bf16* base = span + t0 * st;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int chunk = lane + 32 * c, unit = chunk / 3, part = chunk - 3 * unit;
        const int r = first + g * kGroupRows + unit / kUnits, u = unit % kUnits;
        if (8 * u >= d) continue;
        const int off = 24 * u + 8 * part;
        const bool in = t0 + r < seq_len;
        cp_async16(raw + r * kRaw + off, in ? base + r * st + off : span, in);
      }
  }

  // after this warp's copies have landed: K and V, or Q, of its rows
  template <bool KV>
  __device__ static __forceinline__ void split(const bf16* raw, bf16* t0, bf16* t1, int d) {
    const int lane = threadIdx.x & 31, col = 8 * (lane % kUnits);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = first_row() + g * kGroupRows + lane / kUnits;
      uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
      if (col < d) {
        const uint4* p = reinterpret_cast<const uint4*>(raw + r * kRaw + 3 * col);
        if constexpr (KV)
          split_unit_kv(p[0], p[1], p[2], x0, x1);
        else
          x0 = split_unit_q(p[0], p[1], p[2]);
      }
      *reinterpret_cast<uint4*>(t0 + r * Bb<DP>::kStride + col) = x0;
      if constexpr (KV) *reinterpret_cast<uint4*>(t1 + r * Bb<DP>::kStride + col) = x1;
    }
  }
};

__device__ __forceinline__ void pair_barrier(int id) {  // the two warps of one m-tile
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// x = RA . CA^T over this warp's kHalf columns: x[n] is n-tile n (8
// streamed rows) of the warp's 16 resident rows.  ra: the resident tile at
// this lane's A offset; ca the streamed tile at its B offset.
template <int DP>
__device__ __forceinline__ void scores(float (&x)[Bb<DP>::kBC / 8][4], const bf16* ra,
                                       const bf16* ca) {
  using C = Bb<DP>;
  constexpr int S = C::kStride;
#pragma unroll
  for (int n = 0; n < C::kBC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kHalf / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, ra + 16 * kk);
#pragma unroll
    for (int np = 0; np < C::kBC / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ca + np * 16 * S + 16 * kk);
      mma_bf16(x[2 * np], a, b);
      mma_bf16(x[2 * np + 1], a, b + 2);
    }
  }
}

// acc += p . CB over this tile: p (the C fragments of P or dS, the warp's 16
// resident rows by kBC streamed rows) rounded to bf16 as the A operand, k-step
// kk the streamed rows 16 kk..16 kk + 15; CB's rows through ldmatrix.trans as
// B (cb at this lane's offset), 16 columns of d a load.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[Bb<DP>::kHalf / 8][4],
                                           const float (&p)[Bb<DP>::kBC / 8][4], const bf16* cb) {
  using C = Bb<DP>;
  constexpr int S = C::kStride;
#pragma unroll
  for (int kk = 0; kk < C::kBC / 16; ++kk) {
    const uint32_t a[4] = {pack_rn(p[2 * kk][0], p[2 * kk][1]), pack_rn(p[2 * kk][2], p[2 * kk][3]),
                           pack_rn(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_rn(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < C::kHalf / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, cb + kk * 16 * S + 16 * np);
      mma_bf16(acc[2 * np], a, b);
      mma_bf16(acc[2 * np + 1], a, b + 2);
    }
  }
}

// Rows row0 + g (+ 8) (< seq_len) of an output (row t at out + t * ost), this
// warp's columns below d, times mul, rounded to bf16.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, long long ost,
                                           const float (&acc)[Bb<DP>::kHalf / 8][4], float mul,
                                           int row0, int col0, int seq_len, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + g + 8 * r;
    if (t >= seq_len) continue;
    bf16* orow = out + t * ost + col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < Bb<DP>::kHalf / 8; ++n)
      if (col0 + 8 * n < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(mul * acc[n][2 * r], mul * acc[n][2 * r + 1]);
  }
}

// One block: resident rows [r0, r0 + kRows) of one (batch, head) against
// every streamed tile.  dQ kernel (DKV false): ra = Q, rb = dO, ca = K, cb =
// V, lse / delta of the queries, o0 = dq.  dK/dV kernel: ra = K, rb = V, ca
// = Q, cb = dO, lse / delta of the queries (the streamed rows), o0 = dk, o1 =
// dv.  Output row t at o[t * ost]; lse and delta at the head's token 0.  In
// the span mode Q, K and V come from the qkv rows that start at q (ra in the
// dQ kernel, ca in the dK/dV kernel), dO with cp.async.
template <int DP, bool DKV, int MODE>
__device__ __forceinline__ void bwd_tile_bf16(Rows<bf16> ra, Rows<bf16> rb, Rows<bf16> ca,
                                              Rows<bf16> cb, const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              bf16* __restrict__ o0, bf16* __restrict__ o1,
                                              long long ost, int seq_len, int d, float scale,
                                              int r0) {
  using C = Bb<DP>;
  constexpr int S = C::kStride, BC = C::kBC, R = C::kRows;
  constexpr int kCTiles = BC / 8;         // n-tiles of X and Y
  constexpr int kDTiles = C::kHalf / 8;  // n-tiles of each accumulator
  constexpr bool kSpan = MODE == kLoadSpan;
  using Sp = Span<DP>;  // used only in the span mode's branches

  // RA, RB; the stages; the exchange; the span mode's raw stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sRA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sRB = sRA + C::kRTile;
  unsigned char* sC = reinterpret_cast<unsigned char*>(sRB + C::kRTile);
  float* sXchg = reinterpret_cast<float*>(sC + C::kStages * C::kStageBytes);
  bf16* sRaw = reinterpret_cast<bf16*>(sXchg + C::kXchg);
  // in a stage: CA at 0, CB at kCTile, the column statistics after them
  auto stage = [&](int j) {
    return reinterpret_cast<bf16*>(sC + (j % C::kStages) * C::kStageBytes);
  };
  const Rows<bf16>& span = DKV ? ca : ra;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp / C::kSplitD;                  // this warp's m-tile
  const int col0 = (warp % C::kSplitD) * C::kHalf;  // and its first column of d
  const int n_tiles = (seq_len + BC - 1) / BC;

  // the resident tiles
  if constexpr (MODE == kLoadAsync) {
    copy_async<DP, R>(sRA, ra, r0, seq_len, d);
    copy_async<DP, R>(sRB, rb, r0, seq_len, d);
  } else if constexpr (MODE == kLoadGather) {
    copy_gather<DP, R>(sRA, ra, r0, seq_len, d);
    copy_gather<DP, R>(sRB, rb, r0, seq_len, d);
  } else {  // K and V, or Q, through the raw stage kBC rows at a time; dO copied
    if constexpr (!DKV) copy_async<DP, R>(sRB, rb, r0, seq_len, d);
#pragma unroll 1
    for (int c0 = 0; c0 < R; c0 += BC) {
      Sp::copy(sRaw, span.p, span.st, r0 + c0, seq_len, d);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      Sp::template split<DKV>(sRaw, sRA + c0 * S, sRB + c0 * S, d);
      __syncwarp();  // the raw rows are read before they are copied again
    }
  }

  // tile j's CA and CB (those not from the qkv rows) and, in the dK/dV
  // kernel, its queries' lse and delta, into its stage
  auto copy_stage = [&](int j) {
    bf16* st = stage(j);
    const int c0 = j * BC;
    if constexpr (MODE == kLoadAsync) {
      copy_async<DP, BC>(st, ca, c0, seq_len, d);
      copy_async<DP, BC>(st + C::kCTile, cb, c0, seq_len, d);
    } else if constexpr (MODE == kLoadGather) {
      copy_gather<DP, BC>(st, ca, c0, seq_len, d);
      copy_gather<DP, BC>(st + C::kCTile, cb, c0, seq_len, d);
    } else {
      Sp::copy(sRaw, span.p, span.st, c0, seq_len, d);
      if constexpr (DKV) copy_async<DP, BC>(st + C::kCTile, cb, c0, seq_len, d);
    }
    if constexpr (DKV) {  // lse, then delta, of the tile's queries
      float* stats = reinterpret_cast<float*>(st + 2 * C::kCTile);
      if (threadIdx.x < 2 * BC) {
        const int r = threadIdx.x % BC;
        const float* src = threadIdx.x < BC ? lse : delta;
        const bool in = c0 + r < seq_len;
        cp_async4(stats + threadIdx.x, in ? src + c0 + r : src, in);
      }
    }
  };
  // span mode: split tile j's raw rows (this warp's) into its stage
  auto split_stage = [&](int j) {
    if constexpr (kSpan) {
      cp_async_wait<0>();
      __syncwarp();
      bf16* st = stage(j);
      Sp::template split<!DKV>(sRaw, st, st + C::kCTile, d);
    }
  };
  copy_stage(0);
  cp_async_commit();
  split_stage(0);

  // this lane's offsets: A (ldmatrix, k-step kk at + 16 kk), B "col"
  // (ldmatrix, streamed rows + 16 per pair of n-tiles), B transposed
  // (ldmatrix.trans, streamed rows + 16 per k-step, columns + 16 per pair of
  // n-tiles); each within this warp's columns
  const int a_off = (mt * 16 + (lane & 15)) * S + (lane >> 4) * 8 + col0;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 8 + col0;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8 + col0;

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
    const bf16* cA = stage(j);
    const bf16* cB = cA + C::kCTile;
    const float* stats = reinterpret_cast<const float*>(cA + 2 * C::kCTile);

    float x[kCTiles][4], y[kCTiles][4];
    scores<DP>(x, sRA + a_off, cA + b_off);
    scores<DP>(y, sRB + a_off, cB + b_off);
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
          l2 = stats[c] * kLog2e;
          dl = stats[BC + c];
        } else {
          l2 = row_lse[i >> 1];
          dl = row_delta[i >> 1];
        }
        const float p = c0 + c < seq_len ? ex2(fmaf(x[n][i], sl2, -l2)) : 0.f;
        x[n][i] = p;
        y[n][i] = p * (y[n][i] - dl);
      }

    if constexpr (DKV) {
      accumulate<DP>(acc1, x, cB + v_off);  // dV += P^T dO
      accumulate<DP>(acc0, y, cA + v_off);  // dK += dS^T Q
    } else {
      accumulate<DP>(acc0, y, cA + v_off);  // dQ += dS K
    }
    if (j + 1 < n_tiles) split_stage(j + 1);
  }

  const int row0 = r0 + mt * 16;
  store_rows<DP>(o0, ost, acc0, scale, row0, col0, seq_len, d);
  if constexpr (DKV) store_rows<DP>(o1, ost, acc1, 1.f, row0, col0, seq_len, d);
}

// Grid (resident tiles, heads, batch); the flat layout runs as one head
// (strides h = 0).  lse and delta [B, H, T], outputs contiguous [B, T, H, d].
#define DST_BF16_HEAD                                                                 \
  const int h = blockIdx.y, b = blockIdx.z;                                            \
  const long long bh = static_cast<long long>(b) * num_heads + h;                      \
  const long long out0 = (static_cast<long long>(b) * seq_len * num_heads + h) * d;    \
  const long long ost = static_cast<long long>(num_heads) * d;                         \
  const Rows<bf16> rq{q + b * sq.b + h * sq.h, sq.t, sq.e};                             \
  const Rows<bf16> rk{k + b * sk.b + h * sk.h, sk.t, sk.e};                             \
  const Rows<bf16> rv{v + b * sv.b + h * sv.h, sv.t, sv.e};                             \
  const Rows<bf16> rdo{dout + b * sdo.b + h * sdo.h, sdo.t, sdo.e}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bb<DP>::kThreads, 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int seq_len, int num_heads, int d, Strides sq,
                         Strides sk, Strides sv, Strides sdo, float scale) {
  DST_BF16_HEAD;
  bwd_tile_bf16<DP, false, MODE>(rq, rdo, rk, rv, lse + bh * seq_len, delta + bh * seq_len,
                                 dq + out0, nullptr, ost, seq_len, d, scale,
                                 blockIdx.x * Bb<DP>::kRows);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(Bb<DP>::kThreads, 1)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len,
                          int num_heads, int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                          float scale) {
  DST_BF16_HEAD;
  bwd_tile_bf16<DP, true, MODE>(rk, rv, rq, rdo, lse + bh * seq_len, delta + bh * seq_len,
                                dk + out0, dv + out0, ost, seq_len, d, scale,
                                blockIdx.x * Bb<DP>::kRows);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *d0, *d1;                     // dq, or dk and dv
  int batch, seq_len, num_heads, d;  // num_heads 0: the flat layout
  Strides sq, sk, sv, sdo;
  float scale;
  cudaStream_t stream;
};

template <int DP, int MODE>
cudaError_t run_bwd(const BwdArgs& a) {
  using C = Bb<DP>;
  constexpr size_t smem = C::smem_bytes(MODE);
  static_assert(smem <= 232448, "one block fits the SM's shared memory");
  const int heads = a.num_heads == 0 ? 1 : a.num_heads;  // flat: one head, sh = 0
  const dim3 grid((a.seq_len + C::kRows - 1) / C::kRows, heads, a.batch);
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.dout);
  cudaError_t err;
  if (a.d1 != nullptr) {
    auto kernel = &flash_bwd_dkv_bf16_kernel<DP, MODE>;
    if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, smem, a.stream>>>(
        q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.d0), static_cast<bf16*>(a.d1),
        a.seq_len, heads, a.d, a.sq, a.sk, a.sv, a.sdo, a.scale);
  } else {
    auto kernel = &flash_bwd_dq_bf16_kernel<DP, MODE>;
    if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, smem, a.stream>>>(q, k, v, g, a.lse, a.delta,
                                                  static_cast<bf16*>(a.d0), a.seq_len, heads,
                                                  a.d, a.sq, a.sk, a.sv, a.sdo, a.scale);
  }
  return cudaGetLastError();
}

// The route names this kernel's tiles and a load mode: cp.async only where
// q, k, v and dO all take 16-byte copies, the qkv rows only where q, k, v
// are one projection's interleaved views and dO takes 16-byte copies (each
// checked again here: a misaligned cp.async faults), the element gather for
// any view.
template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, const Route& r) {
  using C = Bb<DP>;
  if (r.block_q != C::kRows || r.block_k != C::kBC) return cudaErrorInvalidValue;
  const bool dout16 = aligned16<bf16>(a.dout, a.sdo, a);
  switch (r.load) {
    case kLoadAsync:
      if (!(aligned16<bf16>(a.q, a.sq, a) && aligned16<bf16>(a.k, a.sk, a) &&
            aligned16<bf16>(a.v, a.sv, a) && dout16))
        return cudaErrorInvalidValue;
      return run_bwd<DP, kLoadAsync>(a);
    case kLoadGather:
      return run_bwd<DP, kLoadGather>(a);
    case kLoadSpan:
      if constexpr (span_dim(DP)) {
        if (a.num_heads == 0 || !qkv_span<bf16>(a) || !dout16) return cudaErrorInvalidValue;
        return run_bwd<DP, kLoadSpan>(a);
      }
      break;
  }
  return cudaErrorInvalidValue;
}

int backward_bf16(const BwdArgs& a, int dtype, const Route& r) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype != 1 || a.d < 8 || a.d % 8 != 0 || a.d > r.padded_d) return static_cast<int>(err);
  switch (r.padded_d) {  // the padded dims of the bf16 backward
    case 16: err = launch_bwd<16>(a, r); break;
    case 32: err = launch_bwd<32>(a, r); break;
    case 48: err = launch_bwd<48>(a, r); break;
    case 64: err = launch_bwd<64>(a, r); break;
    case 80: err = launch_bwd<80>(a, r); break;
    case 128: err = launch_bwd<128>(a, r); break;
    case 160: err = launch_bwd<160>(a, r); break;
    case 256: err = launch_bwd<256>(a, r); break;
  }
  return static_cast<int>(err);
}

BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* d0, void* d1, int batch, int seq_len, int num_heads,
                 int head_dim, const long long* st, float scale, void* stream) {
  return BwdArgs{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 d0, d1, batch, seq_len, num_heads, head_dim, Strides{st[0], st[1], st[2], st[3]},
                 Strides{st[4], st[5], st[6], st[7]}, Strides{st[8], st[9], st[10], st[11]},
                 Strides{st[12], st[13], st[14], st[15]}, scale,
                 static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K2 in bf16: dtype must be 1 (bfloat16; float32 takes the _tf32 entries of
// flash_attn_bwd_tf32.cu).  Strides are in elements, ordered (batch, token,
// head, channel), for q, k, v and dO in turn; lse and delta are contiguous
// [B, H, T] f32; head_dim is a multiple of 8 up to 256.  Then the route
// (padded d, load mode 1: cp.async, 2: the element gather, 3: the qkv rows,
// the resident rows per block, the streamed rows per tile); a route that does
// not match this kernel's tables is refused.  Each returns the cudaError_t
// of its launch.
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

extern "C" int dst_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int batch, int seq_len, int num_heads,
                                     int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                     int padded_d, int load, int block_rows, int tile_rows,
                                     void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return backward_bf16(bwd_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len,
                                num_heads, head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

extern "C" int dst_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int seq_len, int num_heads,
                                      int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                      int padded_d, int load, int block_rows, int tile_rows,
                                      void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1 || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward_bf16(bwd_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, num_heads,
                                head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

// K2c in bf16, the flat layout: strides (batch, token, channel) for q, k, v
// and dO; lse and delta [B, T]; the outputs contiguous [B, T, head_dim];
// then the route, as above (never the qkv rows).
extern "C" int dst_flash_attn_bwd_dq_flat(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int batch, int seq_len, int head_dim,
                                          DST_FLAT_STRIDE_ARGS, float scale, int dtype,
                                          int padded_d, int load, int block_rows, int tile_rows,
                                          void* stream) {
  const long long st[16] = DST_FLAT_STRIDES;
  return backward_bf16(bwd_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len, 0,
                                head_dim, st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

extern "C" int dst_flash_attn_bwd_dkv_flat(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int batch, int seq_len,
                                           int head_dim, DST_FLAT_STRIDE_ARGS, float scale,
                                           int dtype, int padded_d, int load, int block_rows,
                                           int tile_rows, void* stream) {
  const long long st[16] = DST_FLAT_STRIDES;
  if (dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward_bf16(bwd_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, 0, head_dim,
                                st, scale, stream),
                       dtype, Route{padded_d, load, block_rows, tile_rows});
}

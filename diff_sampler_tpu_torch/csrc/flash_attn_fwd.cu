// Flash-attention forward for sm_90a: kernel K1 (multi-head layout) and
// kernel K1c (flat layout).
//
// K1 replaces diff_sampler_tpu/ops/pallas_attention.py::_attn_kernel_mh and,
// at head dims < 128, its packed twin ::_attn_kernel_mh_packed (K1b; both
// launched by _flash_fwd_mh_res).  The TPU kernel packs 128 / d heads into
// one block-diagonal matmul to fill the MXU's 128 lanes; that has no purpose
// on this card, and every head dim runs one head per block here.
// K1c replaces ::_attn_kernel (launched by _flash_fwd_res, the entry of
// flash_attention), the same function on a flat [B*H, T, d] layout, which
// the JAX sdpa takes where the multi-head kernel's VMEM plan fails (Stable
// Diffusion in f32 at T = 4096, 8 heads of d = 40).
// Same math as the TPU kernels, not the same blocking:
//   * non-causal softmax attention per (batch, head);
//   * f32 logits, the scale applied to the f32 q.k product;
//   * online softmax over key tiles in f32;
//   * P cast to bf16 before P@V (its row sums l taken from the f32 values),
//     f32 accumulation;
//   * output in bf16 plus the per-row log-sum-exp in f32;
//   * ragged T: keys >= T masked, query rows >= T never stored.
//
// Layouts.  K1: q/k/v are logical [B, T, H, d] with arbitrary element
// strides, so the kernels read them straight out of the qkv projection's
// interleaved (head, c, qkv) channel layout; out is a contiguous
// [B, T, H, d], lse a contiguous [B, H, T].  K1c: q/k/v are logical
// [B, T, d] with arbitrary strides (B folds batch * heads); out is a
// contiguous [B, T, d], lse a contiguous [B, T]: the multi-head layout with
// one head, which is how the bf16 kernel serves it (the f32 kernel has a
// flat entry of its own).
//
// This file holds the bf16 kernel; the f32 one (3xTF32 on the tensor cores,
// the same structure and load modes) is flash_attn_fwd_tf32.cu, and the
// pieces both use are in flash_fwd.cuh.  The route is
// ops/attention.py::fwd_route, which passes the padded head dim, the load
// mode and the tile sizes; the entry points check them against the tables
// here.
//
// bf16: flash_fwd_tc_kernel, on the tensor cores (FlashAttention-2's
// structure, mma.sync m16n8k16 with f32 accumulators).  A block owns a
// 128-query tile: 8 warps of one m-tile (16 rows) each, or, at padded d =
// 48 to 80, 4 warps of two m-tiles, so that each K / V fragment a warp loads
// from shared memory feeds two products.  Q is loaded once and kept as
// ldmatrix A fragments in registers (re-read from shared memory at padded d
// = 256, where registers would spill).  K / V tiles of BK keys are staged in
// shared memory, three stages in cp.async mode (two tiles in flight while
// one is multiplied), two otherwise.  S = Q K^T takes K as the "col" B
// operand straight from ldmatrix; the online softmax runs on the S
// accumulators in registers (a row lives in one quad of 4 lanes: shuffles
// over 1 and 2), exp2 on log2(e)-prescaled logits, its running max moved
// only when a row would pass it by more than 2^8 (softmax_tile); P is
// rounded to bf16 in registers and fed to P V as the A operand (two adjacent
// m16n8 C fragments are one m16n8k16 A fragment), with V through
// ldmatrix.trans.  Rows are padded by 8 bf16 in shared memory, an odd number
// of 16-byte units, so ldmatrix is free of bank conflicts.
// Head dims: d is padded to DP, the next of 16, 32, 48, 64, 80, 128, 160,
// 256; the padding is zero-filled in shared memory.  Q K^T contracts over
// all DP / 16 k-steps (every tier's d needs them all); P V skips the last
// n-tile of 8 where d = DP - 8, so d = 40 pays nothing there.  Load modes:
//   * cp.async: 16-byte copies straight into the tiles, where every view
//     has element stride 1, a 16-byte aligned base and row, head and batch
//     strides that are multiples of 8 elements (SD's separate projections,
//     the LDM's legacy split);
//   * gather from the qkv rows (SpanTile): q, k, v are one projection's
//     interleaved (c, qkv) channels, element stride 3 (SongUNet and
//     DhariwalUNet): 16-byte cp.async of the rows they share, split into
//     Q, K and V tiles in registers;
//   * gather (Staged): any other view.  Element loads, consecutive lanes on
//     consecutive elements of a row, staged in registers: tile j + 1's K
//     is loaded before tile j's Q K^T and stored to shared memory after it,
//     its V around the softmax and P V.
// Bound: the tensor cores' operations (4 B H T^2 d flops at 989 TFLOP/s),
// which mma.sync does not reach; at d <= 64 the exponentials (B H T^2 on the
// 16 MUFU lanes per SM per clock) and the softmax's instructions take about
// as long as the products, and each block reads its head's K and V from L2
// once per 128 queries (1.5 times that from the qkv rows, which carry q).
// Not done yet: wgmma and TMA (Hopper's full tensor-core rate; TMA cannot
// read element stride 3), warp specialisation, exp2 emulated on the FMA
// units, and clusters that share a head's K / V tiles between blocks.
// Deterministic: no atomics, no split over keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_fwd.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;


// Tiles of the padded head dim DP (mirrored by ops/attention.py::fwd_route):
// kWarps warps, each owning kMT m-tiles of 16 query rows, so that every K / V
// fragment a warp loads from shared memory feeds kMT products.
template <int DP>
struct Tc {
  static constexpr int kMT = DP >= 48 && DP <= 80 ? 2 : 1;  // m-tiles per warp
  static constexpr int kWarps = kMT == 2 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kMT * kWarps;              // query rows per block: 128
  static constexpr int kBK = DP <= 64 ? 64 : 32;             // keys per tile
  static constexpr bool kQInRegs = DP <= 160;  // Q's A fragments stay in registers
  static constexpr int kStride = DP + 8;       // bf16 per shared-memory row
  static constexpr int kTile = kBK * kStride;  // one stage of K or of V
  // K / V stages: three for cp.async (two tiles in flight), two otherwise
  __host__ __device__ static constexpr int stages(int mode) {
    return mode == kLoadAsync ? 3 : 2;
  }
  __host__ __device__ static constexpr size_t smem_bytes(int mode) {  // span: plus raw
    return sizeof(bf16) *
           (kBQ * kStride + 2 * stages(mode) * kTile + (mode == kLoadSpan ? kBK * 3 * DP : 0));
  }
  // the gather stages a K or V tile in kSplit pieces of kPiece rows, at most
  // 16 elements a thread each
  static constexpr int kSplit = kBK / kWarps * ((DP + 31) / 32) > 16 ? 2 : 1;
  static constexpr int kPiece = kBK / kSplit;
};


// cp.async copies of rows [t0, t0 + R) of x into a tile of R rows, 16 bytes
// each; rows >= seq_len and columns >= d are zero-filled.  This thread's
// copies and their offsets are worked out once, for every tile.
template <int DP, int R>
struct AsyncTile {
  static constexpr int kVecs = DP / 8;
  static constexpr int kN = (R * kVecs + Tc<DP>::kThreads - 1) / Tc<DP>::kThreads;
  static constexpr bool kAll = kN * Tc<DP>::kThreads == R * kVecs;  // no idle slots
  long long off[kN];  // the copy's element offset in x from row t0
  int row[kN];        // its row in the tile; 1 << 30 for a padding column
  int dst[kN];        // its element offset in the tile; -1: no copy

  __device__ __forceinline__ AsyncTile(const Rows<bf16>& x, int d) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * Tc<DP>::kThreads;
      const int r = idx / kVecs, c = idx - r * kVecs;
      off[i] = r * x.st + 8 * c;
      row[i] = 8 * c < d ? r : 1 << 30;
      dst[i] = kAll || idx < R * kVecs ? r * Tc<DP>::kStride + 8 * c : -1;
    }
  }

  __device__ __forceinline__ void copy(bf16* tile, const Rows<bf16>& x, int t0,
                                       int seq_len) const {
    const bf16* base = x.p + t0 * x.st;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (!kAll && dst[i] < 0) continue;
      const bool in = t0 + row[i] < seq_len;
      cp_async16(tile + dst[i], in ? base + off[i] : x.p, in);
    }
  }
};

// K and V tiles, rows [t0, t0 + R), out of the interleaved (c, qkv) rows of
// one qkv projection: k at element 3 c + 1 and v at 3 c + 2 of a row that
// starts at span = k - 1 (16-byte aligned, as are its row strides).  A unit
// of 8 columns is 24 contiguous elements, three 16-byte chunks.  The units
// of a tile are numbered row by row and dealt to the warps in groups of 32;
// a warp copies its groups' chunks with cp.async into a raw stage, lane l
// taking chunks l, l + 32 and l + 64 of a group (consecutive lanes on
// consecutive 16 bytes), and after the copies have landed lane l splits
// unit l of each group in registers (byte permutes) into one 16-byte store
// to K and one to V.  A warp reads only the raw slots it copied, so
// __syncwarp orders them and no barrier guards the raw stage.  Rows >=
// seq_len come out zero (zero-filled copies), columns >= d zero.  DP / 8 is
// a power of two up to 32 (DP = 32, 64, 128, 256), so a group spans whole
// rows.
template <int DP, int R>
struct SpanTile {
  static constexpr int kUnits = DP / 8;  // per row
  static constexpr int kRaw = 3 * DP;    // raw stage row, in bf16
  static constexpr int kGroups = R * kUnits / (32 * Tc<DP>::kWarps);  // per warp
  static constexpr int kGroupRows = 32 / kUnits;
  static_assert(kUnits <= 32 && 32 % kUnits == 0 && kGroups >= 1 &&
                    kGroups * 32 * Tc<DP>::kWarps == R * kUnits,
                "units of 8 columns fill whole rows and 32-unit groups");
  long long off[3];  // chunk c's element offset in the span from row t0, group 0
  int row[3];        // its row in the tile, group 0; 1 << 30 in a padding unit
  int first;         // this warp's first row
  int col;           // column of the unit this lane splits

  __device__ __forceinline__ SpanTile(long long st, int d) {
    const int lane = threadIdx.x & 31;
    first = (threadIdx.x >> 5) * kGroups * kGroupRows;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int chunk = lane + 32 * c, unit = chunk / 3, part = chunk - 3 * unit;
      const int r = first + unit / kUnits, u = unit % kUnits;
      off[c] = r * st + 24 * u + 8 * part;
      row[c] = 8 * u < d ? r : 1 << 30;
    }
    col = 8 * (lane % kUnits);
  }

  __device__ __forceinline__ void copy(bf16* stage, const bf16* span, long long st, int t0,
                                       int seq_len) const {
    const int lane = threadIdx.x & 31;
    const bf16* base = span + t0 * st;
    bf16* raw = stage + first * kRaw + 8 * lane;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int r = row[c] + g * kGroupRows;
        if (row[c] == 1 << 30) continue;
        const bool in = t0 + r < seq_len;
        cp_async16(raw + g * 32 * 24 + c * 256, in ? base + off[c] + g * kGroupRows * st : span,
                   in);
      }
  }

  // after this warp's copies have landed
  __device__ __forceinline__ void split(const bf16* stage, bf16* tk, bf16* tv, int d) const {
    const int lane = threadIdx.x & 31;
    const bool real = col < d;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = first + g * kGroupRows + lane / kUnits;
      uint4 ko = make_uint4(0, 0, 0, 0), vo = ko;
      if (real) {
        const uint4* p = reinterpret_cast<const uint4*>(stage + r * kRaw + 3 * col);
        split_unit_kv(p[0], p[1], p[2], ko, vo);
      }
      *reinterpret_cast<uint4*>(tk + r * Tc<DP>::kStride + col) = ko;
      *reinterpret_cast<uint4*>(tv + r * Tc<DP>::kStride + col) = vo;
    }
  }

  // the same for the q of the rows: rows [t0, t0 + R) of the Q tile
  __device__ __forceinline__ void split_q(const bf16* stage, bf16* tq, int d) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = first + g * kGroupRows + lane / kUnits;
      uint4 qo = make_uint4(0, 0, 0, 0);
      if (col < d) {
        const uint4* p = reinterpret_cast<const uint4*>(stage + r * kRaw + 3 * col);
        qo = split_unit_q(p[0], p[1], p[2]);
      }
      *reinterpret_cast<uint4*>(tq + r * Tc<DP>::kStride + col) = qo;
    }
  }
};

// The other modes' stand-in for SpanTile.
struct NoSpan {
  __device__ __forceinline__ NoSpan(long long, int) {}
  __device__ __forceinline__ void copy(bf16*, const bf16*, long long, int, int) const {}
  __device__ __forceinline__ void split(const bf16*, bf16*, bf16*, int) const {}
  __device__ __forceinline__ void split_q(const bf16*, bf16*, int) const {}
};

// Rows [t0, t0 + R) of x staged in registers: warp w takes rows w, w + kWarps,
// ..., its lanes consecutive elements of a row (element lane + 32 c); zero
// past seq_len and d.
template <int DP, int R>
struct Staged {
  static constexpr int kW = Tc<DP>::kWarps;
  static constexpr int kRowsPer = R / kW;
  static constexpr int kCols = (DP + 31) / 32;
  unsigned short v[kRowsPer][kCols];

  __device__ __forceinline__ void load(const Rows<bf16>& x, int t0, int seq_len, int d) {
    const int lane = threadIdx.x & 31, t = t0 + (threadIdx.x >> 5);
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(x.p) + t * x.st + lane * x.se;
    const long long row_step = kW * x.st, col_step = 32 * x.se;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const unsigned short* pc = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        v[i][c] = t + kW * i < seq_len && lane + 32 * c < d ? __ldg(pc) : 0;
        pc += col_step;
      }
      p += row_step;
    }
  }

  __device__ __forceinline__ void store(bf16* dst) const {
    const int lane = threadIdx.x & 31;
    unsigned short* p =
        reinterpret_cast<unsigned short*>(dst) + (threadIdx.x >> 5) * Tc<DP>::kStride + lane;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < DP) p[kW * i * Tc<DP>::kStride + 32 * c] = v[i][c];
  }
};


// One 128-query tile of one (batch, head): out row t at o[t * ost], its lse
// at lse[t].
template <int DP, int MODE>
__device__ __forceinline__ void attend_tc(Rows<bf16> q, Rows<bf16> k, Rows<bf16> v,
                                          bf16* __restrict__ o, long long ost,
                                          float* __restrict__ lse, int seq_len, int d,
                                          float scale, int q0) {
  using C = Tc<DP>;
  constexpr int S = C::kStride, BK = C::kBK, MT = C::kMT;
  constexpr int kKSteps = DP / 16;   // k-steps of Q K^T
  constexpr int kKeyTiles = BK / 8;  // n-tiles of S
  constexpr int kDTiles = DP / 8;    // n-tiles of O
  constexpr int kPiece = C::kPiece, kSplit = C::kSplit;
  using Piece = Staged<DP, kPiece>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kStages = C::stages(MODE);
  bf16* sK = sQ + C::kBQ * S;
  bf16* sV = sK + kStages * C::kTile;
  bf16* sRaw = sV + kStages * C::kTile;  // span mode's raw stage

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (seq_len + BK - 1) / BK;

  // Q and the first K / V tile
  const AsyncTile<DP, BK> k_copies(k, d), v_copies(v, d);
  const std::conditional_t<MODE == kLoadSpan, SpanTile<DP, BK>, NoSpan> span(q.st, d);
  const bf16* span0 = q.p;  // span mode: the rows q, k and v share, stride q.st
  if constexpr (MODE == kLoadAsync) {
    AsyncTile<DP, C::kBQ>(q, d).copy(sQ, q, q0, seq_len);
    k_copies.copy(sK, k, 0, seq_len);
    v_copies.copy(sV, v, 0, seq_len);
    cp_async_commit();
    if (n_tiles > 1) {
      k_copies.copy(sK + C::kTile, k, BK, seq_len);
      v_copies.copy(sV + C::kTile, v, BK, seq_len);
    }
    cp_async_commit();  // one group per tile, empty or not, keeps the count
    cp_async_wait<1>();
  } else if constexpr (MODE == kLoadSpan) {  // Q, BK rows at a time, then K and V
#pragma unroll 1
    for (int r0 = 0; r0 <= C::kBQ; r0 += BK) {
      span.copy(sRaw, span0, q.st, r0 < C::kBQ ? q0 + r0 : 0, seq_len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (r0 < C::kBQ)
        span.split_q(sRaw, sQ + r0 * S, d);
      else
        span.split(sRaw, sK, sV, d);
      __syncwarp();  // the raw slots are read before they are copied again
    }
  } else {
#pragma unroll 1
    for (int r0 = 0; r0 < C::kBQ; r0 += kPiece) {
      Piece rows;
      rows.load(q, q0 + r0, seq_len, d);
      rows.store(sQ + r0 * S);
    }
#pragma unroll 1
    for (int r0 = 0; r0 < BK; r0 += kPiece) {
      Piece rows;
      rows.load(k, r0, seq_len, d);
      rows.store(sK + r0 * S);
      rows.load(v, r0, seq_len, d);
      rows.store(sV + r0 * S);
    }
  }
  __syncthreads();

  // this lane's ldmatrix addresses (mma.cuh): Q as A (m-tile mt at + 16 mt
  // rows), K as B, V as B transposed, each four 8x8 matrices
  const bf16* wQ = sQ + (warp * 16 * MT + (lane & 15)) * S + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;

  uint32_t qf[MT][C::kQInRegs ? kKSteps : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(qf[mt][kk], wQ + 16 * mt * S + 16 * kk);
  }

  float acc[MT][kDTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  // rows g (r = 0: fragment elements 0, 1) and g + 8 (r = 1: elements 2, 3)
  // of each m-tile; m in log2 units, l this lane's partial sum
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
  // logits sl2 * s in log2 units: the scale multiplies once, in the
  // exponent's fused multiply-add
  const float sl2 = scale * kLog2e;
  const bool up = sl2 > 0.f;
  // P V runs over all DP / 8 n-tiles of O but the last, which it skips where
  // d = DP - 8 (d = 40 in 48); the padded columns are zero, so any other d
  // < DP computes zeros past d
  const bool odd_tile = d > DP - 8;

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      if constexpr (MODE == kLoadAsync) cp_async_wait<1>();
      __syncthreads();  // tile j is in place; tile j - 1's stage is free
    }
    const bf16* cK = sK + j % kStages * C::kTile;
    const bf16* cV = sV + j % kStages * C::kTile;
    bf16* nK = sK + (j + 1) % kStages * C::kTile;  // gather and span: tile j + 1
    bf16* nV = sV + (j + 1) % kStages * C::kTile;
    const int k0 = j * BK, k1 = k0 + BK;
    const bool more = j + 1 < n_tiles;
    if constexpr (MODE == kLoadAsync) {  // tile j + 2 into tile j - 1's stage
      if (j + 2 < n_tiles) {
        k_copies.copy(sK + (j + 2) % kStages * C::kTile, k, k1 + BK, seq_len);
        v_copies.copy(sV + (j + 2) % kStages * C::kTile, v, k1 + BK, seq_len);
      }
      cp_async_commit();
    } else if constexpr (MODE == kLoadSpan) {
      if (more) {
        span.copy(sRaw, span0, q.st, k1, seq_len);
        cp_async_commit();
      }
    }
    // gather: piece p of tile j + 1's K is loaded before k-step p *
    // kKSteps / kSplit of Q K^T and stored after the k-steps it spans; its V
    // likewise around the softmax and P V
    Piece staged;

    // S = Q K^T over the k-steps that hold real columns; each K fragment
    // feeds the warp's MT m-tiles
    float s[MT][kKeyTiles][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      if constexpr (MODE == kLoadGather) {
        constexpr int kStep = (kKSteps + kSplit - 1) / kSplit;
        if (more && kk % kStep == 0) {
          if (kk > 0) staged.store(nK + (kk / kStep - 1) * kPiece * S);
          staged.load(k, k1 + kk / kStep * kPiece, seq_len, d);
        }
      }
      {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::kQInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][kk][i];
          } else {
            ldmatrix_x4(a[mt], wQ + 16 * mt * S + 16 * kk);
          }
        }
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, cK + np * 16 * S + k_off + 16 * kk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], b);
            mma_bf16(s[mt][2 * np + 1], a[mt], b + 2);
          }
        }
      }
    }
    if constexpr (MODE == kLoadGather) {
      if (more) {
        staged.store(nK + (kSplit - 1) * kPiece * S);
        staged.load(v, k1, seq_len, d);
      }
    }

    // online softmax on the accumulators (uniform branches: the sign of the
    // scale, and whether this is the ragged last tile)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int key0 = k0 + 2 * t4;
      if (k1 <= seq_len) {
        if (up)
          softmax_tile<true, false>(s[mt], acc[mt], m[mt], l[mt], sl2, key0, seq_len);
        else
          softmax_tile<false, false>(s[mt], acc[mt], m[mt], l[mt], sl2, key0, seq_len);
      } else {
        if (up)
          softmax_tile<true, true>(s[mt], acc[mt], m[mt], l[mt], sl2, key0, seq_len);
        else
          softmax_tile<false, true>(s[mt], acc[mt], m[mt], l[mt], sl2, key0, seq_len);
      }
    }

    // O += P V: P in bf16 as the A operand, over the n-tiles that hold
    // real columns; each V fragment feeds the MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (MODE == kLoadGather) {
        constexpr int kStep = BK / 16 / kSplit;
        if (more && kk > 0 && kk % kStep == 0) {
          staged.store(nV + (kk / kStep - 1) * kPiece * S);
          staged.load(v, k1 + kk / kStep * kPiece, seq_len, d);
        }
      }
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_rn(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_rn(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_rn(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_rn(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cV + kk * 16 * S + v_off + 16 * np);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b);
          if (np + 1 < DP / 16 || odd_tile) mma_bf16(acc[mt][2 * np + 1], a[mt], b + 2);
        }
      }
    }
    if constexpr (MODE == kLoadGather) {
      if (more) staged.store(nV + (kSplit - 1) * kPiece * S);
    } else if constexpr (MODE == kLoadSpan) {
      if (more) {
        cp_async_wait<0>();
        __syncwarp();
        span.split(sRaw, nK, nV, d);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int t = q0 + (warp * MT + mt) * 16 + g + 8 * r;
      if (t >= seq_len) continue;
      bf16* orow = o + t * ost;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n)
        if (8 * n < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t4) =
              __floats2bfloat162_rn(acc[mt][n][2 * r] / sum, acc[mt][n][2 * r + 1] / sum);
      if (t4 == 0) lse[t] = (m[mt][r] + log2f(sum)) * kLn2;
    }
}

// K1 in bf16 (and K1c in bf16, as one head): grid (query tiles, heads, batch).
template <int DP, int MODE>
__global__ void __launch_bounds__(Tc<DP>::kThreads, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int seq_len, int num_heads, int d, Strides sq, Strides sk, Strides sv,
                    float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * num_heads + h;
  attend_tc<DP, MODE>(Rows<bf16>{q + b * sq.b + h * sq.h, sq.t, sq.e},
                      Rows<bf16>{k + b * sk.b + h * sk.h, sk.t, sk.e},
                      Rows<bf16>{v + b * sv.b + h * sv.h, sv.t, sv.e},
                      o + (static_cast<long long>(b) * seq_len * num_heads + h) * d,
                      static_cast<long long>(num_heads) * d, lse + bh * seq_len, seq_len, d,
                      scale, blockIdx.x * Tc<DP>::kBQ);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------


template <int DP>
cudaError_t launch_tc(const Args& a, const Route& r) {
  using C = Tc<DP>;
  if (r.block_q != C::kBQ || r.block_k != C::kBK) return cudaErrorInvalidValue;
  if (r.load == kLoadAsync &&
      !(aligned16<bf16>(a.q, a.sq, a) && aligned16<bf16>(a.k, a.sk, a) &&
        aligned16<bf16>(a.v, a.sv, a)))
    return cudaErrorInvalidValue;
  if (r.load == kLoadSpan && !qkv_span<bf16>(a)) return cudaErrorInvalidValue;
  auto kernel = &flash_fwd_tc_kernel<DP, kLoadAsync>;
  size_t smem = C::smem_bytes(r.load);
  if (r.load == kLoadGather) {
    kernel = &flash_fwd_tc_kernel<DP, kLoadGather>;
  } else if (r.load == kLoadSpan) {
    if constexpr (!span_dim(DP)) return cudaErrorInvalidValue;
    else kernel = &flash_fwd_tc_kernel<DP, kLoadSpan>;
  } else if (r.load != kLoadAsync) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int heads = a.num_heads == 0 ? 1 : a.num_heads;  // flat: one head, sq.h = 0
  const unsigned tiles = (a.seq_len + C::kBQ - 1) / C::kBQ;
  kernel<<<dim3(tiles, heads, a.batch), C::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.seq_len, heads, a.d,
      a.sq, a.sk, a.sv, a.scale);
  return cudaGetLastError();
}

int forward(const Args& a, int dtype, const Route& r) {
  cudaError_t err = cudaErrorInvalidValue;
  if (a.d < 8 || a.d % 8 != 0 || a.d > r.padded_d) return static_cast<int>(err);
  if (dtype == 1) {  // the padded dims of the bf16 kernel
    switch (r.padded_d) {
      case 16: err = launch_tc<16>(a, r); break;
      case 32: err = launch_tc<32>(a, r); break;
      case 48: err = launch_tc<48>(a, r); break;
      case 64: err = launch_tc<64>(a, r); break;
      case 80: err = launch_tc<80>(a, r); break;
      case 128: err = launch_tc<128>(a, r); break;
      case 160: err = launch_tc<160>(a, r); break;
      case 256: err = launch_tc<256>(a, r); break;
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// K1 in bf16.  dtype must be 1 (bfloat16; float32 has its own entry,
// flash_attn_fwd_tf32.cu).  Strides are in elements, ordered (batch, token,
// head, channel).  padded_d, load (1: cp.async, 2: gather, 3: gather from
// the qkv rows), block_q and block_k: the route (ops/attention.py::
// fwd_route); a route that does not match the kernel's tables is refused.
// Returns the cudaError_t of the launch.
extern "C" int dst_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int seq_len, int num_heads, int head_dim,
                                  long long qsb, long long qst, long long qsh, long long qse,
                                  long long ksb, long long kst, long long ksh, long long kse,
                                  long long vsb, long long vst, long long vsh, long long vse,
                                  float scale, int dtype, int padded_d, int load, int block_q,
                                  int block_k, void* stream) {
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, num_heads, head_dim,
               Strides{qsb, qst, qsh, qse}, Strides{ksb, kst, ksh, kse},
               Strides{vsb, vst, vsh, vse}, scale, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype, Route{padded_d, load, block_q, block_k});
}

// K1c, the flat layout.  Strides are in elements, ordered (batch, token,
// channel); out is a contiguous [batch, seq_len, head_dim], lse a contiguous
// [batch, seq_len] f32; the route as for K1.
extern "C" int dst_flash_attn_fwd_flat(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int batch, int seq_len, int head_dim,
                                       long long qsb, long long qst, long long qse,
                                       long long ksb, long long kst, long long kse,
                                       long long vsb, long long vst, long long vse, float scale,
                                       int dtype, int padded_d, int load, int block_q,
                                       int block_k, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, 0, head_dim,
               Strides{qsb, qst, 0, qse}, Strides{ksb, kst, 0, kse}, Strides{vsb, vst, 0, vse},
               scale, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype, Route{padded_d, load, block_q, block_k});
}

extern "C" const char* dst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

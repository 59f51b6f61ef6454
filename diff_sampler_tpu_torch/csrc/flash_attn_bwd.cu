// Flash-attention backward for sm_90a on the CUDA cores, in bf16: kernel K2
// (multi-head layout) and kernel K2c (flat layout), each a dQ kernel and a
// dK/dV kernel.  The f32 backward runs on the tensor cores in 3xTF32
// (flash_attn_bwd_tf32.cu, the same math and layouts); the entries here
// refuse f32.
//
// K2 replaces diff_sampler_tpu/ops/pallas_attention.py::_bwd_dq_kernel_mh
// and ::_bwd_dkv_kernel_mh and, at head dims < 128, their packed twins
// ::_bwd_dq_kernel_mh_packed and ::_bwd_dkv_kernel_mh_packed (K2p; all
// launched by _flash_bwd_mh) and the grid-streamed ::_bwd_dq_kernel_mh_stream
// and ::_bwd_dkv_kernel_mh_stream (K2b, _flash_bwd_mh_stream).  Packing heads
// into one block-diagonal matmul fills the MXU's lanes and has no purpose
// here: every head dim runs one head per block, and every tile is streamed
// through shared memory.  K2c replaces ::_bwd_dq_kernel and ::_bwd_dkv_kernel
// (launched by _flash_bwd, the VJP of flash_attention), the same function on
// a flat [B*H, T, d] layout: the backward of kernel K1c.  Same math, per
// (batch, head), from the forward's output and log-sum-exp:
//   * delta = rowsum(dO * out) in f32, computed by the caller (plain PyTorch,
//     as the JAX package computes it outside Pallas with an einsum);
//   * P  = exp(scale * q.k^T - lse) in f32, recomputed, never stored;
//   * dP = dO.v^T in f32;  dS = P * (dP - delta);
//   * dQ = scale * dS.k            (dQ kernel: a query tile loops over keys);
//   * dV = P^T.dO, dK = scale * dS^T.q  (dK/dV kernel: a key tile loops over
//     queries, k-major as _bwd_dkv_kernel_mh and _bwd_dkv_kernel);
//   * P and dS are rounded to the storage dtype before their products, every
//     sum is in f32, and dq/dk/dv come out in the input dtype;
//   * ragged T: keys >= T are masked in the dQ kernel, query rows >= T in the
//     dK/dV kernel, and rows >= T are never stored.
// Two kernels and no atomics: each output element is summed by one thread in
// a fixed order, so the result is deterministic.
//
// Layouts.  K2: q, k, v and dO are logical [B, T, H, d] with arbitrary
// element strides (the interleaved qkv split; dO may be any view); lse and
// delta are contiguous [B, H, T] f32; dq, dk, dv are contiguous [B, T, H, d].
// K2c: q, k, v and dO are logical [B, T, d] with arbitrary strides (B folds
// batch * heads; grid y indexes it); lse and delta are contiguous [B, T] f32;
// dq, dk, dv are contiguous [B, T, d].
//
// Head dims: any d that is a multiple of 8 up to 256, padded inside the
// kernel to DP, the next of 32, 48, 64, 80, 128, 160, 256, as in K1
// (csrc/flash_attn_fwd.cu): zero-filled columns d..DP in shared memory,
// global loads masked at e < d, no store past d.  The three [T, T] products
// over d (S, dP and the dQ kernel's recomputed S; dP) run over the d real
// columns; the accumulating products (dS.k, or P^T.dO and dS^T.q) pay for
// the DP - d padded columns: at d = 40 (DP 48) +7% of the dQ kernel's FMAs
// and +10% of the dK/dV kernel's; at d = 80 and 160 nothing.
//
// Design: as kernel K1, 256 threads in 16 row groups x 16 column groups,
// tiles staged in shared memory as f32 (bf16 converts exactly), products on
// the CUDA cores with f32 FMAs, accumulators in registers.  Bound: those
// FMAs and their shared-memory loads (four [T, T, d] products per (b, h)
// against K1's two); tensor cores (wgmma) and TMA are left for later.  Tiles
// are 32 x 32 at DP=256, so that K, V, Q and dO tiles (4 x 33 KB in f32) fit
// the 227 KB of shared memory, and 64 x 64 below (90 KB for dQ and 111 KB
// for dK/dV at d=64: two blocks per SM, so one block's tile loads overlap
// the other's products; 209 KB for dK/dV at d=160, one block per SM).  Tiles
// of several heads per block, loaded in one pass, multiply the shared memory
// per block and lost on the H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr size_t kSmemPerSM = 233472;  // 228 KB, of which each block reserves 1 KB

// Blocks of kSmem bytes of shared memory that one SM holds, at most 2: the
// kernels ask ptxas (__launch_bounds__) for registers that let them all be
// resident.  Left to itself, ptxas may give a 64 x 64 tile kernel more than
// 128 registers, and so one block per SM (the dQ kernel at d = 32 and 64).
template <size_t kSmem>
constexpr int min_blocks() {
  return 2 * (kSmem + 1024) <= kSmemPerSM ? 2 : 1;
}

struct Strides {
  long long b, t, h, e;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// The value x takes in the storage dtype, back in f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// DP: the padded head dim, a multiple of 16; each column group owns DP / 16
// output columns, loaded kVec at a time.
template <int DP>
struct Layout {
  static_assert(DP % 16 == 0, "the padded head dim is a multiple of 16");
  static constexpr int kStride = DP + 4;  // +4 floats: conflict-free float4 rows
  static constexpr int kCols = DP / 16;   // output columns per thread
  static constexpr int kVec = kCols % 4 == 0 ? 4 : kCols % 2 == 0 ? 2 : 1;  // per load
  static constexpr int kGroups = kCols / kVec;  // vector loads per row and thread
};

// Rows [t0, t0 + ROWS) of two sources of one (batch, head) (K and V, or Q
// and dO; element (t, e) of x at x[t * s.t + e * s.e]) into shared memory as
// f32 at row stride DP + 4, zero past seq_len and in the padded columns
// d..DP.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tiles(float* dst0, const T* __restrict__ src0, Strides s0,
                                           float* dst1, const T* __restrict__ src1, Strides s1,
                                           int t0, int seq_len, int d) {
  constexpr int S = Layout<DP>::kStride;
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreads) {
    const int r = idx / DP, e = idx % DP;
    const int t = t0 + r;
    const bool in = t < seq_len && e < d;
    dst0[r * S + e] = in ? to_f32(src0[t * s0.t + e * s0.e]) : 0.f;
    dst1[r * S + e] = in ? to_f32(src1[t * s1.t + e * s1.e]) : 0.f;
  }
}

// out[i][j] = sum_{e < d} A[ty + 16 i][e] * B[tx + 16 j][e] over tiles of row
// stride DP + 4 (d is a multiple of 8).
template <int DP, int R, int C>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx, int d,
                                         float (&out)[R][C]) {
  constexpr int S = Layout<DP>::kStride;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < d; e += 4) {
    float4 a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * S + e]);
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * S + e]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        out[i][j] = fmaf(a[i].x, b[j].x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b[j].y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b[j].z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b[j].w, out[i][j]);
      }
  }
}

// acc[i][c] += sum_{j < J} P[ty + 16 i][j] * V[j][col(c)], P of row stride PS,
// V of row stride DP + 4; col(g * kVec + w) = g * 16 * kVec + tx * kVec + w.
template <int DP, int R, int J, int PS>
__device__ __forceinline__ void tile_accumulate(const float* P, const float* V, int ty, int tx,
                                                float (&acc)[R][Layout<DP>::kCols]) {
  using L = Layout<DP>;
  constexpr int kVec = L::kVec;
#pragma unroll 2
  for (int j = 0; j < J; j += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = *reinterpret_cast<const float4*>(&P[(ty + 16 * i) * PS + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[L::kCols];
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        const float* src = &V[(j + jj) * L::kStride + g * 16 * kVec + tx * kVec];
        if constexpr (kVec == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(src);
          vv[g * 4 + 0] = t4.x;
          vv[g * 4 + 1] = t4.y;
          vv[g * 4 + 2] = t4.z;
          vv[g * 4 + 3] = t4.w;
        } else if constexpr (kVec == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(src);
          vv[g * 2 + 0] = t2.x;
          vv[g * 2 + 1] = t2.y;
        } else {
          vv[g] = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
}

// Rows t0 + ty + 16 i (< seq_len) of an output, row t at out + t * ost,
// columns < d, times mul.
template <typename T, int DP, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long ost,
                                           const float (&acc)[R][Layout<DP>::kCols], float mul,
                                           int t0, int seq_len, int d, int ty, int tx) {
  using L = Layout<DP>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= seq_len) continue;
    T* row = out + t * ost;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int w = 0; w < L::kVec; ++w) {
        const int col = g * 16 * L::kVec + tx * L::kVec + w;
        if (col < d) row[col] = from_f32<T>(mul * acc[i][g * L::kVec + w]);
      }
  }
}

template <int DP, int BQ, int BK>
struct DqTile {
  static constexpr int kPStride = BK + 16;  // second half-warp lands on other banks
  static constexpr int kQTile = BQ * Layout<DP>::kStride;  // floats of a Q / dO tile
  static constexpr int kKTile = BK * Layout<DP>::kStride;  // of a K / V tile
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kQTile + 2 * kKTile + BQ * kPStride);
  static constexpr int kMinBlocks = min_blocks<kSmemBytes>();
};

// dQ for one BQ-query tile of one (batch, head), looping over key tiles: q,
// k, v and dout point at the head's token 0, lse and delta at its
// statistics, dq at its output row 0 (row t at dq + t * ost).
template <typename T, int DP, int BQ, int BK>
__device__ __forceinline__ void dq_tile(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        Strides sq, Strides sk, Strides sv, Strides sdo,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, T* __restrict__ dq,
                                        long long ost, int q0, int seq_len, int d, float scale) {
  using L = Layout<DP>;
  using Tl = DqTile<DP, BQ, BK>;
  constexpr int R = BQ / 16, C = BK / 16;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // [BQ][DP + 4]
  float* sDO = sQ + Tl::kQTile;   // [BQ][DP + 4]
  float* sK = sDO + Tl::kQTile;   // [BK][DP + 4]
  float* sV = sK + Tl::kKTile;    // [BK][DP + 4]
  float* sDS = sV + Tl::kKTile;   // [BQ][BK + 16]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tiles<T, DP, BQ>(sQ, q, sq, sDO, dout, sdo, q0, seq_len, d);

  float row_lse[R], row_delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    row_lse[i] = t < seq_len ? lse[t] : 0.f;
    row_delta[i] = t < seq_len ? delta[t] : 0.f;
  }
  float acc[R][L::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tiles<T, DP, BK>(sK, k, sk, sV, v, sv, k0, seq_len, d);
    __syncthreads();

    float s[R][C], dp[R][C];
    tile_dot<DP, R, C>(sQ, sK, ty, tx, d, s);
    tile_dot<DP, R, C>(sDO, sV, ty, tx, d, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const bool in = k0 + tx + 16 * j < seq_len;
        const float p = in ? expf(scale * s[i][j] - row_lse[i]) : 0.f;
        sDS[(ty + 16 * i) * Tl::kPStride + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncthreads();
    tile_accumulate<DP, R, BK, Tl::kPStride>(sDS, sK, ty, tx, acc);
  }
  store_rows<T, DP, R>(dq, ost, acc, scale, q0, seq_len, d, ty, tx);
}

template <int DP, int BQ, int BK>
struct DkvTile {
  static constexpr int kPStride = BQ + 16;
  static constexpr int kKTile = BK * Layout<DP>::kStride;  // floats of a K / V tile
  static constexpr int kQTile = BQ * Layout<DP>::kStride;  // of a Q / dO tile
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kKTile + 2 * kQTile + 2 * BK * kPStride + 2 * BQ);
  static constexpr int kMinBlocks = min_blocks<kSmemBytes>();
};

// dK and dV for one BK-key tile of one (batch, head), looping over query
// tiles; pointers as dq_tile's, dk and dv at the head's output row 0.
template <typename T, int DP, int BQ, int BK>
__device__ __forceinline__ void dkv_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         Strides sq, Strides sk, Strides sv, Strides sdo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, long long ost, int k0, int seq_len,
                                         int d, float scale) {
  using L = Layout<DP>;
  using Tl = DkvTile<DP, BQ, BK>;
  constexpr int R = BK / 16, C = BQ / 16;

  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [BK][DP + 4]
  float* sV = sK + Tl::kKTile;            // [BK][DP + 4]
  float* sQ = sV + Tl::kKTile;            // [BQ][DP + 4]
  float* sDO = sQ + Tl::kQTile;           // [BQ][DP + 4]
  float* sP = sDO + Tl::kQTile;           // [BK][BQ + 16]
  float* sDS = sP + BK * Tl::kPStride;    // [BK][BQ + 16]
  float* sLse = sDS + BK * Tl::kPStride;  // [BQ]
  float* sDelta = sLse + BQ;              // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tiles<T, DP, BK>(sK, k, sk, sV, v, sv, k0, seq_len, d);

  float acc_k[R][L::kCols], acc_v[R][L::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < seq_len; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_tiles<T, DP, BQ>(sQ, q, sq, sDO, dout, sdo, q0, seq_len, d);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < seq_len;
      sLse[r] = in ? lse[q0 + r] : 0.f;
      sDelta[r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are keys ty + 16 i, columns queries tx + 16 j.
    float s[R][C], dp[R][C];
    tile_dot<DP, R, C>(sK, sQ, ty, tx, d, s);
    tile_dot<DP, R, C>(sV, sDO, ty, tx, d, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int col = tx + 16 * j;
        const bool in = q0 + col < seq_len;
        const float p = in ? expf(scale * s[i][j] - sLse[col]) : 0.f;
        sP[(ty + 16 * i) * Tl::kPStride + col] = round_to<T>(p);
        sDS[(ty + 16 * i) * Tl::kPStride + col] = round_to<T>(p * (dp[i][j] - sDelta[col]));
      }
    __syncthreads();
    tile_accumulate<DP, R, BQ, Tl::kPStride>(sP, sDO, ty, tx, acc_v);
    tile_accumulate<DP, R, BQ, Tl::kPStride>(sDS, sQ, ty, tx, acc_k);
  }
  store_rows<T, DP, R>(dk, ost, acc_k, scale, k0, seq_len, d, ty, tx);
  store_rows<T, DP, R>(dv, ost, acc_v, 1.f, k0, seq_len, d, ty, tx);
}

// K2: grid (tiles, heads, batch); lse and delta [B, H, T], outputs
// contiguous [B, T, H, d].
#define DST_MH_HEAD                                                                   \
  const int h = blockIdx.y, b = blockIdx.z;                                            \
  const long long bh = static_cast<long long>(b) * num_heads + h;                      \
  const long long out0 = (static_cast<long long>(b) * seq_len * num_heads + h) * d;    \
  const long long ost = static_cast<long long>(num_heads) * d

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DqTile<DP, BQ, BK>::kMinBlocks)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int seq_len,
                    int num_heads, int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                    float scale) {
  DST_MH_HEAD;
  dq_tile<T, DP, BQ, BK>(q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                         v + b * sv.b + h * sv.h, dout + b * sdo.b + h * sdo.h, sq, sk, sv, sdo,
                         lse + bh * seq_len, delta + bh * seq_len, dq + out0, ost,
                         blockIdx.x * BQ, seq_len, d, scale);
}

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DkvTile<DP, BQ, BK>::kMinBlocks)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq_len, int num_heads, int d, Strides sq, Strides sk, Strides sv,
                     Strides sdo, float scale) {
  DST_MH_HEAD;
  dkv_tile<T, DP, BQ, BK>(q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h,
                          v + b * sv.b + h * sv.h, dout + b * sdo.b + h * sdo.h, sq, sk, sv,
                          sdo, lse + bh * seq_len, delta + bh * seq_len, dk + out0, dv + out0,
                          ost, blockIdx.x * BK, seq_len, d, scale);
}

// K2c: grid (tiles, batch * heads) over the flat layout; lse and delta
// [B, T], outputs contiguous [B, T, d].
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DqTile<DP, BQ, BK>::kMinBlocks)
flash_bwd_dq_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int seq_len, int d, Strides sq, Strides sk,
                         Strides sv, Strides sdo, float scale) {
  const long long bh = blockIdx.y;
  dq_tile<T, DP, BQ, BK>(q + bh * sq.b, k + bh * sk.b, v + bh * sv.b, dout + bh * sdo.b, sq, sk,
                         sv, sdo, lse + bh * seq_len, delta + bh * seq_len,
                         dq + bh * seq_len * d, d, blockIdx.x * BQ, seq_len, d, scale);
}

template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, DkvTile<DP, BQ, BK>::kMinBlocks)
flash_bwd_dkv_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq_len, int d,
                          Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  const long long bh = blockIdx.y;
  dkv_tile<T, DP, BQ, BK>(q + bh * sq.b, k + bh * sk.b, v + bh * sv.b, dout + bh * sdo.b, sq,
                          sk, sv, sdo, lse + bh * seq_len, delta + bh * seq_len,
                          dk + bh * seq_len * d, dv + bh * seq_len * d, d, blockIdx.x * BK,
                          seq_len, d, scale);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *d0, *d1;  // dq, or dk and dv
  int batch, seq_len, num_heads, d;  // num_heads 0: the flat layout
  Strides sq, sk, sv, sdo;
  float scale;
  cudaStream_t stream;
};

// Tile sizes: 32 x 32 at DP=256 (shared memory) and 64 x 64 below.
template <int DP>
struct Tiles {
  static constexpr int kQ = DP >= 256 ? 32 : 64;
  static constexpr int kK = DP >= 256 ? 32 : 64;
};

// Above 48 KB of dynamic shared memory needs an opt-in, which is per device;
// setting it at every launch keeps no state here.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kDq, typename T, int DP>
cudaError_t launch(const Args& a) {
  constexpr int BQ = Tiles<DP>::kQ, BK = Tiles<DP>::kK;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *g = static_cast<const T*>(a.dout);
  T *d0 = static_cast<T*>(a.d0), *d1 = static_cast<T*>(a.d1);
  const bool flat = a.num_heads == 0;
  const unsigned tiles = (a.seq_len + (kDq ? BQ : BK) - 1) / (kDq ? BQ : BK);
  const dim3 grid = flat ? dim3(tiles, a.batch) : dim3(tiles, a.num_heads, a.batch);
  cudaError_t err;
  if constexpr (kDq) {
    constexpr size_t smem = DqTile<DP, BQ, BK>::kSmemBytes;
    if (flat) {
      auto kernel = flash_bwd_dq_flat_kernel<T, DP, BQ, BK>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.lse, a.delta, d0, a.seq_len, a.d,
                                                 a.sq, a.sk, a.sv, a.sdo, a.scale);
    } else {
      auto kernel = flash_bwd_dq_kernel<T, DP, BQ, BK>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.lse, a.delta, d0, a.seq_len,
                                                 a.num_heads, a.d, a.sq, a.sk, a.sv, a.sdo,
                                                 a.scale);
    }
  } else {
    constexpr size_t smem = DkvTile<DP, BQ, BK>::kSmemBytes;
    if (flat) {
      auto kernel = flash_bwd_dkv_flat_kernel<T, DP, BQ, BK>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.lse, a.delta, d0, d1, a.seq_len,
                                                 a.d, a.sq, a.sk, a.sv, a.sdo, a.scale);
    } else {
      auto kernel = flash_bwd_dkv_kernel<T, DP, BQ, BK>;
      if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.lse, a.delta, d0, d1, a.seq_len,
                                                 a.num_heads, a.d, a.sq, a.sk, a.sv, a.sdo,
                                                 a.scale);
    }
  }
  return cudaGetLastError();
}

// The padded head dim: the smallest instantiated DP >= d.
template <bool kDq, typename T>
cudaError_t dispatch_d(const Args& a) {
  if (a.d < 8 || a.d % 8 != 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return launch<kDq, T, 32>(a);
  if (a.d <= 48) return launch<kDq, T, 48>(a);
  if (a.d <= 64) return launch<kDq, T, 64>(a);
  if (a.d <= 80) return launch<kDq, T, 80>(a);
  if (a.d <= 128) return launch<kDq, T, 128>(a);
  if (a.d <= 160) return launch<kDq, T, 160>(a);
  if (a.d <= 256) return launch<kDq, T, 256>(a);
  return cudaErrorInvalidValue;
}

// One entry's work: d1 is null for the dQ kernel.  bf16 only (dtype 1).
int backward(const Args& a, int dtype) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool dq = a.d1 == nullptr;
  return static_cast<int>(dq ? dispatch_d<true, __nv_bfloat16>(a)
                             : dispatch_d<false, __nv_bfloat16>(a));
}

Args mh_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* d0, void* d1, int batch, int seq_len, int num_heads,
             int head_dim, const long long* st, float scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              d0, d1, batch, seq_len, num_heads, head_dim, Strides{st[0], st[1], st[2], st[3]},
              Strides{st[4], st[5], st[6], st[7]}, Strides{st[8], st[9], st[10], st[11]},
              Strides{st[12], st[13], st[14], st[15]}, scale, static_cast<cudaStream_t>(stream)};
}

Args flat_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* d0, void* d1, int batch, int seq_len, int head_dim,
               const long long* st, float scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              d0, d1, batch, seq_len, 0, head_dim, Strides{st[0], st[1], 0, st[2]},
              Strides{st[3], st[4], 0, st[5]}, Strides{st[6], st[7], 0, st[8]},
              Strides{st[9], st[10], 0, st[11]}, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// K2.  dtype must be 1 (bfloat16; float32 takes the _tf32 entries of
// flash_attn_bwd_tf32.cu).  Strides are in elements, ordered
// (batch, token, head, channel), for q, k, v and dO in turn.  lse and delta
// are contiguous [B, H, T] f32; head_dim is a multiple of 8 up to 256.  Each
// returns the cudaError_t of its launch.
#define DST_STRIDE_ARGS                                                                       \
  long long qsb, long long qst, long long qsh, long long qse, long long ksb, long long kst,    \
      long long ksh, long long kse, long long vsb, long long vst, long long vsh, long long vse, \
      long long gsb, long long gst, long long gsh, long long gse
#define DST_STRIDES \
  { qsb, qst, qsh, qse, ksb, kst, ksh, kse, vsb, vst, vsh, vse, gsb, gst, gsh, gse }

extern "C" int dst_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int batch, int seq_len, int num_heads,
                                     int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                     void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return backward(mh_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len, num_heads,
                          head_dim, st, scale, stream), dtype);
}

extern "C" int dst_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int seq_len, int num_heads,
                                      int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                      void* stream) {
  const long long st[16] = DST_STRIDES;
  if (num_heads < 1 || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward(mh_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, num_heads,
                          head_dim, st, scale, stream), dtype);
}

// K2c, the flat layout.  Strides are in elements, ordered (batch, token,
// channel), for q, k, v and dO in turn; lse and delta are contiguous [B, T]
// f32; the outputs are contiguous [B, T, head_dim].
#define DST_FLAT_STRIDE_ARGS                                                                  \
  long long qsb, long long qst, long long qse, long long ksb, long long kst, long long kse,   \
      long long vsb, long long vst, long long vse, long long gsb, long long gst, long long gse
#define DST_FLAT_STRIDES \
  { qsb, qst, qse, ksb, kst, kse, vsb, vst, vse, gsb, gst, gse }

extern "C" int dst_flash_attn_bwd_dq_flat(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int batch, int seq_len, int head_dim,
                                          DST_FLAT_STRIDE_ARGS, float scale, int dtype,
                                          void* stream) {
  const long long st[12] = DST_FLAT_STRIDES;
  return backward(flat_args(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len, head_dim,
                            st, scale, stream), dtype);
}

extern "C" int dst_flash_attn_bwd_dkv_flat(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int batch, int seq_len,
                                           int head_dim, DST_FLAT_STRIDE_ARGS, float scale,
                                           int dtype, void* stream) {
  const long long st[12] = DST_FLAT_STRIDES;
  if (dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return backward(flat_args(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, head_dim, st,
                            scale, stream), dtype);
}

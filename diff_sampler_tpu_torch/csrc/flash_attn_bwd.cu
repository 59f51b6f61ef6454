// Multi-head flash-attention backward (kernel K2: a dQ kernel and a dK/dV
// kernel) for sm_90a.
//
// Replaces diff_sampler_tpu/ops/pallas_attention.py::_bwd_dq_kernel_mh and
// ::_bwd_dkv_kernel_mh and, at head dims < 128, their packed twins
// ::_bwd_dq_kernel_mh_packed and ::_bwd_dkv_kernel_mh_packed (K2p; all
// launched by _flash_bwd_mh).  Packing heads into one block-diagonal matmul
// fills the MXU's lanes and has no purpose here: the d = 32 and d = 64
// instantiations below compute K2p's function one head per block.  Same
// math, per (batch, head), from the forward's output and log-sum-exp:
//   * delta = rowsum(dO * out) in f32, computed by the caller (plain PyTorch,
//     as the JAX package computes it outside Pallas with an einsum);
//   * P  = exp(scale * q.k^T - lse) in f32, recomputed, never stored;
//   * dP = dO.v^T in f32;  dS = P * (dP - delta);
//   * dQ = scale * dS.k            (dQ kernel: a query tile loops over keys);
//   * dV = P^T.dO, dK = scale * dS^T.q  (dK/dV kernel: a key tile loops over
//     queries, k-major as _bwd_dkv_kernel_mh);
//   * P and dS are rounded to the storage dtype before their products, every
//     sum is in f32, and dq/dk/dv come out in the input dtype;
//   * ragged T: keys >= T are masked in the dQ kernel, query rows >= T in the
//     dK/dV kernel, and rows >= T are never stored.
// Two kernels and no atomics: each output element is summed by one thread in
// a fixed order, so the result is deterministic.
//
// Layout: q, k, v and dO are logical [B, T, H, D] with arbitrary element
// strides (the interleaved qkv split; dO may be any view).  lse and delta are
// contiguous [B, H, T] f32.  dq, dk, dv are contiguous [B, T, H, D].
//
// Design: as kernel K1, 256 threads in 16 row groups x 16 column groups,
// tiles staged in shared memory as f32 (bf16 converts exactly), products on
// the CUDA cores with f32 FMAs, accumulators in registers.  Bound: those
// FMAs and their shared-memory loads (four [T, T, D] products per (b, h)
// against K1's two); tensor cores (wgmma) and TMA are left for later.  Tiles
// are 32 x 32 at D=256, so that K, V, Q and dO tiles (4 x 33 KB in f32) fit
// the 227 KB of shared memory, and 64 x 64 below (90 KB for dQ and 111 KB
// for dK/dV at D=64: two blocks per SM, so one block's tile loads overlap
// the other's products).  Tiles of several heads per block, loaded in one
// pass, multiply the shared memory per block and lost on the H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups

struct Strides {
  long long b, t, h, e;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// The value x takes in the storage dtype, back in f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;                  // +4 floats: conflict-free float4 rows
  static constexpr int kVec = D >= 64 ? 4 : 2;           // columns per vector load
  static constexpr int kGroups = D / (16 * kVec);        // vector loads per row and thread
  static constexpr int kCols = kGroups * kVec;           // output columns per thread
};

// Rows [t0, t0 + ROWS) of one head into shared memory as f32, zero past
// seq_len, at row stride D + 4.  Two sources (K and V, or Q and dO) load in
// one pass.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tiles(float* dst0, const T* src0, Strides s0, float* dst1,
                                           const T* src1, Strides s1, int t0, int seq_len) {
  constexpr int S = Layout<D>::kStride;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, e = idx % D;
    const int t = t0 + r;
    const bool in = t < seq_len;
    dst0[r * S + e] = in ? to_f32(src0[t * s0.t + e * s0.e]) : 0.f;
    dst1[r * S + e] = in ? to_f32(src1[t * s1.t + e * s1.e]) : 0.f;
  }
}

// out[i][j] = sum_e A[ty + 16 i][e] * B[tx + 16 j][e] over tiles of row
// stride D + 4.
template <int D, int R, int C>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float (&out)[R][C]) {
  constexpr int S = Layout<D>::kStride;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; e += 4) {
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
// V of row stride D + 4; col(g * kVec + w) = g * 16 * kVec + tx * kVec + w.
template <int D, int R, int J, int PS>
__device__ __forceinline__ void tile_accumulate(const float* P, const float* V, int ty, int tx,
                                                float (&acc)[R][Layout<D>::kCols]) {
  using L = Layout<D>;
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
        } else {
          const float2 t2 = *reinterpret_cast<const float2*>(src);
          vv[g * 2 + 0] = t2.x;
          vv[g * 2 + 1] = t2.y;
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

// Rows t0 + ty + 16 i (< seq_len) of a contiguous [B, T, H, D] output, times mul.
template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[R][Layout<D>::kCols],
                                           float mul, int b, int h, int t0, int seq_len,
                                           int num_heads, int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= seq_len) continue;
    T* row = out + ((static_cast<long long>(b) * seq_len + t) * num_heads + h) * D;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int w = 0; w < L::kVec; ++w)
        row[g * 16 * L::kVec + tx * L::kVec + w] = from_f32<T>(mul * acc[i][g * L::kVec + w]);
  }
}

template <int D, int BQ, int BK>
struct DqTile {
  static constexpr int kPStride = BK + 16;  // second half-warp lands on other banks
  static constexpr int kQTile = BQ * Layout<D>::kStride;  // floats of a Q / dO tile
  static constexpr int kKTile = BK * Layout<D>::kStride;  // of a K / V tile
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kQTile + 2 * kKTile + BQ * kPStride);
};

// dQ for one (BQ-query tile, head, batch), looping over key tiles.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int seq_len,
                    int num_heads, Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  using L = Layout<D>;
  using Tl = DqTile<D, BQ, BK>;
  constexpr int R = BQ / 16, C = BK / 16;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // [BQ][D + 4]
  float* sDO = sQ + Tl::kQTile;   // [BQ][D + 4]
  float* sK = sDO + Tl::kQTile;   // [BK][D + 4]
  float* sV = sK + Tl::kKTile;    // [BK][D + 4]
  float* sDS = sV + Tl::kKTile;   // [BQ][BK + 16]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  load_tiles<T, D, BQ>(sQ, q + b * sq.b + h * sq.h, sq, sDO, dout + b * sdo.b + h * sdo.h,
                       sdo, q0, seq_len);

  const long long stat0 = (static_cast<long long>(b) * num_heads + h) * seq_len;
  float row_lse[R], row_delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + ty + 16 * i;
    row_lse[i] = t < seq_len ? lse[stat0 + t] : 0.f;
    row_delta[i] = t < seq_len ? delta[stat0 + t] : 0.f;
  }
  float acc[R][L::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tiles<T, D, BK>(sK, kb, sk, sV, vb, sv, k0, seq_len);
    __syncthreads();

    float s[R][C], dp[R][C];
    tile_dot<D, R, C>(sQ, sK, ty, tx, s);
    tile_dot<D, R, C>(sDO, sV, ty, tx, dp);
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
    tile_accumulate<D, R, BK, Tl::kPStride>(sDS, sK, ty, tx, acc);
  }
  store_rows<T, D, R>(dq, acc, scale, b, h, q0, seq_len, num_heads, ty, tx);
}

template <int D, int BQ, int BK>
struct DkvTile {
  static constexpr int kPStride = BQ + 16;
  static constexpr int kKTile = BK * Layout<D>::kStride;  // floats of a K / V tile
  static constexpr int kQTile = BQ * Layout<D>::kStride;  // of a Q / dO tile
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kKTile + 2 * kQTile + 2 * BK * kPStride + 2 * BQ);
};

// dK and dV for one (BK-key tile, head, batch), looping over query tiles.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq_len, int num_heads, Strides sq, Strides sk, Strides sv, Strides sdo,
                     float scale) {
  using L = Layout<D>;
  using Tl = DkvTile<D, BQ, BK>;
  constexpr int R = BK / 16, C = BQ / 16;

  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [BK][D + 4]
  float* sV = sK + Tl::kKTile;            // [BK][D + 4]
  float* sQ = sV + Tl::kKTile;            // [BQ][D + 4]
  float* sDO = sQ + Tl::kQTile;           // [BQ][D + 4]
  float* sP = sDO + Tl::kQTile;           // [BK][BQ + 16]
  float* sDS = sP + BK * Tl::kPStride;    // [BK][BQ + 16]
  float* sLse = sDS + BK * Tl::kPStride;  // [BQ]
  float* sDelta = sLse + BQ;              // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const long long stat0 = (static_cast<long long>(b) * num_heads + h) * seq_len;
  load_tiles<T, D, BK>(sK, k + b * sk.b + h * sk.h, sk, sV, v + b * sv.b + h * sv.h, sv, k0,
                       seq_len);

  float acc_k[R][L::kCols], acc_v[R][L::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < seq_len; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_tiles<T, D, BQ>(sQ, qb, sq, sDO, dob, sdo, q0, seq_len);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < seq_len;
      sLse[r] = in ? lse[stat0 + q0 + r] : 0.f;
      sDelta[r] = in ? delta[stat0 + q0 + r] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are keys ty + 16 i, columns queries tx + 16 j.
    float s[R][C], dp[R][C];
    tile_dot<D, R, C>(sK, sQ, ty, tx, s);
    tile_dot<D, R, C>(sV, sDO, ty, tx, dp);
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
    tile_accumulate<D, R, BQ, Tl::kPStride>(sP, sDO, ty, tx, acc_v);
    tile_accumulate<D, R, BQ, Tl::kPStride>(sDS, sQ, ty, tx, acc_k);
  }
  store_rows<T, D, R>(dk, acc_k, scale, b, h, k0, seq_len, num_heads, ty, tx);
  store_rows<T, D, R>(dv, acc_v, 1.f, b, h, k0, seq_len, num_heads, ty, tx);
}

// Tile sizes: 32 x 32 at D=256 (shared memory) and 64 x 64 below.
template <int D>
struct Tiles {
  static constexpr int kQ = D >= 256 ? 32 : 64;
  static constexpr int kK = D >= 256 ? 32 : 64;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *d0, *d1;  // dq, or dk and dv
  int batch, seq_len, num_heads;
  Strides sq, sk, sv, sdo;
  float scale;
  cudaStream_t stream;
};

// Above 48 KB of dynamic shared memory needs an opt-in, which is per device;
// setting it at every launch keeps no state here.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  constexpr size_t smem = DqTile<D, BQ, BK>::kSmemBytes;
  auto kernel = flash_bwd_dq_kernel<T, D, BQ, BK>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq_len + BQ - 1) / BQ, a.num_heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.d0), a.seq_len,
      a.num_heads, a.sq, a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  constexpr size_t smem = DkvTile<D, BQ, BK>::kSmemBytes;
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ, BK>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq_len + BK - 1) / BK, a.num_heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.d0),
      static_cast<T*>(a.d1), a.seq_len, a.num_heads, a.sq, a.sk, a.sv, a.sdo, a.scale);
  return cudaGetLastError();
}

template <bool kDq, typename T, int D>
cudaError_t launch(const Args& a) {
  if constexpr (kDq)
    return launch_dq<T, D>(a);
  else
    return launch_dkv<T, D>(a);
}

template <bool kDq, typename T>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 32: return launch<kDq, T, 32>(a);
    case 64: return launch<kDq, T, 64>(a);
    case 128: return launch<kDq, T, 128>(a);
    case 256: return launch<kDq, T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(int dtype, int d, const Args& a) {
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<kDq, float>(d, a);
  else if (dtype == 1)
    err = dispatch_d<kDq, __nv_bfloat16>(d, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// One entry's work: d1 is null for the dQ kernel.
int backward(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* d0, void* d1, int batch, int seq_len,
             int num_heads, int head_dim, const long long* st, float scale, int dtype,
             void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               d0, d1, batch, seq_len, num_heads, Strides{st[0], st[1], st[2], st[3]},
               Strides{st[4], st[5], st[6], st[7]}, Strides{st[8], st[9], st[10], st[11]},
               Strides{st[12], st[13], st[14], st[15]}, scale, static_cast<cudaStream_t>(stream)};
  return d1 == nullptr ? dispatch<true>(dtype, head_dim, a) : dispatch<false>(dtype, head_dim, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, ordered
// (batch, token, head, channel), for q, k, v and dO in turn.  lse and delta
// are contiguous [B, H, T] f32; head_dim is 32, 64, 128 or 256.  Each
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
  return backward(q, k, v, dout, lse, delta, dq, nullptr, batch, seq_len, num_heads,
                  head_dim, st, scale, dtype, stream);
}

extern "C" int dst_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int seq_len, int num_heads,
                                      int head_dim, DST_STRIDE_ARGS, float scale, int dtype,
                                      void* stream) {
  const long long st[16] = DST_STRIDES;
  return backward(q, k, v, dout, lse, delta, dk, dv, batch, seq_len, num_heads,
                  head_dim, st, scale, dtype, stream);
}

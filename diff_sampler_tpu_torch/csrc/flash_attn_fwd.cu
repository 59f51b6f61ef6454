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
// Diffusion in f32 at T = 4096, 8 heads of d = 40).  Both share one tile
// body; each computes its own addressing from blockIdx and its strides.
// Same math as the TPU kernels, not the same blocking:
//   * non-causal softmax attention per (batch, head);
//   * f32 logits, the scale applied to the f32 q.k product;
//   * online softmax over key tiles in f32;
//   * P cast to the storage dtype before P@V, f32 accumulation;
//   * output in the input dtype plus the per-row log-sum-exp in f32;
//   * ragged T: keys >= T masked, query rows >= T never stored.
//
// Layouts.  K1: q/k/v are logical [B, T, H, d] with arbitrary element
// strides, so the kernel reads them straight out of the qkv projection's
// interleaved (head, c, qkv) channel layout; out is a contiguous
// [B, T, H, d], lse a contiguous [B, H, T].  K1c: q/k/v are logical
// [B, T, d] with arbitrary strides (B folds batch * heads; grid y indexes it);
// out is a contiguous [B, T, d], lse a contiguous [B, T].
//
// Head dims: any d that is a multiple of 8 up to 256.  Each of the 16 column
// groups of a block owns DP / 16 output columns, so d is padded inside the
// kernel to DP, the next of 32, 48, 64, 80, 128, 160, 256 (the TPU pads d
// to 128 outside its kernel, in device memory).  The padding lives in
// shared memory only: columns d..DP of every tile are zero-filled, global
// loads are masked at e < d and no store goes past d.  The q.k product runs
// over the d real columns; only P@V pays for the padding, on DP - d columns:
// at d = 40 (DP 48) that is 8 of 88 FMAs per (query, key) pair, +10%; at
// d = 80 and 160 (and 32, 64, 128, 256) nothing.
//
// Design: one block of 256 threads per (64-query tile, head, batch).  The
// key/value loop that the TPU ran as a sequential grid axis is a loop inside
// the block.  Q, K, V and P tiles are staged in shared memory as f32 (bf16
// values convert exactly), products run on the CUDA cores with f32 FMAs, and
// every thread keeps 4 query rows of the output accumulator in registers.
//
// Bound: f32 FMAs and shared-memory loads on the CUDA cores (4 B H T^2 d
// flops), at every shape the port runs; on the tensor cores' 989 TFLOP/s in
// bf16 the d <= 64 shapes would be bound by their bytes.  The kernel does
// nothing about that yet: tensor cores (mma / wgmma) and TMA are left for
// later.  What it keeps is occupancy: 71 KB of shared memory at d = 64,
// three blocks per SM, so one block's tile loads overlap another's products.
// Giving one block several heads and loading their tiles in one pass, as the
// packed TPU kernel's layout suggests, was measured on the H100 and lost
// (PERF.md): it multiplies the shared memory per block and leaves fewer
// blocks to overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kBlockQ = 64;    // query rows per block
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DP: the padded head dim, a multiple of 16; each column group owns DP / 16
// output columns, loaded kVec at a time.
template <int DP, int BK>
struct Tile {
  static_assert(DP % 16 == 0, "the padded head dim is a multiple of 16");
  static constexpr int kQStride = DP + 4;   // +4 floats: conflict-free float4 rows
  static constexpr int kKStride = DP + 4;
  static constexpr int kVStride = DP;
  static constexpr int kPStride = BK + 16;  // second half-warp lands on other banks
  static constexpr int kCols = DP / 16;                                   // per thread
  static constexpr int kVec = kCols % 4 == 0 ? 4 : kCols % 2 == 0 ? 2 : 1;  // per load
  static constexpr int kVGroups = kCols / kVec;                           // loads per row
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBlockQ * kQStride + BK * kKStride + BK * kVStride + kBlockQ * kPStride);
};

// Rows of one (batch, head): element (t, e) of x lies at x[t * st + e * se].
template <typename T>
struct Rows {
  const T* __restrict__ p;
  long long st, se;
  __device__ __forceinline__ float at(int t, int e) const { return to_f32(p[t * st + e * se]); }
};

// One 64-query tile of one (batch, head): out row t at o[t * ost], its lse
// at lse[t].
template <typename T, int DP, int BK>
__device__ __forceinline__ void attend(Rows<T> q, Rows<T> k, Rows<T> v, T* __restrict__ o,
                                       long long ost, float* __restrict__ lse, int seq_len,
                                       int d, float scale, int q0) {
  using L = Tile<DP, BK>;
  constexpr int kSCols = BK / 16;  // logit columns per thread
  constexpr int kVec = L::kVec;
  constexpr int kOCols = L::kCols;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * L::kQStride;
  float* sV = sK + BK * L::kKStride;
  float* sP = sV + BK * L::kVStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group: rows ty + 16 * i

  // Columns d..DP are zero in every tile: the padding.
  for (int idx = tid; idx < kBlockQ * DP; idx += kThreads) {
    const int r = idx / DP, e = idx % DP;
    const int t = q0 + r;
    sQ[r * L::kQStride + e] = t < seq_len && e < d ? q.at(t, e) : 0.f;
  }

  float acc[kRows][kOCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, e = idx % DP;
      const int t = k0 + r;
      const bool in = t < seq_len && e < d;
      sK[r * L::kKStride + e] = in ? k.at(t, e) : 0.f;
      sV[r * L::kVStride + e] = in ? v.at(t, e) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i and keys tx + 16 j, over the d real
    // columns (d is a multiple of 8).
    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; e += 4) {
      float4 qv[kRows], kv[kSCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * L::kQStride + e]);
#pragma unroll
      for (int j = 0; j < kSCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * L::kKStride + e]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kSCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax.  The 16 threads of a row group share a half warp.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const bool in = k0 + tx + 16 * j < seq_len;
        s[i][j] = in ? scale * s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSCols; ++j) {
        const bool in = k0 + tx + 16 * j < seq_len;
        const float p = in ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty + 16 * i) * L::kPStride + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for rows ty + 16 i and columns g * 16 * kVec + tx * kVec + w.
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * L::kPStride + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kOCols];
#pragma unroll
        for (int g = 0; g < L::kVGroups; ++g) {
          const float* src = &sV[(j + jj) * L::kVStride + g * 16 * kVec + tx * kVec];
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
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kOCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq_len) continue;
    T* orow = o + t * ost;
#pragma unroll
    for (int g = 0; g < L::kVGroups; ++g)
#pragma unroll
      for (int w = 0; w < kVec; ++w) {
        const int col = g * 16 * kVec + tx * kVec + w;
        if (col < d) orow[col] = from_f32<T>(acc[i][g * kVec + w] / l[i]);
      }
    if (tx == 0) lse[t] = m[i] + logf(l[i]);
  }
}

// K1: grid (query tiles, heads, batch).
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq_len, int num_heads, int d,
                 Strides sq, Strides sk, Strides sv, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * num_heads + h;
  attend<T, DP, BK>(Rows<T>{q + b * sq.b + h * sq.h, sq.t, sq.e},
                    Rows<T>{k + b * sk.b + h * sk.h, sk.t, sk.e},
                    Rows<T>{v + b * sv.b + h * sv.h, sv.t, sv.e},
                    o + (static_cast<long long>(b) * seq_len * num_heads + h) * d,
                    static_cast<long long>(num_heads) * d, lse + bh * seq_len, seq_len, d, scale,
                    blockIdx.x * kBlockQ);
}

// K1c: grid (query tiles, batch * heads) over the flat layout.
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_flat_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      int seq_len, int d, Strides sq, Strides sk, Strides sv, float scale) {
  const long long bh = blockIdx.y;
  attend<T, DP, BK>(Rows<T>{q + bh * sq.b, sq.t, sq.e}, Rows<T>{k + bh * sk.b, sk.t, sk.e},
                    Rows<T>{v + bh * sv.b, sv.t, sv.e}, o + bh * seq_len * d, d,
                    lse + bh * seq_len, seq_len, d, scale, blockIdx.x * kBlockQ);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int batch, seq_len, num_heads, d;  // num_heads 0: the flat layout
  Strides sq, sk, sv;
  float scale;
  cudaStream_t stream;
};

// Above 48 KB of dynamic shared memory needs an opt-in, which is per device;
// setting it at every launch keeps no state here.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
cudaError_t launch(const Args& a) {
  constexpr int BK = DP >= 128 ? 32 : 64;
  constexpr size_t smem = Tile<DP, BK>::kSmemBytes;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const unsigned tiles = (a.seq_len + kBlockQ - 1) / kBlockQ;
  cudaError_t err;
  if (a.num_heads == 0) {
    auto kernel = flash_fwd_flat_kernel<T, DP, BK>;
    if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(tiles, a.batch), kThreads, smem, a.stream>>>(q, k, v, o, a.lse, a.seq_len, a.d,
                                                               a.sq, a.sk, a.sv, a.scale);
  } else {
    auto kernel = flash_fwd_kernel<T, DP, BK>;
    if ((err = opt_in(kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(tiles, a.num_heads, a.batch), kThreads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.seq_len, a.num_heads, a.d, a.sq, a.sk, a.sv, a.scale);
  }
  return cudaGetLastError();
}

// The padded head dim: the smallest instantiated DP >= d.
template <typename T>
cudaError_t dispatch_d(const Args& a) {
  if (a.d < 8 || a.d % 8 != 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return launch<T, 32>(a);
  if (a.d <= 48) return launch<T, 48>(a);
  if (a.d <= 64) return launch<T, 64>(a);
  if (a.d <= 80) return launch<T, 80>(a);
  if (a.d <= 128) return launch<T, 128>(a);
  if (a.d <= 160) return launch<T, 160>(a);
  if (a.d <= 256) return launch<T, 256>(a);
  return cudaErrorInvalidValue;
}

int forward(const Args& a, int dtype) {
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(a);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, ordered
// (batch, token, head, channel).  Returns the cudaError_t of the launch.
extern "C" int dst_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int seq_len, int num_heads, int head_dim,
                                  long long qsb, long long qst, long long qsh, long long qse,
                                  long long ksb, long long kst, long long ksh, long long kse,
                                  long long vsb, long long vst, long long vsh, long long vse,
                                  float scale, int dtype, void* stream) {
  if (num_heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, num_heads, head_dim,
               Strides{qsb, qst, qsh, qse}, Strides{ksb, kst, ksh, kse},
               Strides{vsb, vst, vsh, vse}, scale, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype);
}

// K1c, the flat layout.  Strides are in elements, ordered (batch, token,
// channel); out is a contiguous [batch, seq_len, head_dim], lse a contiguous
// [batch, seq_len] f32.
extern "C" int dst_flash_attn_fwd_flat(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int batch, int seq_len, int head_dim,
                                       long long qsb, long long qst, long long qse,
                                       long long ksb, long long kst, long long kse,
                                       long long vsb, long long vst, long long vse, float scale,
                                       int dtype, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, seq_len, 0, head_dim,
               Strides{qsb, qst, 0, qse}, Strides{ksb, kst, 0, kse}, Strides{vsb, vst, 0, vse},
               scale, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype);
}

extern "C" const char* dst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

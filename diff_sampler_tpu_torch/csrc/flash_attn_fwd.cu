// Multi-head flash-attention forward (kernel K1) for sm_90a.
//
// Replaces diff_sampler_tpu/ops/pallas_attention.py::_attn_kernel_mh and, at
// head dims < 128, its packed twin ::_attn_kernel_mh_packed (K1b; both
// launched by _flash_fwd_mh_res).  The TPU kernel packs 128 / d heads into
// one block-diagonal matmul to fill the MXU's 128 lanes; that has no purpose
// on this card, and the d = 32 and d = 64 instantiations below compute K1b's
// function one head per block.  Same math, not the same blocking:
//   * non-causal softmax attention per (batch, head);
//   * f32 logits, the scale applied to the f32 q.k product;
//   * online softmax over key tiles in f32;
//   * P cast to the storage dtype before P@V, f32 accumulation;
//   * output in the input dtype plus the per-row log-sum-exp [B, H, T] in f32;
//   * ragged T: keys >= T masked, query rows >= T never stored.
//
// Layout: q/k/v are logical [B, T, H, D] with arbitrary element strides, so
// the kernel reads them straight out of the qkv projection's interleaved
// (head, c, qkv) channel layout.  The output is a contiguous [B, T, H, D].
//
// Design: one block of 256 threads per (64-query tile, head, batch).  The
// key/value loop that the TPU ran as a sequential grid axis is a loop inside
// the block.  Q, K, V and P tiles are staged in shared memory as f32 (bf16
// values convert exactly), products run on the CUDA cores with f32 FMAs, and
// every thread keeps 4 query rows of the output accumulator in registers.
//
// Bound: f32 FMAs and shared-memory loads on the CUDA cores (4 B H T^2 D
// flops), at the CIFAR shapes (T=256, d=256) and the ImageNet-64 ones (d=64)
// alike; on the tensor cores' 989 TFLOP/s in bf16 the latter would be bound
// by their bytes.  The kernel does nothing about that yet: tensor cores (mma /
// wgmma) and TMA are left for later.  What it keeps is occupancy: 71 KB of
// shared memory at d = 64, three blocks per SM, so one block's tile loads
// overlap another's products.  Giving one block several heads and loading
// their tiles in one pass, as the packed TPU kernel's layout suggests, was
// measured on the H100 and lost (PERF.md): it multiplies the shared memory
// per block and leaves fewer blocks to overlap.

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

template <int D, int BK>
struct Tile {
  static constexpr int kQStride = D + 4;   // +4 floats: conflict-free float4 rows
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D;
  static constexpr int kPStride = BK + 16;  // second half-warp lands on other banks
  static constexpr int kVec = D >= 64 ? 4 : 2;           // V columns per vector load
  static constexpr int kVGroups = D / (16 * kVec);       // vector loads per V row
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBlockQ * kQStride + BK * kKStride + BK * kVStride + kBlockQ * kPStride);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int seq_len, int num_heads,
                 Strides sq, Strides sk, Strides sv, float scale) {
  using L = Tile<D, BK>;
  constexpr int kSCols = BK / 16;  // logit columns per thread
  constexpr int kVec = L::kVec;
  constexpr int kOCols = L::kVGroups * kVec;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * L::kQStride;
  float* sV = sK + BK * L::kKStride;
  float* sP = sV + BK * L::kVStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group: rows ty + 16 * i
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, e = idx % D;
    const int t = q0 + r;
    sQ[r * L::kQStride + e] = t < seq_len ? to_f32(qb[t * sq.t + e * sq.e]) : 0.f;
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
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, e = idx % D;
      const int t = k0 + r;
      const bool in = t < seq_len;
      sK[r * L::kKStride + e] = in ? to_f32(kb[t * sk.t + e * sk.e]) : 0.f;
      sV[r * L::kVStride + e] = in ? to_f32(vb[t * sv.t + e * sv.e]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i and keys tx + 16 j.
    float s[kRows][kSCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
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
          } else {
            const float2 t2 = *reinterpret_cast<const float2*>(src);
            vv[g * 2 + 0] = t2.x;
            vv[g * 2 + 1] = t2.y;
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
    T* orow = o + ((static_cast<long long>(b) * seq_len + t) * num_heads + h) * D;
#pragma unroll
    for (int g = 0; g < L::kVGroups; ++g)
#pragma unroll
      for (int w = 0; w < kVec; ++w)
        orow[g * 16 * kVec + tx * kVec + w] = from_f32<T>(acc[i][g * kVec + w] / l[i]);
    if (tx == 0)
      lse[(static_cast<long long>(b) * num_heads + h) * seq_len + t] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int seq_len, int num_heads, Strides sq, Strides sk, Strides sv, float scale,
                   cudaStream_t stream) {
  constexpr int BK = D >= 128 ? 32 : 64;
  constexpr size_t smem = Tile<D, BK>::kSmemBytes;
  auto kernel = flash_fwd_kernel<T, D, BK>;
  // Above 48 KB of dynamic shared memory needs an opt-in, which is per
  // device; setting it at every launch keeps no state here.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse,
                                           seq_len, num_heads, sq, sk, sv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int seq_len, int num_heads, Strides sq, Strides sk, Strides sv,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, seq_len, num_heads, sq, sk, sv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, seq_len, num_heads, sq, sk, sv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, seq_len, num_heads, sq, sk, sv, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, batch, seq_len, num_heads, sq, sk, sv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, ordered
// (batch, token, head, channel).  Returns the cudaError_t of the launch.
extern "C" int dst_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int seq_len, int num_heads, int head_dim,
                                  long long qsb, long long qst, long long qsh, long long qse,
                                  long long ksb, long long kst, long long ksh, long long kse,
                                  long long vsb, long long vst, long long vsh, long long vse,
                                  float scale, int dtype, void* stream) {
  const Strides sq{qsb, qst, qsh, qse}, sk{ksb, kst, ksh, kse}, sv{vsb, vst, vsh, vse};
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(head_dim, q, k, v, o, lse_f, batch, seq_len, num_heads, sq, sk, sv, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(head_dim, q, k, v, o, lse_f, batch, seq_len, num_heads, sq, sk, sv, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* dst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

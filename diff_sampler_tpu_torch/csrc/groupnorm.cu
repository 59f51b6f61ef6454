// Fused GroupNorm (+ affine) (+ SiLU) over NHWC (kernel K3) for sm_90a.
//
// Replaces diff_sampler_tpu/ops/pallas_groupnorm.py::_gn_kernel (launched by
// _pallas_gn) and computes the function of its plain twin _jnp_gn:
//   * f32 statistics per (sample, group) over H*W*(C/groups) elements;
//   * the affine folded into a per-(sample, channel) a = scale * rsqrt(var +
//     eps), b = bias - mean * a;
//   * out = x * a + b, then SiLU if asked, cast back to the input dtype.
// The TPU kernel takes E[x^2] - E[x]^2 through a block-diagonal matmul, which
// lost ~4e-3 there.  Here the statistics are exact two-pass sums at every
// level: each thread reduces 16 rows of one channel held in registers (their
// mean, then the centred sum of squares), merges those into its chunk's (mean,
// M2) by Chan's formula, and a second kernel combines the chunks of a group in
// f64, again mean first and centred squares second.  The variance is clamped
// at 0 as in _jnp_gn.
//
// Three kernels, no atomics, every sum in a fixed order: the result is
// deterministic.
//   1. partial stats: one block per (chunk of rows, sample), one thread per
//      channel, so a warp reads consecutive channels of a row;
//   2. finalize: one block per (group, sample) writes a and b, [N, C] f32;
//   3. apply: a grid-stride pass over x in 16-byte vectors (4 f32 or 8 bf16
//      channels), reading a and b from L1/L2.
// Bound: device memory.  x is read twice (statistics, then apply; the TPU
// kernel kept the [H*W, C] slab in VMEM, which a 227 KB block cannot hold at
// the VQ decoder's 256 x 256 x 128) and out written once; the bound counts
// one read and one write.  Its backward is the plain version's VJP
// (ops/groupnorm.py), as the JAX package's _gn_bwd is _jnp_gn's.
//
// Layout: x and out are contiguous [N, H*W, C]; scale and bias f32 [C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSub = 16;           // rows of one channel a thread holds in registers
constexpr int kFinalThreads = 256;  // a power of two: the tree reduction halves it
constexpr int kApplyThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// (mean, M2) of rows [chunk * rows, min(.. + rows, hw)) of every channel of
// sample n, into pmean / pm2 [N, n_chunks, C].
template <typename T>
__global__ void __launch_bounds__(256)
gn_partial_stats_kernel(const T* __restrict__ x, float* __restrict__ pmean,
                        float* __restrict__ pm2, int hw, int c, int rows, int n_chunks) {
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(r0 + rows, hw);
  const T* xn = x + static_cast<long long>(n) * hw * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = r0; r < r1; r += kSub) {
      const int m = min(kSub, r1 - r);
      float v[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        v[i] = i < m ? to_f32(xn[static_cast<long long>(r + i) * c + ch]) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) s += v[i];
      const float fm = static_cast<float>(m);
      const float sub_mean = s / fm;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float d = i < m ? v[i] - sub_mean : 0.f;
        q = fmaf(d, d, q);
      }
      // Chan et al.: (cnt, mean, m2) merged with (m, sub_mean, q)
      const float tot = cnt + fm;
      const float delta = sub_mean - mean;
      mean = fmaf(delta, fm / tot, mean);
      m2 += q + delta * delta * (cnt * fm / tot);
      cnt = tot;
    }
    const long long o = (static_cast<long long>(n) * n_chunks + chunk) * c + ch;
    pmean[o] = mean;
    pm2[o] = m2;
  }
}

// Sum over the block in a fixed tree order; every thread gets the total.
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

// a, b [N, C] of one (group, sample) from the chunks' (mean, M2).
__global__ void __launch_bounds__(kFinalThreads)
gn_finalize_kernel(const float* __restrict__ pmean, const float* __restrict__ pm2,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ a, float* __restrict__ b, int hw, int c, int groups,
                   int rows, int n_chunks, float eps) {
  __shared__ double red[kFinalThreads];
  const int g = blockIdx.x, n = blockIdx.y;
  const int cg = c / groups, items = n_chunks * cg;
  const float* pm = pmean + static_cast<long long>(n) * n_chunks * c + g * cg;
  const float* pq = pm2 + static_cast<long long>(n) * n_chunks * c + g * cg;

  double s = 0.0;
  for (int i = threadIdx.x; i < items; i += kFinalThreads) {
    const int chunk = i / cg, j = chunk * c + i % cg;
    s += static_cast<double>(min(rows, hw - chunk * rows)) * pm[j];
  }
  const double total = static_cast<double>(hw) * cg;
  const double mean = block_sum(s, red) / total;
  double q = 0.0;
  for (int i = threadIdx.x; i < items; i += kFinalThreads) {
    const int chunk = i / cg, j = chunk * c + i % cg;
    const double d = pm[j] - mean;
    q += pq[j] + static_cast<double>(min(rows, hw - chunk * rows)) * d * d;
  }
  const float var = static_cast<float>(fmax(block_sum(q, red) / total, 0.0));
  const float inv = 1.f / sqrtf(var + eps);
  const float meanf = static_cast<float>(mean);
  for (int j = threadIdx.x; j < cg; j += kFinalThreads) {
    const int ch = g * cg + j;
    const long long o = static_cast<long long>(n) * c + ch;
    const float ac = inv * scale[ch];
    a[o] = ac;
    b[o] = bias[ch] - meanf * ac;
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// out = x * a + b (+ SiLU) over VEC channels at a time (C % VEC == 0).
template <typename T, int VEC>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, long long n_vec,
                long long hwc, int c, int apply_silu) {
  const Pack<T, VEC>* xin = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* xout = reinterpret_cast<Pack<T, VEC>*>(out);
  for (long long v = static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x; v < n_vec;
       v += static_cast<long long>(gridDim.x) * kApplyThreads) {
    const long long i = v * VEC;
    const long long nc = (i / hwc) * c + i % c;  // (sample, first channel) of a and b
    const Pack<T, VEC> p = xin[v];
    Pack<T, VEC> r;
#pragma unroll
    for (int w = 0; w < VEC; ++w) {
      float y = fmaf(to_f32(p.v[w]), a[nc + w], b[nc + w]);
      if (apply_silu) y = y / (1.f + expf(-y));
      r.v[w] = from_f32<T>(y);
    }
    xout[v] = r;
  }
}

template <typename T, int VEC>
cudaError_t apply(const void* x, const float* a, const float* b, void* out, long long numel,
                  long long hwc, int c, int apply_silu, cudaStream_t stream) {
  const long long n_vec = numel / VEC;
  const long long blocks = (n_vec + kApplyThreads - 1) / kApplyThreads;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  gn_apply_kernel<T, VEC><<<grid, kApplyThreads, 0, stream>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(out), n_vec, hwc, c, apply_silu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const float* scale, const float* bias, void* out, float* scratch,
                int n, int hw, int c, int groups, int rows, float eps, int apply_silu, int vec,
                cudaStream_t stream) {
  const int n_chunks = (hw + rows - 1) / rows;
  float* pmean = scratch;
  float* pm2 = pmean + static_cast<long long>(n) * n_chunks * c;
  float* a = pm2 + static_cast<long long>(n) * n_chunks * c;
  float* b = a + static_cast<long long>(n) * c;
  const int threads = c < 256 ? (c + 31) / 32 * 32 : 256;
  gn_partial_stats_kernel<T><<<dim3(n_chunks, n), threads, 0, stream>>>(
      static_cast<const T*>(x), pmean, pm2, hw, c, rows, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<dim3(groups, n), kFinalThreads, 0, stream>>>(
      pmean, pm2, scale, bias, a, b, hw, c, groups, rows, n_chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long hwc = static_cast<long long>(hw) * c, numel = hwc * n;
  switch (vec) {
    case 1: return apply<T, 1>(x, a, b, out, numel, hwc, c, apply_silu, stream);
    case 4: return apply<T, 4>(x, a, b, out, numel, hwc, c, apply_silu, stream);
    case 8: return apply<T, 8>(x, a, b, out, numel, hwc, c, apply_silu, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, out: contiguous [n, hw, c]; scale,
// bias: f32 [c]; scratch: f32, 2 * n * ceil(hw / rows) * c + 2 * n * c
// elements.  vec: channels per vector of the apply pass, 1, 4 or 8, with c %
// vec == 0 and x, out aligned to vec elements.  Returns the cudaError_t of
// the launches.
extern "C" int dst_groupnorm_silu(const void* x, const void* scale, const void* bias, void* out,
                                  void* scratch, int n, int hw, int c, int groups, int rows,
                                  float eps, int apply_silu, int vec, int dtype, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = run<float>(x, sc, bi, out, sp, n, hw, c, groups, rows, eps, apply_silu, vec, s);
  else if (dtype == 1)
    err = run<__nv_bfloat16>(x, sc, bi, out, sp, n, hw, c, groups, rows, eps, apply_silu, vec, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

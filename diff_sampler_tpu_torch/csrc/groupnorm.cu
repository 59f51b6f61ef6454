// Fused GroupNorm (+ affine) (+ SiLU) over NHWC (kernel K3) for sm_90a.
//
// Replaces diff_sampler_tpu/ops/pallas_groupnorm.py::_gn_kernel (launched by
// _pallas_gn) and computes the function of its plain twin _jnp_gn:
//   * f32 statistics per (sample, group) over H*W*(C/groups) elements;
//   * the affine folded into a per-(sample, channel) a = scale * rsqrt(var +
//     eps), b = bias - mean * a;
//   * out = x * a + b, then SiLU if asked, cast back to the input dtype.
// The TPU kernel takes E[x^2] - E[x]^2 through a block-diagonal matmul, which
// lost ~4e-3 there.  Here the statistics are exact two-pass sums: the mean
// first, then the centred squares.  The variance is clamped at 0 as in
// _jnp_gn.  Every sum runs in a fixed order and no atomic decides an order,
// so two runs are bit-identical.
//
// Bound: device memory.  The TPU kernel holds a sample's whole [H*W, C] slab
// in VMEM (grid (n,)) and reads x once.  Two routes, chosen by the wrapper
// (ops/groupnorm.py::gn_route, which mirrors the constants below):
//   * slab: one kernel, x read once.  One thread-block cluster per sample, of
//     1-16 blocks (16 is Hopper's non-portable limit).  Each block copies its
//     share of the sample's rows into shared memory with 16-byte cp.async,
//     sums each channel over its rows (f32 runs of kRun rows folded into
//     f64), then each group in f64.  The blocks exchange per-group partials
//     through distributed shared memory under the cluster barrier and each
//     rank adds them in rank order; the same again for the centred squares,
//     read a second time from shared memory.  Each block then forms a and b
//     for its channels and writes out once.  Every thread reads only the
//     vectors it copied itself, so the copy needs no block barrier.
//   * stream: two kernels, for the slabs the route gives no cluster (the VQ
//     and KL decoders' levels, and the U-Nets' levels that neither 8 blocks
//     nor 16 blocks two to an SM hold).  The statistics kernel reads 16-byte
//     vectors (8 bf16 or 4 f32 channels a thread), holds kRegs values of
//     them in registers for a sub-run's mean and centred squares, merges the
//     runs by Chan's formula, and writes the chunk's per-group (mean, M2) in
//     f64.  The last block of each sample to arrive (a per-sample counter,
//     which that block resets; the atomic picks the block, never an order)
//     combines the chunks in chunk order and writes a and b [N, C].  The
//     apply kernel runs on a (row chunk, sample) grid with a and b in
//     registers and no 64-bit division.  x is read twice.
// Its backward is the plain version's VJP (ops/groupnorm.py), as the JAX
// package's _gn_bwd is _jnp_gn's.
//
// Layout: x and out are contiguous [N, H*W, C]; scale and bias f32 [C].

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;          // blocks per cluster, non-portable above 8
constexpr int kPortableCluster = 8;
constexpr int kSmemLimit = 232448;       // shared memory a block may opt into
constexpr int kDefaultSmem = 49152;      // above it only by opting in
constexpr int kSlabThreads = 256;
constexpr int kStreamThreads = 256;
constexpr int kRun = 16;                 // rows a slab thread sums in f32 before f64
constexpr int kRegs = 32;                // x values a stream-stats thread holds
constexpr int kApplySplit = 4;           // stream apply blocks per statistics block
constexpr int kSeg = 8;                  // threads that reduce one group together

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__host__ __device__ inline long long align_up(long long v, long long a) {
  return (v + a - 1) / a * a;
}

// Threads of a block split as `lanes` threads per column of 16 bytes of
// channels; where the columns outnumber the threads, one lane and a loop over
// columns.  A thread's rows, and so every sum's order, follow from the lanes
// alone: a kernel that loads one channel at a time (an unaligned x) sums in
// the same order as one that loads 16 bytes, and gives the same bits.
__host__ __device__ inline int lanes_of(int threads, int c, int elt) {
  const int ncol = (c * elt + 15) / 16;
  return threads / ncol > 1 ? threads / ncol : 1;
}

// Shared memory of the slab kernel, in bytes from the start: the block's
// rows of x, the lanes' f32 partials [lanes, C], the per-group f64 partials
// (sum, centred squares) that the cluster exchanges, then the per-group f32
// mean and 1 / std.
struct SlabLayout {
  long long lane, psum, pm2, gmean, ginv, bytes;
};
__host__ __device__ inline SlabLayout slab_layout(int hw, int c, int groups, int cluster,
                                                  int threads, int elt) {
  SlabLayout s;
  const long long rows = (hw + cluster - 1) / cluster;
  s.lane = align_up(rows * c * elt, 16);
  s.psum = align_up(s.lane + static_cast<long long>(lanes_of(threads, c, elt)) * c * 4, 8);
  s.pm2 = s.psum + 8LL * groups;
  s.gmean = s.pm2 + 8LL * groups;
  s.ginv = s.gmean + 4LL * groups;
  s.bytes = s.ginv + 4LL * groups;
  return s;
}

// Shared memory of the stream statistics kernel: the lanes' (mean, M2) [lanes, C].
inline long long stream_smem(int c, int elt) {
  return 8LL * lanes_of(kStreamThreads, c, elt) * c;
}

// The sum over `width` consecutive lanes of a warp (a power of two up to 32)
// in a fixed butterfly order: each of them gets the same bits, on every rank
// that adds the same values.  Every lane of the warp takes part.
__device__ __forceinline__ double seg_sum(double v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Runs body(g, sub) for every group g with kSeg consecutive threads to a
// group (sub = 0 .. kSeg - 1), all of the block's threads each round; g ==
// groups (no group) pads the last round, whose threads still join the
// butterflies.
template <typename F>
__device__ __forceinline__ void for_groups(int groups, F body) {
  for (int base = 0; base < groups * kSeg; base += blockDim.x) {
    const int t = base + threadIdx.x;
    body(min(t / kSeg, groups), t % kSeg);
  }
}

// Sum over the thread's rows (l, l + lanes, ...) of f(channel, x) for the VEC
// channels of column col: f32 runs of kRun rows, folded into f64.
template <typename T, int VEC, typename F>
__device__ __forceinline__ void sum_rows(const T* slab, int c, int col, int l, int rows,
                                         int lanes, F f, double (&acc)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0;
  for (int rs = l; rs < rows; rs += kRun * lanes) {
    const int re = min(rows, rs + kRun * lanes);
    float s[VEC] = {};
#pragma unroll 4
    for (int r = rs; r < re; r += lanes) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(slab + r * c + col * VEC);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] += f(v, to_f32(p.v[v]));
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += s[v];
  }
}

// The block's per-group total of the lanes' partials [lanes, C] in f64:
// thread sub of a group's kSeg adds the (channel, lane) pairs sub, sub +
// kSeg, ..., then their butterfly.
__device__ __forceinline__ void group_partials(const float* lane, double* part, int c,
                                               int groups, int lanes) {
  const int cg_ = c / groups;
  for_groups(groups, [&](int g, int sub) {
    double t = 0.0;
    if (g < groups)
      for (int i = sub; i < cg_ * lanes; i += kSeg)
        t += lane[(i % lanes) * c + g * cg_ + i / lanes];
    t = seg_sum(t, kSeg);
    if (g < groups && sub == 0) part[g] = t;
  });
}

// done(g, total) for every group, total the cluster's sum of the per-group
// partials `part`: a group's pow2(cs) consecutive threads read one rank each
// (thread q rank q), then their butterfly.
template <typename F>
__device__ __forceinline__ void cluster_totals(cg::cluster_group& cluster, double* part,
                                               int groups, int cs, F done) {
  int width = 1;
  while (width < cs) width <<= 1;
  for (int base = 0; base < groups * width; base += blockDim.x) {
    const int t = base + threadIdx.x, g = t / width, q = t % width;
    double v = g < groups && q < cs ? cluster.map_shared_rank(part, q)[g] : 0.0;
    v = seg_sum(v, width);
    if (g < groups && q == 0) done(g, v);
  }
}

// One cluster of blocks per sample; rank r of cs takes rows
// [r * hw / cs, (r + 1) * hw / cs).
template <typename T, int VEC>
__global__ void __launch_bounds__(kSlabThreads)
gn_slab_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int hw, int c, int groups,
               float eps, int apply_silu) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / cs;
  const int r0 = static_cast<int>(static_cast<long long>(rank) * hw / cs);
  const int rows = static_cast<int>(static_cast<long long>(rank + 1) * hw / cs) - r0;
  const int nt = blockDim.x, ncol = c / VEC, cg_ = c / groups;
  const int lanes = lanes_of(nt, c, sizeof(T)), items = lanes * ncol;
  const SlabLayout lay = slab_layout(hw, c, groups, cs, nt, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);
  float* lane = reinterpret_cast<float*>(smem + lay.lane);
  double* psum = reinterpret_cast<double*>(smem + lay.psum);
  double* pm2 = reinterpret_cast<double*>(smem + lay.pm2);
  float* gmean = reinterpret_cast<float*>(smem + lay.gmean);
  float* ginv = reinterpret_cast<float*>(smem + lay.ginv);
  const long long base = (static_cast<long long>(n) * hw + r0) * c;
  const T* xs = x + base;

  // x -> shared memory, each thread the vectors it reads below
  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
#pragma unroll 4
    for (int r = l; r < rows; r += lanes) {
      const int o = r * c + col * VEC;
      if constexpr (VEC > 1) cp_async16(slab + o, xs + o, true);
      else slab[o] = xs[o];
    }
  }
  if constexpr (VEC > 1) {
    cp_async_commit();
    cp_async_wait<0>();
  }

  // pass 1: the mean
  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
    double acc[VEC];
    sum_rows<T, VEC>(slab, c, col, l, rows, lanes, [](int, float v) { return v; }, acc);
#pragma unroll
    for (int v = 0; v < VEC; ++v) lane[l * c + col * VEC + v] = static_cast<float>(acc[v]);
  }
  __syncthreads();
  group_partials(lane, psum, c, groups, lanes);
  cluster.sync();
  const double count = static_cast<double>(hw) * cg_;
  cluster_totals(cluster, psum, groups, cs,
                 [&](int g, double t) { gmean[g] = static_cast<float>(t / count); });
  __syncthreads();

  // pass 2: the centred squares
  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
    float m[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) m[v] = gmean[(col * VEC + v) / cg_];
    double acc[VEC];
    sum_rows<T, VEC>(slab, c, col, l, rows, lanes, [&m](int v, float xv) {
      const float d = xv - m[v];
      return d * d;
    }, acc);
#pragma unroll
    for (int v = 0; v < VEC; ++v) lane[l * c + col * VEC + v] = static_cast<float>(acc[v]);
  }
  __syncthreads();
  group_partials(lane, pm2, c, groups, lanes);
  cluster.sync();
  cluster_totals(cluster, pm2, groups, cs, [&](int g, double t) {
    ginv[g] = 1.f / sqrtf(static_cast<float>(fmax(t / count, 0.0)) + eps);
  });
  __syncthreads();
  // the other ranks have read this block's partials once all arrive here;
  // the wait before the exit keeps its shared memory alive until then
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // out = x * a + b (+ SiLU), from shared memory
  T* os = out + base;
  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
    float a[VEC], b[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int ch = col * VEC + v, g = ch / cg_;
      a[v] = ginv[g] * scale[ch];
      b[v] = bias[ch] - gmean[g] * a[v];
    }
#pragma unroll 4
    for (int r = l; r < rows; r += lanes) {
      const int o = r * c + col * VEC;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(slab + o);
      Pack<T, VEC> y;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float f = fmaf(to_f32(p.v[v]), a[v], b[v]);
        if (apply_silu) f = f / (1.f + expf(-f));
        y.v[v] = from_f32<T>(f);
      }
      *reinterpret_cast<Pack<T, VEC>*>(os + o) = y;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [chunk * rows, ..) of sample n: per group (mean, M2) of the chunk into
// pmean / pm2 [N, chunks, groups] (f64); the sample's last block to arrive
// combines the chunks and writes a, b [N, C].  In bf16 a 16-byte load
// carries twice the values to merge, and four blocks an SM (at most 64
// registers a thread) keep more loads in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStreamThreads, sizeof(T) == 2 ? 4 : 1)
gn_stream_stats_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, double* pmean, double* pm2,
                       float* __restrict__ a, float* __restrict__ b, unsigned* arrivals, int hw,
                       int c, int groups, int rows, float eps) {
  // rows a thread holds in registers: as many as 16-byte loads fill kRegs
  constexpr int S = kRegs * static_cast<int>(sizeof(T)) / 16;
  const int chunk = blockIdx.x, n = blockIdx.y, chunks = gridDim.x;
  const int r0 = chunk * rows, nr = min(rows, hw - r0);
  const int nt = blockDim.x, ncol = c / VEC, cg_ = c / groups;
  const int lanes = lanes_of(nt, c, sizeof(T)), items = lanes * ncol;
  extern __shared__ float lane_stats[];  // mean [lanes, C], then M2 [lanes, C]
  float* lmean = lane_stats;
  float* lm2 = lane_stats + lanes * c;
  const T* xs = x + (static_cast<long long>(n) * hw + r0) * c;

  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
    float cnt = 0.f, mean[VEC] = {}, m2[VEC] = {};
    for (int rs = l; rs < nr; rs += S * lanes) {
      const int m = min(S, (nr - rs + lanes - 1) / lanes);
      Pack<T, VEC> p[S];
#pragma unroll
      for (int i = 0; i < S; ++i)
        if (i < m)
          p[i] = *reinterpret_cast<const Pack<T, VEC>*>(
              xs + static_cast<long long>(rs + i * lanes) * c + col * VEC);
      const float fm = static_cast<float>(m), tot = cnt + fm, rfm = 1.f / fm;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < S; ++i) s += i < m ? to_f32(p[i].v[v]) : 0.f;
        const float sub_mean = s * rfm;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float d = i < m ? to_f32(p[i].v[v]) - sub_mean : 0.f;
          q = fmaf(d, d, q);
        }
        // Chan et al.: (cnt, mean, m2) merged with (m, sub_mean, q)
        const float delta = sub_mean - mean[v];
        mean[v] = fmaf(delta, fm / tot, mean[v]);
        m2[v] += q + delta * delta * (cnt * fm / tot);
      }
      cnt = tot;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      lmean[l * c + col * VEC + v] = mean[v];
      lm2[l * c + col * VEC + v] = m2[v];
    }
  }
  __syncthreads();
  // per group of the chunk: thread sub of the group's kSeg takes the
  // (channel, lane) pairs sub, sub + kSeg, ..., weighted by the lane's rows;
  // the butterflies give all kSeg the mean, then the centred squares
  auto lane_rows = [&](int k) { return nr > k ? (nr - k + lanes - 1) / lanes : 0; };
  for_groups(groups, [&](int g, int sub) {
    const int items = g < groups ? cg_ * lanes : 0;
    double s = 0.0, q = 0.0;
    for (int i = sub; i < items; i += kSeg)
      s += lane_rows(i % lanes) * static_cast<double>(lmean[(i % lanes) * c + g * cg_ + i / lanes]);
    const double mu = seg_sum(s, kSeg) / (static_cast<double>(nr) * cg_);
    for (int i = sub; i < items; i += kSeg) {
      const int j = (i % lanes) * c + g * cg_ + i / lanes;
      const double d = lmean[j] - mu;
      q += lm2[j] + lane_rows(i % lanes) * d * d;
    }
    q = seg_sum(q, kSeg);
    if (g < groups && sub == 0) {
      const long long o = (static_cast<long long>(n) * chunks + chunk) * groups + g;
      pmean[o] = mu;
      pm2[o] = q;
    }
  });

  // the sample's last block combines its chunks
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + n, 1u) == static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double total = static_cast<double>(hw) * cg_;
  auto cnt = [&](int k) { return static_cast<double>(min(rows, hw - k * rows)) * cg_; };
  for_groups(groups, [&](int g, int sub) {
    const long long o = static_cast<long long>(n) * chunks * groups + min(g, groups - 1);
    const int ks = g < groups ? chunks : 0;
    double s = 0.0, q = 0.0;
    for (int k = sub; k < ks; k += kSeg) s += cnt(k) * __ldcg(pmean + o + k * groups);
    const double mu = seg_sum(s, kSeg) / total;
    for (int k = sub; k < ks; k += kSeg) {
      const double d = __ldcg(pmean + o + k * groups) - mu;
      q += __ldcg(pm2 + o + k * groups) + cnt(k) * d * d;
    }
    const float var = static_cast<float>(fmax(seg_sum(q, kSeg) / total, 0.0));
    const float inv = 1.f / sqrtf(var + eps), meanf = static_cast<float>(mu);
    for (int j = sub; j < (g < groups ? cg_ : 0); j += kSeg) {
      const int ch = g * cg_ + j;
      const float ac = inv * scale[ch];
      a[static_cast<long long>(n) * c + ch] = ac;
      b[static_cast<long long>(n) * c + ch] = bias[ch] - meanf * ac;
    }
  });
  if (threadIdx.x == 0) arrivals[n] = 0;
}

// out = x * a + b (+ SiLU) over rows [chunk * rows, ..) of sample n.  The
// blocks take the chunks in the reverse of the statistics kernel's order, so
// that the first find the last rows it read still in the 50 MB L2.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStreamThreads)
gn_stream_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b, T* __restrict__ out, int hw, int c, int rows,
                       int apply_silu) {
  const int chunk = gridDim.x - 1 - blockIdx.x, n = gridDim.y - 1 - blockIdx.y;
  const int r0 = chunk * rows, nr = min(rows, hw - r0);
  const int nt = blockDim.x, ncol = c / VEC;
  const int lanes = lanes_of(nt, c, sizeof(T)), items = lanes * ncol;
  const long long base = (static_cast<long long>(n) * hw + r0) * c;
  for (int it = threadIdx.x; it < items; it += nt) {
    const int col = it % ncol, l = it / ncol;
    float av[VEC], bv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      av[v] = a[static_cast<long long>(n) * c + col * VEC + v];
      bv[v] = b[static_cast<long long>(n) * c + col * VEC + v];
    }
#pragma unroll 4
    for (int r = l; r < nr; r += lanes) {
      const long long o = base + static_cast<long long>(r) * c + col * VEC;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + o);
      Pack<T, VEC> y;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float f = fmaf(to_f32(p.v[v]), av[v], bv[v]);
        if (apply_silu) f = f / (1.f + expf(-f));
        y.v[v] = from_f32<T>(f);
      }
      *reinterpret_cast<Pack<T, VEC>*>(out + o) = y;
    }
  }
}

// Attributes set once per kernel (the largest opt-in shared memory so far,
// non-portable clusters) and the active-cluster count per launch shape.
std::mutex attr_lock;
std::map<const void*, int> smem_set;
std::map<const void*, bool> nonportable_set;
std::map<std::tuple<const void*, int, int, int>, int> active_clusters_of;

cudaError_t opt_in(const void* kernel, long long smem, bool nonportable) {
  std::lock_guard<std::mutex> guard(attr_lock);
  if (smem > kDefaultSmem && smem_set[kernel] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set[kernel] = static_cast<int>(smem);
  }
  if (nonportable && !nonportable_set[kernel]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable_set[kernel] = true;
  }
  return cudaSuccess;
}

// The launch of the slab kernel: one cluster of `cluster` blocks per sample.
template <typename T, int VEC>
cudaLaunchConfig_t slab_config(cudaLaunchAttribute* attr, int n, int cluster, int threads,
                               int smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(n));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of this shape the card holds at once (0: it cannot
// schedule one), after the kernel's attributes are set; cached per shape.
template <typename T, int VEC>
cudaError_t active_clusters(int cluster, int threads, int smem, int* active) {
  auto kernel = gn_slab_kernel<T, VEC>;
  const void* key = reinterpret_cast<const void*>(kernel);
  cudaError_t err = opt_in(key, smem, cluster > kPortableCluster);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(attr_lock);
  const auto shape = std::make_tuple(key, cluster, threads, smem);
  auto found = active_clusters_of.find(shape);
  if (found == active_clusters_of.end()) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = slab_config<T, VEC>(attr, 1, cluster, threads, smem, 0);
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (err != cudaSuccess) return err;
    found = active_clusters_of.emplace(shape, count).first;
  }
  *active = found->second;
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch_slab(const void* x, const float* scale, const float* bias, void* out, int n,
                        int hw, int c, int groups, float eps, int apply_silu, int cluster,
                        int threads, int smem, cudaStream_t stream) {
  const SlabLayout lay = slab_layout(hw, c, groups, cluster, threads, sizeof(T));
  if (cluster < 1 || cluster > kMaxCluster || cluster > hw ||
      threads != kSlabThreads || lay.bytes != smem || smem > kSmemLimit)
    return cudaErrorInvalidValue;
  // a cluster that cannot be scheduled at all is refused, not run elsewhere
  int active = 0;
  cudaError_t err = active_clusters<T, VEC>(cluster, threads, smem, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = slab_config<T, VEC>(attr, n, cluster, threads, smem, stream);
  err = cudaLaunchKernelEx(&cfg, gn_slab_kernel<T, VEC>, static_cast<const T*>(x), scale, bias,
                           static_cast<T*>(out), hw, c, groups, eps, apply_silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_stream(const void* x, const float* scale, const float* bias, void* out,
                          void* scratch, unsigned* arrivals, int n, int hw, int c, int groups,
                          float eps, int apply_silu, int threads, int rows, int smem,
                          cudaStream_t stream) {
  if (threads != kStreamThreads || rows < 1 || stream_smem(c, sizeof(T)) != smem ||
      smem > kSmemLimit || n > 65535)
    return cudaErrorInvalidValue;
  const int chunks = (hw + rows - 1) / rows;
  double* pmean = static_cast<double*>(scratch);
  double* pm2 = pmean + static_cast<long long>(n) * chunks * groups;
  float* a = reinterpret_cast<float*>(pm2 + static_cast<long long>(n) * chunks * groups);
  float* b = a + static_cast<long long>(n) * c;
  auto stats = gn_stream_stats_kernel<T, VEC>;
  cudaError_t err = opt_in(reinterpret_cast<const void*>(stats), smem, false);
  if (err != cudaSuccess) return err;
  const dim3 grid(chunks, n);
  stats<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), scale, bias, pmean, pm2, a, b,
                                         arrivals, hw, c, groups, rows, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int apply_rows = (rows + kApplySplit - 1) / kApplySplit;
  gn_stream_apply_kernel<T, VEC><<<dim3((hw + apply_rows - 1) / apply_rows, n), threads, 0,
                                   stream>>>(static_cast<const T*>(x), a, b,
                                             static_cast<T*>(out), hw, c, apply_rows,
                                             apply_silu);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run(const void* x, const float* scale, const float* bias, void* out, void* scratch,
                unsigned* arrivals, int n, int hw, int c, int groups, float eps, int apply_silu,
                int kind, int cluster, int threads, int rows, int smem, cudaStream_t stream) {
  if (c % VEC || c % groups) return cudaErrorInvalidValue;
  if (kind == 0)
    return launch_slab<T, VEC>(x, scale, bias, out, n, hw, c, groups, eps, apply_silu, cluster,
                               threads, smem, stream);
  if (kind == 1)
    return launch_stream<T, VEC>(x, scale, bias, out, scratch, arrivals, n, hw, c, groups, eps,
                                 apply_silu, threads, rows, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, out: contiguous [n, hw, c]; scale,
// bias: f32 [c].  vec: channels per 16-byte vector (f32 4, bf16 8) where c %
// vec == 0 and x, out are 16-byte aligned, else 1.  kind 0 (slab): one
// cluster of `cluster` blocks of `threads` threads per sample, `smem` bytes
// of shared memory a block (slab_layout's).  kind 1 (stream): chunks of
// `rows` rows, `threads` threads, `smem` bytes (stream_smem's) for the
// statistics kernel; scratch: 16 * n * ceil(hw / rows) * groups + 8 * n * c
// bytes; arrivals: n zeroed counters, left zeroed.  Returns the cudaError_t
// of the launches; a route the tables do not hold, or a cluster the card
// cannot schedule, is refused with an error and nothing runs.
extern "C" int dst_groupnorm_silu(const void* x, const void* scale, const void* bias, void* out,
                                  void* scratch, void* arrivals, int n, int hw, int c, int groups,
                                  float eps, int apply_silu, int vec, int dtype, int kind,
                                  int cluster, int threads, int rows, int smem, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    err = run<float, 4>(x, sc, bi, out, scratch, arr, n, hw, c, groups, eps, apply_silu, kind,
                        cluster, threads, rows, smem, s);
  else if (dtype == 0 && vec == 1)
    err = run<float, 1>(x, sc, bi, out, scratch, arr, n, hw, c, groups, eps, apply_silu, kind,
                        cluster, threads, rows, smem, s);
  else if (dtype == 1 && vec == 8)
    err = run<__nv_bfloat16, 8>(x, sc, bi, out, scratch, arr, n, hw, c, groups, eps,
                                apply_silu, kind, cluster, threads, rows, smem, s);
  else if (dtype == 1 && vec == 1)
    err = run<__nv_bfloat16, 1>(x, sc, bi, out, scratch, arr, n, hw, c, groups, eps,
                                apply_silu, kind, cluster, threads, rows, smem, s);
  return static_cast<int>(err);
}

// The clusters of a slab route that the card holds at once (0: none), or
// minus the cudaError_t of the query.
extern "C" int dst_groupnorm_active_clusters(int dtype, int vec, int cluster, int threads,
                                             int smem) {
  int active = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) err = active_clusters<float, 4>(cluster, threads, smem, &active);
  else if (dtype == 0 && vec == 1) err = active_clusters<float, 1>(cluster, threads, smem, &active);
  else if (dtype == 1 && vec == 8)
    err = active_clusters<__nv_bfloat16, 8>(cluster, threads, smem, &active);
  else if (dtype == 1 && vec == 1)
    err = active_clusters<__nv_bfloat16, 1>(cluster, threads, smem, &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

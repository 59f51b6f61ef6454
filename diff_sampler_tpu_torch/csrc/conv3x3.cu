// Direct 3x3 conv, stride 1, SAME padding, NHWC, with an optional fused
// per-(sample, channel) affine + SiLU prologue (kernel K4) for sm_90a.
//
// Replaces diff_sampler_tpu/ops/pallas_conv.py::_kernel (launched by
// _conv_call through conv3x3 and gn_silu_conv3x3) and computes its function:
//   z   = silu(x * a[n] + b[n]) in f32, rounded to x's dtype   (fused only)
//   out = bias + sum over (dy, dx, ci) z[n, y+dy-1, x+dx-1, ci] * w[dy, dx, ci]
// with w in x's dtype, products summed in f32, the f32 bias added last and
// the result rounded to x's dtype.  The SAME padding lies outside the
// prologue: a pixel outside the image is 0, not silu(b).  The TPU kernel
// zeroes a padded VMEM copy of the block and writes only its interior; here
// every shifted load is masked instead, so no padded copy exists.
//
// Design: an implicit GEMM.  M = N*H*W output pixels, N = Cout, K = 9*Cin.
// One block of 256 threads owns a 128-pixel x 128-channel output tile (the
// pixels may span image rows and images: each row's (n, y, x) is computed
// once) and loops over the 9 taps and the Cin chunks, one (tap, chunk) pair a
// step.  Per step it stages the shifted, masked A tile and the w[dy, dx] B
// tile in shared memory.
//   * bf16: a 3-stage cp.async pipeline (two steps' copies in flight while a
//     third is multiplied; masked copies zero-fill, so the halo costs no
//     load), ldmatrix into mma.sync m16n8k16 fragments with f32 accumulators,
//     8 warps of 64 x 32 outputs, 32-channel chunks, 55.5 KB of dynamic
//     shared memory.  The fused prologue runs on the staged tile in shared
//     memory, each thread on the vectors it copied, for step s+1 while the
//     tensor cores work on step s; the zero-filled halo is left as it is.
//   * f32: CUDA-core FMAs (not TF32, so that it holds to 1e-5 of the plain
//     version); register-staged double buffer, the prologue applied on the
//     way to shared memory, each thread 8 x 8 outputs, 8-channel chunks.
//
// Bound: operations.  CIFAR-10's [256, 32, 32, 256] -> 256 and FFHQ's
// [256, 64, 64, 128] -> 128 are each 309 GFLOP: 0.313 ms on the tensor
// cores' 989 TFLOP/s in bf16 (their bytes take 0.08 / 0.16 ms), 4.6 ms on
// the CUDA cores' 67 TFLOP/s in f32.  What the design does about it: the
// bf16 products are on the tensor cores, each staged tile feeds 128 outputs
// per element from shared memory, and the pipeline hides the copies'
// latency.  What it does not do yet: wgmma and TMA (Hopper's full tensor-core
// rate), or applying the prologue once per pixel (it is recomputed for each
// of the 9 taps).
//
// Shapes: Cin and Cout multiples of 8 (one 16-byte vector holds 8 bf16
// channels), any N, H, W >= 1.  Layouts: x contiguous [N, H, W, Cin]; w
// contiguous [3, 3, Cin, Cout] in x's dtype; a, b f32 [N, Cin] (fused only);
// bias f32 [Cout]; out contiguous [N, H, W, Cout]; x and w 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 128;  // output channels per block

// silu in f32 from the fast exponential and division: within a few ulp of
// z / (1 + expf(-z)), far below the bf16 rounding that follows and the f32
// tolerance (1e-5 of the output); exp(-z) = inf for z < -88 gives -0
__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK16 = 32;          // input channels per step
constexpr int kStages = 3;         // cp.async pipeline depth
constexpr int kAS16 = kBK16 + 8;   // A row stride in bf16 (80 bytes: ldmatrix conflict-free)
constexpr int kBS16 = kBN + 8;     // B row stride in bf16 (272 bytes: the same)
constexpr int kAStage = kBM * kAS16;   // bf16 per stage
constexpr int kBStage = kBK16 * kBS16;
constexpr int kSmem16 = kStages * (kAStage + kBStage) * 2;  // bytes: 56832

// One step is a (tap, 32-channel chunk) pair.  Stage layout in shared
// memory: A [128 pixels][32 channels] (x shifted by the tap, prologue
// applied, zero outside the image) and B [32 channels][128 couts] (w[dy, dx]),
// both as they lie in device memory, so cp.async copies them unchanged;
// ldmatrix (B transposed) turns them into mma fragments.
template <bool kFuse>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int N,
                    int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kStages * kAStage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const long long HW = static_cast<long long>(H) * W;
  const long long M = N * HW;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A copies: rows tid/4 and tid/4 + 64 of the tile, channels 8*(tid%4) .. +7
  const int a_vec = tid & 3;
  int rn[2], ry[2], rx[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    rok[i] = m < M;
    const long long mm = rok[i] ? m : 0;
    rn[i] = static_cast<int>(mm / HW);
    const long long rem = mm - rn[i] * HW;
    ry[i] = static_cast<int>(rem / W);
    rx[i] = static_cast<int>(rem - static_cast<long long>(ry[i]) * W);
  }
  // B copies: chunk rows tid/16 and tid/16 + 16, couts 8*(tid%16) .. +7
  const int b_row = tid >> 4, b_vec = tid & 15;

  const int kc = (Cin + kBK16 - 1) / kBK16;
  const int steps = 9 * kc;

  // where step s reads x for A row i (false: outside the image, or past Cin)
  auto a_src = [&](int s, int i, long long& off) -> bool {
    const int tap = s / kc, c = (s - tap * kc) * kBK16 + 8 * a_vec;
    const int yy = ry[i] + tap / 3 - 1, xx = rx[i] + tap % 3 - 1;
    off = ((static_cast<long long>(rn[i]) * H + yy) * W + xx) * Cin + c;
    return rok[i] && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  auto issue = [&](int s) {
    if (s < steps) {
      const int buf = s % kStages;
      const int tap = s / kc, c0 = (s - tap * kc) * kBK16;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        long long off;
        const bool ok = a_src(s, i, off);
        cp_async16(As + buf * kAStage + ((tid >> 2) + 64 * i) * kAS16 + 8 * a_vec,
                   ok ? x + off : x, ok);
      }
      const int co = n0 + 8 * b_vec;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ci = c0 + b_row + 16 * j;
        const bool ok = ci < Cin && co < Cout;
        cp_async16(Bs + buf * kBStage + (b_row + 16 * j) * kBS16 + 8 * b_vec,
                   ok ? w + (static_cast<long long>(tap) * Cin + ci) * Cout + co : w, ok);
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count uniform
  };

  // silu(x * a + b) in f32, rounded to bf16, on this thread's own A vectors
  // of step s (its copies have landed); the zero-filled halo stays zero
  auto prologue = [&](int s) {
    if (!kFuse || s >= steps) return;
    const int buf = s % kStages, tap = s / kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      long long off;
      if (!a_src(s, i, off)) continue;
      uint4* p = reinterpret_cast<uint4*>(As + buf * kAStage + ((tid >> 2) + 64 * i) * kAS16 +
                                          8 * a_vec);
      uint4 v = *p;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
      const long long ab = static_cast<long long>(rn[i]) * Cin + (s - tap * kc) * kBK16 +
                           8 * a_vec;
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(a + ab));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(a + ab + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + ab));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + ab + 4));
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(silu_fast(__bfloat162float(e[j]) * av[j] + bv[j]));
      *p = v;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  cp_async_wait<kStages - 2>();  // step 0 has landed
  prologue(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // step s staged and visible; step s-1's buffer free
    issue(s + kStages - 1);
    const __nv_bfloat16* A = As + (s % kStages) * kAStage;
    const __nv_bfloat16* B = Bs + (s % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], A + (wm * 64 + mi * 16 + (lane & 15)) * kAS16 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int mat = lane >> 3;
        uint32_t r[4];
        ldmatrix_x4_trans(r, B + (kk + (mat & 1) * 8 + (lane & 7)) * kBS16 + wn * 32 +
                                 nj * 16 + (mat >> 1) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    // step s+1's copies have landed; its prologue overlaps the products above
    cp_async_wait<kStages - 2>();
    prologue(s + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= Cout) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm * 64 + mi * 16 + g + 8 * half;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + row * Cout + col) =
              pack_bf16(__float2bfloat16(acc[mi][ni][2 * half] + b0),
                        __float2bfloat16(acc[mi][ni][2 * half + 1] + b1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK32 = 8;           // input channels per step
constexpr int kPad32 = kBM + 4;    // row stride of both tiles in floats

template <bool kFuse>
__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int N, int H,
                   int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[2][kBK32 * kPad32];  // [k][pixel]
  __shared__ __align__(16) float Bs[2][kBK32 * kPad32];  // [k][cout]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // outputs: pixels ty*8 .. +7, couts tx*8 .. +7
  const long long HW = static_cast<long long>(H) * W;
  const long long M = N * HW;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loads: pixel tid/2 of the tile, channels 4*(tid%2) .. +3
  const int a_row = tid >> 1, a_vec = tid & 1;
  const long long am = m0 + a_row;
  const bool arow_ok = am < M;
  const long long amm = arow_ok ? am : 0;
  const int an = static_cast<int>(amm / HW);
  const long long arem = amm - an * HW;
  const int ay = static_cast<int>(arem / W);
  const int ax = static_cast<int>(arem - static_cast<long long>(ay) * W);
  // B loads: chunk row tid/32, couts 4*(tid%32) .. +3
  const int b_row = tid >> 5, b_vec = tid & 31;

  const int kc = Cin / kBK32;
  const int steps = 9 * kc;

  float4 xa, av, bv, wb;
  bool ok;

  auto load = [&](int s) {
    const int tap = s / kc, c0 = (s - tap * kc) * kBK32;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    const int c = c0 + 4 * a_vec;
    const int yy = ay + dy - 1, xx = ax + dx - 1;
    ok = arow_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
    xa = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      xa = *reinterpret_cast<const float4*>(
          x + ((static_cast<long long>(an) * H + yy) * W + xx) * Cin + c);
      if (kFuse) {
        const long long ab = static_cast<long long>(an) * Cin + c;
        av = *reinterpret_cast<const float4*>(a + ab);
        bv = *reinterpret_cast<const float4*>(b + ab);
      }
    }
    const int co = n0 + 4 * b_vec;
    wb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (co < Cout)
      wb = *reinterpret_cast<const float4*>(
          w + (static_cast<long long>(tap) * Cin + c0 + b_row) * Cout + co);
  };

  auto store = [&](int buf) {
    float v[4] = {xa.x, xa.y, xa.z, xa.w};
    if (kFuse && ok) {
      const float ap[4] = {av.x, av.y, av.z, av.w}, bp[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = silu_fast(v[j] * ap[j] + bp[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][(4 * a_vec + j) * kPad32 + a_row] = v[j];
    *reinterpret_cast<float4*>(&Bs[buf][b_row * kPad32 + 4 * b_vec]) = wb;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k * kPad32 + ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k * kPad32 + ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k * kPad32 + tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k * kPad32 + tx * 8 + 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  const int col = n0 + tx * 8;
  if (col >= Cout) return;
  const float4 bias0 = *reinterpret_cast<const float4*>(bias + col);
  const float4 bias1 = *reinterpret_cast<const float4*>(bias + col + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty * 8 + i;
    if (row >= M) break;
    float* o = out + row * Cout + col;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0] + bias0.x, acc[i][1] + bias0.y,
                                                acc[i][2] + bias0.z, acc[i][3] + bias0.w);
    *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4] + bias1.x, acc[i][5] + bias1.y,
                                                    acc[i][6] + bias1.z, acc[i][7] + bias1.w);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16.  a and b are read only when fuse is 1.
extern "C" int dst_conv3x3(const void* x, const void* a, const void* b, const void* w,
                           const void* bias, void* out, int n, int h, int wd, int cin, int cout,
                           int fuse, int dtype, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 8 || cout < 8 || cin % 8 || cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(n) * h * wd;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) {
    const float* xx = static_cast<const float*>(x);
    const float* ww = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (fuse)
      conv3x3_f32_kernel<true><<<grid, kThreads, 0, s>>>(xx, af, bf, ww, bi, o, n, h, wd, cin, cout);
    else
      conv3x3_f32_kernel<false><<<grid, kThreads, 0, s>>>(xx, af, bf, ww, bi, o, n, h, wd, cin, cout);
  } else if (dtype == 1) {
    const __nv_bfloat16* xx = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* ww = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    auto kernel = fuse ? conv3x3_bf16_kernel<true> : conv3x3_bf16_kernel<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem16);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, kSmem16, s>>>(xx, af, bf, ww, bi, o, n, h, wd, cin, cout);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

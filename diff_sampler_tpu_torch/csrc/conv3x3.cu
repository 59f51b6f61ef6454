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
// zeroes a padded VMEM copy of the block, writes the prologue's output into
// its interior and takes the 9 shifted products from it; the bf16 kernel
// here does the same in shared memory.
//
// bf16: wgmma on a TMA-loaded halo tile (conv3x3_bf16_wgmma_kernel).  An
// implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin.
//   * Tiles.  An output tile is a patch of tile_h x tile_w pixels of one
//     image (at most kConvM = 256; ops/conv.py::conv_plan picks the patch,
//     whole rows up to 32 columns) by kConvN = 128 output channels.  A
//     persistent grid (one block per SM) walks the tiles in a fixed order;
//     the two output-channel tiles of a patch are neighbours, so x is read
//     from device memory about once.
//   * Halo.  For each 64-channel chunk of Cin, one TMA load brings the
//     patch's halo, [tile_h + 2, tile_w + 2, 64] of x, from a box that starts
//     at (y0 - 1, x0 - 1).  TMA fills out-of-bounds coordinates with zeros,
//     so the SAME padding and the channels past Cin arrive as 0 with no
//     masks.  Each pixel is one 128-byte row, stored with the 128-byte
//     swizzle.  The 9 taps read shifted views of this one tile: A's bytes
//     from L2 drop from 9 shifted copies of 256 pixels to (tile_h + 2) x
//     (tile_w + 2) pixels a chunk (340 at 8 x 32, 6.8x fewer).
//   * Prologue once per staged pixel (fused entry).  Three warps of the
//     producer warpgroup apply silu(x * a + b) in place on each halo tile
//     once it lands, skipping the pixels outside the image and the channels
//     past Cin, which stay 0, then release it to the consumers.  They run
//     up to two chunks ahead of the tensor cores, off the critical path.
//   * B.  wgmma reads w[tap] from shared memory through a descriptor: the
//     wrapper passes w as [3, 3, Cout, Cin] (K-major), and one TMA load per
//     (chunk, tap) brings its [128 Cout, 64 Cin] tile (16 KB) into a ring of
//     kBStages stages.
//   * Products.  Two consumer warpgroups, each 128 pixels (two m64 tiles) x
//     128 channels: wgmma.m64n128k16 with A in registers, which ldmatrix
//     loads from the swizzled halo at per-lane pixel addresses, so any
//     (dy, dx) shift is an address and a patch row is any width.  Each half
//     tap (2 k16 steps x 2 m64 tiles) is one wgmma group; A's registers are
//     double-buffered across groups, and a stage is released to the producer
//     once the group that last read it has retired.
//   * Pipeline.  Warp 0 of warpgroup 0 issues every TMA load (halos two
//     chunks ahead, B as its ring allows) against "full" mbarriers; the
//     consumers release stages through "empty" ones.  setmaxnreg gives the
//     consumers 224 registers and warpgroup 0 56.  Sums run in a fixed
//     order with no atomics: two runs are bit-identical.
//   * Epilogue.  The bias is added in f32 and the bf16 result staged per
//     warp in shared memory, 16 rows x 32 channels at a time, so each lane
//     stores 16 contiguous bytes of an output row.
//
// f32: CUDA-core FMAs (not TF32, so that it holds to 1e-5 of the plain
// version); register-staged double buffer, the prologue applied on the way
// to shared memory, each thread 8 x 8 outputs, 8-channel chunks, 128-pixel x
// 128-channel tiles; the halo is masked per load.
//
// Bound: operations.  CIFAR-10's [256, 32, 32, 256] -> 256 and FFHQ's
// [256, 64, 64, 128] -> 128 are each 309 GFLOP: 0.313 ms on the tensor
// cores' 989 TFLOP/s in bf16 (their bytes take 0.08 / 0.16 ms), 4.6 ms on
// the CUDA cores' 67 TFLOP/s in f32.  What limits the bf16 kernel below
// that: shared memory, which at the peak rate would serve ~117 of its 128
// bytes a clock (wgmma reads each 16 x 128 B tile once per m64 tile, 1/64
// B a FLOP; the ldmatrix of A 1/128; the TMA writes ~1/240); the tile's
// epilogue, through which the tensor cores wait; in the fused entry, the
// MUFU rate of the three prologue warps (two MUFU ops a value).
//
// Shapes: Cin and Cout multiples of 8 (one 16-byte vector holds 8 bf16
// channels), any N, H, W >= 1.  Layouts: x contiguous [N, H, W, Cin]; w
// contiguous [3, 3, Cin, Cout] (f32) or [3, 3, Cout, Cin] (bf16) in x's
// dtype; a, b f32 [N, Cin] (fused only); bias f32 [Cout]; out contiguous
// [N, H, W, Cout]; every pointer 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

// silu in f32 from the fast exponential and division: within a few ulp of
// z / (1 + expf(-z)), far below the bf16 rounding that follows and the f32
// tolerance (1e-5 of the output); exp(-z) = inf for z < -88 gives -0
__device__ __forceinline__ float silu_fast(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// ---------------------------------------------------------------------------
// bf16: wgmma on a TMA-loaded halo tile
// ---------------------------------------------------------------------------

constexpr int kConvM = 256;          // output pixels per tile
constexpr int kConvN = 128;          // output channels per tile
constexpr int kConvK = 64;           // input channels per chunk (one 128-byte row)
constexpr int kHaloMax = 352;        // halo pixels a stage holds
constexpr int kHaloStages = 3;
constexpr int kBStages = 5;
constexpr int kHaloBytes = kHaloMax * kConvK * 2;  // 45056
constexpr int kBBytes = kConvN * kConvK * 2;       // 16384
constexpr int kConvThreads = 384;    // warpgroup 0: producer warp + 3 prologue warps; 1, 2: consumers
constexpr int kPrologueThreads = 96;
constexpr int kProloguePixels = 2;   // pixels in flight per prologue thread
constexpr int kConsumerWarps = 8;
constexpr int kMaxBox = 256;         // TMA box dimension limit
// register budgets after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168, the
// launch's allocation at one block of 384 threads per SM
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// epilogue staging: per consumer warp 16 rows x 32 output channels of bf16
constexpr int kEpiRows = 16, kEpiCols = 32;
constexpr int kEpiBytes = kConsumerWarps * kEpiRows * kEpiCols * 2;
constexpr int kBarBytes = 8 * (3 * kHaloStages + 2 * kBStages);
// the 1024 bytes align the stages for the 128-byte swizzle
constexpr int kSmemConv =
    1024 + kHaloStages * kHaloBytes + kBStages * kBBytes + kBarBytes + kEpiBytes;

struct ConvGeom {
  int n, h, w, cin, cout;
  int tile_h, tile_w, tiles_x, tiles_y, co_tiles, tiles, kc;
};

struct Tile {
  int n, y0, x0, n0;
};

// tile t: output channels fastest, then patch columns, rows, images
__device__ __forceinline__ Tile tile_of(const ConvGeom& g, int t) {
  Tile r;
  const int co = t % g.co_tiles;
  t /= g.co_tiles;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  r.n = t / g.tiles_y;
  r.y0 = ty * g.tile_h;
  r.x0 = tx * g.tile_w;
  r.n0 = co * kConvN;
  return r;
}

template <bool kFuse>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a,
                          const float* __restrict__ b, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, const ConvGeom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* halo = smem;                               // [kHaloStages][kHaloBytes]
  unsigned char* btile = smem + kHaloStages * kHaloBytes;   // [kBStages][kBBytes]
  unsigned char* epi = btile + kBStages * kBBytes;          // [kConsumerWarps][1 KB]
  uint64_t* hfull = reinterpret_cast<uint64_t*>(epi + kEpiBytes);
  uint64_t* hready = hfull + kHaloStages;  // the prologue has run (fused)
  uint64_t* hempty = hready + kHaloStages;
  uint64_t* bfull = hempty + kHaloStages;
  uint64_t* bempty = bfull + kBStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(hfull + s, 1);
      mbar_init(hready + s, kPrologueThreads);
      mbar_init(hempty + s, kConsumerWarps);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(bfull + s, 1);
      mbar_init(bempty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the block's items: (tile, 64-channel chunk) pairs of tiles blockIdx.x,
  // blockIdx.x + gridDim.x, ..., chunks fastest
  const int items = g.kc * ((g.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);
  auto tile_at = [&](int j) { return tile_of(g, blockIdx.x + (j / g.kc) * gridDim.x); };

  if (warp < 4) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
      if (lane != 0) return;
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&wmap);
      const uint32_t halo_bytes = (g.tile_h + 2) * (g.tile_w + 2) * kConvK * 2;
      auto load_halo = [&](int j) {
        const int s = j % kHaloStages;
        mbar_wait(hempty + s, ((j / kHaloStages) & 1) ^ 1);
        const Tile t = tile_at(j);
        mbar_expect_tx(hfull + s, halo_bytes);
        tma_load_4d(halo + s * kHaloBytes, &xmap, hfull + s, (j % g.kc) * kConvK, t.x0 - 1,
                    t.y0 - 1, t.n);
      };
      load_halo(0);
      if (items > 1) load_halo(1);
      int bi = 0;
      for (int j = 0; j < items; ++j) {
        const Tile t = tile_at(j);
        const int c0 = (j % g.kc) * kConvK;
        for (int tap = 0; tap < 9; ++tap, ++bi) {
          // by now the consumers have begun item j and released item j-1's
          // halo stage, which item j+2 takes
          if (tap == kBStages && j + 2 < items) load_halo(j + 2);
          const int s = bi % kBStages;
          mbar_wait(bempty + s, ((bi / kBStages) & 1) ^ 1);
          mbar_expect_tx(bfull + s, kBBytes);
          tma_load_3d(btile + s * kBBytes, &wmap, bfull + s, c0, t.n0, tap);
        }
      }
    } else if (kFuse) {
      // the prologue, once per staged pixel: thread i takes channels
      // 8 (i % 8) .. +7 of halo pixels i / 8, i / 8 + 12, ..., kProloguePixels
      // at a time
      const int tid = threadIdx.x - 32, k = tid & 7;
      const int hw2 = g.tile_w + 2, pixels = (g.tile_h + 2) * hw2;
      // p / hw2 as (p * inv) >> 16: exact for p < 416 and hw2 <= 34
      const uint32_t inv = (65536u + hw2 - 1) / hw2;
      constexpr int kStep = kPrologueThreads / 8;
      for (int j = 0; j < items; ++j) {
        const int s = j % kHaloStages;
        const Tile t = tile_at(j);
        const int ch = (j % g.kc) * kConvK + 8 * k;
        unsigned char* base = halo + s * kHaloBytes;
        mbar_wait(hfull + s, (j / kHaloStages) & 1);
        if (ch < g.cin) {  // channels past Cin stay 0
          float av[8], bv[8];
          const long long ab = static_cast<long long>(t.n) * g.cin + ch;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float4 a4 = __ldg(reinterpret_cast<const float4*>(a + ab) + i);
            const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + ab) + i);
            av[4 * i] = a4.x, av[4 * i + 1] = a4.y, av[4 * i + 2] = a4.z, av[4 * i + 3] = a4.w;
            bv[4 * i] = b4.x, bv[4 * i + 1] = b4.y, bv[4 * i + 2] = b4.z, bv[4 * i + 3] = b4.w;
          }
          for (int p = tid >> 3; p < pixels; p += kProloguePixels * kStep) {
            int pp[kProloguePixels];
            bool in[kProloguePixels];
            uint4 val[kProloguePixels];
#pragma unroll
            for (int u = 0; u < kProloguePixels; ++u) {
              pp[u] = p + u * kStep;
              const int hr = (pp[u] * inv) >> 16, hc = pp[u] - hr * hw2;
              const int yy = t.y0 - 1 + hr, xx = t.x0 - 1 + hc;
              // pixels outside the image stay 0
              in[u] = pp[u] < pixels && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
              val[u] = *reinterpret_cast<const uint4*>(
                  base + swz128_offset(pp[u] < pixels ? pp[u] : p, k));
            }
#pragma unroll
            for (int u = 0; u < kProloguePixels; ++u) {
              uint32_t* e = reinterpret_cast<uint32_t*>(&val[u]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e + i));
                e[i] = pack_rn(silu_fast(z.x * av[2 * i] + bv[2 * i]),
                               silu_fast(z.y * av[2 * i + 1] + bv[2 * i + 1]));
              }
              if (in[u]) *reinterpret_cast<uint4*>(base + swz128_offset(pp[u], k)) = val[u];
            }
          }
        }
        fence_proxy_async();  // the next TMA load into this stage comes after these writes
        mbar_arrive(hready + s);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = (warp >> 2) - 1, wl = warp & 3;
    const int hw2 = g.tile_w + 2;
    // this lane's ldmatrix rows: row lane % 16 of warp wl's 16-row slab of
    // each of the warpgroup's two m64 tiles, as halo pixels at tap (0, 0);
    // rows past the patch read pixel 0 and are never stored
    int p0[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wg * 128 + mi * 64 + wl * 16 + (lane & 15);
      const int r = m / g.tile_w, c = m - r * g.tile_w;
      p0[mi] = r < g.tile_h ? r * hw2 + c : 0;
    }
    const uint32_t khalf = lane >> 4;  // ldmatrix: lanes 16-31 give k 8-15
    const uint32_t halo_s = smem_addr(halo), b_s = smem_addr(btile);

    float acc[2][64];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
    uint32_t af[2][2][2][4];  // [half tap][m64 tile][k16 step of the half][fragment]
    // j: the block's items so far; pend_*: stages to release once their last group retires
    int j = 0, bi = 0, pend_b = -1, pend_h = -1;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      for (int c = 0; c < g.kc; ++c, ++j) {
        const int hs = j % kHaloStages;
        mbar_wait((kFuse ? hready : hfull) + hs, (j / kHaloStages) & 1);
        const uint32_t hbase = halo_s + hs * kHaloBytes;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap, ++bi) {
          const int bs = bi % kBStages;
          const int shift = (tap / 3) * hw2 + tap % 3;
          uint32_t row[2], sw[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint32_t p = p0[mi] + shift;
            row[mi] = hbase + p * 128u;
            sw[mi] = p & 7u;
          }
          const uint64_t desc = wgmma_desc_sw128(b_s + bs * kBBytes);
          mbar_wait(bfull + bs, (bi / kBStages) & 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int kl = 0; kl < 2; ++kl)
                ldmatrix_x4_at(af[h][mi][kl],
                               row[mi] + ((((4 * h + 2 * kl) | khalf) ^ sw[mi]) << 4));
            wgmma_fence();
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int kl = 0; kl < 2; ++kl)
                // a tile's first product overwrites the last tile's sums
                wgmma_m64n128k16_bf16_rs(acc[mi], af[h][mi][kl], desc + 2 * (2 * h + kl),
                                         tap + h + kl > 0 || c > 0);
            wgmma_commit();
            wgmma_wait<1>();  // the group before this one has retired
            if (h == 0) {
              if (lane == 0) {
                if (pend_b >= 0) mbar_arrive(bempty + pend_b);
                if (pend_h >= 0) mbar_arrive(hempty + pend_h);
              }
              pend_b = pend_h = -1;
            }
          }
          pend_b = bs;
        }
        pend_h = hs;
      }

      // epilogue: bias, bf16
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(bempty + pend_b);
        mbar_arrive(hempty + pend_h);
      }
      pend_b = pend_h = -1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[mi][i]);
      const Tile t = tile_of(g, tile);
      // through shared memory, 16 rows x 32 channels of a warp at a time, so
      // each lane stores 16 bytes of one output row; the 16-byte chunks of a
      // staged row are swizzled by (row / 2) % 4, so neither pass conflicts
      unsigned char* stage = epi + (warp - 4) * (kEpiRows * kEpiCols * 2);
      const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        __nv_bfloat16* orow[2];  // the rows this lane stores: lane / 4 and lane / 4 + 8
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wg * 128 + mi * 64 + wl * 16 + g8 + 8 * i;
          const int r = m / g.tile_w, cc = m - r * g.tile_w;
          const int y = t.y0 + r, x = t.x0 + cc;
          orow[i] = r < g.tile_h && y < g.h && x < g.w
                        ? out + ((static_cast<long long>(t.n) * g.h + y) * g.w + x) * g.cout
                        : nullptr;
        }
#pragma unroll
        for (int q = 0; q < kConvN / kEpiCols; ++q) {
          const int col = t.n0 + q * kEpiCols;
          if (col >= g.cout) break;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const int cj = col + 8 * jn + 2 * t4;  // Cout may end inside the 32 channels
            const float2 bv = cj < g.cout ? __ldg(reinterpret_cast<const float2*>(bias + cj))
                                          : make_float2(0.f, 0.f);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = g8 + 8 * half, a_i = 4 * (4 * q + jn) + 2 * half;
              *reinterpret_cast<uint32_t*>(stage + r * 64 + ((jn ^ ((r >> 1) & 3)) << 4) + 4 * t4) =
                  pack_rn(acc[mi][a_i] + bv.x, acc[mi][a_i + 1] + bv.y);
            }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = g8 + 8 * i;
            const uint4 v =
                *reinterpret_cast<const uint4*>(stage + r * 64 + ((t4 ^ ((r >> 1) & 3)) << 4));
            if (orow[i] != nullptr && col + 8 * t4 < g.cout)
              *reinterpret_cast<uint4*>(orow[i] + col + 8 * t4) = v;
          }
          __syncwarp();
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBM = 128;           // output pixels per block
constexpr int kBN = 128;           // output channels per block
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



// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint so that
// the library links without -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 tensor map with the 128-byte swizzle, zeros out of bounds; dims
// and box innermost first, strides in bytes for dims 1..rank-1
bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// f32 K4.  a and b are read only when fuse is 1.
extern "C" int dst_conv3x3_f32(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* out, int n, int h, int wd, int cin,
                               int cout, int fuse, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 8 || cout < 8 || cin % 8 || cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(n) * h * wd;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* ww = static_cast<const float*>(w);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (fuse)
    conv3x3_f32_kernel<true><<<grid, kThreads, 0, s>>>(xx, af, bf, ww, bi, o, n, h, wd, cin, cout);
  else
    conv3x3_f32_kernel<false><<<grid, kThreads, 0, s>>>(xx, af, bf, ww, bi, o, n, h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// bf16 K4 on a tile_h x tile_w patch plan (ops/conv.py::conv_plan); wt is
// w as [3, 3, Cout, Cin].  a and b are read only when fuse is 1.  Refuses a
// patch its halo stage or TMA's boxes cannot hold.
extern "C" int dst_conv3x3_bf16(const void* x, const void* a, const void* b, const void* wt,
                                const void* bias, void* out, int n, int h, int wd, int cin,
                                int cout, int fuse, int tile_h, int tile_w, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 8 || cout < 8 || cin % 8 || cout % 8 || tile_h < 1 ||
      tile_w < 1 || tile_h * tile_w > kConvM || (tile_h + 2) * (tile_w + 2) > kHaloMax ||
      tile_w + 2 > kMaxBox || tile_h + 2 > kMaxBox || !aligned16(x) || !aligned16(wt) ||
      !aligned16(bias) || !aligned16(out) || (fuse && (!aligned16(a) || !aligned16(b))))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g;
  g.n = n, g.h = h, g.w = wd, g.cin = cin, g.cout = cout;
  g.tile_h = tile_h, g.tile_w = tile_w;
  g.tiles_x = (wd + tile_w - 1) / tile_w;
  g.tiles_y = (h + tile_h - 1) / tile_h;
  g.co_tiles = (cout + kConvN - 1) / kConvN;
  g.kc = (cin + kConvK - 1) / kConvK;
  const long long tiles = static_cast<long long>(n) * g.tiles_y * g.tiles_x * g.co_tiles;
  const int sms = sm_count();
  if (tiles >= (1ll << 31) || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wd),
                               static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[3] = {2ull * cin, 2ull * cin * wd, 2ull * cin * wd * h};
  const cuuint32_t xbox[4] = {kConvK, static_cast<cuuint32_t>(tile_w + 2),
                              static_cast<cuuint32_t>(tile_h + 2), 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t wstrides[2] = {2ull * cin, 2ull * cin * cout};
  const cuuint32_t wbox[3] = {kConvK, kConvN, 1};
  if (!encode_bf16(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode_bf16(&wmap, wt, 3, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = fuse ? conv3x3_bf16_wgmma_kernel<true> : conv3x3_bf16_wgmma_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemConv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kConvThreads, kSmemConv, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

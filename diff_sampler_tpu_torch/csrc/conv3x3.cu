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
// its interior and takes the 9 shifted products from it; the kernels here
// do the same in shared memory.
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
// f32: 3xTF32 wgmma on the same halo-tile pipeline
// (conv3x3_f32_wgmma_kernel), where the differences are:
//   * Halo.  A chunk is 32 f32 channels, again one 128-byte row a pixel, so
//     the stage, the swizzle and the ldmatrix addresses are bf16's.
//     ldmatrix.x4.b16 loads wgmma's TF32 m64k8 A fragment (each 32-bit
//     element as two b16 halves of one row); a k8 step is 32 bytes into the
//     row, as bf16's k16 step.  The prologue runs in f32 and is not rounded.
//   * Split.  A is split into TF32 hi and lo in registers (cvt.rna, as
//     mma.cuh::split_tf32).  w is split once per call by
//     conv3x3_split_w_kernel into w_hi and w_lo, each [3, 3, Cout, Cin],
//     whose [64 Cout, 32 Cin] tiles (8 KB each) the TMA ring brings together.
//   * Products.  wgmma.m64n64k8 TF32, three per k8 step as mma_3xtf32
//     orders them: lo(a) hi(w), hi(a) lo(w), then hi(a) hi(w); lo lo (2^-22
//     of a product) is dropped.
//   * Accumulation.  The tensor cores truncate as they accumulate, so a run
//     of kFoldTaps taps (12 products a tap) goes into fresh accumulators,
//     scale-d 0 on its first product, which are then added to the f32 sums,
//     rounded to nearest.  Main and fresh sums of 256 pixels x 128 channels
//     would take all 256 registers of every consumer thread: a tile is 256
//     pixels x 64 channels, 32 + 32 sums per m64 tile, two m64 tiles per
//     consumer warpgroup, A's hi and lo double-buffered across the wgmma
//     groups (one group per k8 step: 2 tiles x 3 products).
//   * Epilogue.  The bias is added in f32 and each lane stores its two
//     channels of a row, 8 bytes (four lanes fill a 32-byte sector), with
//     no staging.
//
// Bound: operations.  CIFAR-10's [256, 32, 32, 256] -> 256 and FFHQ's
// [256, 64, 64, 128] -> 128 are each 309 GFLOP: 0.313 ms on the tensor
// cores' 989 TFLOP/s in bf16 (their bytes take 0.08 / 0.16 ms); in f32
// three TF32 products each at 495 TFLOP/s, 1.874 ms (4.6 ms on the CUDA
// cores' 67 TFLOP/s; bytes 0.16 / 0.32 ms).  What limits the bf16 kernel
// below that: shared memory, which at the peak rate would serve ~117 of its
// 128 bytes a clock (wgmma reads each 16 x 128 B tile once per m64 tile,
// 1/64 B a FLOP; the ldmatrix of A 1/128; the TMA writes ~1/240); the
// tile's epilogue, through which the tensor cores wait; in the fused entry,
// the MUFU rate of the three prologue warps (two MUFU ops a value).  The
// f32 kernel at the TF32 rate: wgmma's B reads 1/32 B a FLOP from shared
// memory (64 of its 128 bytes a clock); each fold drains a warpgroup's
// wgmma pipeline, which the other consumer warpgroup covers; the TMA loads
// from L2 (w's two tiles per tap, and the halo once per 64-channel output
// tile) ~14 bytes a clock per SM at that rate; the split of A, ~12 ALU ops
// a thread per three wgmma.
//
// Shapes: Cin and Cout multiples of 8 (16-byte TMA strides; one 16-byte
// vector holds 8 bf16 channels), any N, H, W >= 1.  Layouts: x contiguous
// [N, H, W, Cin]; w contiguous [3, 3, Cout, Cin] (bf16; f32: w_hi and w_lo
// from the split, which takes w [3, 3, Cin, Cout]); a, b f32 [N, Cin] (fused
// only); bias f32 [Cout]; out contiguous [N, H, W, Cout]; every pointer
// 16-byte aligned.

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

// tile t of kN output channels: output channels fastest, then patch
// columns, rows, images
template <int kN>
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
  r.n0 = co * kN;
  return r;
}

// The pipeline's mbarriers, in shared memory: per halo stage "full" (its
// TMA load has landed), "ready" (the prologue has run; fused only) and
// "empty" (the consumer warps are done with it); per B stage "full" and
// "empty"
template <int kBS>
struct ConvBarriers {
  uint64_t hfull[kHaloStages], hready[kHaloStages], hempty[kHaloStages];
  uint64_t bfull[kBS], bempty[kBS];

  __device__ void init() {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(hfull + s, 1);
      mbar_init(hready + s, kPrologueThreads);
      mbar_init(hempty + s, kConsumerWarps);
    }
    for (int s = 0; s < kBS; ++s) {
      mbar_init(bfull + s, 1);
      mbar_init(bempty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
};

static_assert(sizeof(ConvBarriers<kBStages>) == kBarBytes, "the bf16 kernel's barriers");

// The producer, lane 0 of warp 0: every TMA load of the block's items
// ((tile, chunk of kK input channels) pairs, chunks fastest), each halo two
// items ahead, each tap's B tiles (kBTile bytes from each of the kMaps
// weight maps) as the ring of kBS stages allows
template <int kK, int kBS, int kBTile, int kMaps, typename TileAt>
__device__ __forceinline__ void conv_produce(const CUtensorMap* xmap,
                                             const CUtensorMap* const (&wmaps)[kMaps],
                                             unsigned char* halo, unsigned char* btile,
                                             ConvBarriers<kBS>& bar, const ConvGeom& g, int items,
                                             TileAt tile_at) {
  prefetch_tensormap(xmap);
  for (int i = 0; i < kMaps; ++i) prefetch_tensormap(wmaps[i]);
  const uint32_t halo_bytes = (g.tile_h + 2) * (g.tile_w + 2) * 128;  // 128-byte rows
  auto load_halo = [&](int j) {
    const int s = j % kHaloStages;
    mbar_wait(bar.hempty + s, ((j / kHaloStages) & 1) ^ 1);
    const Tile t = tile_at(j);
    mbar_expect_tx(bar.hfull + s, halo_bytes);
    tma_load_4d(halo + s * kHaloBytes, xmap, bar.hfull + s, (j % g.kc) * kK, t.x0 - 1, t.y0 - 1,
                t.n);
  };
  load_halo(0);
  if (items > 1) load_halo(1);
  int bi = 0;
  for (int j = 0; j < items; ++j) {
    const Tile t = tile_at(j);
    const int c0 = (j % g.kc) * kK;
    for (int tap = 0; tap < 9; ++tap, ++bi) {
      // by now the consumers have begun item j and released item j-1's
      // halo stage, which item j+2 takes
      if (tap == kBS && j + 2 < items) load_halo(j + 2);
      const int s = bi % kBS;
      mbar_wait(bar.bempty + s, ((bi / kBS) & 1) ^ 1);
      mbar_expect_tx(bar.bfull + s, kMaps * kBTile);
      for (int i = 0; i < kMaps; ++i)
        tma_load_3d(btile + (s * kMaps + i) * kBTile, wmaps[i], bar.bfull + s, c0, t.n0, tap);
    }
  }
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
  auto& bar = *reinterpret_cast<ConvBarriers<kBStages>*>(epi + kEpiBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  // the block's items: (tile, 64-channel chunk) pairs of tiles blockIdx.x,
  // blockIdx.x + gridDim.x, ..., chunks fastest
  const int items = g.kc * ((g.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);
  auto tile_at = [&](int j) { return tile_of<kConvN>(g, blockIdx.x + (j / g.kc) * gridDim.x); };

  if (warp < 4) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
      if (lane != 0) return;
      const CUtensorMap* const wmaps[1] = {&wmap};
      conv_produce<kConvK, kBStages, kBBytes>(&xmap, wmaps, halo, btile, bar, g, items, tile_at);
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
        mbar_wait(bar.hfull + s, (j / kHaloStages) & 1);
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
        mbar_arrive(bar.hready + s);
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
        mbar_wait((kFuse ? bar.hready : bar.hfull) + hs, (j / kHaloStages) & 1);
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
          mbar_wait(bar.bfull + bs, (bi / kBStages) & 1);
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
                if (pend_b >= 0) mbar_arrive(bar.bempty + pend_b);
                if (pend_h >= 0) mbar_arrive(bar.hempty + pend_h);
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
        mbar_arrive(bar.bempty + pend_b);
        mbar_arrive(bar.hempty + pend_h);
      }
      pend_b = pend_h = -1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[mi][i]);
      const Tile t = tile_of<kConvN>(g, tile);
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
// f32: 3xTF32 wgmma on the same halo tile
// ---------------------------------------------------------------------------

constexpr int kConvN32 = 64;         // output channels per tile
constexpr int kConvK32 = 32;         // input channels per chunk (one 128-byte row)
constexpr int kBStages32 = 5;
constexpr int kBTile32 = kConvN32 * kConvK32 * 4;  // 8192: the tile of w_hi, or of w_lo
constexpr int kBBytes32 = 2 * kBTile32;            // 16384: both
constexpr int kBarBytes32 = 8 * (3 * kHaloStages + 2 * kBStages32);
constexpr int kSmemConv32 =
    1024 + kHaloStages * kHaloBytes + kBStages32 * kBBytes32 + kBarBytes32;
static_assert(sizeof(ConvBarriers<kBStages32>) == kBarBytes32, "the f32 kernel's barriers");
// The tensor cores truncate as they accumulate, so each run of products goes
// into fresh accumulators (scale-d 0 on its first product), which are then
// added to the f32 sums, rounded to nearest: a run is kFoldTaps taps (the
// last run of a chunk ends at tap 8), 12 products a tap.  Runs of a chunk
// keep the error at ~1/4 of the tolerance and cost no time measured against
// shorter ones (cli/conv_variants.py); a tile in one run misses it.
constexpr int kFoldTaps = 9;

template <bool kFuse>
__global__ void __launch_bounds__(kConvThreads, 1)
conv3x3_f32_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap hmap,
                         const __grid_constant__ CUtensorMap lmap, const float* __restrict__ a,
                         const float* __restrict__ b, const float* __restrict__ bias,
                         float* __restrict__ out, const ConvGeom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* halo = smem;                               // [kHaloStages][kHaloBytes]
  unsigned char* btile = smem + kHaloStages * kHaloBytes;   // [kBStages32][w_hi, w_lo]
  auto& bar = *reinterpret_cast<ConvBarriers<kBStages32>*>(btile + kBStages32 * kBBytes32);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  // the block's items: (tile, 32-channel chunk) pairs, chunks fastest
  const int items = g.kc * ((g.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1);
  auto tile_at = [&](int j) {
    return tile_of<kConvN32>(g, blockIdx.x + (j / g.kc) * gridDim.x);
  };

  if (warp < 4) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
      if (lane != 0) return;
      const CUtensorMap* const wmaps[2] = {&hmap, &lmap};
      conv_produce<kConvK32, kBStages32, kBTile32>(&xmap, wmaps, halo, btile, bar, g, items,
                                                   tile_at);
    } else if (kFuse) {
      // the prologue in f32, once per staged pixel: thread i takes channels
      // 4 (i % 8) .. +3 of halo pixels i / 8, i / 8 + 12, ...
      const int tid = threadIdx.x - 32, k = tid & 7;
      const int hw2 = g.tile_w + 2, pixels = (g.tile_h + 2) * hw2;
      const uint32_t inv = (65536u + hw2 - 1) / hw2;  // as in bf16
      constexpr int kStep = kPrologueThreads / 8;
      for (int j = 0; j < items; ++j) {
        const int s = j % kHaloStages;
        const Tile t = tile_at(j);
        const int ch = (j % g.kc) * kConvK32 + 4 * k;
        unsigned char* base = halo + s * kHaloBytes;
        mbar_wait(bar.hfull + s, (j / kHaloStages) & 1);
        if (ch < g.cin) {  // all four channels inside Cin, or all past it
          const long long ab = static_cast<long long>(t.n) * g.cin + ch;
          const float4 av = __ldg(reinterpret_cast<const float4*>(a + ab));
          const float4 bv = __ldg(reinterpret_cast<const float4*>(b + ab));
          for (int p = tid >> 3; p < pixels; p += kProloguePixels * kStep) {
            int pp[kProloguePixels];
            bool in[kProloguePixels];
            float4 v[kProloguePixels];
#pragma unroll
            for (int u = 0; u < kProloguePixels; ++u) {
              pp[u] = p + u * kStep;
              const int hr = (pp[u] * inv) >> 16, hc = pp[u] - hr * hw2;
              const int yy = t.y0 - 1 + hr, xx = t.x0 - 1 + hc;
              in[u] = pp[u] < pixels && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
              v[u] = *reinterpret_cast<const float4*>(
                  base + swz128_offset(pp[u] < pixels ? pp[u] : p, k));
            }
#pragma unroll
            for (int u = 0; u < kProloguePixels; ++u) {
              v[u].x = silu_fast(v[u].x * av.x + bv.x);
              v[u].y = silu_fast(v[u].y * av.y + bv.y);
              v[u].z = silu_fast(v[u].z * av.z + bv.z);
              v[u].w = silu_fast(v[u].w * av.w + bv.w);
              if (in[u]) *reinterpret_cast<float4*>(base + swz128_offset(pp[u], k)) = v[u];
            }
          }
        }
        fence_proxy_async();
        mbar_arrive(bar.hready + s);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = (warp >> 2) - 1, wl = warp & 3;
    const int hw2 = g.tile_w + 2;
    // this lane's ldmatrix rows, as in bf16
    int p0[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wg * 128 + mi * 64 + wl * 16 + (lane & 15);
      const int r = m / g.tile_w, c = m - r * g.tile_w;
      p0[mi] = r < g.tile_h ? r * hw2 + c : 0;
    }
    const uint32_t khalf = lane >> 4;  // ldmatrix: lanes 16-31 give k 4-7 of a k8 step
    const uint32_t halo_s = smem_addr(halo), b_s = smem_addr(btile);

    float acc[2][32], part[2][32];  // [m64 tile]: the f32 sums; the run's fresh sums
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mi][i] = part[mi][i] = 0.f;
    uint32_t ah[2][2][4], al[2][2][4];  // [group parity][m64 tile]: A's TF32 hi and lo
    auto release = [&](int sb, int sh) {
      if (lane == 0) {
        if (sb >= 0) mbar_arrive(bar.bempty + sb);
        if (sh >= 0) mbar_arrive(bar.hempty + sh);
      }
    };
    // pend_*: stages to release once the group that last read them retires
    int j = 0, bi = 0, pend_b = -1, pend_h = -1;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      for (int c = 0; c < g.kc; ++c, ++j) {
        const int hs = j % kHaloStages;
        mbar_wait((kFuse ? bar.hready : bar.hfull) + hs, (j / kHaloStages) & 1);
        const uint32_t hbase = halo_s + hs * kHaloBytes;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap, ++bi) {
          const int bs = bi % kBStages32;
          const int shift = (tap / 3) * hw2 + tap % 3;
          uint32_t row[2], sw[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint32_t p = p0[mi] + shift;
            row[mi] = hbase + p * 128u;
            sw[mi] = p & 7u;
          }
          const uint64_t dhi = wgmma_desc_sw128(b_s + bs * kBBytes32);
          const uint64_t dlo = wgmma_desc_sw128(b_s + bs * kBBytes32 + kBTile32);
          const bool starts = tap % kFoldTaps == 0;
          const bool ends = tap % kFoldTaps == kFoldTaps - 1 || tap == 8;
          mbar_wait(bar.bfull + bs, (bi / kBStages32) & 1);
          // one wgmma group per k8 step: 2 m64 tiles x 3 products
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int u = kk & 1;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              uint32_t raw[4];
              ldmatrix_x4_at(raw, row[mi] + ((((2 * kk) | khalf) ^ sw[mi]) << 4));
              split_tf32(raw, ah[u][mi], al[u][mi]);
            }
            wgmma_fence();
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              // as mma_3xtf32: the small products first; a run's first
              // product overwrites the last run's sums
              wgmma_m64n64k8_tf32_rs(part[mi], al[u][mi], dhi + 2 * kk, kk > 0 || !starts);
              wgmma_m64n64k8_tf32_rs(part[mi], ah[u][mi], dlo + 2 * kk, true);
              wgmma_m64n64k8_tf32_rs(part[mi], ah[u][mi], dhi + 2 * kk, true);
            }
            wgmma_commit();
            // this group is the last to read B stage bs, and at tap 8 halo stage hs
            const int last_b = kk == 3 ? bs : -1, last_h = kk == 3 && tap == 8 ? hs : -1;
            if (kk == 3 && ends) {
              wgmma_wait<0>();
              release(pend_b, pend_h);
              release(last_b, last_h);
              pend_b = pend_h = -1;
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  fence_operand(part[mi][i]);
                  acc[mi][i] += part[mi][i];
                }
            } else {
              wgmma_wait<1>();  // the group before this one has retired
              release(pend_b, pend_h);
              pend_b = last_b, pend_h = last_h;
            }
          }
        }
      }

      // epilogue: bias, then f32 straight from the sums: a lane's two
      // channels of a row are 8 bytes, four lanes one 32-byte sector
      const Tile t = tile_of<kConvN32>(g, tile);
      const int g8 = lane >> 2, t4 = lane & 3;
      float2 bv[kConvN32 / 8];
#pragma unroll
      for (int jn = 0; jn < kConvN32 / 8; ++jn) {
        const int cj = t.n0 + 8 * jn + 2 * t4;
        bv[jn] = cj < g.cout ? __ldg(reinterpret_cast<const float2*>(bias + cj))
                             : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = wg * 128 + mi * 64 + wl * 16 + g8 + 8 * half;
          const int r = m / g.tile_w, cc = m - r * g.tile_w;
          const int y = t.y0 + r, x = t.x0 + cc;
          if (r < g.tile_h && y < g.h && x < g.w) {
            float* o = out + ((static_cast<long long>(t.n) * g.h + y) * g.w + x) * g.cout + t.n0 +
                       2 * t4;
#pragma unroll
            for (int jn = 0; jn < kConvN32 / 8; ++jn)
              if (t.n0 + 8 * jn < g.cout)  // Cout may end inside the tile
                *reinterpret_cast<float2*>(o + 8 * jn) =
                    make_float2(acc[mi][4 * jn + 2 * half] + bv[jn].x,
                                acc[mi][4 * jn + 2 * half + 1] + bv[jn].y);
          }
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[mi][i] = 0.f;
    }
  }
}

// w [3, 3, Cin, Cout] f32 -> its TF32 split (mma.cuh::split_tf32) w_hi,
// w_lo, each [9, Cout, Cin] (K-major for wgmma's B), through a 32 x 32
// shared-memory tile per tap, so that reads and writes are both coalesced
__global__ void __launch_bounds__(256)
conv3x3_split_w_kernel(const float* __restrict__ w, float* __restrict__ w_hi,
                       float* __restrict__ w_lo, int cin, int cout) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z, ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8)
    if (ci0 + i < cin && co0 + tx < cout)
      tile[i][tx] = w[(static_cast<long long>(tap) * cin + ci0 + i) * cout + co0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    if (co0 + i < cout && ci0 + tx < cin) {
      uint32_t hi, lo;
      split_tf32(tile[tx][i], hi, lo);
      const long long o = (static_cast<long long>(tap) * cout + co0 + i) * cin + ci0 + tx;
      w_hi[o] = __uint_as_float(hi);
      w_lo[o] = __uint_as_float(lo);
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

// a tensor map with the 128-byte swizzle, zeros out of bounds; dims and
// box innermost first, strides in bytes for dims 1..rank-1
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The geometry of a call on a tile_h x tile_w patch plan
// (ops/conv.py::conv_plan) with tile_n output channels a tile and chunk
// input channels a halo load, and the TMA maps of x's halo ([N, H, W, Cin]
// in boxes of [1, tile_h + 2, tile_w + 2, chunk]) and of each of the nw
// weight tensors ([9, Cout, Cin] in boxes of [1, tile_n, chunk]), elements
// of elt bytes.  False for a shape, patch or pointer the kernels refuse.
bool conv_setup(ConvGeom& g, CUtensorMap* xmap, CUtensorMap* wmaps, const void* x,
                const void* const* ws, int nw, const void* a, const void* b, const void* bias,
                const void* out, int n, int h, int wd, int cin, int cout, int fuse, int tile_h,
                int tile_w, CUtensorMapDataType type, int elt, int tile_n, int chunk) {
  if (n < 1 || h < 1 || wd < 1 || cin < 8 || cout < 8 || cin % 8 || cout % 8 || tile_h < 1 ||
      tile_w < 1 || tile_h * tile_w > kConvM || (tile_h + 2) * (tile_w + 2) > kHaloMax ||
      tile_w + 2 > kMaxBox || tile_h + 2 > kMaxBox || !aligned16(x) || !aligned16(bias) ||
      !aligned16(out) || (fuse && (!aligned16(a) || !aligned16(b))))
    return false;
  g.n = n, g.h = h, g.w = wd, g.cin = cin, g.cout = cout;
  g.tile_h = tile_h, g.tile_w = tile_w;
  g.tiles_x = (wd + tile_w - 1) / tile_w;
  g.tiles_y = (h + tile_h - 1) / tile_h;
  g.co_tiles = (cout + tile_n - 1) / tile_n;
  g.kc = (cin + chunk - 1) / chunk;
  const long long tiles = static_cast<long long>(n) * g.tiles_y * g.tiles_x * g.co_tiles;
  if (tiles >= (1ll << 31)) return false;
  g.tiles = static_cast<int>(tiles);
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wd),
                               static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[3] = {1ull * elt * cin, 1ull * elt * cin * wd,
                                  1ull * elt * cin * wd * h};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(tile_w + 2),
                              static_cast<cuuint32_t>(tile_h + 2), 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t wstrides[2] = {1ull * elt * cin, 1ull * elt * cin * cout};
  const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(tile_n), 1};
  if (!encode_map(xmap, type, x, 4, xdims, xstrides, xbox)) return false;
  for (int i = 0; i < nw; ++i)
    if (!aligned16(ws[i]) || !encode_map(wmaps + i, type, ws[i], 3, wdims, wstrides, wbox))
      return false;
  return true;
}

// one persistent block of kConvThreads per SM, at most one per tile
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int smem, const ConvGeom& g, void* stream, Args... args) {
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(g.tiles < sms ? g.tiles : sms);
  kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(args..., g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 K4 on a tile_h x tile_w patch plan (ops/conv.py::conv_plan); w_hi and
// w_lo are the TF32 split of w as [3, 3, Cout, Cin] (dst_conv3x3_split_w).
// a and b are read only when fuse is 1.  Refuses a patch its halo stage or
// TMA's boxes cannot hold.
extern "C" int dst_conv3x3_f32(const void* x, const void* a, const void* b, const void* w_hi,
                               const void* w_lo, const void* bias, void* out, int n, int h,
                               int wd, int cin, int cout, int fuse, int tile_h, int tile_w,
                               void* stream) {
  ConvGeom g;
  CUtensorMap xmap, wmaps[2];
  const void* ws[2] = {w_hi, w_lo};
  if (!conv_setup(g, &xmap, wmaps, x, ws, 2, a, b, bias, out, n, h, wd, cin, cout, fuse, tile_h,
                  tile_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kConvN32, kConvK32))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(fuse ? conv3x3_f32_wgmma_kernel<true> : conv3x3_f32_wgmma_kernel<false>,
                           kSmemConv32, g, stream, xmap, wmaps[0], wmaps[1],
                           static_cast<const float*>(a), static_cast<const float*>(b),
                           static_cast<const float*>(bias), static_cast<float*>(out));
}

// w [3, 3, Cin, Cout] f32 -> w_hi, w_lo, each [3, 3, Cout, Cin]: the TF32
// split that dst_conv3x3_f32 takes
extern "C" int dst_conv3x3_split_w(const void* w, void* w_hi, void* w_lo, int cin, int cout,
                                   void* stream) {
  if (cin < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cout + 31) / 32, (cin + 31) / 32, 9);
  conv3x3_split_w_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(w_hi), static_cast<float*>(w_lo), cin,
      cout);
  return static_cast<int>(cudaGetLastError());
}

// bf16 K4 on a tile_h x tile_w patch plan (ops/conv.py::conv_plan); wt is
// w as [3, 3, Cout, Cin].  a and b are read only when fuse is 1.  Refuses a
// patch its halo stage or TMA's boxes cannot hold.
extern "C" int dst_conv3x3_bf16(const void* x, const void* a, const void* b, const void* wt,
                                const void* bias, void* out, int n, int h, int wd, int cin,
                                int cout, int fuse, int tile_h, int tile_w, void* stream) {
  ConvGeom g;
  CUtensorMap xmap, wmap;
  if (!conv_setup(g, &xmap, &wmap, x, &wt, 1, a, b, bias, out, n, h, wd, cin, cout, fuse, tile_h,
                  tile_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kConvN, kConvK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_persistent(
      fuse ? conv3x3_bf16_wgmma_kernel<true> : conv3x3_bf16_wgmma_kernel<false>, kSmemConv, g,
      stream, xmap, wmap, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out));
}

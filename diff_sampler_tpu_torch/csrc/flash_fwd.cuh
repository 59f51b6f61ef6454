// Pieces shared by the flash-attention forward kernels (flash_attn_fwd.cu: K1
// in bf16; flash_attn_fwd_tf32.cu: K1 in f32): the view and route structs,
// the online softmax on mma accumulators, and the checks of the load modes'
// rules, which the entry points repeat because a misaligned cp.async faults.
// The backward kernels (flash_attn_bwd.cu: K2 in bf16; flash_attn_bwd_tf32.cu:
// K2 in f32) take the views, the route, the load modes, ex2 and the checks
// from here too, and the bf16 backward the span mode's unit split.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, t, h, e;
};

// Rows of one (batch, head): element (t, e) of x lies at p[t * st + e * se].
template <typename T>
struct Rows {
  const T* __restrict__ p;
  long long st, se;
};

constexpr int kLoadAsync = 1;   // cp.async, 16 bytes a copy
constexpr int kLoadGather = 2;  // element loads staged in registers
constexpr int kLoadSpan = 3;    // Q, K and V split out of their shared qkv rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one m-tile over one key tile, in log2 units: the raw
// q.k accumulators s become p = 2^(sl2 s - m), m the row's running max and l
// its sum (this lane's part).  UP: sl2 > 0, so a row's largest logit is
// sl2 * max s (otherwise sl2 * min s).  m moves only where some row of the
// warp would pass it by more than kSlack: then every row takes its new max
// and rescales l and acc.  Otherwise m stays and p <= 2^kSlack, which leaves
// out = acc / l and lse = m + log2 l exact and saves the rescale.  Keys past
// seq_len in a ragged tile drop out (p = 0); key0 is the key of s[0][0].
constexpr float kSlack = 8.f;

template <bool UP, bool RAGGED, int NK, int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[NK][4], float (&acc)[ND][4],
                                             float (&m)[2], float (&l)[2], float sl2, int key0,
                                             int seq_len) {
  const float masked = UP ? -INFINITY : INFINITY;
  float ext[2] = {masked, masked};
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool out = RAGGED && key0 + 8 * n + (i & 1) >= seq_len;
      const float x = out ? masked : s[n][i];
      ext[i >> 1] = UP ? fmaxf(ext[i >> 1], x) : fminf(ext[i >> 1], x);
    }
  float top[2];
  bool grow = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float e = ext[r];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, e, off);
      e = UP ? fmaxf(e, o) : fminf(e, o);
    }
    top[r] = e * sl2;  // finite: every tile holds a real key
    grow |= top[r] > m[r] + kSlack;
  }
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], top[r]);
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = ex2(fmaf(s[n][i], sl2, -m[i >> 1]));
      if (RAGGED && key0 + 8 * n + (i & 1) >= seq_len) p = 0.f;
      l[i >> 1] += p;
      s[n][i] = p;
    }
}

// What ops/attention.py::fwd_route chose; the entry points check it.
struct Route {
  int padded_d, load, block_q, block_k;
};

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

// Whether every view of elements T can take 16-byte copies: element stride 1,
// a 16-byte aligned base, and 16-byte row, head and batch strides (those of a
// size-1 dim never move the pointer).  The route's rule, checked again here
// because a misaligned cp.async faults.  A: the forward's Args or the f32
// backward's BwdArgs (batch and num_heads).
template <typename T, typename A>
bool aligned16(const void* p, const Strides& s, const A& a) {
  constexpr long long vec = 16 / sizeof(T);  // elements in 16 bytes
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.e == 1 && s.t % vec == 0 &&
         (a.batch == 1 || s.b % vec == 0) && (a.num_heads <= 1 || s.h % vec == 0);
}

// Whether q, k and v (elements T) are the views of one qkv projection's
// interleaved (c, qkv) rows, which the span mode reads 16 bytes at a time:
// element stride 3, k one element past q and v one past k, the same strides,
// and each row's start (q) and its strides 16-byte aligned.  The route's
// rule, checked again here.  A: the forward's Args or the bf16 backward's
// BwdArgs (q, k, v as void pointers, their strides, batch and num_heads).
template <typename T, typename A>
bool qkv_span(const A& a) {
  constexpr long long vec = 16 / sizeof(T);
  const char *q = static_cast<const char*>(a.q), *k = static_cast<const char*>(a.k),
             *v = static_cast<const char*>(a.v);
  const Strides &sq = a.sq, &sk = a.sk, &sv = a.sv;
  auto same = [](const Strides& x, const Strides& y) {
    return x.b == y.b && x.t == y.t && x.h == y.h && x.e == y.e;
  };
  return sq.e == 3 && same(sq, sk) && same(sq, sv) && k == q + sizeof(T) &&
         v == k + sizeof(T) && reinterpret_cast<uintptr_t>(q) % 16 == 0 && sq.t % vec == 0 &&
         (a.batch == 1 || sq.b % vec == 0) && (a.num_heads <= 1 || sq.h % vec == 0);
}

// The padded head dims whose rows split into whole groups of 32 units of 8
// bf16 columns: the span mode's (SpanTile in flash_attn_fwd.cu, Span in
// flash_attn_bwd.cu).
__host__ __device__ constexpr bool span_dim(int dp) {
  return dp == 32 || dp == 64 || dp == 128 || dp == 256;
}

// One unit of the span mode: 8 columns of one interleaved (c, qkv) row of
// bf16, 48 bytes read as a, b, c (16-bit positions: q at 3 j, k at 3 j + 1,
// v at 3 j + 2, j < 8), split by byte permutes into the unit's 8 columns of
// k and v, or of q.
__device__ __forceinline__ void split_unit_kv(const uint4& a, const uint4& b, const uint4& c,
                                              uint4& k, uint4& v) {
  k = make_uint4(__byte_perm(a.x, a.z, 0x5432), __byte_perm(a.w, b.y, 0x5432),
                 __byte_perm(b.z, c.x, 0x5432), __byte_perm(c.y, c.w, 0x5432));
  v = make_uint4(__byte_perm(a.y, a.z, 0x7610), __byte_perm(b.x, b.y, 0x7610),
                 __byte_perm(b.w, c.x, 0x7610), __byte_perm(c.z, c.w, 0x7610));
}
__device__ __forceinline__ uint4 split_unit_q(const uint4& a, const uint4& b, const uint4& c) {
  return make_uint4(__byte_perm(a.x, a.y, 0x7610), __byte_perm(a.w, b.x, 0x7610),
                    __byte_perm(b.z, b.w, 0x7610), __byte_perm(c.y, c.z, 0x7610));
}

}  // namespace

// Tensor-core building blocks for sm_90a shared by the kernels that use
// them (conv3x3.cu: K4; flash_attn_fwd.cu / flash_attn_bwd.cu: K1 / K2 in
// bf16; flash_attn_fwd_tf32.cu / flash_attn_bwd_tf32.cu: K1 / K2 in f32):
// cp.async copies (16 and 4 bytes), ldmatrix fragment loads, the mma.sync
// m16n8k16 bf16 product and the m16n8k8 TF32 product, both with f32
// accumulators.
//
// Fragment layouts of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols);
//   B 16x8:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// ldmatrix.x4 loads four 8x8 bf16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; register i of a lane holds matrix i's (row g, cols
// 2t, 2t+1), or with .trans its (rows 2t, 2t+1, col g).
//
// mma.m16n8k8.row.col with TF32 operands (32-bit registers whose low 13
// mantissa bits the tensor cores ignore):
//   A 16x8:  a0 (row g, col t), a1 (row g+8, col t), a2 (row g, col t+4),
//            a3 (row g+8, col t+4);
//   B 8x8:   b0 (row t, col g), b1 (row t+4, col g);
//   C 16x8:  as for m16n8k16.
// ldmatrix.x4 on rows of f32 (pairs of b16) gives register i of a lane word
// t of row g of matrix i, an 8x4-float block: the A fragment of a row-major
// tile and the B fragment of a tile stored with n as its row.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, or 4 zero bytes where !valid (nothing is read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 values rounded to nearest even, as one bf16x2 register (lo in
// the low half)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b on TF32 operands
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest (cvt.rna); a b is summed as lo(a) hi(b) + hi(a) lo(b) + hi(a)
// hi(b), the small products first, lo lo (2^-22 of a b) dropped: about 21
// bits of each product, against f32's 24.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c += a b in 3xTF32: the small products first, then hi hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

}  // namespace

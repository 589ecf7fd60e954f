// Tensor-core building blocks shared by the port's kernels for Hopper
// (sm_90a): 16-byte cp.async staging, ldmatrix fragment loads, the
// mma.sync.m16n8k16 bf16 -> fp32 product and the split 3×TF32 fp32 product
// on mma.sync.m16n8k8 tf32. Included by flash_fwd.cu,
// flash_bwd.cu, decode_attention/csrc/decode.cu and
// similarity_topk/csrc/topk.cu; kernels/build.py hashes it with each.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; zero-fills when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a (16×16 bf16, row) · b (16×8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x split into two tf32 values (10 explicit mantissa bits), each rounded
// to nearest with ties away (cvt.rna): hi = rna(x), lo = rna(x − hi), so
// hi + lo = x to about 2^-22 of |x|. The bits are what the tf32 mma
// reads; fed raw fp32, it would drop x's low 13 bits instead.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a (16×8 tf32, row) · b (8×8 tf32, col), fp32 accumulators.
__device__ __forceinline__ void mma1688(float c[4], const unsigned a[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in split 3×TF32 (a = ah + al, b = bh + bl, each split by
// split_tf32): ah·bl + al·bh + ah·bh summed in fp32, the two small
// products first, as CUTLASS's OpMultiplyAddFastF32 orders them; al·bl
// (~2^-22 of the product) is left out. About 2^-21 of each product's size
// against 2^-24 for an fp32 FMA.
__device__ __forceinline__ void mma_3xtf32(float c[4], const unsigned ah[4],
                                           const unsigned al[4], unsigned bh0,
                                           unsigned bh1, unsigned bl0,
                                           unsigned bl1) {
  mma1688(c, ah, bl0, bl1);
  mma1688(c, al, bh0, bh1);
  mma1688(c, ah, bh0, bh1);
}

// 16-byte cp.async of rows [r0, r0 + rows) of an (n, D) fp32 slab into
// shared rows of stride D + 4 floats (a 32-bit fragment load of 8 rows by
// 4 columns, or of 4 row pairs by 8 columns, then touches 32 banks), the
// block's threads in turn; rows >= n are zero-filled (their source is not
// read).
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int r0, int rows, int n) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int row = e / CH, ch = e % CH;
    const int g = r0 + row;
    const bool ok = g < n;
    cp_async16(dst + row * (D + 4) + ch * 4,
               src + (size_t)(ok ? g : 0) * D + ch * 4, ok);
  }
}

}  // namespace

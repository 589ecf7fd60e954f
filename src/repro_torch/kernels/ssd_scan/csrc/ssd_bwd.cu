// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a); plain C
// interface.
//
// Replaces no TPU kernel: the reference's Pallas scan (ssd_scan_bh,
// repro/kernels/ssd_scan/kernel.py:69) lies on no training path, and its
// model differentiates the jnp ssd_chunked (repro/models/ssm.py:71) through
// XLA. The port's mixer runs the hand-written forward (ssd.cu), so its
// gradient needs a kernel of its own. It computes what ref.ssd_chunked_bwd
// computes, in the same chunked order, in sub-chunks of kQ = 64 tokens. With
// a_t = exp(dt_t·A), u_t = dt_t·x_t, cs the running sum of dt·A inside a
// sub-chunk, L[i][j] = exp(cs_i − cs_j) for j <= i, S0 the state entering
// the sub-chunk (saved by the forward) and R the gradient of the loss by the
// state leaving it:
//   W = L ⊙ C·Bᵀ,  V = L ⊙ dy·uᵀ (per head; dy·uᵀ sums over p)
//   du = Wᵀ·dy + exp(cs_last − cs)·(B·Rᵀ),  dx = dt·du + D·dy
//   dB = Vᵀ·C + exp(cs_last − cs)·(u·R),  dC = V·B + exp(cs)·(dy·S0)
//   dcs = rows − columns of V ⊙ C·Bᵀ + exp(cs)·⟨dy, S0·C⟩
//         − exp(cs_last − cs)·⟨u, R·B⟩ (+ ⟨R, state leaving⟩ at the end)
//   dlog a_t = Σ_{i >= t} dcs_i,  ddt = ⟨du, x⟩ + A·dlog a,  dA = Σ dt·dlog a
//   R ← exp(cs_last)·R + Σ_j exp(cs_j)·dy_j ⊗ C_j  (from dfinal, backwards)
// and d(init) is the R that leaves the first sub-chunk backwards. dB and dC
// sum over the heads; B and C are one group that every head shares.
//
// What bounds it on this card: operations. Per token and head it does ~10
// products of 64 × (n or p) work, against a few hundred bytes in and out;
// every product but bf16 C·Bᵀ has an fp32 operand (dy, R, S0, the masked
// planes), so at fp32 accuracy the tensor cores' rate is split 3×TF32's.
//
// What the design does about it. Four launches, in order on the stream:
//  1. ssd_bwd_local_kernel, one CTA of 8 warps per (sub-chunk, batch·head,
//     p-slab): Σ_j exp(cs_j)·dy_j ⊗ C_j (p × n, depth 64) on the tensor
//     cores (split 3×TF32, C exact where bf16), and the sub-chunk's
//     log-decay cs_last.
//  2. ssd_bwd_carry_kernel, one thread per 4 (p, n) entries of a (batch,
//     head): the R entering each sub-chunk from its end, in place, and
//     d(init). The sequence's one dependent chain; elementwise, 8
//     sub-chunks' loads in flight a thread.
//  3. ssd_bwd_main_kernel, one CTA of 16 warps per (sub-chunk, batch, group
//     of G heads), every sub-chunk at once from S0 and R. G (ops.ssd_bwd_plan)
//     is the largest divisor of h up to 8 that leaves a CTA for every SM.
//     - C·Bᵀ once per CTA (bf16 m16n8k16 from ldmatrix for bf16 inputs,
//       products exact in fp32; split 3×TF32 for f32); each head applies
//       its own decay L to it, evaluated only where j <= i, so the decay
//       extremes stay finite.
//     - The heads' V are summed in registers first, in head order, and
//       (Σ_h V)ᵀ·C and (Σ_h V)·B run once per CTA: B and C do not depend on
//       the head, so Σ_h V_hᵀ·C = (Σ_h V_h)ᵀ·C.
//     - The state terms of dB and dC, Σ_h (exp(cs_last − cs)·u_h)·R_h and
//       Σ_h (exp(cs)·dy_h)·S0_h, are one product of depth G·p each, kept in
//       registers across the heads (the dC term a head at a time, so that
//       ⟨C, its product⟩ gives that head's exp(cs)·⟨dy, S0·C⟩).
//     - Every product runs on mma.sync m16n8k8 tf32 (tc.cuh) split 3×TF32
//       in both dtypes (about 2^-21 of each product; plain one-pass TF32
//       would keep 2^-11); a bf16 operand is exact in tf32, so there its lo
//       half is dropped (two mma of three). The k index of a step of 8 is
//       relabelled (A's column t stands for k 2t, t + 4 for 2t + 1), so an
//       operand stored along k loads as float2 pairs.
//     - The heads (and, where p is wider than the slab, their p-slabs) are
//       a loop of items inside the CTA. dy and dt of the next item arrive
//       by cp.async while this one computes; R and x of the next item land
//       while this one's S0 products run, and its S0 while this one's
//       reductions finish. A head's ddt is written directly.
//     mma.sync over wgmma: every product here is 64 rows by p or n, with
//     operands that are scaled (decay, dt) and split per use; mma.sync
//     reads them from registers after that, and its 16-row tiles let
//     16 warps share the causal products without a warpgroup's fixed
//     64-row shape.
//     Shared memory (ops.bwd_smem_bytes, the one source of its size, which
//     the C entry refuses to differ): B, C [64][nmax + 8] in the input
//     dtype; C·Bᵀ, later Σ V [64][68]; dy (two buffers) and x [64][pb + 8];
//     R and S0 [pb][nmax + 4]; bf16 x staging [64][pb]; 3264 floats of
//     vectors and fixed-order partial sums; nmax is 128 up to n 128, else
//     256. Row strides keep the fragment loads free of bank conflicts or
//     at two ways. At the training shape (p 64, n 128) that is 222,976
//     bytes in f32 and 196,352 in bf16: one CTA of 16 warps per SM (the
//     aim of 12 warps or more is met; two CTAs would need half the bytes),
//     128 registers a thread (launch bounds) and no spills at nmax 128;
//     at nmax 256 ptxas spills 36–48 bytes a thread.
//     Where the time goes (scripts/ssd_bwd_anatomy.py, H100 80GB HBM3 at
//     700 W): at the training shape each of the four larger products of
//     an item costs 0.08–0.11 ms of the main kernel's ~0.59 (f32), dy·uᵀ
//     on its causal blocks 0.03, the rest is staging, barriers and
//     epilogues; the kernel runs at about a quarter of the card's
//     mma.sync tf32 rate, its issue slots taken by the per-use scaling
//     and splitting of the operands.
//  4. ssd_bwd_sum_kernel (one launch): the dB and dC partials of the head
//     groups, and the dA and dD partials of every (batch, sub-chunk),
//     each summed in a fixed order, dB and dC into the input dtype.
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits. Rows past the sequence's end are staged as zeros with dt = 0;
// n is padded with zeros to nmax.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "../../flash_attention/csrc/tc.cuh"

namespace {

constexpr int kQ = 64;              // tokens per sub-chunk (ssd.cu's kQ)
constexpr int kThreads = 512;       // main kernel: 16 warps
constexpr int kLocalThreads = 256;  // local kernel: 8 warps
constexpr int kSumThreads = 256;
constexpr int kLdQ = kQ + 4;        // row stride of the (kQ × kQ) plane
constexpr int kMaxN = 256;
constexpr int kMaxGroup = 8;
constexpr int kMaxSmem = 232448;    // an H100 CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

// The main kernel's vectors, offsets in floats: dt of the two item
// buffers; the current item's dt, cs, exp(cs), exp(cs_last − cs) and that
// times dt; per-warp partials of the row sums of V ⊙ C·Bᵀ (by column
// block), of its column sums (by row block), of ⟨x, B·Rᵀ⟩, ⟨du, x⟩ and
// ⟨dy, x⟩ (by 8-column tile of the du product) and of ⟨C, dy·S0⟩ (by
// column group of the dC product); a head's running dcs, ⟨du, x⟩ and
// ⟨dy, x⟩ over its p-slabs; the ⟨R, leaving state⟩ parts of 6 warps and
// the head's sum of them.
constexpr int kVDts = 0, kVDtv = 128, kVCs = 192, kVEcs = 256, kVDec = 320,
              kVUdec = 384, kVRowS = 448, kVColS = 704, kVTdot = 960,
              kVRddt = 1472, kVRdd = 1984, kVZdot = 2496, kVDcsA = 3008,
              kVDdtA = 3072, kVDdA = 3136, kVLpart = 3200, kVMisc = 3232,
              kVFloats = 3264;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Two consecutive elements as fp32 (8- or 4-byte aligned).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 4-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// `rows` rows of a slab whose row r starts at src + r·stride into shared
// rows of stride ld, 16-byte chunks up to `cols` columns; rows >= rlim and
// chunks at or past `valid` columns are zero-filled (their source is not
// read).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long stride, int rows, int rlim,
                                      int valid, int cols) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int cpr = cols / CH;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e % cpr) * CH;
    const bool ok = r < rlim && c < valid;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

// cs = inclusive running sum of dt·a over the sub-chunk (one warp, two
// tokens a lane), as ssd.cu's running_sum
__device__ __forceinline__ void running_sum(const float* dts, float* cs,
                                            float a, int lane) {
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += o;
  }
  float before = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) before = 0.f;
  cs[2 * lane] = before + v0;
  cs[2 * lane + 1] = s;
}

// acc[m][j] += A·B for MT 16-row tiles m and NT 8-column tiles j, k over
// [k0, k1) in steps of 8, on mma.sync m16n8k8 tf32. fa(m, r, k) gives A's
// row r of tile m at columns k and k + 1, fb(j, c, k) B's rows k and k + 1
// at column c of tile j, each as a float2; within a step the k index is
// relabelled (A's column t stands for k 2t, t + 4 for 2t + 1; B's rows
// likewise). An operand flagged exact (AX, BX: bf16 values, exact in tf32)
// is not split; the others are split 3×TF32, the small products first
// (ah·bl, al·bh, then ah·bh, as tc.cuh's mma_3xtf32).
template <int MT, int NT, bool AX, bool BX, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (*acc)[NT][4], int k0,
                                          int k1, const FA& fa,
                                          const FB& fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kb = k0; kb < k1; kb += 8) {
    const int k = kb + 2 * t;
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float2 r0 = fa(m, g, k), r1 = fa(m, g + 8, k);
      const float v[4] = {r0.x, r1.x, r0.y, r1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (AX) {
          ah[m][e] = __float_as_uint(v[e]);
          al[m][e] = 0u;
        } else {
          split_tf32(v[e], ah[m][e], al[m][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bv = fb(j, g, k);
      unsigned bh0, bl0, bh1, bl1;
      if constexpr (BX) {
        bh0 = __float_as_uint(bv.x);
        bh1 = __float_as_uint(bv.y);
        bl0 = bl1 = 0u;
      } else {
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (!BX) mma1688(acc[m][j], ah[m], bl0, bl1);
        if constexpr (!AX) mma1688(acc[m][j], al[m], bh0, bh1);
        mma1688(acc[m][j], ah[m], bh0, bh1);
      }
    }
  }
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* states;       // (b, h, nsub, P, N)
  const float* final_state;  // (b, h, P, N)
  const float* dy;           // (b, l, h, P)
  const float* dfinal;       // (b, h, P, N) or null
  void* dx;                  // (b, l, h, P), input dtype
  float* ddt;                // (b, l, h)
  float* r;                  // (b, h, nsub, P, N): the R entering each
  float* glog;               // (b, h, nsub): each sub-chunk's cs_last
  float* dinit;              // (b, h, P, N) or null
  float* dbp;                // (h / G, b, l, N) partials
  float* dcp;                // (h / G, b, l, N)
  float* dap;                // (b, nsub, h)
  float* ddp;                // (b, nsub, h)
  int B, L, H, P, N, NP, G, nsub;
  long long xs_b, xs_t, xs_h, dts_b, dts_t, bs_b, bs_t, cs_b, cs_t;
};

// The main kernel's shared memory, bytes (ops.bwd_smem_bytes).
template <typename T, int NMAX, int PB>
struct MainLayout {
  static constexpr int LN = NMAX + 8;  // B, C row stride (elements of T)
  static constexpr int LP = PB + 8;    // dy, x row stride (floats)
  static constexpr int LS = NMAX + 4;  // R, S0 row stride (floats)
  static constexpr size_t bc = (size_t)kQ * LN * sizeof(T);
  static constexpr size_t off_c = bc;
  static constexpr size_t off_w = 2 * bc;
  static constexpr size_t off_dy = off_w + (size_t)kQ * kLdQ * 4;
  static constexpr size_t off_x = off_dy + 2 * (size_t)kQ * LP * 4;
  static constexpr size_t off_st = off_x + (size_t)kQ * LP * 4;
  static constexpr size_t off_xst = off_st + 2 * (size_t)PB * LS * 4;
  static constexpr size_t xst = sizeof(T) == 2 ? (size_t)kQ * PB * 2 : 0;
  static constexpr size_t off_vec = off_xst + xst;
  static constexpr size_t bytes = off_vec + (size_t)kVFloats * 4;
};

// The local kernel's: C [kQ][nmax + 4 (f32) or + 8 (bf16)] in the input
// dtype, exp(cs)·dy [kQ][pb + 4], dt and cs.
template <typename T, int NMAX, int PB>
struct LocalLayout {
  static constexpr int LN = NMAX + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int LP = PB + 4;
  static constexpr size_t off_dy = (size_t)kQ * LN * sizeof(T);
  static constexpr size_t bytes = off_dy + ((size_t)kQ * LP + 2 * kQ) * 4;
};

// 1. The gradient each sub-chunk's outputs give the state entering it,
// Σ_j exp(cs_j)·dy_j ⊗ C_j (PB × N), into r; and cs_last into glog.
// Grid (nsub, b·h, P / PB); each warp holds all PB rows and NMAX / 8
// columns.
template <typename T, int NMAX, int PB>
__global__ void __launch_bounds__(kLocalThreads) ssd_bwd_local_kernel(
    const Params pr) {
  using Ly = LocalLayout<T, NMAX, PB>;
  constexpr int LN = Ly::LN, LP = Ly::LP;
  constexpr int MT = PB / 16, NT = NMAX / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Cs = reinterpret_cast<T*>(smem);
  float* dys = reinterpret_cast<float*>(smem + Ly::off_dy);
  float* dts = dys + kQ * LP;
  float* cs = dts + kQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k = blockIdx.x, bh = blockIdx.y, p0 = blockIdx.z * PB;
  const int bi = bh / pr.H, hi = bh % pr.H;
  const int t0 = k * kQ, rlim = min(kQ, pr.L - t0);
  const int N = pr.N;
  stage<T>(Cs, LN,
           static_cast<const T*>(pr.Cm) + bi * pr.cs_b + (long long)t0 * pr.cs_t,
           pr.cs_t, kQ, rlim, N, NMAX);
  stage<float>(dys, LP,
               pr.dy + (((size_t)bi * pr.L + t0) * pr.H + hi) * pr.P + p0,
               (long long)pr.H * pr.P, kQ, rlim, PB, PB);
  if (tid < kQ)
    cp_async4(dts + tid,
              pr.dt + bi * pr.dts_b +
                  (long long)(t0 + (tid < rlim ? tid : 0)) * pr.dts_t + hi,
              tid < rlim);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) running_sum(dts, cs, pr.A[hi], lane);
  __syncthreads();
  if (blockIdx.z == 0 && tid == 0)
    pr.glog[(size_t)bh * pr.nsub + k] = cs[kQ - 1];
  for (int e = tid; e < kQ * PB; e += kLocalThreads) {
    const int r = e / PB, c = e % PB;
    dys[r * LP + c] *= expf(cs[r]);
  }
  __syncthreads();
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  const int nc = 8 * NT * warp;
  mma_tiles<MT, NT, false, sizeof(T) == 2>(
      acc, 0, kQ,
      [&](int m, int r, int kk) {
        const int pp = 16 * m + r;
        return make_float2(dys[kk * LP + pp], dys[(kk + 1) * LP + pp]);
      },
      [&](int j, int c, int kk) {
        const int col = nc + 8 * j + c;
        return make_float2(to_f32(Cs[kk * LN + col]),
                           to_f32(Cs[(kk + 1) * LN + col]));
      });
  float* out = pr.r + ((size_t)bh * pr.nsub + k) * pr.P * N + (size_t)p0 * N;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = nc + 8 * j + 2 * t;
      if (col < N)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st2(out + (size_t)(16 * m + g + 8 * r) * N + col, acc[m][j][2 * r],
              acc[m][j][2 * r + 1]);
    }
}

// 2. Backwards over the sub-chunks, one thread per 4 consecutive (p, n)
// entries of a (batch, head): r holds each sub-chunk's local term on entry
// and the R entering it (the gradient by the state that leaves it) on exit;
// R starts from dfinal and d(init) is what leaves the first. The loads of
// kCarry sub-chunks are issued before their stores, so that many are in
// flight: one at a time, the chain of dependent loads bound the kernel.
constexpr int kCarry = 8;

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__global__ void __launch_bounds__(256) ssd_bwd_carry_kernel(
    const Params pr) {
  const size_t pn4 = (size_t)pr.P * pr.N / 4;
  const size_t total = (size_t)pr.B * pr.H * pn4;
  const int nsub = pr.nsub;
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < total;
       e += (size_t)gridDim.x * 256) {
    const size_t bh = e / pn4;
    float4* rp = reinterpret_cast<float4*>(pr.r) + bh * nsub * pn4 + e % pn4;
    const float* gl = pr.glog + bh * nsub;
    float4 R = pr.dfinal != nullptr
                   ? reinterpret_cast<const float4*>(pr.dfinal)[e]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k1 = nsub; k1 > 0; k1 -= kCarry) {
      float4 local[kCarry];
      float dec[kCarry];
#pragma unroll
      for (int u = 0; u < kCarry; ++u) {
        const int k = k1 - 1 - u;
        if (k >= 0) {
          local[u] = rp[(size_t)k * pn4];
          dec[u] = expf(gl[k]);
        }
      }
#pragma unroll
      for (int u = 0; u < kCarry; ++u) {
        const int k = k1 - 1 - u;
        if (k >= 0) {
          rp[(size_t)k * pn4] = R;
          R = fma4(dec[u], R, local[u]);
        }
      }
    }
    if (pr.dinit != nullptr) reinterpret_cast<float4*>(pr.dinit)[e] = R;
  }
}

// 3. Everything else, one CTA per (sub-chunk, batch, group of G heads);
// grid (nsub, b · h / G). The items are the group's heads, each in P / PB
// slabs of head_dim.
template <typename T, int NMAX, int PB>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_main_kernel(
    const Params pr) {
  using Ly = MainLayout<T, NMAX, PB>;
  constexpr int LN = Ly::LN, LP = Ly::LP, LS = Ly::LS;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NTW = NMAX / 64;              // dB / dC: 8-column tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* Bs = reinterpret_cast<T*>(smem);
  T* Cs = reinterpret_cast<T*>(smem + Ly::off_c);
  float* Ws = reinterpret_cast<float*>(smem + Ly::off_w);  // C·Bᵀ, then Σ V
  float* dyb = reinterpret_cast<float*>(smem + Ly::off_dy);
  float* xs = reinterpret_cast<float*>(smem + Ly::off_x);
  float* Rs = reinterpret_cast<float*>(smem + Ly::off_st);
  float* S0s = Rs + PB * LS;
  T* xst = reinterpret_cast<T*>(smem + Ly::off_xst);
  float* vec = reinterpret_cast<float*>(smem + Ly::off_vec);
  float* dtb = vec + kVDts;
  float* dtv = vec + kVDtv;
  float* cs = vec + kVCs;
  float* ecs = vec + kVEcs;
  float* dec = vec + kVDec;
  float* udec = vec + kVUdec;
  float* rowS = vec + kVRowS;
  float* colS = vec + kVColS;
  float* tdot = vec + kVTdot;
  float* rddt = vec + kVRddt;
  float* rdd = vec + kVRdd;
  float* zdot = vec + kVZdot;
  float* dcsA = vec + kVDcsA;
  float* ddtA = vec + kVDdtA;
  float* ddA = vec + kVDdA;
  float* lpart = vec + kVLpart;
  float* misc = vec + kVMisc;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k = blockIdx.x;
  const int groups = pr.H / pr.G;
  const int grp = blockIdx.y % groups, bi = blockIdx.y / groups;
  const int h0 = grp * pr.G;
  const int t0 = k * kQ, rlim = min(kQ, pr.L - t0);
  const int N = pr.N, P = pr.P, H = pr.H;
  const int nslab = P / PB, items = pr.G * nslab;
  const size_t pn = (size_t)P * N;
  // the lower-triangular 16 × 16 block of warps 0-9 (the causal products)
  const int tmt = (warp >= 1) + (warp >= 3) + (warp >= 6);
  const int tnb = warp - tmt * (tmt + 1) / 2;
  // the du product: row tiles dm0 and 3 − dm0 (of 4), so that the causal
  // Wᵀ·dy costs every warp the same, and column tile dnt of the slab
  const int dm0 = warp & 1, dnt = warp >> 1;
  const int pc = 8 * dnt;
  // the dB / dC products: rows 32·wm.., state columns 8·NTW·wn..
  const int wm = warp & 1, wn = warp >> 1;
  const int nc = 8 * NTW * wn;

  auto load_dy = [&](int it) {   // dy and dt of item `it`, buffer it & 1
    const int head = h0 + it / nslab, p0 = (it % nslab) * PB;
    stage<float>(dyb + (it & 1) * kQ * LP, LP,
                 pr.dy + (((size_t)bi * pr.L + t0) * H + head) * P + p0,
                 (long long)H * P, kQ, rlim, PB, PB);
    if (tid < kQ)
      cp_async4(dtb + (it & 1) * kQ + tid,
                pr.dt + bi * pr.dts_b +
                    (long long)(t0 + (tid < rlim ? tid : 0)) * pr.dts_t + head,
                tid < rlim);
  };
  auto load_x = [&](int it) {
    const int head = h0 + it / nslab, p0 = (it % nslab) * PB;
    const T* src = static_cast<const T*>(pr.x) + bi * pr.xs_b +
                   (long long)t0 * pr.xs_t + head * pr.xs_h + p0;
    if constexpr (BF)
      stage<T>(xst, PB, src, pr.xs_t, kQ, rlim, PB, PB);
    else
      stage<T>(reinterpret_cast<T*>(xs), LP, src, pr.xs_t, kQ, rlim, PB, PB);
  };
  auto load_state = [&](float* dst, const float* base, int it) {
    const int head = h0 + it / nslab, p0 = (it % nslab) * PB;
    stage<float>(dst, LS,
                 base + (((size_t)bi * H + head) * pr.nsub + k) * pn +
                     (size_t)p0 * N,
                 N, PB, PB, N, NMAX);
  };

  for (int e = kVDtv + tid; e < kVFloats; e += kThreads) vec[e] = 0.f;
  stage<T>(Bs, LN,
           static_cast<const T*>(pr.Bm) + bi * pr.bs_b + (long long)t0 * pr.bs_t,
           pr.bs_t, kQ, rlim, N, NMAX);
  stage<T>(Cs, LN,
           static_cast<const T*>(pr.Cm) + bi * pr.cs_b + (long long)t0 * pr.cs_t,
           pr.cs_t, kQ, rlim, N, NMAX);
  load_dy(0);
  load_x(0);
  load_state(Rs, pr.r, 0);
  cp_async_commit();
  load_state(S0s, pr.states, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // C·Bᵀ, once for the group: the 10 lower-triangular 16 × 16 blocks
  if (warp < 10) {
    float acc[1][2][4] = {};
    if constexpr (BF) {
      const int lm = lane >> 3, lr = lane & 7;
      for (int k0 = 0; k0 < pr.NP; k0 += 16) {
        unsigned qa[4], b[4];
        ldsm_x4(qa, Cs + (16 * tmt + (lm & 1) * 8 + lr) * LN + k0 +
                        (lm >> 1) * 8);
        ldsm_x4(b, Bs + (16 * tnb + (lm >> 1) * 8 + lr) * LN + k0 +
                       (lm & 1) * 8);
        mma16816(acc[0][0], qa, b[0], b[1]);
        mma16816(acc[0][1], qa, b[2], b[3]);
      }
    } else {
      mma_tiles<1, 2, false, false>(
          acc, 0, pr.NP,
          [&](int, int r, int kk) {
            return ld2(Cs + (16 * tmt + r) * LN + kk);
          },
          [&](int j, int c, int kk) {
            return ld2(Bs + (16 * tnb + 8 * j + c) * LN + kk);
          });
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st2(Ws + (16 * tmt + g + 8 * r) * kLdQ + 16 * tnb + 8 * j + 2 * t,
            acc[0][j][2 * r], acc[0][j][2 * r + 1]);
  }

  float vsum[2][4] = {};                       // warps 0-9: Σ V, their block
  float dbacc[2][NTW][4] = {}, dcacc[2][NTW][4] = {};
  for (int it = 0; it < items; ++it) {
    const int head = h0 + it / nslab, s = it % nslab, p0 = s * PB;
    float* dys = dyb + (it & 1) * kQ * LP;
    if (it + 1 < items) load_dy(it + 1);
    cp_async_commit();
    cp_async_wait<2>();          // this item's dy, dt, x and R
    __syncthreads();
    const float a = pr.A[head];
    if constexpr (BF)
      for (int e = tid; e < kQ * PB; e += kThreads)
        xs[(e / PB) * LP + e % PB] = to_f32(xst[e]);
    if (warp == 0) {
      const float* dts = dtb + (it & 1) * kQ;
      running_sum(dts, cs, a, lane);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = lane + 32 * q;
        const float d = dts[i], e = expf(cs[kQ - 1] - cs[i]);
        dtv[i] = d;
        ecs[i] = expf(cs[i]);
        dec[i] = e;
        udec[i] = e * d;
      }
    }
    __syncthreads();

    if (warp < 10) {
      // V = L ⊙ dy·uᵀ on this warp's block, summed over the items; the row
      // and column sums of V ⊙ C·Bᵀ
      float acc[1][2][4] = {};
      mma_tiles<1, 2, false, false>(
          acc, 0, PB,
          [&](int, int r, int kk) {
            return ld2(dys + (16 * tmt + r) * LP + kk);
          },
          [&](int j, int c, int kk) {
            const int jj = 16 * tnb + 8 * j + c;
            const float2 v = ld2(xs + jj * LP + kk);
            const float d = dtv[jj];
            return make_float2(v.x * d, v.y * d);
          });
      float rsum[2] = {0.f, 0.f}, csum[2][2] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * tmt + g + 8 * (e >> 1);
          const int jj = 16 * tnb + 8 * j + 2 * t + (e & 1);
          float v = 0.f, sv = 0.f;
          if (jj <= i) {
            v = acc[0][j][e] * expf(cs[i] - cs[jj]);
            sv = v * Ws[i * kLdQ + jj];
          }
          vsum[j][e] += v;
          rsum[e >> 1] += sv;
          csum[j][e & 1] += sv;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) rsum[r] = quad_sum(rsum[r]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = csum[j][c];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          csum[j][c] = v + __shfl_xor_sync(kFull, v, 16);
        }
      if (t == 0) {
        rowS[tnb * kQ + 16 * tmt + g] = rsum[0];
        rowS[tnb * kQ + 16 * tmt + g + 8] = rsum[1];
      }
      if (g == 0)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            colS[tmt * kQ + 16 * tnb + 8 * j + 2 * t + c] = csum[j][c];
    } else {
      // ⟨R, the state leaving⟩: the next sub-chunk's entering state, or
      // the final state (R is zero there without dfinal)
      const float* nxt =
          k + 1 < pr.nsub
              ? pr.states + (((size_t)bi * H + head) * pr.nsub + k + 1) * pn +
                    (size_t)p0 * N
              : (pr.dfinal != nullptr
                     ? pr.final_state + (((size_t)bi * H + head) * P + p0) * N
                     : nullptr);
      float part = 0.f;
      if (nxt != nullptr) {
        // every load of a round issued before its products
        constexpr int kU = 8, kT = kThreads - 320;
        const int q = N / 4, total = PB * q;
        for (int e0 = tid - 320; e0 < total; e0 += kU * kT) {
          float4 rv[kU], sv[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int e = min(e0 + u * kT, total - 1);
            const int pp = e / q, c = (e % q) * 4;
            rv[u] = *reinterpret_cast<const float4*>(Rs + pp * LS + c);
            sv[u] = *reinterpret_cast<const float4*>(nxt + (size_t)pp * N + c);
          }
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (e0 + u * kT < total) {
              part = fmaf(rv[u].x, sv[u].x, part);
              part = fmaf(rv[u].y, sv[u].y, part);
              part = fmaf(rv[u].z, sv[u].z, part);
              part = fmaf(rv[u].w, sv[u].w, part);
            }
        }
      }
      part = warp_sum(part);
      if (lane == 0) lpart[warp - 10] = part;
    }

    if (dnt < PB / 8) {
      // T1 = B·Rᵀ; ⟨x, T1⟩; du = exp(cs_last − cs)·T1 + Wᵀ·dy, on the row
      // tiles dm0 and 3 − dm0 of column tile dnt
      float acc[2][1][4] = {};
      mma_tiles<2, 1, BF, false>(
          acc, 0, pr.NP,
          [&](int m, int r, int kk) {
            return ld2(Bs + (16 * (m ? 3 - dm0 : dm0) + r) * LN + kk);
          },
          [&](int, int c, int kk) {
            return ld2(Rs + (pc + c) * LS + kk);
          });
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int mt = m ? 3 - dm0 : dm0;
        float td[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mt + g + 8 * (e >> 1);
          const int col = pc + 2 * t + (e & 1);
          td[e >> 1] = fmaf(xs[i * LP + col], acc[m][0][e], td[e >> 1]);
          acc[m][0][e] *= dec[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) td[r] = quad_sum(td[r]);
        if (t == 0) {
          tdot[dnt * kQ + 16 * mt + g] = td[0];
          tdot[dnt * kQ + 16 * mt + g + 8] = td[1];
        }
        // Wᵀ·dy over the tokens j >= i: 10 steps of 8 for the pair
        mma_tiles<1, 1, false, false>(
            acc + m, 16 * mt, kQ,
            [&](int, int r, int kk) {
              const int i = 16 * mt + r;
              const float ci = cs[i];
              return make_float2(
                  kk >= i ? Ws[kk * kLdQ + i] * expf(cs[kk] - ci) : 0.f,
                  kk + 1 >= i
                      ? Ws[(kk + 1) * kLdQ + i] * expf(cs[kk + 1] - ci)
                      : 0.f);
            },
            [&](int, int c, int kk) {
              const int col = pc + c;
              return make_float2(dys[kk * LP + col],
                                 dys[(kk + 1) * LP + col]);
            });
        // dx = dt·du + D·dy; ⟨du, x⟩ and ⟨dy, x⟩ by row
        const float dd = pr.D != nullptr ? pr.D[head] : 0.f;
        T* dxp = static_cast<T*>(pr.dx) +
                 (((size_t)bi * pr.L + t0) * H + head) * P + p0;
        float rg[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * mt + g + 8 * r;
          const int col = pc + 2 * t;
          const float2 dyv = ld2(dys + i * LP + col);
          const float2 xv = ld2(xs + i * LP + col);
          const float u0 = acc[m][0][2 * r], u1 = acc[m][0][2 * r + 1];
          rg[r] = fmaf(u1, xv.y, u0 * xv.x);
          rd[r] = fmaf(dyv.y, xv.y, dyv.x * xv.x);
          if (i < rlim)
            st2(dxp + (size_t)i * H * P + col, fmaf(dtv[i], u0, dd * dyv.x),
                fmaf(dtv[i], u1, dd * dyv.y));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rg[r] = quad_sum(rg[r]);
          rd[r] = quad_sum(rd[r]);
        }
        if (t == 0)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rddt[dnt * kQ + 16 * mt + g + 8 * r] = rg[r];
            rdd[dnt * kQ + 16 * mt + g + 8 * r] = rd[r];
          }
      }
    }

    // dB's state term += (exp(cs_last − cs)·u)·R
    mma_tiles<2, NTW, false, false>(
        dbacc, 0, PB,
        [&](int m, int r, int kk) {
          const int i = 32 * wm + 16 * m + r;
          const float2 v = ld2(xs + i * LP + kk);
          const float d = udec[i];
          return make_float2(v.x * d, v.y * d);
        },
        [&](int j, int c, int kk) {
          const int col = nc + 8 * j + c;
          return make_float2(Rs[kk * LS + col], Rs[(kk + 1) * LS + col]);
        });
    __syncthreads();
    if (it + 1 < items) {
      load_state(Rs, pr.r, it + 1);
      load_x(it + 1);
    }
    cp_async_commit();
    cp_async_wait<2>();          // this item's S0
    __syncthreads();

    // dC's state term += (exp(cs)·dy)·S0, the head's product apart first:
    // ⟨C, its rows⟩ = exp(cs)·⟨dy, S0·C⟩
    {
      float z[2][NTW][4] = {};
      mma_tiles<2, NTW, false, false>(
          z, 0, PB,
          [&](int m, int r, int kk) {
            const int i = 32 * wm + 16 * m + r;
            const float2 v = ld2(dys + i * LP + kk);
            const float e = ecs[i];
            return make_float2(v.x * e, v.y * e);
          },
          [&](int j, int c, int kk) {
            const int col = nc + 8 * j + c;
            return make_float2(S0s[kk * LS + col], S0s[(kk + 1) * LS + col]);
          });
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float zd[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 32 * wm + 16 * m + g + 8 * (e >> 1);
            const int col = nc + 8 * j + 2 * t + (e & 1);
            zd[e >> 1] =
                fmaf(to_f32(Cs[i * LN + col]), z[m][j][e], zd[e >> 1]);
            dcacc[m][j][e] += z[m][j][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) zd[r] = quad_sum(zd[r]);
        if (t == 0) {
          zdot[wn * kQ + 32 * wm + 16 * m + g] = zd[0];
          zdot[wn * kQ + 32 * wm + 16 * m + g + 8] = zd[1];
        }
      }
    }
    __syncthreads();
    if (it + 1 < items) load_state(S0s, pr.states, it + 1);
    cp_async_commit();

    if (warp == 0) {
      // fold the item's partials into its head's, in a fixed order
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = lane + 32 * q;
        float sv = 0.f, td = 0.f, gs = 0.f, ds = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sv += rowS[c * kQ + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv -= colS[c * kQ + i];
#pragma unroll
        for (int c = 0; c < 8; ++c) sv += zdot[c * kQ + i];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          td += tdot[c * kQ + i];
          gs += rddt[c * kQ + i];
          ds += rdd[c * kQ + i];
        }
        dcsA[i] += fmaf(-udec[i], td, sv);
        ddtA[i] += gs;
        ddA[i] += ds;
      }
      if (lane == 0) {
        float lv = 0.f;
        for (int w = 0; w < 6; ++w) lv += lpart[w];
        misc[0] += lv;
      }
      if (s == nslab - 1) {
        // the head's last slab: dlog a (running sum from the end), ddt,
        // and the head's parts of dA and dD
        __syncwarp();
        const int i0 = 2 * lane, i1 = 2 * lane + 1;
        const float c0 = dcsA[i0];
        const float c1 = dcsA[i1] + (lane == 31 ? misc[0] : 0.f);
        float sfx = c0 + c1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_down_sync(kFull, sfx, off);
          if (lane + off < 32) sfx += o;
        }
        float after = __shfl_down_sync(kFull, sfx, 1);
        if (lane == 31) after = 0.f;
        const float dl1 = c1 + after, dl0 = c0 + dl1;
        float* ddtp = pr.ddt + ((size_t)bi * pr.L + t0) * H + head;
        if (i0 < rlim) ddtp[(size_t)i0 * H] = fmaf(a, dl0, ddtA[i0]);
        if (i1 < rlim) ddtp[(size_t)i1 * H] = fmaf(a, dl1, ddtA[i1]);
        const float da = warp_sum(fmaf(dtv[i0], dl0, dtv[i1] * dl1));
        const float dds = warp_sum(ddA[i0] + ddA[i1]);
        dcsA[i0] = dcsA[i1] = 0.f;
        ddtA[i0] = ddtA[i1] = 0.f;
        ddA[i0] = ddA[i1] = 0.f;
        if (lane == 0) {
          const size_t at = ((size_t)bi * pr.nsub + k) * H + head;
          pr.dap[at] = da;
          pr.ddp[at] = dds;
          misc[0] = 0.f;
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  // Σ V into the (kQ × kQ) plane; then (Σ V)ᵀ·C and (Σ V)·B
  if (warp < 10)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st2(Ws + (16 * tmt + g + 8 * r) * kLdQ + 16 * tnb + 8 * j + 2 * t,
            vsum[j][2 * r], vsum[j][2 * r + 1]);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = 2 * wm + m;
    mma_tiles<1, NTW, false, BF>(
        dbacc + m, 16 * mt, kQ,
        [&](int, int r, int kk) {
          const int i = 16 * mt + r;
          return make_float2(Ws[kk * kLdQ + i], Ws[(kk + 1) * kLdQ + i]);
        },
        [&](int j, int c, int kk) {
          const int col = nc + 8 * j + c;
          return make_float2(to_f32(Cs[kk * LN + col]),
                             to_f32(Cs[(kk + 1) * LN + col]));
        });
    mma_tiles<1, NTW, false, BF>(
        dcacc + m, 0, 16 * mt + 16,
        [&](int, int r, int kk) {
          return ld2(Ws + (16 * mt + r) * kLdQ + kk);
        },
        [&](int j, int c, int kk) {
          const int col = nc + 8 * j + c;
          return make_float2(to_f32(Bs[kk * LN + col]),
                             to_f32(Bs[(kk + 1) * LN + col]));
        });
  }
  float* dbp = pr.dbp + (((size_t)grp * pr.B + bi) * pr.L + t0) * N;
  float* dcp = pr.dcp + (((size_t)grp * pr.B + bi) * pr.L + t0) * N;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 32 * wm + 16 * m + g + 8 * r;
        const int col = nc + 8 * j + 2 * t;
        if (i < rlim && col < N) {
          st2(dbp + (size_t)i * N + col, dbacc[m][j][2 * r],
              dbacc[m][j][2 * r + 1]);
          st2(dcp + (size_t)i * N + col, dcacc[m][j][2 * r],
              dcacc[m][j][2 * r + 1]);
        }
      }
}

// 4. dB, dC: Σ over the head groups of their partials, into the input
// dtype; dA, dD: Σ over every (batch, sub-chunk); each in increasing part.
template <typename T>
__global__ void __launch_bounds__(kSumThreads) ssd_bwd_sum_kernel(
    const Params pr, T* dB, T* dC, float* dA, float* dD) {
  const size_t bln = (size_t)pr.B * pr.L * pr.N;
  const int groups = pr.H / pr.G, parts = pr.B * pr.nsub;
  const size_t total = 2 * bln + 2 * (size_t)pr.H;
  for (size_t e = (size_t)blockIdx.x * kSumThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kSumThreads) {
    if (e < 2 * bln) {
      const bool c = e >= bln;
      const size_t o = c ? e - bln : e;
      const float* part = c ? pr.dcp : pr.dbp;
      float s = 0.f;
      for (int r = 0; r < groups; ++r) s += part[(size_t)r * bln + o];
      (c ? dC : dB)[o] = from_f32<T>(s);
    } else {
      const int o = (int)(e - 2 * bln);
      const bool d = o >= pr.H;
      const int hh = d ? o - pr.H : o;
      if (d && dD == nullptr) continue;
      const float* part = d ? pr.ddp : pr.dap;
      float s = 0.f;
      for (int r = 0; r < parts; ++r) s += part[(size_t)r * pr.H + hh];
      (d ? dD : dA)[hh] = s;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

unsigned blocks_for(size_t count, int threads, size_t most) {
  const size_t b = (count + threads - 1) / threads;
  return (unsigned)(b < most ? b : most);
}

template <typename T, int NMAX, int PB>
cudaError_t run(const Params& pr, void* dB, void* dC, float* dA, float* dD,
                cudaStream_t st) {
  constexpr size_t local_bytes = LocalLayout<T, NMAX, PB>::bytes;
  constexpr size_t main_bytes = MainLayout<T, NMAX, PB>::bytes;
  auto local = ssd_bwd_local_kernel<T, NMAX, PB>;
  auto body = ssd_bwd_main_kernel<T, NMAX, PB>;
  cudaError_t err = allow_smem(local, local_bytes);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(body, main_bytes)) != cudaSuccess) return err;
  local<<<dim3((unsigned)pr.nsub, (unsigned)(pr.B * pr.H),
               (unsigned)(pr.P / PB)),
          kLocalThreads, local_bytes, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t quads = (size_t)pr.B * pr.H * pr.P * pr.N / 4;
  ssd_bwd_carry_kernel<<<blocks_for(quads, 256, 8192), 256, 0, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  body<<<dim3((unsigned)pr.nsub, (unsigned)(pr.B * (pr.H / pr.G))),
         kThreads, main_bytes, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t sums = 2 * (size_t)pr.B * pr.L * pr.N + 2 * (size_t)pr.H;
  ssd_bwd_sum_kernel<T><<<blocks_for(sums, kSumThreads, 4096), kSumThreads,
                          0, st>>>(pr, static_cast<T*>(dB),
                                   static_cast<T*>(dC), dA, dD);
  return cudaGetLastError();
}

// The layouts a CTA's shared memory holds; others are never instantiated.
template <typename T, int NMAX, int PB>
constexpr bool fits() {
  return MainLayout<T, NMAX, PB>::bytes <= (size_t)kMaxSmem;
}

template <typename T, int NMAX, int PB>
size_t main_bytes_of() {
  if constexpr (fits<T, NMAX, PB>()) return MainLayout<T, NMAX, PB>::bytes;
  return 0;
}

template <typename T, int NMAX, int PB>
cudaError_t run_fit(const Params& pr, void* dB, void* dC, float* dA,
                    float* dD, cudaStream_t st) {
  if constexpr (fits<T, NMAX, PB>())
    return run<T, NMAX, PB>(pr, dB, dC, dA, dD, st);
  return cudaErrorInvalidValue;
}

// The main kernel's shared bytes at (dtype, nmax, p_block); 0 where the
// layout does not fit.
template <typename T>
size_t layout_bytes(int nmax, int pb) {
  if (nmax == 128)
    return pb == 64 ? main_bytes_of<T, 128, 64>()
                    : pb == 32 ? main_bytes_of<T, 128, 32>()
                               : main_bytes_of<T, 128, 16>();
  return pb == 64 ? main_bytes_of<T, 256, 64>()
                  : pb == 32 ? main_bytes_of<T, 256, 32>()
                             : main_bytes_of<T, 256, 16>();
}

template <typename T>
cudaError_t dispatch(const Params& pr, int nmax, int pb, void* dB, void* dC,
                     float* dA, float* dD, cudaStream_t st) {
  if (nmax == 128) {
    if (pb == 64) return run_fit<T, 128, 64>(pr, dB, dC, dA, dD, st);
    if (pb == 32) return run_fit<T, 128, 32>(pr, dB, dC, dA, dD, st);
    return run_fit<T, 128, 16>(pr, dB, dC, dA, dD, st);
  }
  if (pb == 64) return run_fit<T, 256, 64>(pr, dB, dC, dA, dD, st);
  if (pb == 32) return run_fit<T, 256, 32>(pr, dB, dC, dA, dD, st);
  return run_fit<T, 256, 16>(pr, dB, dC, dA, dD, st);
}

bool aligned16(const void* p, int item, long long s0, long long s1,
               long long s2) {
  const long long v = 16 / item;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % v == 0 &&
         s1 % v == 0 && s2 % v == 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Inputs as repro_ssd_scan takes them: x (b, l, h, p) with element strides
// (xs_b, xs_t, xs_h, 1); dt (b, l, h) fp32 with strides (dts_b, dts_t, 1);
// A, D (h,) fp32 (D may be null); Bm, Cm (b, l, n) with strides (bs_b,
// bs_t, 1), (cs_b, cs_t, 1); x, Bm, Cm of `dtype` (0 = float32, 1 =
// bfloat16), 16-byte aligned with strides of whole 16-byte units. From the
// forward: states (b, h, ceil(l / 64), p, n) and final_state (b, h, p, n)
// fp32 contiguous. dy (b, l, h, p) fp32 and dfinal (b, h, p, n) fp32 (or
// null: zeros), contiguous; all four 16-byte aligned. Outputs, contiguous:
// dx (b, l, h, p), dB and dC (b, l, n) in `dtype`; ddt (b, l, h), dA (h,),
// dD (h,) (null when D is) and dinit (b, h, p, n) (or null) fp32. Scratch,
// fp32: r (b, h, nsub, p, n), glog (b, h, nsub), dbp and dcp (h / group, b,
// l, n), dap and ddp (b, nsub, h). p_block (16, 32 or 64, dividing p), the
// head group (1..8, dividing h) and the main kernel's shared bytes are
// ops.ssd_bwd_plan's; another layout is refused before anything launches.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* states,
    const void* final_state, const void* dy, const void* dfinal, void* dx,
    void* dB, void* dC, void* ddt, void* dA, void* dD, void* dinit, void* r,
    void* glog, void* dbp, void* dcp, void* dap, void* ddp, int dtype, int b,
    int l, int h, int p, int n, long long xs_b, long long xs_t,
    long long xs_h, long long dts_b, long long dts_t, long long bs_b,
    long long bs_t, long long cs_b, long long cs_t, int p_block, int group,
    long long smem, void* stream) {
  const int item = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int nmax = n <= 128 ? 128 : kMaxN;
  const bool shape_ok =
      item != 0 && b >= 1 && l >= 1 && h >= 1 && n >= 8 && n % 8 == 0 &&
      n <= kMaxN && (p_block == 16 || p_block == 32 || p_block == 64) &&
      p >= p_block && p % p_block == 0 && p / p_block <= 65535 &&
      group >= 1 && group <= kMaxGroup && h % group == 0 &&
      (long long)b * h <= 65535;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const size_t bytes = item == 4 ? layout_bytes<float>(nmax, p_block)
                                 : layout_bytes<__nv_bfloat16>(nmax, p_block);
  if (bytes == 0 || smem != (long long)bytes || states == nullptr ||
      final_state == nullptr || dy == nullptr ||
      !aligned16(x, item, xs_b, xs_t, xs_h) ||
      !aligned16(Bm, item, bs_b, bs_t, 0) ||
      !aligned16(Cm, item, cs_b, cs_t, 0) || !aligned16(states) ||
      !aligned16(final_state) || !aligned16(dy) ||
      (dfinal != nullptr && !aligned16(dfinal)) || !aligned16(r) ||
      !aligned16(dinit) ||
      !aligned16(dx) || !aligned16(dbp) || !aligned16(dcp))
    return (int)cudaErrorInvalidValue;
  Params pr;
  pr.x = x;
  pr.dt = static_cast<const float*>(dt);
  pr.A = static_cast<const float*>(A);
  pr.Bm = Bm;
  pr.Cm = Cm;
  pr.D = static_cast<const float*>(D);
  pr.states = static_cast<const float*>(states);
  pr.final_state = static_cast<const float*>(final_state);
  pr.dy = static_cast<const float*>(dy);
  pr.dfinal = static_cast<const float*>(dfinal);
  pr.dx = dx;
  pr.ddt = static_cast<float*>(ddt);
  pr.r = static_cast<float*>(r);
  pr.glog = static_cast<float*>(glog);
  pr.dinit = static_cast<float*>(dinit);
  pr.dbp = static_cast<float*>(dbp);
  pr.dcp = static_cast<float*>(dcp);
  pr.dap = static_cast<float*>(dap);
  pr.ddp = static_cast<float*>(ddp);
  pr.B = b;
  pr.L = l;
  pr.H = h;
  pr.P = p;
  pr.N = n;
  pr.NP = (n + 15) & ~15;
  pr.G = group;
  pr.nsub = (l + kQ - 1) / kQ;
  pr.xs_b = xs_b;
  pr.xs_t = xs_t;
  pr.xs_h = xs_h;
  pr.dts_b = dts_b;
  pr.dts_t = dts_t;
  pr.bs_b = bs_b;
  pr.bs_t = bs_t;
  pr.cs_b = cs_b;
  pr.cs_t = cs_t;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(pr, nmax, p_block, dB, dC,
                            static_cast<float*>(dA), static_cast<float*>(dD),
                            st)
          : dispatch<__nv_bfloat16>(pr, nmax, p_block, dB, dC,
                                    static_cast<float*>(dA),
                                    static_cast<float*>(dD), st);
  return (int)err;
}

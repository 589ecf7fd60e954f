// Mamba-2 SSD chunked scan for Hopper (sm_90a); plain C interface.
//
// Replaces: repro/kernels/ssd_scan/kernel.py, ssd_scan_bh (:69) and its body
// _ssd_kernel (:23). Same function, per (batch, head), over the sequence in
// chunks, with the state carried from chunk to chunk in fp32:
//   y_c   = (C_c B_cᵀ ⊙ L_c)(dt·x)_c + exp(cum)·C_c·stateᵀ + D·x_c
//   state ← exp(cum[-1])·state + ((dt·x)_c ⊙ exp(cum[-1] − cum))ᵀ B_c
// where cum is the running sum of dt·A inside the chunk and L_c[i][j] =
// exp(cum_i − cum_j) for j <= i. B and C are one group shared by every head.
// Beyond the TPU kernel, which starts from zero and keeps the carried state
// in VMEM scratch, this one takes an optional initial state and writes the
// state after the last chunk (the decode cache's SSD state).
//
// What bounds it on this card: operations. The function's least work is
// ~4.3·n·p flops per token and head (the chunked form at its best chunk;
// the recurrence is 5·n·p), against (p + 1 + 2·n / h)·bytes in; at
// Mamba-2-130M's p 64, n 128 that is hundreds of flops per byte. At the
// serving prefill (one prompt of 256 tokens) the whole function is a few
// microseconds of tensor-core work, so what decides the time is how much of
// the card the launch fills and how long its one dependent chain (the state
// carried along the sequence) is.
//
// What the design does about it. The scan runs in sub-chunks of kQ = 64
// tokens (a 256-token chunk's L alone would fill an SM's shared memory); the
// result depends on the chunk length only by rounding.
// - More of the card, a shorter chain. Mamba-2's own split, in one launch:
//   the sequence is cut into segments of `per_cta` sub-chunks, one CTA each,
//   and the segments of one (batch, head, p-block) form one thread-block
//   cluster (<= 8 CTAs). A CTA's 8 warps split its chunk pass: warps 0-3
//   write each sub-chunk's intra-chunk output (y = (L ⊙ C·Bᵀ)·(dt·x) + D·x,
//   which needs no state) while warps 4-7 build the segment's local state
//   from zero (chunk state), publish it in shared memory with the segment's
//   summed log-decay G and arrive at a cluster barrier; once every segment
//   has, warps 4-7 fold the earlier segments' local states, read through
//   distributed shared memory, into the entering state in segment order
//   (state passing: S = exp(G_c)·S + S_c from the initial state), still
//   side by side with warps 0-3. Then all 8 warps add exp(cum)·C·stateᵀ to
//   each sub-chunk's outputs, carrying the state through the segment. The
//   last CTA writes the final state. The grid is (cluster · batch · head,
//   p / p_block), its shape from ops.ssd_plan (192 CTAs, two per SM, at one
//   prompt of 256 tokens).
// - Tensor cores for the four products, through mma.sync (tc.cuh). C·Bᵀ:
//   bf16 m16n8k16 from ldmatrix for bf16 inputs (products exact in fp32,
//   sums fp32), split 3×TF32 for f32 inputs; each of warps 0-3 owns 16 rows
//   and multiplies only the 8-column tiles at or below its diagonal. Its C
//   fragment, decayed by exp(cum_i − cum_j) (evaluated only at j <= i, so
//   the decay extremes stay finite) and split into tf32 hi and lo, is
//   relabelled as the A fragment of (L ⊙ C·Bᵀ)·(dt·x) (A's column t stands
//   for key 2t, t + 4 for 2t + 1, and dt·x is read in that order). That
//   product, C·stateᵀ and the state update (decayed dt·x)ᵀ·B each have an
//   fp32 operand, so they run split 3×TF32 in both dtypes (about 2^-21 of
//   each product); a bf16 operand is exact in tf32, so there the lo half of
//   that side is zero and two mma of three are left.
// - Pipelined staging in the input dtype. B, C, x (bf16 stays bf16) and dt
//   arrive by cp.async (16 bytes; 4 for dt's strided column); with two
//   sub-chunks or more a CTA double-buffers them where shared memory allows,
//   the next sub-chunk landing while this one is multiplied. bf16 halves
//   the staged bytes; with one sub-chunk the carried state reuses the
//   staged B's space once every warp has read B, so f32 and bf16 alike run
//   two CTAs per SM up to 32 head_dim columns.
// - Ragged ends. Rows past the sequence's end are staged as zeros with
//   dt = 0, so they add nothing to the state and leave cum unchanged; their
//   outputs are not written. n is padded to a multiple of 16 with zeros.
// - Layout. x (b, l, h, p) and dt (b, l, h) are read in place through their
//   batch, token and head strides (the mixer's split views, no copy), B and
//   C through batch and token strides; y is written as (b, l, h, p).
// - States for the backward. Given a `states` buffer (b, h, ⌈l / 64⌉, p, n)
//   fp32 (under grad mode; ssd_bwd.cu reads it), the output pass also writes
//   the state entering each sub-chunk there, as it carries it. Without one
//   (serving) nothing more is written.
// Inputs x, B, C are f32 or bf16 (one dtype); dt, A, D and the states are
// fp32; y is fp32. Everything accumulates in fp32 with no atomic adds and
// the segments' states fold in a fixed order, so a result is the same on
// every run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "../../flash_attention/csrc/tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kQ = 64;            // tokens per sub-chunk
constexpr int kMaxN = 256;        // largest state size
constexpr int kMaxCluster = 8;    // CTAs along the sequence (portable)
constexpr int kMaxSmem = 232448;  // an H100 CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Named CTA barrier `id` over `threads` threads: arrive without waiting,
// or arrive and wait.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared memory, bytes. Per stage: B and C [kQ][NP + 8] and x [kQ][PB] in
// the input dtype, dt and cum [kQ] fp32. Then, once: dt·x [kQ][PB + 4],
// the decay to the sub-chunk's end [kQ], the published local state and
// the carried state [PB][NP + 8] fp32 each, and 16 bytes for the
// segment's log-decay. With one sub-chunk per CTA the carried state takes
// the place of the staged B when it fits there (it is written once every
// warp has read B for the last time). Row strides keep the fragment loads
// free of bank conflicts.
__host__ __device__ inline size_t stage_bytes(int item, int pb, int np) {
  return (size_t)2 * kQ * (np + 8) * item + (size_t)kQ * pb * item +
         2 * kQ * 4;
}
__host__ __device__ inline bool state_in_b(int item, int pb, int per_cta) {
  return per_cta == 1 && pb * 4 <= kQ * item;
}
__host__ __device__ inline size_t smem_bytes(int item, int pb, int np,
                                             int stages, int per_cta) {
  const size_t state = (size_t)pb * (np + 8) * 4;
  return stages * stage_bytes(item, pb, np) + (size_t)kQ * (pb + 4) * 4 +
         kQ * 4 + (state_in_b(item, pb, per_cta) ? 1 : 2) * state + 16;
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* init_state;
  float* y;
  float* final_state;
  float* states;   // (b, h, nsub, P, N): the state entering each sub-chunk
  int L, H, P, N, NP, nsub, per_cta, stages;
  long long xs_b, xs_t, xs_h, dts_b, dts_t, bs_b, bs_t, cs_b, cs_t;
};

// Rows [t0, t0 + kQ) of a (L, cols) slab with row stride `stride` into
// shared rows of stride ld, 16-byte chunks; chunks past L or `valid`
// columns are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long stride, int t0, int L,
                                           int valid, int cols) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int cpr = cols / CH;
  for (int e = threadIdx.x; e < kQ * cpr; e += kThreads) {
    const int r = e / cpr, c = (e % cpr) * CH;
    const bool ok = t0 + r < L && c < valid;
    cp_async16(dst + r * ld + c, ok ? src + (t0 + r) * stride + c : src, ok);
  }
}

// cum = inclusive running sum of dt·A over the sub-chunk (warp 0, two
// tokens a lane)
__device__ __forceinline__ void running_sum(const float* dts, float* cum,
                                            float a) {
  const int lane = threadIdx.x;
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += o;
  }
  float before = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) before = 0.f;
  cum[2 * lane] = before + v0;
  cum[2 * lane + 1] = s;
}

// S ← dec·S + Wᵀ·B (PB × NP; dec == 0 starts from zero) with W = dt·x ⊙
// decay (the decay to the sub-chunk's end per token): M = PB state rows
// (p), N = NP state columns, K = the sub-chunk's 64 tokens, relabelled (A's
// column t stands for token 2t, t + 4 for 2t + 1; B's rows are read in that
// order), in units of 16 rows × 16 columns, unit w0, w0 + nw, ... for this
// warp. bf16 B is exact in tf32 (its lo half is zero: two mma of three).
template <typename T, int PB>
__device__ __forceinline__ void state_update(float* S, int NS,
                                             const float* dtx,
                                             const float* dcy, const T* Bs,
                                             int NP, float dec, int w0,
                                             int nw, int g, int t) {
  constexpr int XS = PB + 4;
  const int nq = NP / 16;
  for (int u = w0; u < (PB / 16) * nq; u += nw) {
    const int mt = u / nq, n0 = (u % nq) * 16;
    float* s0 = S + (16 * mt + g) * NS + n0 + 2 * t;
    float* s1 = s0 + 8 * NS;
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 u0 = *reinterpret_cast<const float2*>(s0 + 8 * h);
      const float2 u1 = *reinterpret_cast<const float2*>(s1 + 8 * h);
      acc[h][0] = dec != 0.f ? dec * u0.x : 0.f;
      acc[h][1] = dec != 0.f ? dec * u0.y : 0.f;
      acc[h][2] = dec != 0.f ? dec * u1.x : 0.f;
      acc[h][3] = dec != 0.f ? dec * u1.y : 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int j = 8 * ks + 2 * t;
      const float* xp = dtx + j * XS + 16 * mt + g;
      const float d0 = dcy[j], d1 = dcy[j + 1];
      unsigned ah[4], al[4];
      split_tf32(xp[0] * d0, ah[0], al[0]);             // row g,     2t
      split_tf32(xp[8] * d0, ah[1], al[1]);             // row g + 8, 2t
      split_tf32(xp[XS] * d1, ah[2], al[2]);            // row g,     2t + 1
      split_tf32(xp[XS + 8] * d1, ah[3], al[3]);        // row g + 8, 2t + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* bp = Bs + j * NS + n0 + 8 * h + g;
        const float b0 = to_f32(bp[0]), b1 = to_f32(bp[NS]);
        if constexpr (sizeof(T) == 4) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(b0, bh0, bl0);
          split_tf32(b1, bh1, bl1);
          mma_3xtf32(acc[h], ah, al, bh0, bh1, bl0, bl1);
        } else {
          mma1688(acc[h], al, __float_as_uint(b0), __float_as_uint(b1));
          mma1688(acc[h], ah, __float_as_uint(b0), __float_as_uint(b1));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(s0 + 8 * h) = make_float2(acc[h][0],
                                                           acc[h][1]);
      *reinterpret_cast<float2*>(s1 + 8 * h) = make_float2(acc[h][2],
                                                           acc[h][3]);
    }
  }
}

// One warp's intra-chunk output for its 16 rows (16·w ..), whose NJ = 2w + 2
// 8-column tiles of C·Bᵀ hold a j <= i: yd = (L ⊙ C·Bᵀ)·(dt·x), 16 × PB.
template <typename T, int PB, int NJ>
__device__ __forceinline__ void intra(float (&yd)[PB / 8][4], const T* Cs,
                                      const T* Bs, const float* cum,
                                      const float* dtx, int NP, int warp,
                                      int lane, bool release_b) {
  constexpr int XS = PB + 4;
  const int g = lane >> 2, t = lane & 3;
  const int NS = NP + 8;
  float sc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    // C·Bᵀ, bf16 m16n8k16: C rows as A through ldmatrix, B rows as the
    // column operand (two 8-column tiles per ldmatrix.x4)
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll 2
    for (int k0 = 0; k0 < NP; k0 += 16) {
      unsigned qa[4];
      ldsm_x4(qa, Cs + (16 * warp + (lm & 1) * 8 + lr) * NS + k0 +
                      (lm >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, Bs + (np * 16 + (lm >> 1) * 8 + lr) * NS + k0 +
                       (lm & 1) * 8);
        mma16816(sc[2 * np], qa, b[0], b[1]);
        mma16816(sc[2 * np + 1], qa, b[2], b[3]);
      }
    }
  } else {
    // C·Bᵀ, split 3×TF32; the k index is relabelled (A's column t stands
    // for n index 2t, t + 4 for 2t + 1) so each side loads float2 pairs
    const float* c0p = Cs + (16 * warp + g) * NS + 2 * t;
#pragma unroll 2
    for (int k0 = 0; k0 < NP; k0 += 8) {
      const float2 c0 = *reinterpret_cast<const float2*>(c0p + k0);
      const float2 c1 = *reinterpret_cast<const float2*>(c0p + 8 * NS + k0);
      unsigned ah[4], al[4];
      split_tf32(c0.x, ah[0], al[0]);
      split_tf32(c1.x, ah[1], al[1]);
      split_tf32(c0.y, ah[2], al[2]);
      split_tf32(c1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(
            Bs + (8 * j + g) * NS + k0 + 2 * t);
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
        mma_3xtf32(sc[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  if (release_b) bar_arrive(1, kThreads);   // this warp is done with B

  // L ⊙ C·Bᵀ: exp(cum_i − cum_j) only where j <= i
  const int i0 = 16 * warp + g;
  const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1), row = i0 + 8 * (e >> 1);
      sc[j][e] = col <= row ? sc[j][e] * expf(ci[e >> 1] - cum[col]) : 0.f;
    }

  // yd = scores·(dt·x): the C fragment relabelled as A (column t is key
  // 2t, t + 4 is key 2t + 1), dt·x's rows read in that order
#pragma unroll
  for (int dn = 0; dn < PB / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) yd[dn][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unsigned ph[4], pl[4];
    split_tf32(sc[j][0], ph[0], pl[0]);   // row g,     key 2t
    split_tf32(sc[j][2], ph[1], pl[1]);   // row g + 8, key 2t
    split_tf32(sc[j][1], ph[2], pl[2]);   // row g,     key 2t + 1
    split_tf32(sc[j][3], ph[3], pl[3]);   // row g + 8, key 2t + 1
    const float* xp = dtx + (8 * j + 2 * t) * XS + g;
#pragma unroll
    for (int dn = 0; dn < PB / 8; ++dn) {
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(xp[8 * dn], bh0, bl0);
      split_tf32(xp[XS + 8 * dn], bh1, bl1);
      mma_3xtf32(yd[dn], ph, pl, bh0, bh1, bl0, bl1);
    }
  }
}

// yo = C·Sᵀ for 16 rows (16·rw ..) and DN 8-column tiles of the state's
// rows from S (16 × 8·DN), k over the state's NP columns, relabelled as in
// C·Bᵀ; bf16 C is exact in tf32 (two mma of three).
template <typename T, int DN>
__device__ __forceinline__ void carried(float (&yo)[DN][4], const T* Cs,
                                        const float* S, int NP, int rw,
                                        int g, int t) {
  const int NS = NP + 8;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) yo[dn][e] = 0.f;
  const T* c0p = Cs + (16 * rw + g) * NS + 2 * t;
  const float* sp = S + g * NS + 2 * t;
#pragma unroll 2
  for (int k0 = 0; k0 < NP; k0 += 8) {
    unsigned ah[4], al[4];
    if constexpr (sizeof(T) == 2) {
      const float2 c0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(c0p + k0));
      const float2 c1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(c0p + 8 * NS + k0));
      ah[0] = __float_as_uint(c0.x);
      ah[1] = __float_as_uint(c1.x);
      ah[2] = __float_as_uint(c0.y);
      ah[3] = __float_as_uint(c1.y);
    } else {
      const float2 c0 = *reinterpret_cast<const float2*>(c0p + k0);
      const float2 c1 = *reinterpret_cast<const float2*>(c0p + 8 * NS + k0);
      split_tf32(c0.x, ah[0], al[0]);
      split_tf32(c1.x, ah[1], al[1]);
      split_tf32(c0.y, ah[2], al[2]);
      split_tf32(c1.y, ah[3], al[3]);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float2 sv =
          *reinterpret_cast<const float2*>(sp + 8 * dn * NS + k0);
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(sv.x, bh0, bl0);
      split_tf32(sv.y, bh1, bl1);
      if constexpr (sizeof(T) == 2) {
        mma1688(yo[dn], ah, bl0, bl1);
        mma1688(yo[dn], ah, bh0, bh1);
      } else {
        mma_3xtf32(yo[dn], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// State passing by 128 threads (`tid` 0..127): the entering state Scur =
// the initial state folded with the earlier segments' local states in
// segment order, S = exp(G_r)·S + S_r, read through distributed shared
// memory, kU float4 a thread at a time with every load of a segment
// issued before its fold; the last segment also writes the final state,
// exp(G)·S + its own local state.
__device__ __forceinline__ void pass_state(
    float* Scur, const float* Spub, float* misc, const float* init,
    float* final_state, cg::cluster_group& cluster, int rank, int cs,
    float G, size_t state0, int PB, int NP, int N, int tid) {
  constexpr int kU = 8, kT = 128;
  const int NS = NP + 8, q = NP / 4, total = PB * q;
  const bool last_seg = rank == cs - 1;
  for (int e0 = tid; e0 < total; e0 += kT * kU) {
    float4 st[kU];
    int off[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = min(e0 + u * kT, total - 1);
      const int pp = e / q, c = (e % q) * 4;
      off[u] = pp * NS + c;
      st[u] = (init != nullptr && c < N)
                  ? *reinterpret_cast<const float4*>(
                        init + (state0 + pp) * N + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 1
    for (int r = 0; r < rank; ++r) {
      const float dec = expf(*cluster.map_shared_rank(misc, r));
      const float* rp = cluster.map_shared_rank(Spub, r);
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        v[u] = *reinterpret_cast<const float4*>(rp + off[u]);
#pragma unroll
      for (int u = 0; u < kU; ++u) st[u] = fma4(dec, st[u], v[u]);
    }
    const float gself = expf(G);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kT;
      if (e < total) {
        *reinterpret_cast<float4*>(Scur + off[u]) = st[u];
        const int pp = e / q, c = (e % q) * 4;
        if (last_seg && c < N)
          *reinterpret_cast<float4*>(final_state + (state0 + pp) * N + c) =
              fma4(gself, st[u],
                   *reinterpret_cast<const float4*>(Spub + off[u]));
      }
    }
  }
}

// Two CTAs per SM up to 32 head_dim columns a CTA: the registers of a
// 256-thread CTA then stay within 128 a thread.
template <typename T, int PB>
__global__ void __launch_bounds__(kThreads, PB <= 32 ? 2 : 1)
ssd_scan_kernel(const Params pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int NP = pr.NP, NS = NP + 8, L = pr.L, H = pr.H;
  constexpr int XS = PB + 4;

  const size_t sb = stage_bytes((int)sizeof(T), PB, NP);
  float* dtx = reinterpret_cast<float*>(smem + pr.stages * sb);  // [kQ][XS]
  float* dcy = dtx + kQ * XS;               // [kQ]
  float* Spub = dcy + kQ;                   // [PB][NS]
  const bool in_b = state_in_b((int)sizeof(T), PB, pr.per_cta);
  float* Scur = in_b ? reinterpret_cast<float*>(smem) : Spub + PB * NS;
  float* misc = Spub + (in_b ? 1 : 2) * PB * NS;  // [0]: the log-decay
  // stage s: B, C [kQ][NS], x [kQ][PB] (T); dt, cum [kQ] (fp32)
  auto Bs_of = [&](int s) { return reinterpret_cast<T*>(smem + s * sb); };
  auto dts_of = [&](int s) {
    return reinterpret_cast<float*>(Bs_of(s) + 2 * kQ * NS + kQ * PB);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / cs;
  const int bi = bh / H, hi = bh % H;
  const int p0 = blockIdx.y * PB;
  const float a = pr.A[hi];
  const float dd = pr.D != nullptr ? pr.D[hi] : 0.f;
  const T* xb = static_cast<const T*>(pr.x) + bi * pr.xs_b + hi * pr.xs_h + p0;
  const float* dtb = pr.dt + bi * pr.dts_b + hi;
  const T* bb = static_cast<const T*>(pr.Bm) + bi * pr.bs_b;
  const T* cb = static_cast<const T*>(pr.Cm) + bi * pr.cs_b;
  float* yb = pr.y + ((size_t)bi * L * H + hi) * pr.P + p0;
  const long long ys_t = (long long)H * pr.P;
  const int sub0 = rank * pr.per_cta;
  const int mr = min(pr.per_cta, pr.nsub - sub0);   // its sub-chunks
  // item i < mr: sub-chunk i's intra output and chunk state; item mr + k:
  // sub-chunk k's carried-state output. The output pass finds each
  // sub-chunk still in its buffer with one sub-chunk, or two in two
  // buffers; else its items restage.
  const int items = 2 * mr;
  const bool keep = mr == 1 || (pr.stages == 2 && mr <= 2);
  auto buf_of = [&](int i) {
    return pr.stages == 1 ? 0 : (mr <= 2 ? i % mr : i & 1);
  };
  auto load_item = [&](int i) {   // one commit group per item, or empty
    if (i < items && (i < mr || !keep)) {
      const int s = buf_of(i), t0 = (sub0 + i % mr) * kQ;
      T* Bs = Bs_of(s);
      stage_rows<T>(Bs, NS, bb, pr.bs_t, t0, L, pr.N, NP);
      stage_rows<T>(Bs + kQ * NS, NS, cb, pr.cs_t, t0, L, pr.N, NP);
      stage_rows<T>(Bs + 2 * kQ * NS, PB, xb, pr.xs_t, t0, L, PB, PB);
      if (tid < kQ)
        cp_async4(dts_of(s) + tid,
                  dtb + (t0 + tid < L ? (t0 + tid) * pr.dts_t : 0),
                  t0 + tid < L);
    }
    cp_async_commit();
  };

  load_item(0);
  if (pr.stages == 2) load_item(1);
  float G = 0.f;   // the segment's summed log-decay

  // chunk pass: warps 0-3 write each sub-chunk's intra output, warps 4-7
  // build the segment's local state from zero, side by side. Warps 0-3
  // publish nothing, so they arrive at the cluster barrier at once; warps
  // 4-7 arrive after the last sub-chunk's state update, then pass the state
  // while warps 0-3 still work on the intra output.
  if (warp < 4) cluster_arrive();
  for (int k = 0; k < mr; ++k) {
    if (pr.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int s = buf_of(k);
    const T* Bs = Bs_of(s);
    const T* Cs = Bs + kQ * NS;
    const T* Xs = Cs + kQ * NS;
    const float* dts = dts_of(s);
    float* cum = dts_of(s) + kQ;
    if (warp == 0) running_sum(dts, cum, a);
    __syncthreads();
    const float last = cum[kQ - 1];
    G += last;
    for (int e = tid; e < kQ * PB; e += kThreads)
      dtx[(e / PB) * XS + e % PB] = to_f32(Xs[e]) * dts[e / PB];
    if (tid < kQ) dcy[tid] = expf(last - cum[tid]);
    __syncthreads();
    if (warp < 4) {
      float yd[PB / 8][4];
      const bool rel = in_b;   // the carried state takes B's place
      switch (warp) {
        case 0: intra<T, PB, 2>(yd, Cs, Bs, cum, dtx, NP, 0, lane, rel); break;
        case 1: intra<T, PB, 4>(yd, Cs, Bs, cum, dtx, NP, 1, lane, rel); break;
        case 2: intra<T, PB, 6>(yd, Cs, Bs, cum, dtx, NP, 2, lane, rel); break;
        default: intra<T, PB, 8>(yd, Cs, Bs, cum, dtx, NP, 3, lane, rel);
      }
      const int t0 = (sub0 + k) * kQ;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        if (t0 + row < L) {
          float* yp = yb + (t0 + row) * ys_t;
#pragma unroll
          for (int dn = 0; dn < PB / 8; ++dn) {
            const int c = 8 * dn + 2 * t;
            *reinterpret_cast<float2*>(yp + c) = make_float2(
                yd[dn][2 * r] + dd * to_f32(Xs[row * PB + c]),
                yd[dn][2 * r + 1] + dd * to_f32(Xs[row * PB + c + 1]));
          }
        }
      }
      if (k == mr - 1) {
        cluster_wait();
        cluster_arrive();
      }
    } else {
      state_update<T, PB>(Spub, NS, dtx, dcy, Bs, NP,
                          k == 0 ? 0.f : expf(last), warp - 4, 4, g, t);
      if (k == mr - 1) {
        if (tid == 128) misc[0] = G;
        cluster_arrive();      // the local state and G are published
        cluster_wait();
        if (in_b) bar_sync(1, kThreads);   // warps 0-3 are done with B
        pass_state(Scur, Spub, misc, pr.init_state, pr.final_state, cluster,
                   rank, cs, G, ((size_t)bi * H + hi) * pr.P + p0, PB, NP,
                   pr.N, tid - 128);
        cluster_arrive();      // done reading the other CTAs' memory
      }
    }
    __syncthreads();
    load_item(k + pr.stages);
  }

  // output pass: y += exp(cum)·C·stateᵀ for each sub-chunk, warp w on rows
  // 16·(w & 3) .. and half the columns, the state carried through them
  constexpr int DN = PB / 16;
  const int rw = warp & 3, c0 = (warp >> 2) * (PB / 2);
  for (int k = 0; k < mr; ++k) {
    const int i = mr + k, s = buf_of(i);
    const T* Bs = Bs_of(s);
    const T* Cs = Bs + kQ * NS;
    const T* Xs = Cs + kQ * NS;
    const float* dts = dts_of(s);
    float* cum = dts_of(s) + kQ;
    if (!keep) {
      if (pr.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      if (warp == 0) running_sum(dts, cum, a);
      __syncthreads();
    }
    const bool more = k + 1 < mr;
    const float last = cum[kQ - 1];
    if (more) {
      for (int e = tid; e < kQ * PB; e += kThreads)
        dtx[(e / PB) * XS + e % PB] = to_f32(Xs[e]) * dts[e / PB];
      if (tid < kQ) dcy[tid] = expf(last - cum[tid]);
    }
    if (pr.states != nullptr) {
      // Scur is the state entering sub-chunk sub0 + k until the update
      // below, which follows a barrier
      float* sp = pr.states +
                  (((size_t)bi * H + hi) * pr.nsub + sub0 + k) * pr.P * pr.N +
                  (size_t)p0 * pr.N;
      for (int e = tid; e < PB * (pr.N / 4); e += kThreads) {
        const int pp = e / (pr.N / 4), c = (e % (pr.N / 4)) * 4;
        *reinterpret_cast<float4*>(sp + (size_t)pp * pr.N + c) =
            *reinterpret_cast<const float4*>(Scur + pp * NS + c);
      }
    }
    const int t0 = (sub0 + k) * kQ;
    float2 yv[2][DN];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * rw + g + 8 * r;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        yv[r][dn] = t0 + row < L
                        ? *reinterpret_cast<const float2*>(
                              yb + (t0 + row) * ys_t + c0 + 8 * dn + 2 * t)
                        : make_float2(0.f, 0.f);
    }
    float yo[DN][4];
    carried<T, DN>(yo, Cs, Scur + c0 * NS, NP, rw, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * rw + g + 8 * r;
      if (t0 + row < L) {
        const float e = expf(cum[row]);
        float* yp = yb + (t0 + row) * ys_t + c0;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn)
          *reinterpret_cast<float2*>(yp + 8 * dn + 2 * t) =
              make_float2(fmaf(e, yo[dn][2 * r], yv[r][dn].x),
                          fmaf(e, yo[dn][2 * r + 1], yv[r][dn].y));
      }
    }
    if (more) {
      __syncthreads();
      state_update<T, PB>(Scur, NS, dtx, dcy, Bs, NP, expf(last), warp, 8,
                          g, t);
    }
    __syncthreads();
    load_item(i + pr.stages);
  }
  cp_async_wait<0>();
  cluster_wait();   // no CTA leaves while another may read its state
}

// The dynamic shared-memory limit is raised to the card's most once per
// device and kernel instance, not on every launch (a prefill launches once
// per layer).
constexpr int kMaxDevices = 64;

template <typename T, int PB>
std::atomic<bool>* allowed() {
  static std::atomic<bool> done[kMaxDevices];
  return done;
}

template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int PB>
cudaError_t launch(const Params& pr, int b, int cluster, size_t smem,
                   cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, PB>;
  cudaError_t err = allow_smem(kernel, allowed<T, PB>());
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * b * pr.H), (unsigned)(pr.P / PB));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, pr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pb(const Params& pr, int b, int pb, int cluster,
                      size_t smem, cudaStream_t stream) {
  if (pb == 64) return launch<T, 64>(pr, b, cluster, smem, stream);
  if (pb == 32) return launch<T, 32>(pr, b, cluster, smem, stream);
  if (pb == 16) return launch<T, 16>(pr, b, cluster, smem, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, int item, long long s0, long long s1,
               long long s2) {
  const long long v = 16 / item;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % v == 0 &&
         s1 % v == 0 && s2 % v == 0;
}

}  // namespace

// x (b, l, h, p) with element strides (xs_b, xs_t, xs_h, 1); dt (b, l, h)
// fp32 with strides (dts_b, dts_t, 1); A, D (h,) fp32 (D may be null:
// zeros); Bm, Cm (b, l, n) with strides (bs_b, bs_t, 1), (cs_b, cs_t, 1);
// init_state (b, h, p, n) fp32 contiguous or null (zeros); y (b, l, h, p)
// and final_state (b, h, p, n) fp32 contiguous; states (b, h, ceil(l / 64),
// p, n) fp32 contiguous, or null: where given, the state entering each
// 64-token sub-chunk is written there (for the backward). x, Bm, Cm share a dtype:
// 0 = float32, 1 = bfloat16, each 16-byte aligned with strides of whole
// 16-byte units. The launch plan (ops.ssd_plan): p_block head_dim columns
// per CTA (16, 32 or 64, dividing p), `cluster` CTAs along the sequence of
// `per_cta` 64-token sub-chunks each (cluster = ceil(ceil(l / 64) /
// per_cta) <= 8), `stages` staging buffers (1 or 2) and the shared-memory
// bytes of that layout; a plan other than one the kernel runs is refused
// before anything launches. Needs n a multiple of 8 up to 256. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* init_state, void* y,
                              void* final_state, void* states, int dtype,
                              int b, int l,
                              int h, int p, int n, long long xs_b,
                              long long xs_t, long long xs_h, long long dts_b,
                              long long dts_t, long long bs_b, long long bs_t,
                              long long cs_b, long long cs_t, int p_block,
                              int cluster, int per_cta, int stages,
                              long long smem, void* stream) {
  const int item = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int nsub = l >= 1 ? (l + kQ - 1) / kQ : 0;
  const int np = (n + 15) & ~15;
  if (item == 0 || b < 1 || l < 1 || h < 1 || n < 8 || n % 8 != 0 ||
      n > kMaxN || (p_block != 16 && p_block != 32 && p_block != 64) ||
      p < p_block || p % p_block != 0 || p / p_block > 65535 ||
      cluster < 1 || cluster > kMaxCluster || per_cta < 1 ||
      (nsub + per_cta - 1) / per_cta != cluster ||
      (stages != 1 && stages != 2) ||
      smem != (long long)smem_bytes(item, p_block, np, stages, per_cta) ||
      smem > kMaxSmem ||
      (long long)cluster * b * h > 2147483647LL ||
      !aligned16(x, item, xs_b, xs_t, xs_h) ||
      !aligned16(Bm, item, bs_b, bs_t, 0) ||
      !aligned16(Cm, item, cs_b, cs_t, 0) ||
      reinterpret_cast<uintptr_t>(y) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(states) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params pr;
  pr.x = x;
  pr.dt = static_cast<const float*>(dt);
  pr.A = static_cast<const float*>(A);
  pr.Bm = Bm;
  pr.Cm = Cm;
  pr.D = static_cast<const float*>(D);
  pr.init_state = static_cast<const float*>(init_state);
  pr.y = static_cast<float*>(y);
  pr.final_state = static_cast<float*>(final_state);
  pr.states = static_cast<float*>(states);
  pr.L = l;
  pr.H = h;
  pr.P = p;
  pr.N = n;
  pr.NP = np;
  pr.nsub = nsub;
  pr.per_cta = per_cta;
  pr.stages = stages;
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
  cudaError_t err =
      dtype == 0
          ? launch_pb<float>(pr, b, p_block, cluster, (size_t)smem, st)
          : launch_pb<__nv_bfloat16>(pr, b, p_block, cluster, (size_t)smem,
                                     st);
  return (int)err;
}

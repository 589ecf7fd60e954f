// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/flash_attention/kernel.py, flash_fwd_bh (:97) and
// its body _fwd_kernel (:52), the TPU's online-softmax forward. Same
// function: out = softmax(q·kᵀ·d^-1/2 + bias + mask)·v and the per-row
// lse = m + log(l), with causal, sliding-window or bidirectional masks, an
// optional additive key bias, the additive NEG_INF = -1e30 convention and
// the max(l, 1e-30) guard.
//
// What bounds it on this card: per head it does 4·s·t·d flops and moves
// q, k, v and out once, 8·s·d bytes in bf16 at s = t. At the image tower's
// shape (d 64, s = t = 196) that is s/2 = 98 flops per byte, below the
// card's bf16 line (~295), so the bytes set the least time; but on the
// fp32 FMA units the same flops would take five times as long, so the
// products must run on the tensor cores, and q, k, v must be read once per
// CTA. In fp32 (the 'f32' precision policy) the same flops on the FMA units
// (67 TFLOP/s) take longer than the bytes (s/4 = 49 flops per byte), so
// fp32 runs on the tensor cores too, as split 3×TF32 (below): 495 TFLOP/s
// of tf32 make 165 of fp32-accurate work.
//
// bf16 inputs (the training and prefill paths) take the tensor-core
// design: one CTA per (head, block of 16·W query rows), W warps (W = 4,
// fewer where s <= 48: the text tower's s = 16 runs one warp per head;
// ops.fwd_plan picks W and the key tile), each warp owning 16 query rows.
// q, k and v stay bf16 in shared memory in rows padded by 16 bytes
// (ldmatrix reads them without bank conflicts); the q block is staged once
// and held in registers as mma A fragments, and k/v tiles of 64 keys (t
// rounded up to 16 where t < 64) arrive by 16-byte cp.async into a
// double-buffered ring, the next tile landing while this one is
// multiplied. Per tile each warp computes S = q·kᵀ (16 × 64, fp32
// accumulators) with mma.sync.m16n8k16 bf16 -> fp32 fed by ldmatrix,
// scales it by d^-1/2 in fp32 (not a power of two at d 128, so q is not
// pre-scaled in bf16), adds the bias and the mask, and carries the online
// softmax in the C fragments: row max and sum over a row's four lanes by
// quad shuffles, fp32, in log2 units so that each exponential is one ex2.
// p = 2^(S − m) is rounded to bf16 and reused in registers as the A
// fragment of o += p·v, v read with ldmatrix.trans; the row sum l takes
// the unrounded p. The output accumulates in fp32 registers;
// lse = m + log(max(l, 1e-30)) in fp32. Key tiles wholly outside a causal
// or windowed mask are skipped per CTA and per warp, a tile every row
// attends in full skips the element-wise mask, and key n-tiles past t are
// not multiplied. The plain version rounds p to bf16 before p·v as well
// (ref.flash_fwd_ref). What this design does not do: wgmma, TMA, or hold
// a head's k and v once for all its query blocks; each of a head's CTAs
// streams all of them, which is most of its time at the training
// microbatch (PERF.md).
//
// f32 inputs (zero-shot serving, f32 training, the f32 prefills) take the
// same grid on mma.sync.m16n8k8 tf32, each product in split 3×TF32: every
// fp32 operand x becomes hi = rna(x) and lo = rna(x − hi) in tf32, and a·b
// is ah·bl + al·bh + ah·bh summed in fp32, the small products first
// (CUTLASS's OpMultiplyAddFastF32, the scheme PyTorch's own f32 attention
// uses). That leaves about 2^-21 of each product against 2^-24 for an fp32
// FMA: a few 1e-6 on a score at d 64, inside the f32 limits (5e-5 on out
// and lse); plain TF32 (~2^-11) would not hold them. Each warp splits its
// 16 q rows once, into A fragments held in registers. k and v tiles of 32
// keys (t rounded up to 8 where shorter; ops.fwd_plan) arrive in fp32 by
// 16-byte cp.async into a double-buffered ring, rows padded to D + 4
// floats; once a tile lands, the CTA's threads split it together into
// (hi, lo) pairs, so each element is split once per CTA rather than once
// per warp, and the B fragments load as 64-bit pairs (k rows padded to
// D + 4 pairs, v rows to D + 2: both fragment patterns then touch 32 banks
// per half-warp). Keys go in 8-key n-tiles, so s = 196 costs 208 × 200,
// not 256 × 256; the tile body is instantiated per count of live n-tiles,
// so no runtime bound sits inside the products and the compiler
// interleaves them (a loop guarded by the tile's key count was much
// slower). p stays in
// registers: the C fragment gives a thread keys 2t and 2t + 1, the A
// fragment of p·v wants columns t and t + 4, so A's columns stand for the
// keys in that order and v's B fragment is read in the same order; p is
// split before p·v. The mask, the online softmax and lse stay fp32, and key
// tiles outside a causal or windowed mask are skipped as in the bf16
// kernel. What bounds it: not the tensor cores (a third of their mma.sync
// rate at the image tower's shape) but the splits, the tile's staging and
// the chains of dependent products (scripts/flash_fwd_anatomy.py --f32).
//
// Both designs are instantiated at head dims 64, 80 (HuBERT-XLarge) and
// 128. At d 80 a row is 160 bytes in bf16 (five 16-wide k-steps of q·kᵀ,
// ten 8-wide n-tiles of p·v) and 320 in fp32 (ten 8-wide tf32 k-steps):
// not a power of two, but every row stride stays a multiple of 16 bytes,
// and the padded strides (D + 8 bf16; D + 4 and D + 2 pairs in fp32) put
// the fragment loads on 32 banks as at 64 and 128. d 80 takes d 128's
// register bound (__launch_bounds__ minimum of 2 CTAs an SM, up to 255
// registers a thread), which leaves room for its 60 (bf16) or 120 (f32)
// registers of q fragments and output accumulators; whether d 64's bound
// would hold them is untried (the build log prints each instantiation's
// registers).
//
// Both designs, unlike the TPU kernel, mask the ragged tail (s = 196)
// rather than require it to divide the block, never write rows >= s, and
// let each query head read its kv head (row / group) in place of a repeat
// of k and v. Every accumulation is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#include "tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;


// ---------------------------------------------------------------------------
// bf16: the tensor-core forward
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcMaxW = 4;       // warps per CTA, at most
constexpr int kTcMaxBK = 64;     // keys per staged tile, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the special-function unit (max relative error 2^-22).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory layout, bf16 elements in rows of D + 8: q [16·W rows],
// then `stages` ring stages of k [bk rows] and v [bk rows].
template <int D>
size_t tc_smem_bytes(int warps, int bk, int stages) {
  return sizeof(bf16) * (size_t)(D + 8) * (16 * warps + 2 * stages * bk);
}

// Rows [r0, r0 + rows) of an (n, D) bf16 slab into shared rows of stride
// D + 8 by 16-byte cp.async, the CTA's threads in turn; rows >= n are
// zero-filled (their source is not read).
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int rows, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int row = e / CH, ch = e % CH;
    const int g = r0 + row;
    const bool ok = g < n;
    cp_async16(dst + row * (D + 8) + ch * 8,
               src + (size_t)(ok ? g : 0) * D + ch * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kTcMaxW, D == 64 ? 4 : 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int Tk, int bk,
                    int group, int bias_group, int causal, int window,
                    float scale) {
  constexpr int LD = D + 8;
  constexpr int DK = D / 16;         // k-steps of q·kᵀ over d
  constexpr int DN = D / 8;          // n-tiles of the output
  constexpr int KN = kTcMaxBK / 8;   // n-tiles of a score tile, at most
  const int BQ = blockDim.x / 2;     // 16 query rows per warp
  const float scale_log2 = scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* KVs = Qs + (size_t)BQ * LD;               // [stage][k, v][bk][LD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;     // mma group id: fragment row
  const int tq = lane & 3;      // thread in group: fragment column pair
  const int lr = lane & 7;      // ldmatrix row within a matrix
  const int lm = lane >> 3;     // ldmatrix matrix index
  const int qw0 = q0 + 16 * warp;        // this warp's first query row
  const bool rows = qw0 < S;
  const int w_last = min(qw0 + 15, S - 1);

  const bf16* kb = k + (size_t)(bh / group) * Tk * D;
  const bf16* vb = v + (size_t)(bh / group) * Tk * D;
  const float* brow =
      bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;

  int kt_lo = 0;
  int kt_hi = (Tk + bk - 1) / bk;
  if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, S) - 1) / bk + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / bk);

  // a tile's rows past t are staged (zero) only up to the 16-row step that
  // the products read
  auto prefetch = [&](int kt, int st) {
    const int k0 = kt * bk;
    const int n = min(bk, (Tk - k0 + 15) & ~15);
    bf16* Ks = KVs + (size_t)st * 2 * bk * LD;
    stage_rows<D>(Ks, kb, k0, n, Tk);
    stage_rows<D>(Ks + (size_t)bk * LD, vb, k0, n, Tk);
    cp_async_commit();
  };
  stage_rows<D>(Qs, q + (size_t)bh * S * D, q0,
                min(BQ, (S - q0 + 15) & ~15), S);
  prefetch(kt_lo, 0);   // one group with the q block

  unsigned qa[DK][4];
  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows gq and gq + 8 of the warp: running max (log2 units), and this
  // thread's share of the running sum (the quad's shares add up at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      prefetch(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo && rows) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qa[kk], Qs + (16 * warp + (lm & 1) * 8 + lr) * LD + kk * 16 +
                            (lm >> 1) * 8);
    }
    const int k0 = kt * bk;
    const int nk = min(bk, Tk - k0);     // keys of this tile
    bool attend = rows;
    if (causal) attend = attend && k0 <= w_last;
    if (window > 0) attend = attend && k0 + nk - 1 > qw0 - window;
    if (attend) {
      const bf16* Ks = KVs + (size_t)st * 2 * bk * LD;
      const bf16* Vs = Ks + (size_t)bk * LD;

      // S = q·kᵀ (16 × nk) in fp32
      float sc[KN][4];
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        if (16 * np < nk) {
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            unsigned b[4];
            ldsm_x4(b, Ks + (np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 +
                           (lm & 1) * 8);
            mma16816(sc[2 * np], qa[kk], b[0], b[1]);
            mma16816(sc[2 * np + 1], qa[kk], b[2], b[3]);
          }
        }
      }

      // scale, bias, mask (the reference's order), then the online softmax,
      // all in log2 units (scores times log2 e), so each exponential is one
      // ex2. n-tiles past nk were not multiplied; only a tile that some row
      // does not attend in full is masked element by element. Padding
      // columns (past t) get weight 0, masked keys 2^(-1e30 − m)
      const bool full = nk == bk && (!causal || k0 + nk - 1 <= qw0) &&
                        (window <= 0 || w_last - k0 < window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kcol = k0 + 8 * j + 2 * tq + (e & 1);
          float x = kNegInf;
          if (8 * j < nk) {
            const float bj =
                (brow != nullptr && kcol < Tk) ? brow[kcol] * kLog2e : 0.f;
            x = fmaf(sc[j][e], scale_log2, bj);
            if (!full) {
              const int qrow = qw0 + gq + 8 * (e >> 1);
              bool ok = kcol < Tk;
              if (causal) ok = ok && kcol <= qrow;
              if (window > 0) ok = ok && (qrow - kcol) < window;
              x = ok ? x : kNegInf;
            }
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
      // p = 2^(S − m): fp32 into the row sums, bf16 as p·v's A fragments
      // (C tile j, keys 8j.., is half of A k-step j / 2)
      unsigned pa[KN / 2][4];
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool pad = 8 * j >= nk ||
                           (!full && k0 + 8 * j + 2 * tq + (e & 1) >= Tk);
          p[e] = pad ? 0.f : exp2_approx(sc[j][e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < DN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

      // o += p·v, v read transposed (the contraction runs over the keys)
#pragma unroll
      for (int kk = 0; kk < KN / 2; ++kk) {
        if (16 * kk < nk) {
#pragma unroll
          for (int dp = 0; dp < DN / 2; ++dp) {
            unsigned b[4];
            ldsm_x4_t(b, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD + dp * 16 +
                             (lm >> 1) * 8);
            mma16816(o[2 * dp], pa[kk], b[0], b[1]);
            mma16816(o[2 * dp + 1], pa[kk], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const int qrow = qw0 + gq + 8 * r;
    if (qrow < S) {
      const float lc = fmaxf(sum, 1e-30f);
      bf16* orow = out + ((size_t)bh * S + qrow) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j)
        *reinterpret_cast<unsigned*>(orow + 8 * j + 2 * tq) =
            pack_bf16(o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
      if (tq == 0) lse[(size_t)bh * S + qrow] = (m[r] + log2f(lc)) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int bh, int s,
                      int t, int warps, int bk, int smem, int group,
                      int bias_group, int causal, int window, float scale,
                      cudaStream_t stream) {
  const int blocks = (s + 16 * warps - 1) / (16 * warps);
  if (blocks > 65535 ||
      (size_t)smem != tc_smem_bytes<D>(warps, bk, t > bk ? 2 : 1))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, blocks), 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(lse), s, t, bk, group,
      bias_group, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* lse, int bh,
                        int s, int t, int d, int warps, int bk, int smem,
                        int group, int bias_group, int causal, int window,
                        float scale, cudaStream_t stream) {
  if (warps < 1 || warps > kTcMaxW || bk < 16 || bk > kTcMaxBK ||
      bk % 16 != 0)
    return cudaErrorInvalidValue;
  if (d == 64)
    return launch_tc<64>(q, k, v, bias, out, lse, bh, s, t, warps, bk, smem,
                         group, bias_group, causal, window, scale, stream);
  if (d == 80)
    return launch_tc<80>(q, k, v, bias, out, lse, bh, s, t, warps, bk, smem,
                         group, bias_group, causal, window, scale, stream);
  if (d == 128)
    return launch_tc<128>(q, k, v, bias, out, lse, bh, s, t, warps, bk,
                          smem, group, bias_group, causal, window, scale,
                          stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// f32: the split 3×TF32 tensor-core forward
// ---------------------------------------------------------------------------

constexpr int kF32MaxW = 4;      // warps per CTA, at most
constexpr int kF32MaxBK = 32;    // keys per staged tile, at most

// Shared-memory layout: `stages` ring stages of raw fp32 k and v [bk rows
// of D + 4 floats each], then the current tile split into (hi, lo) tf32
// pairs, k [bk][D + 4] and v [bk][D + 2] pairs. Those strides keep the
// 64-bit pair loads of both B fragments (k: rows g, columns t; v: rows 2t,
// columns g) on 32 distinct banks per half-warp.
template <int D>
size_t f32_smem_bytes(int bk, int stages) {
  return sizeof(float) * (size_t)(D + 4) * 2 * stages * bk +
         sizeof(uint2) * (size_t)bk * (2 * D + 6);
}

// One warp's work on one k/v tile whose NJ 8-key n-tiles hold a key:
// S = q·kᵀ (16 × 8·NJ) from the q fragments and the tile's (hi, lo) pairs,
// the scale, bias and mask (the reference's order), the online softmax in
// log2 units as the bf16 kernel does (padding columns past t get weight 0,
// masked keys 2^(-1e30 − m)), and o += p·v. The C fragment of S gives a
// thread keys 2t and 2t + 1; the A fragment of p·v wants columns t and
// t + 4, so A's column t stands for key 2t and t + 4 for key 2t + 1, and
// v's B fragment is read in that order (rows 2t, 2t + 1): p stays in
// registers, split into hi and lo.
template <int D, int NJ>
__device__ __forceinline__ void f32_tile(
    const unsigned (&qh)[D / 8][4], const unsigned (&ql)[D / 8][4],
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2], const uint2* Kp,
    const uint2* Vp, const float* brow, int k0, int Tk, int qw0, bool full,
    int causal, int window, float scale_log2, int gq, int tq) {
  constexpr int LD = D + 4;
  constexpr int LDV = D + 2;
  constexpr int DK = D / 8;
  float sc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint2* kp = Kp + (8 * j + gq) * LD + kk * 8 + tq;
      const uint2 b0 = kp[0], b1 = kp[4];
      mma_3xtf32(sc[j], qh[kk], ql[kk], b0.x, b1.x, b0.y, b1.y);
    }
  }

  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kcol = k0 + 8 * j + 2 * tq + (e & 1);
      const float bj =
          (brow != nullptr && kcol < Tk) ? brow[kcol] * kLog2e : 0.f;
      float x = fmaf(sc[j][e], scale_log2, bj);
      if (!full) {
        const int qrow = qw0 + gq + 8 * (e >> 1);
        bool ok = kcol < Tk;
        if (causal) ok = ok && kcol <= qrow;
        if (window > 0) ok = ok && (qrow - kcol) < window;
        x = ok ? x : kNegInf;
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool pad = !full && k0 + 8 * j + 2 * tq + (e & 1) >= Tk;
      sc[j][e] = pad ? 0.f : exp2_approx(sc[j][e] - m[e >> 1]);
      l[e >> 1] += sc[j][e];
    }
  }
#pragma unroll
  for (int j = 0; j < DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unsigned ph[4], pl[4];
    split_tf32(sc[j][0], ph[0], pl[0]);   // row g,     key 2t
    split_tf32(sc[j][2], ph[1], pl[1]);   // row g + 8, key 2t
    split_tf32(sc[j][1], ph[2], pl[2]);   // row g,     key 2t + 1
    split_tf32(sc[j][3], ph[3], pl[3]);   // row g + 8, key 2t + 1
    const uint2* vp = Vp + (8 * j + 2 * tq) * LDV + gq;
#pragma unroll
    for (int dn = 0; dn < DK; ++dn) {
      const uint2 b0 = vp[dn * 8], b1 = vp[LDV + dn * 8];
      mma_3xtf32(o[dn], ph, pl, b0.x, b1.x, b0.y, b1.y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kF32MaxW, D == 64 ? 3 : 2)
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ lse,
                        int S, int Tk, int bk, int group, int bias_group,
                        int causal, int window, float scale) {
  constexpr int LD = D + 4;           // raw rows (floats), k pairs
  constexpr int LDV = D + 2;          // v pairs
  constexpr int DK = D / 8;           // k-steps of q·kᵀ; n-tiles of the output
  constexpr int C4 = D / 4;           // 16-byte chunks of a row
  const int BQ = blockDim.x / 2;      // 16 query rows per warp
  const float scale_log2 = scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* KVs = reinterpret_cast<float*>(smem_raw);   // [stage][k, v][bk][LD]
  const int stages = Tk > bk ? 2 : 1;
  uint2* Kp = reinterpret_cast<uint2*>(KVs + (size_t)stages * 2 * bk * LD);
  uint2* Vp = Kp + (size_t)bk * LD;                  // [bk][LDV]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;     // mma group id: fragment row
  const int tq = lane & 3;      // thread in group: fragment column
  const int qw0 = q0 + 16 * warp;        // this warp's first query row
  const bool rows = qw0 < S;
  const int w_last = min(qw0 + 15, S - 1);

  const float* kb = k + (size_t)(bh / group) * Tk * D;
  const float* vb = v + (size_t)(bh / group) * Tk * D;
  const float* brow =
      bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;

  int kt_lo = 0;
  int kt_hi = (Tk + bk - 1) / bk;
  if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, S) - 1) / bk + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / bk);

  // a tile's rows past t are staged (zero) only up to the 8-key step that
  // the products read
  auto prefetch = [&](int kt, int st) {
    const int k0 = kt * bk;
    const int n = min(bk, (Tk - k0 + 7) & ~7);
    float* Ks = KVs + (size_t)st * 2 * bk * LD;
    stage_rows_f32<D>(Ks, kb, k0, n, Tk);
    stage_rows_f32<D>(Ks + (size_t)bk * LD, vb, k0, n, Tk);
    cp_async_commit();
  };
  if (kt_lo < kt_hi) prefetch(kt_lo, 0);

  // this warp's q rows as A fragments (rows g, g + 8; columns t, t + 4 of
  // each 8-wide k-step), split once into tf32 hi and lo (rows >= s zero)
  unsigned qh[DK][4], ql[DK][4];
  {
    const float* qr = q + ((size_t)bh * S + qw0 + gq) * D + tq;
    const bool r0 = qw0 + gq < S, r1 = qw0 + gq + 8 < S;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      split_tf32(r0 ? qr[kk * 8] : 0.f, qh[kk][0], ql[kk][0]);
      split_tf32(r1 ? qr[8 * D + kk * 8] : 0.f, qh[kk][1], ql[kk][1]);
      split_tf32(r0 ? qr[kk * 8 + 4] : 0.f, qh[kk][2], ql[kk][2]);
      split_tf32(r1 ? qr[8 * D + kk * 8 + 4] : 0.f, qh[kk][3], ql[kk][3]);
    }
  }

  float o[DK][4];
#pragma unroll
  for (int j = 0; j < DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows gq and gq + 8 of the warp: running max (log2 units), and this
  // thread's share of the running sum (the quad's shares add up at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    // the stage the next tile lands in was split before the last barrier
    if (kt + 1 < kt_hi) {
      prefetch(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile landed; the last tile's products ended
    const int k0 = kt * bk;
    const int nk = min(bk, Tk - k0);     // keys of this tile
    {
      // split the tile once for every warp: (hi, lo) pairs of k and v
      const int n8 = (nk + 7) & ~7;
      const float* Ks = KVs + (size_t)st * 2 * bk * LD;
      for (int e = tid; e < 2 * n8 * C4; e += blockDim.x) {
        const int isv = e >= n8 * C4;
        const int r = (e - isv * n8 * C4) / C4, c = (e % C4) * 4;
        const float4 x = *reinterpret_cast<const float4*>(
            Ks + ((size_t)isv * bk + r) * LD + c);
        uint4 a, b;
        split_tf32(x.x, a.x, a.y);
        split_tf32(x.y, a.z, a.w);
        split_tf32(x.z, b.x, b.y);
        split_tf32(x.w, b.z, b.w);
        uint2* dst = isv ? Vp + r * LDV + c : Kp + r * LD + c;
        *reinterpret_cast<uint4*>(dst) = a;
        *reinterpret_cast<uint4*>(dst + 2) = b;
      }
    }
    __syncthreads();   // the pairs are in shared memory
    bool attend = rows;
    if (causal) attend = attend && k0 <= w_last;
    if (window > 0) attend = attend && k0 + nk - 1 > qw0 - window;
    if (attend) {
      // one instantiation per count of live 8-key n-tiles: no runtime
      // bound inside, so consecutive n-tiles' products interleave
      const bool full = nk == bk && (!causal || k0 + nk - 1 <= qw0) &&
                        (window <= 0 || w_last - k0 < window);
#define REPRO_F32_TILE(NJ)                                                 \
  f32_tile<D, NJ>(qh, ql, o, m, l, Kp, Vp, brow, k0, Tk, qw0, full, causal, \
                  window, scale_log2, gq, tq)
      switch ((nk + 7) / 8) {
        case 1: REPRO_F32_TILE(1); break;
        case 2: REPRO_F32_TILE(2); break;
        case 3: REPRO_F32_TILE(3); break;
        default: REPRO_F32_TILE(4); break;
      }
#undef REPRO_F32_TILE
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const int qrow = qw0 + gq + 8 * r;
    if (qrow < S) {
      const float lc = fmaxf(sum, 1e-30f);
      float* orow = out + ((size_t)bh * S + qrow) * D;
#pragma unroll
      for (int j = 0; j < DK; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * tq) =
            make_float2(o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
      if (tq == 0) lse[(size_t)bh * S + qrow] = (m[r] + log2f(lc)) * kLn2;
    }
  }
}

// cudaFuncSetAttribute for the f32 kernel's largest plan, once per
// instantiation and device (a call per launch costs host time on the
// serving path's 264 launches per request)
template <int D>
cudaError_t allow_f32_smem() {
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_3xtf32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)f32_smem_bytes<D>(kF32MaxBK, 2));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int bh, int s,
                       int t, int warps, int bk, int smem, int group,
                       int bias_group, int causal, int window, float scale,
                       cudaStream_t stream) {
  const int blocks = (s + 16 * warps - 1) / (16 * warps);
  if (blocks > 65535 || (size_t)smem != f32_smem_bytes<D>(bk, t > bk ? 2 : 1))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_3xtf32_kernel<D>;
  cudaError_t err = allow_f32_smem<D>();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, blocks), 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(lse), s, t, bk, group,
      bias_group, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int bh,
                         int s, int t, int d, int warps, int bk, int smem,
                         int group, int bias_group, int causal, int window,
                         float scale, cudaStream_t stream) {
  if (warps < 1 || warps > kF32MaxW || bk < 8 || bk > kF32MaxBK ||
      bk % 8 != 0)
    return cudaErrorInvalidValue;
  if (d == 64)
    return launch_f32<64>(q, k, v, bias, out, lse, bh, s, t, warps, bk, smem,
                          group, bias_group, causal, window, scale, stream);
  if (d == 80)
    return launch_f32<80>(q, k, v, bias, out, lse, bh, s, t, warps, bk, smem,
                          group, bias_group, causal, window, scale, stream);
  if (d == 128)
    return launch_f32<128>(q, k, v, bias, out, lse, bh, s, t, warps, bk,
                           smem, group, bias_group, causal, window, scale,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (split 3×TF32 tensor cores), 1 = bfloat16 (tensor
// cores). window <= 0: no window. warps per CTA (1..4, 16 query rows each)
// and key_tile, the keys per staged tile (16..64, a multiple of 16, for
// bf16; 8..32, a multiple of 8, for f32); ops.fwd_plan picks both and the
// CTA's dynamic shared memory, smem, which must be the bytes of this
// file's layout for that plan (tc_smem_bytes, f32_smem_bytes): the launch
// takes the plan's bytes and refuses any other. q, k, v must start 16-byte
// aligned. Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* lse,
                               int dtype, int bh, int s, int t, int d,
                               int group, int bias_group, int causal,
                               int window, float scale, int warps,
                               int key_tile, int smem, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, bias, out, lse, bh, s, t, d, warps,
                             key_tile, smem, group, bias_group, causal,
                             window, scale, st);
  if (dtype == 1)
    return (int)dispatch_tc(q, k, v, bias, out, lse, bh, s, t, d, warps,
                            key_tile, smem, group, bias_group, causal,
                            window, scale, st);
  return (int)cudaErrorInvalidValue;
}

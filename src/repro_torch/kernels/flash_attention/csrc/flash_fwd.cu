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
// CTA. In fp32 (the 'f32' precision policy) the FMA units set the pace.
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
// f32 inputs keep the SIMT design (TF32 would not hold the f32 limits): one
// CTA per (head, block of 64 query rows) keeps its q block, the running
// max/sum and the fp32 accumulator on chip for the whole sweep over key
// tiles staged in shared memory, so nothing of the (s, t) score matrix
// reaches device memory and q, k, v are read from it once per CTA. Each
// thread owns 4 query rows by 8 key columns of the score tile and the same
// rows by d/8 output columns, so the row statistics never leave its
// registers and the row reductions are three shuffles among 8 lanes.
//
// Both designs, unlike the TPU kernel, mask the ragged tail (s = 196)
// rather than require it to divide the block, never write rows >= s, and
// let each query head read its kv head (row / group) in place of a repeat
// of k and v; key tiles wholly outside a causal or windowed mask are
// skipped. Every accumulation is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per staged tile
constexpr unsigned kFull = 0xffffffffu;

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1]
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) +
                                  kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int S,
                 int Tk, int group, int bias_group, int causal, int window,
                 float scale) {
  constexpr int RM = kBQ / 16;   // query rows per thread: r + 16 i
  constexpr int CN = kBK / 8;   // score columns per thread: c + 8 j
  constexpr int DN = D / 8;     // output columns per thread: c + 8 j
  constexpr int QS = D + 1;     // padded strides: no bank conflicts
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * D;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;

  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)(bh / group) * Tk * D;
  const float* vb = v + (size_t)(bh / group) * Tk * D;
  const float* brow =
      bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const int qrow = q0 + row;
    Qs[row * QS + col] = qrow < S ? qb[(size_t)qrow * D + col] * scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int kt_lo = 0;
  int kt_hi = (Tk + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, (min(q0 + kBQ, S) - 1) / kBK + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / kBK);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int row = e / D, col = e % D;
      const int krow = k0 + row;
      const bool ok = krow < Tk;
      Ks[row * QS + col] = ok ? kb[(size_t)krow * D + col] : 0.f;
      Vs[row * D + col] = ok ? vb[(size_t)krow * D + col] : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(r + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(c + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // bias, then the mask (the reference's order), then the online softmax
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kcol = k0 + c + 8 * j;
      const float bj = (brow != nullptr && kcol < Tk) ? brow[kcol] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qrow = q0 + r + 16 * i;
        bool valid = kcol < Tk;
        if (causal) valid = valid && kcol <= qrow;
        if (window > 0) valid = valid && (qrow - kcol) < window;
        s[i][j] = valid ? s[i][j] + bj : kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CN; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        // columns past the last key are padding, not masked keys: weight 0
        const float p =
            (k0 + c + 8 * j) < Tk ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      rs += __shfl_xor_sync(kFull, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CN; ++j) Ps[(r + 16 * i) * PS + c + 8 * j] = s[i][j];
    }
    __syncwarp();  // a row of P is written and read by the same 8 lanes

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(r + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[kk * D + c + 8 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qrow = q0 + r + 16 * i;
    if (qrow < S) {
      const float lc = fmaxf(l[i], 1e-30f);
      float* orow = out + ((size_t)bh * S + qrow) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) orow[c + 8 * j] = acc[i][j] / lc;
      if (c == 0) lse[(size_t)bh * S + qrow] = m[i] + logf(lc);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int bh, int s,
                   int t, int group, int bias_group, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(lse), s, t, group,
      bias_group, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int bh,
                         int s, int t, int d, int group, int bias_group,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  if (s > 65535 * kBQ) return cudaErrorInvalidValue;
  if (d == 64)
    return launch<64>(q, k, v, bias, out, lse, bh, s, t, group, bias_group,
                      causal, window, scale, stream);
  if (d == 128)
    return launch<128>(q, k, v, bias, out, lse, bh, s, t, group, bias_group,
                       causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

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
                      int t, int warps, int bk, int group, int bias_group,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  const int blocks = (s + 16 * warps - 1) / (16 * warps);
  if (blocks > 65535) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<D>(warps, bk, t > bk ? 2 : 1);
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
                        int s, int t, int d, int warps, int bk, int group,
                        int bias_group, int causal, int window, float scale,
                        cudaStream_t stream) {
  if (warps < 1 || warps > kTcMaxW || bk < 16 || bk > kTcMaxBK ||
      bk % 16 != 0)
    return cudaErrorInvalidValue;
  if (d == 64)
    return launch_tc<64>(q, k, v, bias, out, lse, bh, s, t, warps, bk, group,
                         bias_group, causal, window, scale, stream);
  if (d == 128)
    return launch_tc<128>(q, k, v, bias, out, lse, bh, s, t, warps, bk,
                          group, bias_group, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor cores). window
// <= 0: no window. bf16 only: warps per CTA (1..4, 16 query rows each) and
// key_tile, the keys per staged tile (16..64, a multiple of 16); ops.fwd_plan
// picks both, and q, k, v must start 16-byte aligned. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* lse,
                               int dtype, int bh, int s, int t, int d,
                               int group, int bias_group, int causal,
                               int window, float scale, int warps,
                               int key_tile, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, bias, out, lse, bh, s, t, d, group,
                             bias_group, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_tc(q, k, v, bias, out, lse, bh, s, t, d, warps,
                            key_tile, group, bias_group, causal, window,
                            scale, st);
  return (int)cudaErrorInvalidValue;
}

// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/flash_attention/kernel.py, flash_bwd_bh (:230)
// with its bodies _recompute_p_ds (:148), _dq_kernel (:171) and _dkv_kernel
// (:198), the TPU's blockwise backward. Same function: from q, k, v, the
// optional additive key bias, the forward's out and per-row lse and the
// upstream dout it recomputes p = exp(q·kᵀ·d^-1/2 + bias + mask − lse),
// forms delta = rowsum(dout·out) and ds = p·(dout·vᵀ − delta), and returns
// dq = ds·k·d^-1/2, dk = dsᵀ·q·d^-1/2 and dv = pᵀ·dout in the input dtype,
// with the causal, sliding-window and bidirectional masks, the additive
// NEG_INF = -1e30 convention and grouped-query heads.
//
// What bounds it on this card: the arithmetic. Per head it recomputes the
// score tile and does five tile products (q·kᵀ, dout·vᵀ, ds·k, dsᵀ·q,
// pᵀ·dout) over inputs read once; at the towers' shapes (d 64, s = t = 196)
// that is far above the card's flops-per-byte line, so the products must
// run on the tensor cores, and the work must not be done twice.
//
// bf16 inputs (the training path) take the tensor-core design:
//   delta  one warp per query row: delta = rowsum(dout·out) in fp32;
//   main   one CTA per (kv row, block of 16·W keys), W warps, each warp
//          owning 16 keys. k and v of the block stay in shared memory as
//          bf16 for the whole CTA; 32-row q and dout tiles of every query
//          head of the GQA group stream through a double-buffered ring of
//          16-byte cp.async copies, the next tile loading while the current
//          one is multiplied. Per tile each warp computes its sᵀ = k·qᵀ and
//          dpᵀ = v·doutᵀ (16 × 32, fp32 accumulators), turns them into pᵀ
//          and dsᵀ in registers, rounds them to bf16 and feeds them straight
//          back as the A operands of dv += pᵀ·dout and dk += dsᵀ·q; dsᵀ also
//          goes to shared memory, where all warps then compute the tile's
//          dq = ds·k. Every product is mma.sync.m16n8k16 bf16 -> fp32 fed by
//          ldmatrix from rows padded by 16 bytes against bank conflicts; the
//          d^-1/2 scale is applied to the fp32 scores and to the dk and dq
//          accumulators. Each product runs once: nothing is recomputed.
//          With t <= 16·W (the towers: W 16 at d 64, so t <= 256) the block
//          holds every key and writes dq itself; longer t splits the keys
//          over CTAs, each writing an fp32 dq partial, and
//   dq_sum sums the partials in key-block order (only rows a block can
//          reach), scales and rounds them.
// No atomics anywhere, so every run gives the same bits; masked-out q tiles
// are skipped, and the ragged tail is zero-filled as it is staged.
// p and ds are rounded to bf16 where they become mma operands, as the plain
// version does for bf16 inputs.
//
// f32 inputs keep the SIMT design (TF32 would not hold the f32 limit):
//   dq     one CTA per (head, 64 query rows) keeps q, dout and the fp32 dq
//          accumulator on chip for the whole sweep over 64-key tiles;
//   dkv    one CTA per (kv row, 64 keys) keeps k, v and the fp32 dk and dv
//          accumulators on chip while it sweeps the query tiles of every
//          query head of its GQA group, the in-kernel counterpart of the
//          reference's repeat of k and v (whose VJP sums over the group).
// Each thread owns 4 rows by 8 columns of a score tile; the row statistics
// come from lse and delta, so no reduction runs inside the tile loop.
// Shared-memory rows are padded by one word against bank conflicts, and
// tiles wholly outside a causal or windowed mask are skipped. The ragged
// tail (s = 196) is masked rather than required to divide a block: rows >= s
// and key columns >= t are zero-filled as they are staged, their p is
// forced to 0, lse and delta are never read past s and nothing is written
// past s or t. Every accumulation is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows per tile
constexpr int kBK = 64;                 // keys per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Whether query row qrow may attend key column kcol (the reference's
// _tile_mask, with the ragged tail of both axes).
__device__ __forceinline__ bool attends(int qrow, int kcol, int S, int Tk,
                                        int causal, int window) {
  bool ok = qrow < S && kcol < Tk;
  if (causal) ok = ok && kcol <= qrow;
  if (window > 0) ok = ok && (qrow - kcol) < window;
  return ok;
}

// Stage rows [r0, r0 + 64) of a (rows, D) slab into fp32 shared memory
// with row stride D + 1, times `mul`; rows >= n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int n, float mul) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const int g = r0 + row;
    dst[row * (D + 1) + col] =
        g < n ? to_f32(src[(size_t)g * D + col]) * mul : 0.f;
  }
}

// delta[row] = sum_d dout[row, d] * out[row, d], one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(g[d]), to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [BQ][D+1]; Ks, Vs [BK][D+1]; Ps [BQ][BK+1]
  return sizeof(float) *
         (size_t)(2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Tk, int group, int bias_group, int causal,
                    int window, float scale) {
  constexpr int RM = kBQ / 16;  // query rows per thread: r + 16 i
  constexpr int CN = kBK / 8;   // key columns per thread: c + 8 j
  constexpr int DN = D / 8;     // dq columns per thread: c + 8 j
  constexpr int QS = D + 1;
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * QS;
  float* Ks = dOs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * QS;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;

  const T* kb = k + (size_t)(bh / group) * Tk * D;
  const T* vb = v + (size_t)(bh / group) * Tk * D;
  const float* brow =
      bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;

  stage<T, D>(Qs, q + (size_t)bh * S * D, q0, S, scale);
  stage<T, D>(dOs, dout + (size_t)bh * S * D, q0, S, 1.f);

  float row_lse[RM], row_delta[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qrow = q0 + r + 16 * i;
    row_lse[i] = qrow < S ? lse[(size_t)bh * S + qrow] : 0.f;
    row_delta[i] = qrow < S ? delta[(size_t)bh * S + qrow] : 0.f;
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
    stage<T, D>(Ks, kb, k0, Tk, 1.f);
    stage<T, D>(Vs, vb, k0, Tk, 1.f);
    __syncthreads();

    // p = exp(q·kᵀ + bias − lse) on the valid entries, 0 elsewhere
    float p[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) p[i][j] = 0.f;
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
        for (int j = 0; j < CN; ++j) p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kcol = k0 + c + 8 * j;
      const float bj = (brow != nullptr && kcol < Tk) ? brow[kcol] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qrow = q0 + r + 16 * i;
        p[i][j] = attends(qrow, kcol, S, Tk, causal, window)
                      ? expf(p[i][j] + bj - row_lse[i])
                      : 0.f;
      }
    }

    // ds = p·(dout·vᵀ − delta), staged for the ds·k product
    float dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float gv[RM], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) gv[i] = dOs[(r + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) vv[j] = Vs[(c + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ps[(r + 16 * i) * PS + c + 8 * j] =
            p[i][j] * (dp[i][j] - row_delta[i]);
    __syncwarp();  // a row of ds is written and read by the same 8 lanes

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[RM], kv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) sv[i] = Ps[(r + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DN; ++j) kv[j] = Ks[kk * QS + c + 8 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qrow = q0 + r + 16 * i;
    if (qrow < S) {
      T* drow = dq + ((size_t)bh * S + qrow) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) store(drow + c + 8 * j, acc[i][j] * scale);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs [BK][D+1]; Qs, dOs [BQ][D+1]; Pt, dSt [BK][BQ+1];
  // lse, delta [BQ]; bias [BK]
  return sizeof(float) * (size_t)(2 * kBK * (D + 1) + 2 * kBQ * (D + 1) +
                                  2 * kBK * (kBQ + 1) + 2 * kBQ + kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int group,
                     int bias_group, int causal, int window, float scale) {
  constexpr int RM = kBK / 16;  // key rows per thread: r + 16 i
  constexpr int CN = kBQ / 8;   // query columns per thread: c + 8 j
  constexpr int DN = D / 8;     // dk/dv columns per thread: c + 8 j
  constexpr int QS = D + 1;
  constexpr int PS = kBQ + 1;

  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * QS;
  float* Qs = Vs + kBK * QS;
  float* dOs = Qs + kBQ * QS;
  float* Pt = dOs + kBQ * QS;
  float* dSt = Pt + kBK * PS;
  float* lse_s = dSt + kBK * PS;
  float* delta_s = lse_s + kBQ;
  float* bias_s = delta_s + kBQ;

  const int kvr = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;

  stage<T, D>(Ks, k + (size_t)kvr * Tk * D, k0, Tk, 1.f);
  stage<T, D>(Vs, v + (size_t)kvr * Tk * D, k0, Tk, 1.f);

  float acc_k[RM][DN], acc_v[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  const int nq = (S + kBQ - 1) / kBQ;
  int qt_lo = 0;
  int qt_hi = nq;
  if (causal) qt_lo = min(nq, k0 / kBQ);
  if (window > 0) qt_hi = min(nq, (k0 + kBK - 1 + window - 1) / kBQ + 1);

  for (int g = 0; g < group; ++g) {
    const int bh = kvr * group + g;
    const T* qb = q + (size_t)bh * S * D;
    const T* gb = dout + (size_t)bh * S * D;
    const float* brow =
        bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(Qs, qb, q0, S, scale);
      stage<T, D>(dOs, gb, q0, S, 1.f);
      if (tid < kBQ) {
        const int qrow = q0 + tid;
        lse_s[tid] = qrow < S ? lse[(size_t)bh * S + qrow] : 0.f;
        delta_s[tid] = qrow < S ? delta[(size_t)bh * S + qrow] : 0.f;
      } else {
        const int kcol = k0 + tid - kBQ;
        bias_s[tid - kBQ] =
            (brow != nullptr && kcol < Tk) ? brow[kcol] : 0.f;
      }
      __syncthreads();

      // pᵀ = exp(k·qᵀ + bias − lse) on the valid entries, 0 elsewhere
      float st[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) st[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RM], qv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) kv[i] = Ks[(r + 16 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) qv[j] = Qs[(c + 8 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kcol = k0 + r + 16 * i;
        const float bi = bias_s[r + 16 * i];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int qrow = q0 + c + 8 * j;
          Pt[(r + 16 * i) * PS + c + 8 * j] =
              attends(qrow, kcol, S, Tk, causal, window)
                  ? expf(st[i][j] + bi - lse_s[c + 8 * j])
                  : 0.f;
        }
      }

      // dsᵀ = pᵀ·(v·doutᵀ − delta)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) st[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float vv[RM], gv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) vv[i] = Vs[(r + 16 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) gv[j] = dOs[(c + 8 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) st[i][j] = fmaf(vv[i], gv[j], st[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int e = (r + 16 * i) * PS + c + 8 * j;
          dSt[e] = Pt[e] * (st[i][j] - delta_s[c + 8 * j]);
        }
      __syncwarp();  // rows of pᵀ and dsᵀ are written and read by 8 lanes

      // dv += pᵀ·dout, dk += dsᵀ·q (q is pre-scaled, so this IS dk)
#pragma unroll 2
      for (int qq = 0; qq < kBQ; ++qq) {
        float pv[RM], sv[RM], gv[DN], qv[DN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = Pt[(r + 16 * i) * PS + qq];
          sv[i] = dSt[(r + 16 * i) * PS + qq];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          gv[j] = dOs[qq * QS + c + 8 * j];
          qv[j] = Qs[qq * QS + c + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int krow = k0 + r + 16 * i;
    if (krow < Tk) {
      T* krow_p = dk + ((size_t)kvr * Tk + krow) * D;
      T* vrow_p = dv + ((size_t)kvr * Tk + krow) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        store(krow_p + c + 8 * j, acc_k[i][j]);
        store(vrow_p + c + 8 * j, acc_v[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core backward
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 32;        // query rows per streamed tile

// Shared-memory layout of the main kernel, in bf16 elements unless noted:
// k, v [BK][D + 8]; q, dout [2 stages][BQ][D + 8]; dsᵀ [BK][BQ + 8]; then
// fp32 lse, delta [2][BQ] and bias [BK].
template <int D, int W>
struct TcLayout {
  static constexpr int BK = 16 * W;
  static constexpr int LD = D + 8;
  static constexpr int LDS = kTcBQ + 8;
  static constexpr size_t kv = (size_t)BK * LD;
  static constexpr size_t qt = (size_t)kTcBQ * LD;
  static constexpr size_t bf16_elems = 2 * kv + 4 * qt + (size_t)BK * LDS;
  static constexpr size_t bytes =
      bf16_elems * 2 + sizeof(float) * (4 * kTcBQ + BK);
};

// Rows [r0, r0 + rows) of an (n, D) bf16 slab into shared rows of stride
// D + 8 with 16-byte cp.async; rows >= n are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void stage_rows_async(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 int r0, int rows, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += NT) {
    const int row = e / CH, ch = e % CH;
    const int g = r0 + row;
    const bool ok = g < n;
    cp_async16(dst + row * (D + 8) + ch * 8,
               src + (size_t)(ok ? g : 0) * D + ch * 8, ok);
  }
}

template <int D, int W>
__global__ void __launch_bounds__(32 * W, 1)
flash_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dq_part, int S, int Tk, int group,
                    int bias_group, int causal, int window, float scale) {
  using L = TcLayout<D, W>;
  constexpr int NT = 32 * W;
  constexpr int BK = L::BK;
  constexpr int BQ = kTcBQ;
  constexpr int LD = L::LD;
  constexpr int LDS = L::LDS;
  constexpr int DN = D / 8;             // n-tiles of d
  constexpr int QN = BQ / 8;            // n-tiles of a q tile
  constexpr int DQ_NT = DN / (W / 2);   // dq n-tiles per warp
  static_assert(W % 2 == 0 && DN % (W / 2) == 0, "dq tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + L::kv;
  __nv_bfloat16* Qs = Vs + L::kv;          // [2][BQ][LD]
  __nv_bfloat16* dOs = Qs + 2 * L::qt;     // [2][BQ][LD]
  __nv_bfloat16* dSt = dOs + 2 * L::qt;    // [BK][LDS]
  float* lse_s = reinterpret_cast<float*>(dSt + (size_t)BK * LDS);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                  // [2][BQ]
  float* bias_s = delta_s + 2 * BQ;                                 // [BK]

  const int kvr = blockIdx.x;
  const int kb = blockIdx.y;
  const int k0 = kb * BK;
  const int nk = min(BK, Tk - k0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;     // mma group id: fragment row
  const int tq = lane & 3;      // thread in group: fragment column pair
  const int lr = lane & 7;      // ldmatrix row within a matrix
  const int lm = lane >> 3;     // ldmatrix matrix index
  const int kw0 = 16 * warp;    // this warp's first key (block-local)
  const bool active = kw0 < nk;
  const bool split = gridDim.y > 1;

  stage_rows_async<D, NT>(Ks, k + (size_t)kvr * Tk * D, k0, BK, Tk);
  stage_rows_async<D, NT>(Vs, v + (size_t)kvr * Tk * D, k0, BK, Tk);
  cp_async_commit();

  // the q tiles this key block can reach
  const int nq = (S + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = nq;
  if (causal) qt_lo = min(nq, k0 / BQ);
  if (window > 0) qt_hi = min(nq, (k0 + nk - 2 + window) / BQ + 1);
  const int per_head = max(0, qt_hi - qt_lo);
  const int items = group * per_head;

  auto prefetch = [&](int item, int st) {
    const int bh = kvr * group + item / per_head;
    const int q0 = (qt_lo + item % per_head) * BQ;
    stage_rows_async<D, NT>(Qs + st * L::qt, q + (size_t)bh * S * D, q0, BQ,
                            S);
    stage_rows_async<D, NT>(dOs + st * L::qt, dout + (size_t)bh * S * D, q0,
                            BQ, S);
    cp_async_commit();
    if (tid < BQ) {
      const int qrow = q0 + tid;
      lse_s[st * BQ + tid] = qrow < S ? lse[(size_t)bh * S + qrow] : 0.f;
      delta_s[st * BQ + tid] = qrow < S ? delta[(size_t)bh * S + qrow] : 0.f;
    }
  };

  float acc_dk[DN][4], acc_dv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  if (items > 0) prefetch(0, 0);

  for (int item = 0; item < items; ++item) {
    const int st = item & 1;
    const int bh = kvr * group + item / per_head;
    const int q0 = (qt_lo + item % per_head) * BQ;
    if (item % per_head == 0) {
      // a new query head: its bias row (the last tile's readers finished
      // at the barrier that ended it)
      const float* brow =
          bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;
      for (int e = tid; e < BK; e += NT) {
        const int kcol = k0 + e;
        bias_s[e] = (brow != nullptr && kcol < Tk) ? brow[kcol] : 0.f;
      }
    }
    if (item + 1 < items) {
      prefetch(item + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* Qt = Qs + st * L::qt;
    const __nv_bfloat16* dOt = dOs + st * L::qt;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;

    if (active) {
      // sᵀ = k·qᵀ and dpᵀ = v·doutᵀ for this warp's 16 keys × BQ queries
      float s_acc[QN][4], p_acc[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] = p_acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ak[4], av[4];
        const int arow = kw0 + (lm & 1) * 8 + lr;
        const int acol = kk * 16 + (lm >> 1) * 8;
        ldsm_x4(ak, Ks + arow * LD + acol);
        ldsm_x4(av, Vs + arow * LD + acol);
#pragma unroll
        for (int np = 0; np < QN / 2; ++np) {
          unsigned bq[4], bo[4];
          const int brow = np * 16 + (lm >> 1) * 8 + lr;
          const int bcol = kk * 16 + (lm & 1) * 8;
          ldsm_x4(bq, Qt + brow * LD + bcol);
          ldsm_x4(bo, dOt + brow * LD + bcol);
          mma16816(s_acc[2 * np], ak, bq[0], bq[1]);
          mma16816(s_acc[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(p_acc[2 * np], av, bo[0], bo[1]);
          mma16816(p_acc[2 * np + 1], av, bo[2], bo[3]);
        }
      }

      // pᵀ and dsᵀ, rounded to bf16 as A fragments; dsᵀ also to shared
      unsigned pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kw0 + gq + (e >> 1) * 8;
          const int ql = 8 * j + 2 * tq + (e & 1);
          const int kcol = k0 + kl, qrow = q0 + ql;
          bool ok = qrow < S && kcol < Tk;
          if (causal) ok = ok && kcol <= qrow;
          if (window > 0) ok = ok && (qrow - kcol) < window;
          pv[e] = ok ? expf(s_acc[j][e] * scale + bias_s[kl] - lse_t[ql])
                     : 0.f;
          dsv[e] = pv[e] * (p_acc[j][e] - delta_t[ql]);
        }
        const unsigned p01 = pack_bf16(pv[0], pv[1]);
        const unsigned p23 = pack_bf16(pv[2], pv[3]);
        const unsigned s01 = pack_bf16(dsv[0], dsv[1]);
        const unsigned s23 = pack_bf16(dsv[2], dsv[3]);
        // C tile j (queries 8j..8j+7) is half of A k-step j / 2
        pa[j >> 1][(j & 1) * 2 + 0] = p01;
        pa[j >> 1][(j & 1) * 2 + 1] = p23;
        sa[j >> 1][(j & 1) * 2 + 0] = s01;
        sa[j >> 1][(j & 1) * 2 + 1] = s23;
        *reinterpret_cast<unsigned*>(dSt + (kw0 + gq) * LDS + 8 * j +
                                     2 * tq) = s01;
        *reinterpret_cast<unsigned*>(dSt + (kw0 + gq + 8) * LDS + 8 * j +
                                     2 * tq) = s23;
      }

      // dv += pᵀ·dout, dk += dsᵀ·q (the contraction runs over the queries)
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          unsigned bo[4], bq[4];
          const int brow = kq * 16 + (lm & 1) * 8 + lr;
          const int bcol = dp * 16 + (lm >> 1) * 8;
          ldsm_x4_t(bo, dOt + brow * LD + bcol);
          ldsm_x4_t(bq, Qt + brow * LD + bcol);
          mma16816(acc_dv[2 * dp], pa[kq], bo[0], bo[1]);
          mma16816(acc_dv[2 * dp + 1], pa[kq], bo[2], bo[3]);
          mma16816(acc_dk[2 * dp], sa[kq], bq[0], bq[1]);
          mma16816(acc_dk[2 * dp + 1], sa[kq], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // dsᵀ of every warp is in shared memory

    // dq (BQ × D) = ds (BQ × nk) · k: warp -> 16 queries × DQ_NT n-tiles
    {
      const int mt = warp & 1;
      const int nt0 = (warp >> 1) * DQ_NT;
      float acc[DQ_NT][4];
#pragma unroll
      for (int j = 0; j < DQ_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const int ksteps = (nk + 15) / 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[4];
        ldsm_x4_t(a, dSt + (ks * 16 + (lm >> 1) * 8 + lr) * LDS + mt * 16 +
                         (lm & 1) * 8);
        const int brow = ks * 16 + (lm & 1) * 8 + lr;
        if constexpr (DQ_NT % 2 == 0) {
#pragma unroll
          for (int j = 0; j < DQ_NT; j += 2) {
            unsigned b[4];
            ldsm_x4_t(b, Ks + brow * LD + (nt0 + j) * 8 + (lm >> 1) * 8);
            mma16816(acc[j], a, b[0], b[1]);
            mma16816(acc[j + 1], a, b[2], b[3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < DQ_NT; ++j) {
            unsigned b[2];
            ldsm_x2_t(b, Ks + brow * LD + (nt0 + j) * 8);
            mma16816(acc[j], a, b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < DQ_NT; ++j) {
        const int col = (nt0 + j) * 8 + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qrow = q0 + mt * 16 + gq + 8 * h;
          if (qrow >= S) continue;
          const size_t off = ((size_t)bh * S + qrow) * D + col;
          if (split) {
            *reinterpret_cast<float2*>(
                dq_part + (size_t)kb * gridDim.x * group * S * D + off) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            *reinterpret_cast<unsigned*>(dq + off) =
                pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
          }
        }
      }
    }
    __syncthreads();   // dsᵀ and this stage are free for the next tile
  }
  cp_async_wait<0>();

  // a single key block writes every dq row: the rows of unreachable q
  // tiles (no key of theirs is attended) are zero
  if (!split) {
    for (int qt = 0; qt < nq; ++qt) {
      if (qt >= qt_lo && qt < qt_hi) continue;
      for (int g = 0; g < group; ++g) {
        const int bh = kvr * group + g;
        for (int e = tid; e < BQ * D; e += NT) {
          const int qrow = qt * BQ + e / D;
          if (qrow < S)
            dq[((size_t)bh * S + qrow) * D + e % D] = __float2bfloat16(0.f);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int krow = k0 + kw0 + gq + 8 * h;
        if (krow >= Tk) continue;
        const size_t off = ((size_t)kvr * Tk + krow) * D + col;
        *reinterpret_cast<unsigned*>(dk + off) =
            pack_bf16(acc_dk[j][2 * h] * scale, acc_dk[j][2 * h + 1] * scale);
        *reinterpret_cast<unsigned*>(dv + off) =
            pack_bf16(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
      }
    }
  }
}

// dq = d^-1/2 · the sum, in key-block order, of the partials of the key
// blocks that hold a key the row attends; one thread per element.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum_kernel(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ dq, int rows, int S,
                        int Tk, int bk, int nkb, int causal, int window,
                        float scale) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (size_t)rows * D) return;
  const int qrow = (int)((idx / D) % S);
  int hi = Tk - 1;
  if (causal) hi = min(hi, qrow);
  const int lo = window > 0 ? max(0, qrow - window + 1) : 0;
  float acc = 0.f;
  if (lo <= hi)
    for (int b = lo / bk; b <= hi / bk && b < nkb; ++b)
      acc += part[(size_t)b * rows * D + idx];
  dq[idx] = __float2bfloat16(acc * scale);
}

template <int D, int W>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* bias, const void* out, const void* dout,
                      const void* lse, void* delta, void* dq, void* dk,
                      void* dv, void* dq_part, int bh, int s, int t,
                      int group, int bias_group, int causal, int window,
                      float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int nkb = (t + 16 * W - 1) / (16 * W);
  if (nkb > 1 && dq_part == nullptr) return cudaErrorInvalidValue;
  const int rows = bh * s;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<bf16, D>
      <<<(rows + rows_per_cta - 1) / rows_per_cta, kThreads, 0, stream>>>(
          static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
          static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem = TcLayout<D, W>::bytes;
  auto kernel = flash_bwd_tc_kernel<D, W>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh / group, nkb), 32 * W, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_part), s, t, group, bias_group, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nkb == 1) return err;
  const size_t n = (size_t)rows * D;
  flash_bwd_dq_sum_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dq_part), static_cast<bf16*>(dq), rows, s, t,
      16 * W, nkb, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the SIMT kernels' launcher
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* out, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk,
                   void* dv, int bh, int s, int t, int group, int bias_group,
                   int causal, int window, float scale,
                   cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(dout);
  const float* b_ = static_cast<const float*>(bias);
  const float* l_ = static_cast<const float*>(lse);
  float* d_ = static_cast<float*>(delta);

  const int rows = bh * s;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<T, D>
      <<<(rows + rows_per_cta - 1) / rows_per_cta, kThreads, 0, stream>>>(
          static_cast<const T*>(out), g_, d_, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = dq_smem_bytes<D>();
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (s + kBQ - 1) / kBQ), kThreads, dq_smem, stream>>>(
          q_, k_, v_, b_, g_, l_, d_, static_cast<T*>(dq), s, t, group,
          bias_group, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dkv_smem = dkv_smem_bytes<D>();
  auto dkv_kernel = flash_bwd_dkv_kernel<T, D>;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh / group, (t + kBK - 1) / kBK), kThreads, dkv_smem,
         stream>>>(q_, k_, v_, b_, g_, l_, d_, static_cast<T*>(dk),
                   static_cast<T*>(dv), s, t, group, bias_group, causal,
                   window, scale);
  return cudaGetLastError();
}

// bf16 key blocks (16 keys per warp) the tensor-core kernel is built for.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* bias, const void* out, const void* dout,
                        const void* lse, void* delta, void* dq, void* dk,
                        void* dv, void* dq_part, int bh, int s, int t, int d,
                        int key_block, int group, int bias_group, int causal,
                        int window, float scale, cudaStream_t stream) {
  if (key_block < 1 || (t + key_block - 1) / key_block > 65535)
    return cudaErrorInvalidValue;
#define REPRO_TC(D, W)                                                      \
  if (d == D && key_block == 16 * W)                                        \
    return launch_tc<D, W>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv, \
                           dq_part, bh, s, t, group, bias_group, causal,     \
                           window, scale, stream);
  REPRO_TC(64, 4)
  REPRO_TC(64, 16)
  REPRO_TC(128, 4)
  REPRO_TC(128, 8)
#undef REPRO_TC
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, const void* out, const void* dout,
                         const void* lse, void* delta, void* dq, void* dk,
                         void* dv, int bh, int s, int t, int d, int group,
                         int bias_group, int causal, int window, float scale,
                         cudaStream_t stream) {
  if (s > 65535 * kBQ || t > 65535 * kBK) return cudaErrorInvalidValue;
  if (d == 64)
    return launch<float, 64>(q, k, v, bias, out, dout, lse, delta, dq, dk,
                             dv, bh, s, t, group, bias_group, causal, window,
                             scale, stream);
  if (d == 128)
    return launch<float, 128>(q, k, v, bias, out, dout, lse, delta, dq, dk,
                              dv, bh, s, t, group, bias_group, causal, window,
                              scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor cores). window
// <= 0: no window. delta is a (bh, s) fp32 scratch the caller allocates.
// bf16 only: key_block is the keys per CTA (64 or 256 at d 64, 64 or 128 at
// d 128; ops.bwd_plan picks it), and dq_part an fp32 scratch of
// ceil(t / key_block) * bh * s * d entries when t > key_block, else unused.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* out,
                               const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               void* dq_part, int dtype, int bh, int s, int t,
                               int d, int key_block, int group,
                               int bias_group, int causal, int window,
                               float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1 ||
      bh % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, bias, out, dout, lse, delta, dq, dk,
                             dv, bh, s, t, d, group, bias_group, causal,
                             window, scale, st);
  if (dtype == 1)
    return (int)dispatch_tc(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                            dq_part, bh, s, t, d, key_block, group,
                            bias_group, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

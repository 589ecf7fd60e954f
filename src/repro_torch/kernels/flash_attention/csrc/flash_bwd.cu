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
// What bounds it on this card: the arithmetic. Per (head, block) it
// recomputes the score tile and does five tile products (q·kᵀ, dout·vᵀ,
// ds·k, dsᵀ·q, pᵀ·dout) over inputs read once per CTA; at the towers'
// shapes (d 64, s = t = 196) that is far above the card's flops-per-byte
// line, and these SIMT loops run on the FMA units in fp32.
//
// What the design does about it: the TPU grid's sequential carries do not
// exist here, so the work is split FlashAttention-2 style into three
// kernels, none of which needs atomics:
//   delta  one warp per query row: delta = rowsum(dout·out) in fp32;
//   dq     one CTA per (head, 64 query rows) keeps q, dout and the fp32 dq
//          accumulator on chip for the whole sweep over 64-key tiles;
//   dkv    one CTA per (kv row, 64 keys) keeps k, v and the fp32 dk and dv
//          accumulators on chip while it sweeps the query tiles of every
//          query head of its GQA group, the in-kernel counterpart of the
//          reference's repeat of k and v (whose VJP sums over the group).
// Nothing of the (s, t) matrices reaches device memory. Each thread owns 4
// rows by 8 columns of a score tile; the row statistics come from lse and
// delta, so no reduction runs inside the tile loop. Shared-memory rows are
// padded by one word against bank conflicts, and tiles wholly
// outside a causal or windowed mask are skipped. The ragged tail (s = 196)
// is masked rather than required to divide a block: rows >= s and key
// columns >= t are zero-filled as they are staged, their p is forced to 0,
// lse and delta are never read past s and nothing is written past s or t.
// Inputs are f32 or bf16, converted to fp32 as they are staged; every
// accumulation is fp32. A simple kernel first: wgmma, TMA and pipelining
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, const void* out, const void* dout,
                     const void* lse, void* delta, void* dq, void* dk,
                     void* dv, int bh, int s, int t, int d, int group,
                     int bias_group, int causal, int window, float scale,
                     cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                         bh, s, t, group, bias_group, causal, window, scale,
                         stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                          bh, s, t, group, bias_group, causal, window, scale,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. delta is a
// (bh, s) fp32 scratch the caller allocates. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* out,
                               const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               int dtype, int bh, int s, int t, int d,
                               int group, int bias_group, int causal,
                               int window, float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1 ||
      bh % group != 0 || s > 65535 * kBQ || t > 65535 * kBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, bias, out, dout, lse, delta, dq, dk,
                                dv, bh, s, t, d, group, bias_group, causal,
                                window, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, bias, out, dout, lse, delta,
                                        dq, dk, dv, bh, s, t, d, group,
                                        bias_group, causal, window, scale,
                                        st);
  return (int)cudaErrorInvalidValue;
}

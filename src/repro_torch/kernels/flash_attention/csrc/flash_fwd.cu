// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/flash_attention/kernel.py, flash_fwd_bh (:97) and
// its body _fwd_kernel (:52), the TPU's online-softmax forward. Same
// function: out = softmax(q·kᵀ·d^-1/2 + bias + mask)·v and the per-row
// lse = m + log(l), with causal, sliding-window or bidirectional masks, an
// optional additive key bias, the additive NEG_INF = -1e30 convention and
// the max(l, 1e-30) guard.
//
// What bounds it on this card: the arithmetic. Per (head, query block) it
// does 4·BQ·t·d flops on BQ·d + 2·t·d inputs; at the towers' shapes (d 64,
// s = t = 196) that is far above the card's flops-per-byte line, and in
// fp32 (the 'f32' precision policy) the FMA units, not the tensor cores,
// set the pace.
//
// What the design does about it: one CTA per (head, block of 64 query
// rows) keeps its q block, the running max/sum and the fp32 accumulator on
// chip for the whole sweep over key tiles staged in shared memory, so
// nothing of the (s, t) score matrix reaches device memory and q, k, v are
// read from it once per CTA. Each thread owns 4 query rows by 8 key
// columns of the score tile and the same rows by d/8 output columns, so
// the row statistics never leave its registers and the row reductions are
// three shuffles among 8 lanes. Unlike the TPU kernel, the ragged tail
// (s = 196) is masked rather than required to divide the block, rows >= s
// are never written, and each query head reads its kv head (row / group)
// in place of a repeat of k and v. Key tiles wholly outside a causal or
// windowed mask are skipped. Inputs are f32 or bf16, converted to fp32 as
// they are staged; accumulation is fp32 throughout. A simple kernel first:
// wgmma, TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per staged tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1]
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) +
                                  kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int S, int Tk,
                 int group, int bias_group, int causal, int window,
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

  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)(bh / group) * Tk * D;
  const T* vb = v + (size_t)(bh / group) * Tk * D;
  const float* brow =
      bias != nullptr ? bias + (size_t)(bh / bias_group) * Tk : nullptr;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const int qrow = q0 + row;
    Qs[row * QS + col] =
        qrow < S ? to_f32(qb[(size_t)qrow * D + col]) * scale : 0.f;
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
      Ks[row * QS + col] = ok ? to_f32(kb[(size_t)krow * D + col]) : 0.f;
      Vs[row * D + col] = ok ? to_f32(vb[(size_t)krow * D + col]) : 0.f;
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
      T* orow = out + ((size_t)bh * S + qrow) * D;
#pragma unroll
      for (int j = 0; j < DN; ++j) store(orow + c + 8 * j, acc[i][j] / lc);
      if (c == 0) lse[(size_t)bh * S + qrow] = m[i] + logf(lc);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int bh, int s,
                   int t, int group, int bias_group, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), s, t, group,
      bias_group, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, void* out, void* lse, int bh, int s,
                     int t, int d, int group, int bias_group, int causal,
                     int window, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, bias, out, lse, bh, s, t, group,
                         bias_group, causal, window, scale, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, bias, out, lse, bh, s, t, group,
                          bias_group, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* lse,
                               int dtype, int bh, int s, int t, int d,
                               int group, int bias_group, int causal,
                               int window, float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1 ||
      s > 65535 * kBQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, bias, out, lse, bh, s, t, d, group,
                          bias_group, causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, bias, out, lse, bh, s, t, d,
                                  group, bias_group, causal, window, scale,
                                  st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

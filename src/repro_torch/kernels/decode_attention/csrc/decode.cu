// Single-token GQA decode attention over a KV cache for Hopper (sm_90a),
// split over the cache length; plain C interface.
//
// Replaces: repro/kernels/decode_attention/kernel.py, decode_attention_bkv
// (:72) and its body _decode_kernel (:32). Same function: per (batch, kv
// head) row, the g query heads of the GQA group attend over the row's
// cache of t keys under a per-key validity mask, out = softmax(q·kᵀ·d^-1/2
// masked)·v in fp32, with NEG_INF = -1e30 scores and p set to exactly 0 at
// masked keys, and a max(l, 1e-30) guard so that a row with no valid key
// gives exact zeros. The output is in q's dtype.
//
// What bounds it on this card: device-memory bandwidth. Each row reads
// its t keys and values once and does 4·g·d flops per key, about g/2
// flops per byte in bf16 (2 at g = 4), far below the card's ~295 flops per
// byte, so the time is the bytes of the cache sweep over 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks the cache in order
// along its grid's inner axis, one row at a time. Here the sweep is split
// over the cache length (split-K, "flash decoding"): one CTA per (row,
// chunk of keys, group of up to GP query heads), so that 8 slots × 8 kv
// heads (64 rows) or a single request (8 rows) still fill the 132 SMs.
// Each CTA stages its row's query heads (pre-scaled by d^-1/2) once,
// streams its chunk through shared memory in tiles of 128 keys with
// 16-byte coalesced loads, keys and values once for all heads of the GQA
// group, and keeps an fp32 online softmax (m, l, acc[g][d]). It writes the
// partial (m, l, acc); a second kernel merges each row's partials in chunk
// order, with no atomics, so a result is the same on every run. The
// number of chunks is chosen by the wrapper from t alone, never from the
// batch or the mask, so a row's result does not depend on its batch and a
// (b, t) mask with equal rows gives the shared-mask result bit for bit.
// The ragged tail of t is masked and never read. Inputs are f32 or bf16
// (one dtype), converted to fp32 as they are staged. A simple kernel
// first: skipping chunks that the mask kills, TMA and a bf16 mma for the
// g×d products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTK = 128;                // keys per staged tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kTK, "the score phase gives each thread one key");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T at p (16-byte aligned) as fp32
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int D, int GP>
constexpr size_t smem_bytes() {
  // Qs [GP][D], Ks [TK][D+1], Vs [TK][D], Ps [GP][TK],
  // Red [PARTS-1][GP][D], Stat [3][GP], then Ok [TK] ints
  constexpr int parts = kThreads / D;
  return sizeof(float) * (size_t)(GP * D + kTK * (D + 1) + kTK * D +
                                  GP * kTK + (parts - 1) * GP * D + 3 * GP) +
         sizeof(int) * kTK;
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int G, int Tk,
                    int chunk_len, int n_chunks, int mask_div, float scale) {
  constexpr int KS = D + 1;                   // padded: no bank conflicts
  constexpr int EPV = 16 / (int)sizeof(T);    // elements per 16 bytes
  constexpr int VPR = D / EPV;                // 16-byte vectors per row
  constexpr int PARTS = kThreads / D;         // key partitions in p·v
  constexpr int KPT = kTK / 32;               // keys per lane in a row op
  constexpr int KPP = kTK / PARTS;            // keys per p·v partition

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + GP * D;
  float* Vs = Ks + kTK * KS;
  float* Ps = Vs + kTK * D;
  float* Red = Ps + GP * kTK;
  float* Stat = Red + (PARTS - 1) * GP * D;   // m, l, alpha per head
  int* Ok = reinterpret_cast<int*>(Stat + 3 * GP);

  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int h0 = blockIdx.z * GP;
  const int gn = min(GP, G - h0);
  const int tid = threadIdx.x;
  const int j0 = chunk * chunk_len;
  const int j1 = min(j0 + chunk_len, Tk);
  const unsigned char* vmask =
      valid + (mask_div > 0 ? (size_t)(row / mask_div) * Tk : 0);
  const T* krow = k + (size_t)row * Tk * D;
  const T* vrow = v + (size_t)row * Tk * D;

  for (int e = tid; e < GP * D; e += kThreads) {
    const int gi = e / D;
    Qs[e] = gi < gn ? to_f32(q[((size_t)row * G + h0 + gi) * D + e % D]) *
                          scale
                    : 0.f;
  }
  if (tid < GP) {
    Stat[tid] = kNegInf;
    Stat[GP + tid] = 0.f;
    Stat[2 * GP + tid] = 1.f;
  }
  const int c = tid % D;      // output column of this thread in p·v
  const int part = tid / D;   // its key partition in p·v
  float acc[GP];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) acc[gi] = 0.f;
  __syncthreads();

  for (int jt = j0; jt < j1; jt += kTK) {
    const int nt = min(kTK, j1 - jt);
    // 1. stage the key and value tiles as fp32 (rows past the tail: 0)
    for (int e = tid; e < kTK * VPR; e += kThreads) {
      const int r = e / VPR;
      const int col = (e % VPR) * EPV;
      float kx[EPV], vx[EPV];
      if (r < nt) {
        load16(krow + (size_t)(jt + r) * D + col, kx);
        load16(vrow + (size_t)(jt + r) * D + col, vx);
      } else {
#pragma unroll
        for (int i = 0; i < EPV; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < EPV; ++i) Ks[r * KS + col + i] = kx[i];
#pragma unroll
      for (int i = 0; i < EPV; i += 4)
        *reinterpret_cast<float4*>(Vs + r * D + col + i) =
            make_float4(vx[i], vx[i + 1], vx[i + 2], vx[i + 3]);
    }
    __syncthreads();
    // 2. scores: this thread owns key jt + tid, for every head
    {
      float s[GP];
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) s[gi] = 0.f;
      const float* kr = Ks + tid * KS;
#pragma unroll 4
      for (int dd = 0; dd < D; dd += 4) {
        const float k0 = kr[dd], k1 = kr[dd + 1], k2 = kr[dd + 2],
                    k3 = kr[dd + 3];
#pragma unroll
        for (int gi = 0; gi < GP; ++gi) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + gi * D + dd);
          s[gi] = fmaf(qv.x, k0, s[gi]);
          s[gi] = fmaf(qv.y, k1, s[gi]);
          s[gi] = fmaf(qv.z, k2, s[gi]);
          s[gi] = fmaf(qv.w, k3, s[gi]);
        }
      }
      const int ok = (tid < nt && vmask[jt + tid] != 0) ? 1 : 0;
      Ok[tid] = ok;
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) Ps[gi * kTK + tid] = ok ? s[gi] : kNegInf;
    }
    __syncthreads();
    // 3. online-softmax statistics, one warp per head: p is set to 0 at
    //    masked keys explicitly (a tile with no valid key while m is still
    //    NEG_INF would otherwise give exp(0) = 1)
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int gi = warp; gi < gn; gi += kThreads / 32) {
        float sv[KPT];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          sv[i] = Ps[gi * kTK + lane + 32 * i];
          mx = fmaxf(mx, sv[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_old = Stat[gi];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int j = lane + 32 * i;
          const float p = Ok[j] ? expf(sv[i] - m_new) : 0.f;
          Ps[gi * kTK + j] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          Stat[2 * GP + gi] = alpha;
          Stat[GP + gi] = Stat[GP + gi] * alpha + sum;
          Stat[gi] = m_new;
        }
      }
    }
    __syncthreads();
    // 4. acc = acc·alpha + p·v over this thread's keys of the tile, four
    //    at a time (p = 0 and v = 0 on rows past the tail, so the whole
    //    partition is summed)
#pragma unroll
    for (int gi = 0; gi < GP; ++gi) acc[gi] *= Stat[2 * GP + gi];
#pragma unroll 4
    for (int j = part * KPP; j < (part + 1) * KPP; j += 4) {
      const float v0 = Vs[j * D + c], v1 = Vs[(j + 1) * D + c],
                  v2 = Vs[(j + 2) * D + c], v3 = Vs[(j + 3) * D + c];
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + gi * kTK + j);
        acc[gi] = fmaf(p.x, v0, acc[gi]);
        acc[gi] = fmaf(p.y, v1, acc[gi]);
        acc[gi] = fmaf(p.z, v2, acc[gi]);
        acc[gi] = fmaf(p.w, v3, acc[gi]);
      }
    }
    __syncthreads();
  }

  // 5. sum the key partitions, write the chunk's partial (m, l, acc)
  if (PARTS > 1) {
    if (part > 0) {
#pragma unroll
      for (int gi = 0; gi < GP; ++gi)
        Red[((part - 1) * GP + gi) * D + c] = acc[gi];
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < PARTS; ++p) {
#pragma unroll
        for (int gi = 0; gi < GP; ++gi) acc[gi] += Red[((p - 1) * GP + gi) * D + c];
      }
    }
  }
  if (part == 0) {
#pragma unroll
    for (int gi = 0; gi < GP; ++gi) {
      if (gi < gn)
        part_acc[(((size_t)row * G + h0 + gi) * n_chunks + chunk) * D + c] =
            acc[gi];
    }
  }
  if (tid < gn) {
    const size_t o = ((size_t)row * G + h0 + tid) * n_chunks + chunk;
    part_m[o] = Stat[tid];
    part_l[o] = Stat[GP + tid];
  }
}

// One CTA per (row, head), one thread per output column: merges the
// row's chunk partials in chunk order. All chunks empty: M = NEG_INF,
// every weight exp(0) = 1 times l = 0 and acc = 0, so the output is 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    int G, int n_chunks) {
  const int row = blockIdx.x;
  const int gi = blockIdx.y;
  const int c = threadIdx.x;
  const size_t base = ((size_t)row * G + gi) * n_chunks;
  float M = kNegInf;
  for (int ch = 0; ch < n_chunks; ++ch) M = fmaxf(M, part_m[base + ch]);
  float L = 0.f, a = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const float w = expf(part_m[base + ch] - M);
    L = fmaf(part_l[base + ch], w, L);
    a = fmaf(part_acc[(base + ch) * D + c], w, a);
  }
  store(out + ((size_t)row * G + gi) * D + c, a / fmaxf(L, 1e-30f));
}

template <typename T, int D, int GP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, void* part_m, void* part_l,
                   void* part_acc, int bkv, int g, int t, int mask_div,
                   int chunk_len, int n_chunks, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, GP>();
  auto split = decode_split_kernel<T, D, GP>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bkv, n_chunks, (g + GP - 1) / GP);
  split<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), g, t, chunk_len, n_chunks, mask_div,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(bkv, g), D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), g,
      n_chunks);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const void* valid, void* out, void* part_m,
                           void* part_l, void* part_acc, int bkv, int g,
                           int t, int mask_div, int chunk_len, int n_chunks,
                           float scale, cudaStream_t stream) {
  if (g <= 4)
    return launch<T, D, 4>(q, k, v, valid, out, part_m, part_l, part_acc,
                           bkv, g, t, mask_div, chunk_len, n_chunks, scale,
                           stream);
  return launch<T, D, 16>(q, k, v, valid, out, part_m, part_l, part_acc,
                          bkv, g, t, mask_div, chunk_len, n_chunks, scale,
                          stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* valid, void* out, void* part_m, void* part_l,
                     void* part_acc, int bkv, int g, int t, int d,
                     int mask_div, int chunk_len, int n_chunks, float scale,
                     cudaStream_t stream) {
  if (d == 64)
    return dispatch_group<T, 64>(q, k, v, valid, out, part_m, part_l,
                                 part_acc, bkv, g, t, mask_div, chunk_len,
                                 n_chunks, scale, stream);
  if (d == 128)
    return dispatch_group<T, 128>(q, k, v, valid, out, part_m, part_l,
                                  part_acc, bkv, g, t, mask_div, chunk_len,
                                  n_chunks, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (bkv, g, d); k/v (bkv, t, d); valid: bool bytes, one row of t shared
// by every cache row (mask_div = 0) or one row per group of mask_div
// consecutive cache rows (row r reads mask row r / mask_div); out
// (bkv, g, d) in q's dtype; part_m/part_l (bkv, g, n_chunks) and part_acc
// (bkv, g, n_chunks, d) fp32 scratch. Keys [c·chunk_len, (c+1)·chunk_len)
// go to chunk c. dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, void* part_m, void* part_l,
                                      void* part_acc, int dtype, int bkv,
                                      int g, int t, int d, int mask_div,
                                      int chunk_len, int n_chunks,
                                      float scale, void* stream) {
  if (bkv < 1 || g < 1 || t < 1 || mask_div < 0 || chunk_len < 1 ||
      n_chunks != (t + chunk_len - 1) / chunk_len || n_chunks > 65535 ||
      (g + 15) / 16 > 65535 || g > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, valid, out, part_m, part_l, part_acc, bkv,
                          g, t, d, mask_div, chunk_len, n_chunks, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, valid, out, part_m, part_l,
                                  part_acc, bkv, g, t, d, mask_div, chunk_len,
                                  n_chunks, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

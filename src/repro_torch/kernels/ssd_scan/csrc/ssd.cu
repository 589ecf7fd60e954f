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
// Mamba-2-130M's p 64, n 128 that is hundreds of flops per byte, above the
// fp32 FMA units' ~20. This kernel does more: per 64-token sub-chunk and
// 16 columns it computes the whole 64 × 64 C·Bᵀ tile (the largest term).
//
// What the design does about it:
// - Shared memory. The TPU works on a 256-token chunk at a time: its L (256
//   KB in fp32) and its B and C chunks (128 KB each) do not fit in an SM's
//   227 KB. This kernel scans in sub-chunks of its own size, kQ = 64 tokens,
//   and carries the state between them; the result depends on the chunk
//   length only by rounding. A sub-chunk's B and C (64 × n), its 64 × 64
//   score tile and the (16 × n) state of its columns stay in shared memory
//   (106 KB at n 128, two CTAs per SM).
// - Too few CTAs. A (batch, head) grid is 24 CTAs for one prompt. Output
//   columns and state rows are independent across head_dim, so the grid is
//   (batch·head, p / 16): 96 CTAs for one Mamba-2-130M prompt. Each CTA
//   recomputes its sub-chunk's C·Bᵀ (the largest term); computing it once per
//   (batch, sub-chunk) for all heads is later work, as are tensor cores.
// - Masked exps. L is evaluated only at j <= i, where cum_i − cum_j <= 0;
//   above the diagonal nothing is evaluated (the TPU kernel takes exp first
//   and masks after, which overflows to inf at fast decay; a 0/1 mask would
//   then give NaN).
// - Ragged chunks. Rows past the sequence's end are staged as zeros with
//   dt = 0, so they add nothing to the state and leave cum unchanged; their
//   outputs are not written.
// - Layout. x (b, l, h, p) and dt (b, l, h) are read in place through their
//   batch, token and head strides (the mixer's split views, no copy), B and
//   C through batch and token strides; y is written as (b, l, h, p).
// Inputs x, B, C are f32 or bf16 (one dtype); dt, A, D and the states are
// fp32; y is fp32. Everything accumulates in fp32 with no atomic adds, so
// a result is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;            // tokens per sub-chunk
constexpr int kPB = 16;           // head_dim columns per CTA
constexpr int kSS = kQ + 4;       // score tile row stride (floats)
constexpr int kMaxN = 256;        // largest state size
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 4 * kQ, "the output phase gives each row 4 threads");
static_assert(kThreads / 16 * 4 == kQ, "the score phase tiles 64 x 64");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// B, C [kQ][n + 4], scores [kQ][kSS], x, dt·x, decayed dt·x [kQ][kPB],
// state [kPB][n + 4], dt and cum [kQ]
size_t smem_bytes(int n) {
  const int ns = n + 4;
  return sizeof(float) *
         (size_t)(2 * kQ * ns + kQ * kSS + 3 * kQ * kPB + kPB * ns + 2 * kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ init_state, float* __restrict__ y,
                float* __restrict__ final_state, int L, int H, int P, int N,
                long long xs_b, long long xs_t, long long xs_h,
                long long dts_b, long long dts_t, long long bs_b,
                long long bs_t, long long cs_b, long long cs_t) {
  extern __shared__ __align__(16) float smem[];
  const int NS = N + 4;
  float* Bs = smem;
  float* Cs = Bs + kQ * NS;
  float* Sc = Cs + kQ * NS;
  float* Xr = Sc + kQ * kSS;
  float* Xd = Xr + kQ * kPB;
  float* Xw = Xd + kQ * kPB;
  float* St = Xw + kQ * kPB;
  float* dts = St + kPB * NS;
  float* cum = dts + kQ;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H;
  const int hi = blockIdx.x % H;
  const int p0 = blockIdx.y * kPB;
  const float a = A[hi];
  const float dd = D != nullptr ? D[hi] : 0.f;
  const T* xb = x + bi * xs_b + hi * xs_h + p0;
  const float* dtb = dt + bi * dts_b + hi;
  const T* bb = Bm + bi * bs_b;
  const T* cb = Cm + bi * cs_b;
  const size_t state0 = (((size_t)bi * H + hi) * P + p0) * N;

  for (int e = tid; e < kPB * N; e += kThreads) {
    const int pp = e / N, k = e % N;
    St[pp * NS + k] = init_state != nullptr ? init_state[state0 + e] : 0.f;
  }

  // thread roles: score tile rows ig + 16·r, columns jg + 16·c; output row
  // orow, columns 4·oq..4·oq+3; state columns 2·sg, 2·sg+1 at k = 4·lane
  const int ig = tid / 16, jg = tid % 16;
  const int orow = tid / 4, oq = tid % 4;
  const int sg = tid / 32, lane = tid % 32;

  for (int t0 = 0; t0 < L; t0 += kQ) {
    const int nt = min(kQ, L - t0);
    // 1. stage B, C, x and dt as fp32 (rows past the end: 0)
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int r = e / N, k = e % N;
      float bv = 0.f, cv = 0.f;
      if (r < nt) {
        bv = to_f32(bb[(t0 + r) * bs_t + k]);
        cv = to_f32(cb[(t0 + r) * cs_t + k]);
      }
      Bs[r * NS + k] = bv;
      Cs[r * NS + k] = cv;
    }
    for (int e = tid; e < kQ * kPB; e += kThreads) {
      const int r = e / kPB, c = e % kPB;
      Xr[e] = r < nt ? to_f32(xb[(t0 + r) * xs_t + c]) : 0.f;
    }
    if (tid < kQ) dts[tid] = tid < nt ? dtb[(t0 + tid) * dts_t] : 0.f;
    __syncthreads();

    // 2. cum = inclusive running sum of dt·A (warp 0, two tokens a lane);
    //    dt·x for everyone else
    if (tid < 32) {
      const float v0 = dts[2 * tid] * a, v1 = dts[2 * tid + 1] * a;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, s, off);
        if (tid >= off) s += o;
      }
      float before = __shfl_up_sync(kFull, s, 1);
      if (tid == 0) before = 0.f;
      cum[2 * tid] = before + v0;
      cum[2 * tid + 1] = s;
    }
    for (int e = tid; e < kQ * kPB; e += kThreads) Xd[e] = Xr[e] * dts[e / kPB];
    __syncthreads();

    // 3. scores[i][j] = (C_i · B_j)·exp(cum_i − cum_j) for j <= i, else 0;
    //    dt·x decayed to the sub-chunk's end for the state update
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < N; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(Cs + (ig + 16 * r) * NS + k);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(Bs + (jg + 16 * c) * NS + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ig + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = jg + 16 * c;
          Sc[i * kSS + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    const float last = cum[kQ - 1];
    for (int e = tid; e < kQ * kPB; e += kThreads)
      Xw[e] = Xd[e] * expf(last - cum[e / kPB]);
    __syncthreads();

    // 4. y = scores·(dt·x) + exp(cum)·C·stateᵀ + D·x for this thread's row
    {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j <= orow; ++j) {
        const float s = Sc[orow * kSS + j];
        const float4 xv = *reinterpret_cast<const float4*>(Xd + j * kPB + 4 * oq);
        o[0] = fmaf(s, xv.x, o[0]);
        o[1] = fmaf(s, xv.y, o[1]);
        o[2] = fmaf(s, xv.z, o[2]);
        o[3] = fmaf(s, xv.w, o[3]);
      }
      float in[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < N; k += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(Cs + orow * NS + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          in[r] = dot4(cv, *reinterpret_cast<const float4*>(
                               St + (4 * oq + r) * NS + k), in[r]);
      }
      if (orow < nt) {
        const float e = expf(cum[orow]);
        float4 out;
        out.x = fmaf(e, in[0], o[0]) + dd * Xr[orow * kPB + 4 * oq];
        out.y = fmaf(e, in[1], o[1]) + dd * Xr[orow * kPB + 4 * oq + 1];
        out.z = fmaf(e, in[2], o[2]) + dd * Xr[orow * kPB + 4 * oq + 2];
        out.w = fmaf(e, in[3], o[3]) + dd * Xr[orow * kPB + 4 * oq + 3];
        *reinterpret_cast<float4*>(
            y + (((size_t)bi * L + t0 + orow) * H + hi) * P + p0 + 4 * oq) = out;
      }
    }
    __syncthreads();

    // 5. state ← exp(cum[-1])·state + (decayed dt·x)ᵀ·B over the real rows
    {
      const float dec = expf(last);
      for (int k = 4 * lane; k < N; k += 128) {
        float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
        for (int j = 0; j < nt; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * NS + k);
          const float2 w = *reinterpret_cast<const float2*>(Xw + j * kPB + 2 * sg);
          s0.x = fmaf(w.x, bv.x, s0.x);
          s0.y = fmaf(w.x, bv.y, s0.y);
          s0.z = fmaf(w.x, bv.z, s0.z);
          s0.w = fmaf(w.x, bv.w, s0.w);
          s1.x = fmaf(w.y, bv.x, s1.x);
          s1.y = fmaf(w.y, bv.y, s1.y);
          s1.z = fmaf(w.y, bv.z, s1.z);
          s1.w = fmaf(w.y, bv.w, s1.w);
        }
        float4* r0 = reinterpret_cast<float4*>(St + (2 * sg) * NS + k);
        float4* r1 = reinterpret_cast<float4*>(St + (2 * sg + 1) * NS + k);
        const float4 o0 = *r0, o1 = *r1;
        *r0 = make_float4(fmaf(dec, o0.x, s0.x), fmaf(dec, o0.y, s0.y),
                          fmaf(dec, o0.z, s0.z), fmaf(dec, o0.w, s0.w));
        *r1 = make_float4(fmaf(dec, o1.x, s1.x), fmaf(dec, o1.y, s1.y),
                          fmaf(dec, o1.z, s1.z), fmaf(dec, o1.w, s1.w));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < kPB * N; e += kThreads)
    final_state[state0 + e] = St[(e / N) * NS + e % N];
}

// The dynamic shared-memory limit is raised to the largest n's need once
// per device and kernel instance, not on every launch (a prefill launches
// once per layer).
constexpr int kMaxDevices = 64;

template <typename T>
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
                             (int)smem_bytes(kMaxN));
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* init_state, void* y, void* final_state, int b,
                   int l, int h, int p, int n, long long xs_b, long long xs_t,
                   long long xs_h, long long dts_b, long long dts_t,
                   long long bs_b, long long bs_t, long long cs_b,
                   long long cs_t, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = allow_smem(kernel, allowed<T>());
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n);
  const dim3 grid(b * h, p / kPB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init_state), static_cast<float*>(y),
      static_cast<float*>(final_state), l, h, p, n, xs_b, xs_t, xs_h, dts_b,
      dts_t, bs_b, bs_t, cs_b, cs_t);
  return cudaGetLastError();
}

}  // namespace

// x (b, l, h, p) with element strides (xs_b, xs_t, xs_h, 1); dt (b, l, h)
// fp32 with strides (dts_b, dts_t, 1); A, D (h,) fp32 (D may be null:
// zeros); Bm, Cm (b, l, n) with strides (bs_b, bs_t, 1), (cs_b, cs_t, 1);
// init_state (b, h, p, n) fp32 contiguous or null (zeros); y (b, l, h, p)
// and final_state (b, h, p, n) fp32 contiguous. x, Bm, Cm share a dtype:
// 0 = float32, 1 = bfloat16. Needs p % 16 == 0, n % 4 == 0, n <= 256, and
// 16-byte aligned y. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* init_state, void* y,
                              void* final_state, int dtype, int b, int l,
                              int h, int p, int n, long long xs_b,
                              long long xs_t, long long xs_h, long long dts_b,
                              long long dts_t, long long bs_b, long long bs_t,
                              long long cs_b, long long cs_t, void* stream) {
  if (b < 1 || l < 1 || h < 1 || p < kPB || p % kPB != 0 || n < 4 ||
      n % 4 != 0 || n > kMaxN || (long long)b * h > 2147483647LL ||
      p / kPB > 65535 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, dt, A, Bm, Cm, D, init_state, y, final_state, b, l,
                        h, p, n, xs_b, xs_t, xs_h, dts_b, dts_t, bs_b, bs_t,
                        cs_b, cs_t, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, init_state, y,
                                final_state, b, l, h, p, n, xs_b, xs_t, xs_h,
                                dts_b, dts_t, bs_b, bs_t, cs_b, cs_t, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

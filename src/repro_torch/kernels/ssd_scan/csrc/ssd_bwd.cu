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
// and d(init) is the R that leaves the first sub-chunk backwards.
//
// What bounds it on this card: operations. Per token and head it does ~16
// products of 64 × (n or p) work (about 8·(2n + p)·64 flops at its best),
// against a few hundred bytes in and out.
//
// The design is the simple one; a redesign on the tensor cores is queued
// (ROADMAP.md Queue 2). The sequence's one dependent chain, R, is cut out
// of the main work: four launches, in order on the stream,
//  1. ssd_bwd_local_kernel, one CTA per (sub-chunk, batch·head, p-block):
//     Σ_j exp(cs_j)·dy_j ⊗ C_j and the sub-chunk's log-decay cs_last;
//  2. ssd_bwd_carry_kernel, one thread per (batch, head, p, n): the R
//     entering each sub-chunk from its end, in place, and d(init);
//  3. ssd_bwd_main_kernel, one CTA per (sub-chunk, batch·head, p-block),
//     every sub-chunk at once: all of the above from S0 and R, with dx
//     written in the input dtype and fp32 partials of what sums over heads,
//     p-blocks or the sequence (dB, dC by head and p-block; ddt by p-block;
//     dA, dD by CTA);
//  4. ssd_bwd_sum_kernel (five launches): each partial summed in a fixed
//     order into dB, dC (input dtype), ddt, dA, dD (fp32).
// Every product is an fp32 register-tiled loop over shared memory (a
// thread owns 4 × 4 outputs spread 1/4 of the tile apart, and the odd row
// strides keep a warp's loads free of bank conflicts). No float atomics:
// every sum runs in a fixed order, so two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;              // tokens per sub-chunk (ssd.cu's kQ)
constexpr int kLdQ = kQ + 1;        // row stride of the (kQ × kQ) planes
constexpr int kMaxN = 256;
constexpr int kMaxSmem = 232448;    // an H100 CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

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

// Shared floats of the main kernel: B, C [kQ][n + 1]; x, dy, u and a
// scratch plane [kQ][pb + 1]; one state [pb][n + 1] (R, then S0); W, V and
// V ⊙ C·Bᵀ [kQ][kQ + 1]; 7 vectors [kQ]; 32 for a block reduction.
__host__ __device__ inline size_t main_floats(int pb, int n) {
  return (size_t)2 * kQ * (n + 1) + (size_t)4 * kQ * (pb + 1) +
         (size_t)pb * (n + 1) + (size_t)3 * kQ * kLdQ + 7 * kQ + 32;
}
// The local kernel's: C [kQ][n + 1], exp(cs)·dy [kQ][pb + 1], dt and cs.
__host__ __device__ inline size_t local_floats(int pb, int n) {
  return (size_t)kQ * (n + 1) + (size_t)kQ * (pb + 1) + 2 * kQ;
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
  float* r;                  // (b, h, nsub, P, N): the R entering each
  float* glog;               // (b, h, nsub): each sub-chunk's cs_last
  float* dinit;              // (b, h, P, N) or null
  float* dbp;                // (h · npb, b, l, N) partials
  float* dcp;                // (h · npb, b, l, N)
  float* ddtp;               // (npb, b, l, h)
  float* dap;                // (b, nsub, npb, h)
  float* ddp;                // (b, nsub, npb, h)
  int B, L, H, P, N, PB, nsub;
  long long xs_b, xs_t, xs_h, dts_b, dts_t, bs_b, bs_t, cs_b, cs_t;
};

// out(i, j) = Σ_k a1(i, k)·b1(k, j) over k < K1, then + Σ_k a2(i, k)·b2(k,
// j) over k < K2, each in increasing k, for i < M and j < NN (multiples of
// 4); epi(i, j, value) takes each result. A thread's 16 outputs are rows
// i0 + r·M/4 and columns j0 + c·NN/4 (r, c < 4), so a warp's lanes read
// neighbouring rows or columns.
template <class A1, class B1, class A2, class B2, class E>
__device__ __forceinline__ void gemm(int M, int NN, int K1, A1 a1, B1 b1,
                                     int K2, A2 a2, B2 b2, E epi) {
  const int rs = M / 4, cs = NN / 4;
  for (int e = threadIdx.x; e < rs * cs; e += kThreads) {
    const int i0 = e / cs, j0 = e % cs;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K1; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = a1(i0 + r * rs, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b1(k, j0 + c * cs);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll 4
    for (int k = 0; k < K2; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = a2(i0 + r * rs, k);
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b2(k, j0 + c * cs);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(i0 + r * rs, j0 + c * cs, acc[r][c]);
  }
}

struct Zero {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// cs = inclusive running sum of dt·a over the sub-chunk (warp 0, two tokens
// a lane), as ssd.cu's running_sum
__device__ __forceinline__ void running_sum(const float* dts, float* cs,
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
  cs[2 * lane] = before + v0;
  cs[2 * lane + 1] = s;
}

// Sum of every thread's `v` in a fixed order (lanes by a shuffle tree,
// then the warps in order); the result is valid in thread 0. `red` holds 8
// floats. Ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Stages rows [t0, t0 + kQ) of the sub-chunk as fp32: dt (zero past L,
// where every row is zero) and x, dy columns [p0, p0 + PB) and, where
// `with_bc`, B and C (any of the output pointers may be null).
template <typename T>
__device__ __forceinline__ void stage(const Params& pr, int bi, int hi,
                                      int p0, int t0, float* dts, float* xs,
                                      float* dys, float* Bs, float* Cs) {
  const int N = pr.N, PB = pr.PB, ldn = N + 1, ldp = PB + 1;
  const T* bb = static_cast<const T*>(pr.Bm) + bi * pr.bs_b;
  const T* cb = static_cast<const T*>(pr.Cm) + bi * pr.cs_b;
  if (Bs != nullptr || Cs != nullptr)
    for (int e = threadIdx.x; e < kQ * N; e += kThreads) {
      const int r = e / N, c = e % N;
      const bool ok = t0 + r < pr.L;
      if (Bs != nullptr)
        Bs[r * ldn + c] = ok ? to_f32(bb[(t0 + r) * pr.bs_t + c]) : 0.f;
      if (Cs != nullptr)
        Cs[r * ldn + c] = ok ? to_f32(cb[(t0 + r) * pr.cs_t + c]) : 0.f;
    }
  const T* xb =
      static_cast<const T*>(pr.x) + bi * pr.xs_b + hi * pr.xs_h + p0;
  const float* dyb = pr.dy + ((size_t)bi * pr.L * pr.H + hi) * pr.P + p0;
  const long long dys_t = (long long)pr.H * pr.P;
  for (int e = threadIdx.x; e < kQ * PB; e += kThreads) {
    const int r = e / PB, c = e % PB;
    const bool ok = t0 + r < pr.L;
    if (xs != nullptr) xs[r * ldp + c] = ok ? to_f32(xb[(t0 + r) * pr.xs_t + c])
                                            : 0.f;
    dys[r * ldp + c] = ok ? dyb[(t0 + r) * dys_t + c] : 0.f;
  }
  if (threadIdx.x < kQ) {
    const int t = t0 + threadIdx.x;
    dts[threadIdx.x] =
        t < pr.L ? pr.dt[bi * pr.dts_b + t * pr.dts_t + hi] : 0.f;
  }
}

// 1. The gradient each sub-chunk's outputs give the state entering it,
// Σ_j exp(cs_j)·dy_j ⊗ C_j (PB × N), into r; and cs_last into glog.
// Grid (nsub, b·h, P / PB).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_local_kernel(
    const Params pr) {
  extern __shared__ __align__(16) float sm[];
  const int N = pr.N, PB = pr.PB, ldn = N + 1, ldp = PB + 1;
  float* Cs = sm;
  float* dys = Cs + kQ * ldn;
  float* dts = dys + kQ * ldp;
  float* cs = dts + kQ;
  const int k = blockIdx.x, bh = blockIdx.y, p0 = blockIdx.z * PB;
  const int bi = bh / pr.H, hi = bh % pr.H;
  stage<T>(pr, bi, hi, p0, k * kQ, dts, nullptr, dys, nullptr, Cs);
  __syncthreads();
  if (threadIdx.x < 32) running_sum(dts, cs, pr.A[hi]);
  __syncthreads();
  for (int e = threadIdx.x; e < kQ * PB; e += kThreads) {
    const int r = e / PB, c = e % PB;
    dys[r * ldp + c] *= expf(cs[r]);
  }
  if (blockIdx.z == 0 && threadIdx.x == 0)
    pr.glog[(size_t)bh * pr.nsub + k] = cs[kQ - 1];
  __syncthreads();
  float* out = pr.r + ((size_t)bh * pr.nsub + k) * pr.P * N + (size_t)p0 * N;
  gemm(PB, N, kQ, [&](int p, int j) { return dys[j * ldp + p]; },
       [&](int j, int n) { return Cs[j * ldn + n]; }, 0, Zero(), Zero(),
       [&](int p, int n, float v) { out[(size_t)p * N + n] = v; });
}

// 2. Backwards over the sub-chunks, one thread per (batch·head, p, n): r
// holds each sub-chunk's local term on entry and the R entering it (the
// gradient by the state that leaves it) on exit; R starts from dfinal and
// d(init) is what leaves the first.
__global__ void __launch_bounds__(kThreads) ssd_bwd_carry_kernel(
    const Params pr) {
  const size_t pn = (size_t)pr.P * pr.N;
  const size_t total = (size_t)pr.B * pr.H * pn;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t bh = e / pn, rest = e % pn;
    float R = pr.dfinal != nullptr ? pr.dfinal[e] : 0.f;
    for (int k = pr.nsub - 1; k >= 0; --k) {
      float* rp = pr.r + (bh * pr.nsub + k) * pn + rest;
      const float local = *rp;
      *rp = R;
      R = fmaf(expf(pr.glog[bh * pr.nsub + k]), R, local);
    }
    if (pr.dinit != nullptr) pr.dinit[e] = R;
  }
}

// 3. Everything else, one CTA per (sub-chunk, batch·head, p-block).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_main_kernel(
    const Params pr) {
  extern __shared__ __align__(16) float sm[];
  const int N = pr.N, PB = pr.PB, ldn = N + 1, ldp = PB + 1;
  float* Bs = sm;
  float* Cs = Bs + kQ * ldn;
  float* xs = Cs + kQ * ldn;
  float* dys = xs + kQ * ldp;
  float* us = dys + kQ * ldp;
  float* T1 = us + kQ * ldp;
  float* St = T1 + kQ * ldp;     // R, then S0
  float* W = St + PB * ldn;
  float* V = W + kQ * kLdQ;
  float* S = V + kQ * kLdQ;
  float* dts = S + kQ * kLdQ;
  float* cs = dts + kQ;
  float* ecs = cs + kQ;          // exp(cs)
  float* dec = ecs + kQ;         // exp(cs_last − cs)
  float* dcs = dec + kQ;
  float* row_ddt = dcs + kQ;     // ⟨du, x⟩ by row
  float* row_dd = row_ddt + kQ;  // ⟨dy, x⟩ by row
  float* red = row_dd + kQ;
  const int tid = threadIdx.x;
  const int k = blockIdx.x, bh = blockIdx.y, pbi = blockIdx.z;
  const int p0 = pbi * PB, npb = pr.P / PB;
  const int bi = bh / pr.H, hi = bh % pr.H;
  const int t0 = k * kQ;
  const float a = pr.A[hi];
  const float dd = pr.D != nullptr ? pr.D[hi] : 0.f;
  const size_t pn = (size_t)pr.P * N;
  const size_t state_at = ((size_t)bh * pr.nsub + k) * pn + (size_t)p0 * N;

  stage<T>(pr, bi, hi, p0, t0, dts, xs, dys, Bs, Cs);
  for (int e = tid; e < PB * N; e += kThreads)   // R
    St[(e / N) * ldn + e % N] = pr.r[state_at + e];
  __syncthreads();
  if (tid < 32) running_sum(dts, cs, a);
  __syncthreads();
  if (tid < kQ) {
    ecs[tid] = expf(cs[tid]);
    dec[tid] = expf(cs[kQ - 1] - cs[tid]);
  }
  for (int e = tid; e < kQ * PB; e += kThreads) {
    const int r = e / PB, c = e % PB;
    us[r * ldp + c] = dts[r] * xs[r * ldp + c];
  }
  __syncthreads();

  // W = L ⊙ C·Bᵀ
  gemm(kQ, kQ, N, [&](int i, int n) { return Cs[i * ldn + n]; },
       [&](int n, int j) { return Bs[j * ldn + n]; }, 0, Zero(), Zero(),
       [&](int i, int j, float v) {
         W[i * kLdQ + j] = j <= i ? v * expf(cs[i] - cs[j]) : 0.f;
       });
  __syncthreads();
  // V = L ⊙ dy·uᵀ and V ⊙ C·Bᵀ (= dy·uᵀ ⊙ W)
  gemm(kQ, kQ, PB, [&](int i, int p) { return dys[i * ldp + p]; },
       [&](int p, int j) { return us[j * ldp + p]; }, 0, Zero(), Zero(),
       [&](int i, int j, float v) {
         V[i * kLdQ + j] = j <= i ? v * expf(cs[i] - cs[j]) : 0.f;
         S[i * kLdQ + j] = v * W[i * kLdQ + j];
       });
  // T1 = B·Rᵀ
  gemm(kQ, PB, N, [&](int i, int n) { return Bs[i * ldn + n]; },
       [&](int n, int p) { return St[p * ldn + n]; }, 0, Zero(), Zero(),
       [&](int i, int p, float v) { T1[i * ldp + p] = v; });
  // ⟨R, the state leaving⟩: the next sub-chunk's entering state, or the
  // final state (R is zero there without dfinal)
  float part = 0.f;
  if (k + 1 < pr.nsub || pr.dfinal != nullptr) {
    const float* nxt = k + 1 < pr.nsub
                           ? pr.states + state_at + pn
                           : pr.final_state + (size_t)bh * pn + (size_t)p0 * N;
    for (int e = tid; e < PB * N; e += kThreads)
      part = fmaf(St[(e / N) * ldn + e % N], nxt[e], part);
  }
  const float leaving = block_sum(part, red);   // (its barriers)
  if (tid < kQ) {
    const int i = tid;
    float rs = 0.f, cl = 0.f, st = 0.f;
    for (int j = 0; j < kQ; ++j) rs += S[i * kLdQ + j];
    for (int j = 0; j < kQ; ++j) cl += S[j * kLdQ + i];
    for (int p = 0; p < PB; ++p) st = fmaf(us[i * ldp + p], T1[i * ldp + p],
                                           st);
    dcs[i] = rs - cl - dec[i] * st;
  }
  // dB = Vᵀ·C + exp(cs_last − cs)·(u·R), this head's and p-block's part
  float* dbp = pr.dbp + (((size_t)hi * npb + pbi) * pr.B + bi) * pr.L * N;
  gemm(kQ, N, kQ, [&](int i, int j) { return V[j * kLdQ + i]; },
       [&](int j, int n) { return Cs[j * ldn + n]; }, PB,
       [&](int i, int p) { return dec[i] * us[i * ldp + p]; },
       [&](int p, int n) { return St[p * ldn + n]; },
       [&](int i, int n, float v) {
         if (t0 + i < pr.L) dbp[(size_t)(t0 + i) * N + n] = v;
       });
  __syncthreads();
  // du = Wᵀ·dy + exp(cs_last − cs)·T1, into T1
  gemm(kQ, PB, kQ, [&](int i, int j) { return W[j * kLdQ + i]; },
       [&](int j, int p) { return dys[j * ldp + p]; }, 0, Zero(), Zero(),
       [&](int i, int p, float v) {
         T1[i * ldp + p] = fmaf(dec[i], T1[i * ldp + p], v);
       });
  __syncthreads();
  T* dx = static_cast<T*>(pr.dx) + ((size_t)bi * pr.L * pr.H + hi) * pr.P +
          p0;
  for (int e = tid; e < kQ * PB; e += kThreads) {
    const int r = e / PB, c = e % PB;
    if (t0 + r < pr.L)
      dx[(size_t)(t0 + r) * pr.H * pr.P + c] = from_f32<T>(
          fmaf(dts[r], T1[r * ldp + c], dd * dys[r * ldp + c]));
  }
  if (tid < kQ) {
    float g = 0.f, d = 0.f;
    for (int p = 0; p < PB; ++p) {
      g = fmaf(T1[tid * ldp + p], xs[tid * ldp + p], g);
      d = fmaf(dys[tid * ldp + p], xs[tid * ldp + p], d);
    }
    row_ddt[tid] = g;
    row_dd[tid] = d;
  }
  __syncthreads();
  for (int e = tid; e < PB * N; e += kThreads)   // S0
    St[(e / N) * ldn + e % N] = pr.states[state_at + e];
  __syncthreads();
  // T1 = C·S0ᵀ
  gemm(kQ, PB, N, [&](int i, int n) { return Cs[i * ldn + n]; },
       [&](int n, int p) { return St[p * ldn + n]; }, 0, Zero(), Zero(),
       [&](int i, int p, float v) { T1[i * ldp + p] = v; });
  __syncthreads();
  if (tid < kQ) {
    float s = 0.f;
    for (int p = 0; p < PB; ++p)
      s = fmaf(dys[tid * ldp + p], T1[tid * ldp + p], s);
    dcs[tid] = fmaf(ecs[tid], s, dcs[tid]);
  }
  // dC = V·B + exp(cs)·(dy·S0)
  float* dcp = pr.dcp + (((size_t)hi * npb + pbi) * pr.B + bi) * pr.L * N;
  gemm(kQ, N, kQ, [&](int i, int j) { return V[i * kLdQ + j]; },
       [&](int j, int n) { return Bs[j * ldn + n]; }, PB,
       [&](int i, int p) { return ecs[i] * dys[i * ldp + p]; },
       [&](int p, int n) { return St[p * ldn + n]; },
       [&](int i, int n, float v) {
         if (t0 + i < pr.L) dcp[(size_t)(t0 + i) * N + n] = v;
       });
  __syncthreads();
  if (tid == 0) {
    dcs[kQ - 1] += leaving;
    float dl = 0.f, da = 0.f, ddsum = 0.f;
    float* ddtp = pr.ddtp + ((size_t)pbi * pr.B + bi) * pr.L * pr.H + hi;
    for (int i = kQ - 1; i >= 0; --i) {
      dl += dcs[i];
      if (t0 + i < pr.L)
        ddtp[(size_t)(t0 + i) * pr.H] = fmaf(a, dl, row_ddt[i]);
      da = fmaf(dts[i], dl, da);
    }
    for (int i = 0; i < kQ; ++i) ddsum += row_dd[i];
    const size_t at = (((size_t)bi * pr.nsub + k) * npb + pbi) * pr.H + hi;
    pr.dap[at] = da;
    pr.ddp[at] = ddsum;
  }
}

// 4. out[e] = Σ_{r < parts} part[r·count + e], r in increasing order.
template <typename TO>
__global__ void __launch_bounds__(kThreads) ssd_bwd_sum_kernel(
    const float* part, TO* out, size_t count, int parts) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < count;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int r = 0; r < parts; ++r) s += part[(size_t)r * count + e];
    out[e] = from_f32<TO>(s);
  }
}

template <typename TO>
cudaError_t sum_parts(const float* part, TO* out, size_t count, int parts,
                      cudaStream_t st) {
  const size_t blocks = (count + kThreads - 1) / kThreads;
  ssd_bwd_sum_kernel<TO><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           kThreads, 0, st>>>(part, out, count, parts);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T>
cudaError_t run(const Params& pr, size_t smem, void* dB, void* dC, float* ddt,
                float* dA, float* dD, cudaStream_t st) {
  const dim3 grid((unsigned)pr.nsub, (unsigned)(pr.B * pr.H),
                  (unsigned)(pr.P / pr.PB));
  cudaError_t err = allow_smem(ssd_bwd_local_kernel<T>);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_bwd_main_kernel<T>);
  if (err != cudaSuccess) return err;
  ssd_bwd_local_kernel<T><<<grid, kThreads,
                            local_floats(pr.PB, pr.N) * sizeof(float), st>>>(
      pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t states = (size_t)pr.B * pr.H * pr.P * pr.N;
  const size_t blocks = (states + kThreads - 1) / kThreads;
  ssd_bwd_carry_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads,
                         0, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_main_kernel<T><<<grid, kThreads, smem, st>>>(pr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int npb = pr.P / pr.PB;
  const size_t bln = (size_t)pr.B * pr.L * pr.N;
  if ((err = sum_parts<T>(pr.dbp, static_cast<T*>(dB), bln, pr.H * npb,
                          st)) != cudaSuccess)
    return err;
  if ((err = sum_parts<T>(pr.dcp, static_cast<T*>(dC), bln, pr.H * npb,
                          st)) != cudaSuccess)
    return err;
  if ((err = sum_parts<float>(pr.ddtp, ddt, (size_t)pr.B * pr.L * pr.H, npb,
                              st)) != cudaSuccess)
    return err;
  if ((err = sum_parts<float>(pr.dap, dA, (size_t)pr.H,
                              pr.B * pr.nsub * npb, st)) != cudaSuccess)
    return err;
  if (dD != nullptr)
    err = sum_parts<float>(pr.ddp, dD, (size_t)pr.H, pr.B * pr.nsub * npb,
                           st);
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Inputs as repro_ssd_scan takes them: x (b, l, h, p) with element strides
// (xs_b, xs_t, xs_h, 1); dt (b, l, h) fp32 with strides (dts_b, dts_t, 1);
// A, D (h,) fp32 (D may be null); Bm, Cm (b, l, n) with strides (bs_b,
// bs_t, 1), (cs_b, cs_t, 1); x, Bm, Cm of `dtype` (0 = float32, 1 =
// bfloat16). From the forward: states (b, h, ceil(l / 64), p, n) and
// final_state (b, h, p, n) fp32 contiguous. dy (b, l, h, p) fp32 and dfinal
// (b, h, p, n) fp32 (or null: zeros), contiguous. Outputs, contiguous: dx
// (b, l, h, p), dB and dC (b, l, n) in `dtype`; ddt (b, l, h), dA (h,), dD
// (h,) (null when D is) and dinit (b, h, p, n) (or null) fp32. Scratch,
// fp32: r (b, h, nsub, p, n), glog (b, h, nsub), dbp and dcp (h·p / p_block,
// b, l, n), ddtp (p / p_block, b, l, h), dap and ddp (b, nsub, p / p_block,
// h). p_block (16, 32 or 64, dividing p) and the main kernel's shared bytes
// are ops.ssd_bwd_plan's; another layout is refused before anything
// launches. Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* states,
    const void* final_state, const void* dy, const void* dfinal, void* dx,
    void* dB, void* dC, void* ddt, void* dA, void* dD, void* dinit, void* r,
    void* glog, void* dbp, void* dcp, void* ddtp, void* dap, void* ddp,
    int dtype, int b, int l, int h, int p, int n, long long xs_b,
    long long xs_t, long long xs_h, long long dts_b, long long dts_t,
    long long bs_b, long long bs_t, long long cs_b, long long cs_t,
    int p_block, long long smem, void* stream) {
  const int item = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (item == 0 || b < 1 || l < 1 || h < 1 || n < 8 || n % 8 != 0 ||
      n > kMaxN || (p_block != 16 && p_block != 32 && p_block != 64) ||
      p < p_block || p % p_block != 0 || p / p_block > 65535 ||
      (long long)b * h > 65535 ||
      smem != (long long)(main_floats(p_block, n) * sizeof(float)) ||
      smem > kMaxSmem ||
      (long long)local_floats(p_block, n) * 4 > kMaxSmem ||
      states == nullptr || final_state == nullptr || dy == nullptr ||
      !aligned16(x) || !aligned16(Bm) || !aligned16(Cm))
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
  pr.r = static_cast<float*>(r);
  pr.glog = static_cast<float*>(glog);
  pr.dinit = static_cast<float*>(dinit);
  pr.dbp = static_cast<float*>(dbp);
  pr.dcp = static_cast<float*>(dcp);
  pr.ddtp = static_cast<float*>(ddtp);
  pr.dap = static_cast<float*>(dap);
  pr.ddp = static_cast<float*>(ddp);
  pr.B = b;
  pr.L = l;
  pr.H = h;
  pr.P = p;
  pr.N = n;
  pr.PB = p_block;
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
          ? run<float>(pr, (size_t)smem, dB, dC, static_cast<float*>(ddt),
                       static_cast<float*>(dA), static_cast<float*>(dD), st)
          : run<__nv_bfloat16>(pr, (size_t)smem, dB, dC,
                               static_cast<float*>(ddt),
                               static_cast<float*>(dA),
                               static_cast<float*>(dD), st);
  return (int)err;
}

// Fused contrastive loss for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/contrastive_loss/kernel.py, fwd_fused (:107) with
// its body _fused_fwd_kernel (:77), and bwd_fused (:185) with its body
// _fused_bwd_kernel (:149), the TPU's single-sweep kernels of paper Eq. 3;
// and the legacy 4-pass pair, row_col_lse (:295; _row_lse_kernel :229,
// _col_lse_kernel :241) and grads (:337; _dx_kernel :254, _dy_kernel :277).
// Same functions: for A = X·Yᵀ·inv_tau (B × B, never stored) the forwards
// return the row and column log-sum-exps; the backward recomputes A tile
// by tile from them and returns
//   dA = (exp(A − row_lse) + exp(A − col_lse) − 2·δ_ij·with_diag) / (2·b_norm)
//   dX = dA·Y·inv_tau,  dY = dAᵀ·X·inv_tau,  dlog_tau = −Σ dA·A
// in fp32, with dA rounded to bf16 before the contractions when the inputs
// are bf16, as the reference's _contract does (kernel.py:57-61).
//
// What bounds it on this card: the arithmetic. At the training shape
// (B = 2048, D = 512, fp32 from the towers) the forward does 2·B²·D flops
// (row_col_lse twice that: each sweep computes A once) and the backward
// 3·2·B²·D on 2·B·D inputs, far above the card's flops-per-byte line; these
// SIMT loops run on the FMA units in fp32.
//
// What the design does about it: the TPU kernels carry full-length column
// statistics (forward) and a VMEM-resident (B, D) dY (backward) across a
// sequential grid axis; CTAs here run in parallel and in no order, so
// nothing is carried between them and no fp32 atomics are used, which
// keeps every result the same from run to run:
//   forward   one CTA per 64×64 tile of A (B = 2048 gives 1024 CTAs) writes
//             partial row (max, sum) and partial column (max, sum) of its
//             tile; a combine kernel folds the partials in a fixed order
//             into row_lse and col_lse;
//   row_col_lse  one launch of 2·⌈B/16⌉ CTAs (256 at B = 2048): blockIdx.y
//             picks the sweep (self = X for row_lse, self = Y for col_lse);
//             each CTA owns 16 self rows, walks every 128-row tile of the
//             other matrix with 4×4 register-blocked scores per thread and
//             keeps each row's online (max, sum) in registers (one warp per
//             4 rows, reduced by shuffles), then writes the lse: no
//             partials, no scratch beyond the two (B,) outputs;
//   backward  a row-parallel launch (16 rows of X per CTA, 128 CTAs at
//             B = 2048) sweeps all column tiles and accumulates its dX rows
//             in shared memory, with one dlog_tau partial per CTA; a
//             column-parallel launch of the same kernel with the roles of X
//             and Y (and of the two lse vectors) swapped accumulates dY; a
//             one-CTA kernel sums the dlog_tau partials in a fixed order.
//             This is also the TPU's grads: its _dx_kernel and _dy_kernel
//             are the same two sweeps, so repro_contrastive_grads launches
//             this sequence as it is.
// Any B >= 1 is taken: rows and columns past B are zero-filled as they are
// staged and masked out of every statistic. inv_tau is read from device
// memory, so the host never synchronises. Inputs are f32 or bf16, converted
// to fp32 as they are staged; every accumulation is fp32. A simple kernel
// first: wgmma, TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;     // forward tile edge; backward other-tile rows
constexpr int kRows = 16;     // backward and row_col_lse self rows per CTA
constexpr int kLseTile = 128; // row_col_lse other rows per tile
constexpr int kDC = 32;       // staged chunk of the embedding dim
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// The contraction operand: dA as the TPU feeds it to the MXU.
__device__ __forceinline__ float as_operand(float x, float) { return x; }
__device__ __forceinline__ float as_operand(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [r0, r0 + rows) x columns [d0, d0 + kDC) of a (B, D) matrix
// into fp32 shared memory with row stride kDC + 1; entries past B or D
// are zero.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, int r0,
                                            int rows, int d0, int B, int D) {
  for (int e = threadIdx.x; e < rows * kDC; e += kThreads) {
    const int row = e / kDC, col = e % kDC;
    const int g = r0 + row, d = d0 + col;
    dst[row * (kDC + 1) + col] =
        (g < B && d < D) ? to_f32(src[(size_t)g * D + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: one 64×64 tile of A per CTA -> partial row / column (max, sum)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
contrastive_fwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const float* __restrict__ inv_tau_p,
                            float* __restrict__ row_m,
                            float* __restrict__ row_s,
                            float* __restrict__ col_m,
                            float* __restrict__ col_s, int B, int D) {
  constexpr int CS = kDC + 1;
  constexpr int AS = kTile + 1;
  __shared__ float Xs[kTile * CS];
  __shared__ float Ys[kTile * CS];
  __shared__ float As[kTile * AS];

  const int i0 = blockIdx.x * kTile;   // rows of A (X)
  const int j0 = blockIdx.y * kTile;   // columns of A (Y)
  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const float inv_tau = *inv_tau_p;

  float a[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    __syncthreads();
    stage_chunk(Xs, x, i0, kTile, d0, B, D);
    stage_chunk(Ys, y, j0, kTile, d0, B, D);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kDC; ++d) {
      float xv[4], yv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[(r + 16 * i) * CS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) yv[j] = Ys[(c + 8 * j) * CS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      As[(r + 16 * i) * AS + c + 8 * j] = a[i][j] * inv_tau;
  __syncthreads();

  // threads 0..63 reduce a row of the tile, 64..127 a column
  const bool is_row = tid < kTile;
  const int e = is_row ? tid : tid - kTile;
  const int g = (is_row ? i0 : j0) + e;      // global row or column
  const int n_other = min(kTile, B - (is_row ? j0 : i0));
  if (g < B) {
    float m = kNeg;
    for (int o = 0; o < n_other; ++o)
      m = fmaxf(m, is_row ? As[e * AS + o] : As[o * AS + e]);
    float s = 0.f;
    for (int o = 0; o < n_other; ++o)
      s += expf((is_row ? As[e * AS + o] : As[o * AS + e]) - m);
    if (is_row) {
      row_m[(size_t)blockIdx.y * B + g] = m;
      row_s[(size_t)blockIdx.y * B + g] = s;
    } else {
      col_m[(size_t)blockIdx.x * B + g] = m;
      col_s[(size_t)blockIdx.x * B + g] = s;
    }
  }
}

// lse = logsumexp over the n partials (max, sum) of each of B rows and B
// columns, folded in partial order.
__global__ void __launch_bounds__(kThreads)
contrastive_fwd_combine_kernel(const float* __restrict__ row_m,
                               const float* __restrict__ row_s,
                               const float* __restrict__ col_m,
                               const float* __restrict__ col_s,
                               float* __restrict__ row_lse,
                               float* __restrict__ col_lse, int B, int n) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= 2 * B) return;
  const bool is_row = idx < B;
  const int g = is_row ? idx : idx - B;
  const float* pm = is_row ? row_m : col_m;
  const float* ps = is_row ? row_s : col_s;
  float m = kNeg;
  for (int p = 0; p < n; ++p) m = fmaxf(m, pm[(size_t)p * B + g]);
  float s = 0.f;
  for (int p = 0; p < n; ++p)
    s += ps[(size_t)p * B + g] * expf(pm[(size_t)p * B + g] - m);
  (is_row ? row_lse : col_lse)[g] = m + logf(s);
}

// ---------------------------------------------------------------------------
// row_col_lse: 16 "self" rows per CTA sweep every 128-row tile of "other"
// with an online (max, sum) per row; blockIdx.y picks the sweep
// (0: self = X, other = Y -> row_lse; 1: self = Y, other = X -> col_lse)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
contrastive_lse_sweep_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             const float* __restrict__ inv_tau_p,
                             float* __restrict__ row_lse,
                             float* __restrict__ col_lse, int B, int D) {
  constexpr int CS = kDC + 1;
  __shared__ float Ss[kRows * CS];
  __shared__ float Os[kLseTile * CS];

  const bool is_row = blockIdx.y == 0;
  const T* self = is_row ? x : y;
  const T* other = is_row ? y : x;
  const int s0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int r = tid >> 5;          // warp: self rows r + 4 i
  const int c = tid & 31;          // lane: other rows c + 32 j of the tile
  const float inv_tau = *inv_tau_p;

  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    s[i] = 0.f;
  }
  for (int o0 = 0; o0 < B; o0 += kLseTile) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();
      stage_chunk(Ss, self, s0, kRows, d0, B, D);
      stage_chunk(Os, other, o0, kLseTile, d0, B, D);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDC; ++d) {
        float sv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ss[(r + 4 * i) * CS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ov[j] = Os[(c + 32 * j) * CS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(sv[i], ov[j], a[i][j]);
      }
    }
    // fold this tile's 128 columns into each row's running (max, sum)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
      float tm = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = o0 + c + 32 * j < B ? a[i][j] * inv_tau : kNeg;
        tm = fmaxf(tm, v[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, off));
      const float mn = fmaxf(m[i], tm);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ts += expf(v[j] - mn);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ts += __shfl_xor_sync(kFull, ts, off);
      s[i] = s[i] * expf(m[i] - mn) + ts;
      m[i] = mn;
    }
  }
  if (c == 0) {
    float* lse = is_row ? row_lse : col_lse;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = s0 + r + 4 * i;
      if (g < B) lse[g] = m[i] + logf(s[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: 16 "self" rows per CTA sweep every 64-row tile of "other"
// (self = X, other = Y for dX; self = Y, other = X for dY)
// ---------------------------------------------------------------------------

size_t grad_smem_bytes(int D) {
  // Ss [kRows][D + 1], acc [kRows][D], Os [kTile][kDC + 1],
  // dAs [kRows][kTile + 1], lse_self [kRows], warp sums [4]
  return sizeof(float) *
         ((size_t)kRows * (D + 1) + (size_t)kRows * D + kTile * (kDC + 1) +
          kRows * (kTile + 1) + kRows + 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
contrastive_grad_kernel(const T* __restrict__ self,
                        const T* __restrict__ other,
                        const float* __restrict__ inv_tau_p,
                        const float* __restrict__ lse_self,
                        const float* __restrict__ lse_other,
                        float* __restrict__ grad,
                        float* __restrict__ dtau_part, int B, int D,
                        float two_bn, int with_diag) {
  constexpr int CS = kDC + 1;
  constexpr int AS = kTile + 1;
  extern __shared__ float smem[];
  float* Ss = smem;                              // [kRows][D + 1]
  float* acc = Ss + kRows * (D + 1);             // [kRows][D]
  float* Os = acc + kRows * D;                   // [kTile][CS]
  float* dAs = Os + kTile * CS;                  // [kRows][AS]
  float* lse_s = dAs + kRows * AS;               // [kRows]
  float* warp_sum = lse_s + kRows;               // [4]

  const int s0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int r = tid >> 3;          // self row of the tile: 0..15
  const int c = tid & 7;           // other columns c + 8 j
  const float inv_tau = *inv_tau_p;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int row = e / D, d = e % D;
    const int g = s0 + row;
    Ss[row * (D + 1) + d] = g < B ? to_f32(self[(size_t)g * D + d]) : 0.f;
    acc[e] = 0.f;
  }
  if (tid < kRows) lse_s[tid] = s0 + tid < B ? lse_self[s0 + tid] : 0.f;

  const int srow = s0 + r;
  float dtau = 0.f;
  for (int o0 = 0; o0 < B; o0 += kTile) {
    // a = self · otherᵀ · inv_tau for 16 rows x 64 columns
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();
      stage_chunk(Os, other, o0, kTile, d0, B, D);
      __syncthreads();
      const int dn = min(kDC, D - d0);
      for (int d = 0; d < dn; ++d) {
        const float sv = Ss[r * (D + 1) + d0 + d];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          a[j] = fmaf(sv, Os[(c + 8 * j) * CS + d], a[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int orow = o0 + c + 8 * j;
      float da = 0.f;
      if (srow < B && orow < B) {
        const float av = a[j] * inv_tau;
        da = expf(av - lse_s[r]) + expf(av - lse_other[orow]);
        if (with_diag && srow == orow) da -= 2.f;
        da = da / two_bn;
        dtau -= da * av;
      }
      dAs[r * AS + c + 8 * j] = as_operand(da, T());
    }

    // acc[row, :] += dA[row, :] · other tile
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // dA is written; the previous chunk's readers done
      stage_chunk(Os, other, o0, kTile, d0, B, D);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kDC / 8; ++jj) {
        const int col = c + 8 * jj;
        if (d0 + col < D) {
          float sum = 0.f;
#pragma unroll 8
          for (int o = 0; o < kTile; ++o)
            sum = fmaf(dAs[r * AS + o], Os[o * CS + col], sum);
          acc[r * D + d0 + col] += sum;
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int g = s0 + e / D;
    if (g < B) grad[(size_t)s0 * D + e] = acc[e] * inv_tau;
  }
  if (dtau_part != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dtau += __shfl_xor_sync(kFull, dtau, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = dtau;
    __syncthreads();
    if (tid == 0)
      dtau_part[blockIdx.x] =
          (warp_sum[0] + warp_sum[1]) + (warp_sum[2] + warp_sum[3]);
  }
}

// dtau = sum of n partials, in a fixed order.
__global__ void __launch_bounds__(256)
contrastive_dtau_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ dtau, int n) {
  __shared__ float buf[256];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) s += part[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *dtau = buf[0];
}

template <typename T>
cudaError_t fwd(const void* x, const void* y, const void* inv_tau,
                void* row_lse, void* col_lse, void* part, int B, int D,
                cudaStream_t stream) {
  const int n = (B + kTile - 1) / kTile;
  float* p = static_cast<float*>(part);
  float* row_m = p;
  float* row_s = p + (size_t)n * B;
  float* col_m = p + 2 * (size_t)n * B;
  float* col_s = p + 3 * (size_t)n * B;
  contrastive_fwd_tile_kernel<T><<<dim3(n, n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(inv_tau), row_m, row_s, col_m, col_s, B, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  contrastive_fwd_combine_kernel<<<(2 * B + kThreads - 1) / kThreads,
                                   kThreads, 0, stream>>>(
      row_m, row_s, col_m, col_s, static_cast<float*>(row_lse),
      static_cast<float*>(col_lse), B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_col_lse(const void* x, const void* y, const void* inv_tau,
                        void* row_lse, void* col_lse, int B, int D,
                        cudaStream_t stream) {
  const int n = (B + kRows - 1) / kRows;
  contrastive_lse_sweep_kernel<T><<<dim3(n, 2), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(inv_tau), static_cast<float*>(row_lse),
      static_cast<float*>(col_lse), B, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* y, const void* inv_tau,
                const void* row_lse, const void* col_lse, void* dx, void* dy,
                void* dtau, void* part, int B, int D, float two_bn,
                int with_diag, cudaStream_t stream) {
  const size_t smem = grad_smem_bytes(D);
  auto kernel = contrastive_grad_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n = (B + kRows - 1) / kRows;
  const float* it = static_cast<const float*>(inv_tau);
  const float* rl = static_cast<const float*>(row_lse);
  const float* cl = static_cast<const float*>(col_lse);
  float* p = static_cast<float*>(part);
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), it, rl, cl,
      static_cast<float*>(dx), p, B, D, two_bn, with_diag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(x), it, cl, rl,
      static_cast<float*>(dy), nullptr, B, D, two_bn, with_diag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  contrastive_dtau_sum_kernel<<<1, 256, 0, stream>>>(
      p, static_cast<float*>(dtau), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: (B, D); inv_tau: one fp32 on the
// device; row_lse, col_lse: (B,) fp32 outputs; part: fp32 scratch of
// 4 * ceil(B / 64) * B entries. Returns the CUDA error code (0 on success).
extern "C" int repro_contrastive_fwd(const void* x, const void* y,
                                     const void* inv_tau, void* row_lse,
                                     void* col_lse, void* part, int dtype,
                                     int B, int D, void* stream) {
  if (B < 1 || D < 1 || B > 65535 * kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(x, y, inv_tau, row_lse, col_lse, part, B, D, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(x, y, inv_tau, row_lse, col_lse, part, B,
                                   D, st);
  return (int)cudaErrorInvalidValue;
}

// dx, dy: (B, D) fp32 outputs; dtau: one fp32 output; part: fp32 scratch of
// ceil(B / 16) entries; two_bn = 2 * b_norm. D may be at most 1024 (the
// dX/dY rows live in shared memory). Returns the CUDA error code.
extern "C" int repro_contrastive_bwd(const void* x, const void* y,
                                     const void* inv_tau,
                                     const void* row_lse,
                                     const void* col_lse, void* dx, void* dy,
                                     void* dtau, void* part, int dtype, int B,
                                     int D, float two_bn, int with_diag,
                                     void* stream) {
  if (B < 1 || D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(x, y, inv_tau, row_lse, col_lse, dx, dy, dtau,
                           part, B, D, two_bn, with_diag, st);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(x, y, inv_tau, row_lse, col_lse, dx, dy,
                                   dtau, part, B, D, two_bn, with_diag, st);
  return (int)cudaErrorInvalidValue;
}

// The legacy pair's forward: row_lse, col_lse (B,) fp32 outputs from two
// single-reduction sweeps in one launch; no scratch, any D. Returns the CUDA
// error code.
extern "C" int repro_contrastive_row_col_lse(const void* x, const void* y,
                                             const void* inv_tau,
                                             void* row_lse, void* col_lse,
                                             int dtype, int B, int D,
                                             void* stream) {
  if (B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)row_col_lse<float>(x, y, inv_tau, row_lse, col_lse, B, D, st);
  if (dtype == 1)
    return (int)row_col_lse<__nv_bfloat16>(x, y, inv_tau, row_lse, col_lse,
                                           B, D, st);
  return (int)cudaErrorInvalidValue;
}

// The legacy pair's backward, the TPU's grads: its dX sweep and dY sweep
// are the backward's two launches above, so this runs that sequence with
// the same arguments and limits as repro_contrastive_bwd.
extern "C" int repro_contrastive_grads(const void* x, const void* y,
                                       const void* inv_tau,
                                       const void* row_lse,
                                       const void* col_lse, void* dx,
                                       void* dy, void* dtau, void* part,
                                       int dtype, int B, int D, float two_bn,
                                       int with_diag, void* stream) {
  return repro_contrastive_bwd(x, y, inv_tau, row_lse, col_lse, dx, dy, dtau,
                               part, dtype, B, D, two_bn, with_diag, stream);
}

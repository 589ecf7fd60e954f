// Fused similarity→top-k for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/similarity_topk/kernel.py, topk_fused (:85) with
// its body _topk_kernel (:64) and running merge _merge_topk (:48), the
// TPU's blockwise X·Cᵀ·inv_tau with a running top-k per row. Same
// function: per row the k largest logits, values descending, ties to the
// LOWER class id; slots no class filled carry (NEG, IDX_PAD).
//
// What bounds it on this card: the class matrix. Its n·d elements are the
// bytes that must move, and the 2·b·n·d flops run on the FMA units in
// fp32. At b <= 64 serving rows the flops per class byte are few, so the
// kernel must keep every SM streaming classes at once; the (b, n) logit
// matrix itself must never reach device memory.
//
// What the design does about it: the TPU grid has one row block and walks
// the class axis in order (nI = 1 at serving batch sizes: one CTA out of
// 132 here). This kernel splits the class axis across CTAs instead: each
// CTA takes a chunk of classes for a block of 16 or 64 rows, computes the
// logits tile by tile (64 classes, embedding staged 32 deep in shared
// memory, fp32 FMA), and keeps a sorted running top-k per row in shared
// memory. A warp owns a row's list; a candidate enters only if it beats the
// current k-th entry (one ballot per 32 candidates, so after the first
// tiles almost nothing is inserted), and an insertion is a warp-wide
// rank-and-shift. Each CTA writes a (b, k) partial with global class ids;
// a second small kernel merges the partials, one thread per partial,
// taking k rounds of a block-wide arg-max over the partials' heads. The
// order (value desc, id asc) is total, so the split cannot change the
// result. A simple kernel first: tensor cores and pipelined loads are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kIdxPad = 1 << 30;
constexpr int kThreads = 256;
constexpr int kBC = 64;     // classes per tile
constexpr int kDK = 32;     // embedding depth per staged chunk
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the output order: larger value first, then the lower id
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <int BM>
constexpr size_t partial_smem_bytes() {
  // Xs [BM][DK+1], Cs [BC][DK+1], Ls [BM][BC+1], TV/TI [BM][kMaxK]
  return sizeof(float) * (size_t)(BM * (kDK + 1) + kBC * (kDK + 1) +
                                  BM * (kBC + 1) + 2 * BM * kMaxK);
}

// Insert (nv, ni) into the sorted list (tv, ti) of length K, if it beats
// the current last entry. Called by all 32 lanes of one warp.
__device__ __forceinline__ void insert(float* tv, int* ti, int K, float nv,
                                       int ni, int lane) {
  if (!better(nv, ni, tv[K - 1], ti[K - 1])) return;  // warp-uniform
  const int e0 = lane, e1 = lane + 32;
  const bool in0 = e0 < K, in1 = e1 < K;
  const float v0 = in0 ? tv[e0] : kNeg, v1 = in1 ? tv[e1] : kNeg;
  const int i0 = in0 ? ti[e0] : kIdxPad, i1 = in1 ? ti[e1] : kIdxPad;
  // the entries better than the candidate are a prefix of the list
  const int pos = __popc(__ballot_sync(kFull, in0 && better(v0, i0, nv, ni))) +
                  __popc(__ballot_sync(kFull, in1 && better(v1, i1, nv, ni)));
  const float pv0 = (in0 && e0 > 0) ? tv[e0 - 1] : 0.f;
  const int pi0 = (in0 && e0 > 0) ? ti[e0 - 1] : 0;
  const float pv1 = in1 ? tv[e1 - 1] : 0.f;
  const int pi1 = in1 ? ti[e1 - 1] : 0;
  __syncwarp();
  if (in0 && e0 >= pos) {
    tv[e0] = e0 == pos ? nv : pv0;
    ti[e0] = e0 == pos ? ni : pi0;
  }
  if (in1 && e1 >= pos) {
    tv[e1] = e1 == pos ? nv : pv1;
    ti[e1] = e1 == pos ? ni : pi1;
  }
  __syncwarp();
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ x, const T* __restrict__ c,
                    float inv_tau, int B, int N, int Dm, int K, int chunk,
                    int P, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  constexpr int RM = BM / 16;      // rows per thread: ty + 16 i
  constexpr int CN = kBC / 16;     // classes per thread: tx + 16 j
  constexpr int XS = kDK + 1;
  constexpr int LS = kBC + 1;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Cs = Xs + BM * XS;
  float* Ls = Cs + kBC * XS;
  float* TV = Ls + BM * LS;
  int* TI = reinterpret_cast<int*>(TV + BM * kMaxK);

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int c_lo = part * chunk;
  const int c_hi = min(N, c_lo + chunk);

  for (int e = tid; e < BM * kMaxK; e += kThreads) {
    TV[e] = kNeg;
    TI[e] = kIdxPad;
  }

  for (int ct = c_lo; ct < c_hi; ct += kBC) {
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < Dm; d0 += kDK) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      for (int e = tid; e < BM * kDK; e += kThreads) {
        const int row = e / kDK, col = d0 + e % kDK;
        const int gr = row0 + row;
        Xs[row * XS + e % kDK] =
            (gr < B && col < Dm) ? to_f32(x[(size_t)gr * Dm + col]) : 0.f;
      }
      for (int e = tid; e < kBC * kDK; e += kThreads) {
        const int row = e / kDK, col = d0 + e % kDK;
        const int cls = ct + row;
        Cs[row * XS + e % kDK] =
            (cls < c_hi && col < Dm) ? to_f32(c[(size_t)cls * Dm + col])
                                     : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kDK; ++dd) {
        float xv[RM], cv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) xv[i] = Xs[(ty + 16 * i) * XS + dd];
#pragma unroll
        for (int j = 0; j < CN; ++j) cv[j] = Cs[(tx + 16 * j) * XS + dd];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ls[(ty + 16 * i) * LS + tx + 16 * j] = acc[i][j] * inv_tau;
    __syncthreads();

    // merge the tile into each row's running top-k: one warp per row
    for (int row = warp; row < BM; row += kThreads / 32) {
      if (row0 + row >= B) break;  // rows are visited in increasing order
      float* tv = TV + row * kMaxK;
      int* ti = TI + row * kMaxK;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane + 32 * half;
        const int cls = ct + col;
        const float val = Ls[row * LS + col];
        const bool live = cls < c_hi;
        unsigned mask = __ballot_sync(
            kFull, live && better(val, cls, tv[K - 1], ti[K - 1]));
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float nv = __shfl_sync(kFull, val, src);
          const int ni = __shfl_sync(kFull, cls, src);
          insert(tv, ti, K, nv, ni, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * K; e += kThreads) {
    const int row = e / K, j = e % K;
    const int gr = row0 + row;
    if (gr < B) {
      const size_t o = ((size_t)gr * P + part) * K + j;
      part_v[o] = TV[row * kMaxK + j];
      part_i[o] = TI[row * kMaxK + j];
    }
  }
}

// the merge's order: the output order, then the lower partial
__device__ __forceinline__ bool better3(float va, int ia, int pa, float vb,
                                        int ib, int pb) {
  return va > vb || (va == vb && (ia < ib || (ia == ib && pa < pb)));
}

__global__ void topk_merge_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i, int P,
                                  int K, float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  __shared__ float wv[32];
  __shared__ int wi[32], wp[32];
  __shared__ int winner;
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* pv = part_v + ((size_t)row * P + tid) * K;
  const int* pi = part_i + ((size_t)row * P + tid) * K;
  int head = 0;
  float cv = tid < P ? pv[0] : kNeg;
  int ci = tid < P ? pi[0] : kIdxPad;
  for (int e = 0; e < K; ++e) {
    float bv = cv;
    int bi = ci, bp = tid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int op = __shfl_xor_sync(kFull, bp, off);
      if (better3(ov, oi, op, bv, bi, bp)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wp[warp] = bp;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : kNeg;
      bi = lane < nwarps ? wi[lane] : kIdxPad;
      bp = lane < nwarps ? wp[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        const int op = __shfl_xor_sync(kFull, bp, off);
        if (better3(ov, oi, op, bv, bi, bp)) {
          bv = ov;
          bi = oi;
          bp = op;
        }
      }
      if (lane == 0) {
        out_v[(size_t)row * K + e] = bv;
        out_i[(size_t)row * K + e] = bi;
        winner = bp;
      }
    }
    __syncthreads();
    if (tid == winner) {
      ++head;
      cv = head < K ? pv[head] : kNeg;
      ci = head < K ? pi[head] : kIdxPad;
    }
  }
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* c, int b, int n, int d, int k,
                   float inv_tau, int chunk, int parts, void* part_v,
                   void* part_i, void* out_v, void* out_i,
                   cudaStream_t stream) {
  constexpr size_t smem = partial_smem_bytes<BM>();
  auto kernel = topk_partial_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(parts, (b + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), inv_tau, b, n, d,
      k, chunk, parts, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 32 * ((parts + 31) / 32);
  topk_merge_kernel<<<b, threads, 0, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      parts, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. block_m: image rows per CTA, 16 or 64.
// part_v/part_i: (b, parts, k) scratch; out_v/out_i: (b, k). Returns the
// CUDA error code of the launches.
extern "C" int repro_similarity_topk(const void* x, const void* c, int dtype,
                                     int b, int n, int d, int k,
                                     float inv_tau, int block_m, int chunk,
                                     int parts, void* part_v, void* part_i,
                                     void* out_v, void* out_i, void* stream) {
  if (b < 1 || n < 1 || d < 1 || k < 1 || k > kMaxK || k > n || chunk < 1 ||
      parts < 1 || parts > 1024 || (long long)chunk * parts < n ||
      block_m < 1 || (b + block_m - 1) / block_m > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TOPK_LAUNCH(T, DT, BM)                                        \
  if (dtype == DT && block_m == BM)                                         \
    return (int)launch<T, BM>(x, c, b, n, d, k, inv_tau, chunk, parts,      \
                              part_v, part_i, out_v, out_i, st);
  REPRO_TOPK_LAUNCH(float, 0, 16)
  REPRO_TOPK_LAUNCH(float, 0, 64)
  REPRO_TOPK_LAUNCH(__nv_bfloat16, 1, 16)
  REPRO_TOPK_LAUNCH(__nv_bfloat16, 1, 64)
#undef REPRO_TOPK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Fused similarity→top-k for Hopper (sm_90a), plain C interface.
//
// Replaces: repro/kernels/similarity_topk/kernel.py, topk_fused (:85) with
// its body _topk_kernel (:64) and running merge _merge_topk (:48), the
// TPU's blockwise X·Cᵀ·inv_tau with a running top-k per row. Same
// function: per row the k largest logits, values descending, ties to the
// LOWER class id; slots no class filled carry (NEG, IDX_PAD).
//
// What bounds it on this card: the 2·b·n·d flops on the fp32 FMA units
// (f32 means full fp32: no TF32), or at small b·n the latency of one
// launch. The class matrix's n·d elements are the bytes that must move; at
// b <= 64 serving rows each class element feeds b FMAs, so the FMA units,
// not memory, set the pace once b passes ~20. The (b, n) logit matrix must
// never reach device memory.
//
// What the design does about it:
// - The class axis is split across CTAs (the TPU grid walks it in order on
//   one core): CTA p takes classes [p·chunk, (p+1)·chunk) for a block of
//   16 or 64 image rows; the wrapper sizes chunk so that the grid fills
//   the card once.
// - The CTA's image block stays in shared memory, staged once (with the
//   first class tile's depth chunks), never re-staged per class tile.
//   Class tiles of 128 classes stream through a ring of 32-deep chunks
//   (16-byte cp.async, 3 stages; 4 at 16 rows), so the next chunks load
//   while the current one is multiplied.
// - Register blocking: each warp owns 8 (or 4) rows of the block; a lane
//   holds 4 (or 2) rows × 8 classes of logits in fp32 and does 128 (or 64)
//   FMAs per 12 (or 10) 16-byte shared-memory reads.
// - Selection in registers: a warp owns its rows' sorted top-k lists in
//   shared memory, so no lock is needed. A logit becomes a candidate only
//   if it beats its row's current k-th entry (read once per tile); a half
//   warp (one row) extracts its candidates best first into a run of at
//   most k, then merges the run into the list once (each entry's new rank
//   by a binary search of the other side), so a row whose list is already
//   good does nothing past one ballot.
// - One launch: each CTA writes its (rows, k) partial with global class
//   ids; the partials merge in a tree of two levels inside the launch: the
//   last CTA of each group of 16 to finish (a device counter, raised after
//   __threadfence, which that CTA resets) merges its group, and the last
//   group merges the groups, a half warp per row, with k rounds of an
//   arg-max over the partials' heads (one merge of all partials in one
//   CTA measured slow: it pulls every partial through one SM). The order
//   (value desc, id asc) is total, so no split and no arrival order can
//   change the result.
// bf16 inputs are staged as bf16 and widened to fp32 in registers, so they
// accumulate in fp32 as f32 inputs do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#include "../../flash_attention/csrc/tc.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kIdxPad = 1 << 30;
constexpr int kMaxK = 64;
constexpr int kMaxParts = 256;     // partials per row at most
constexpr int kGroup = 16;         // partials a first-level merge takes
constexpr int kBN = 128;           // classes per tile: 16 lanes × 8
constexpr int kTN = 8;             // classes per lane
constexpr int kKC = 32;            // embedding depth per staged chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 230400;  // dynamic shared memory per CTA

template <typename T, int BM>
struct TopkLayout {
  static constexpr int kWarps = BM == 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int RW = BM / kWarps;      // rows per warp
  static constexpr int TM = RW / 2;           // rows per lane
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int CLD = kKC + PAD;       // staged class rows
  static constexpr int S = BM == 16 ? 4 : 3;  // ring stages
  static constexpr size_t ring = (size_t)S * kBN * CLD * sizeof(T);
  static __host__ __device__ int xld(int d) {
    return (d + kKC - 1) / kKC * kKC + PAD;
  }
  // image block [BM][xld], ring, the lists (values [BM][k], ids), then
  // each half warp's run of new candidates (values [k], ids)
  static __host__ __device__ size_t compute_bytes(int d, int k) {
    return (size_t)BM * xld(d) * sizeof(T) + ring + (size_t)BM * k * 8 +
           (size_t)kWarps * 2 * k * 8;
  }
  // a merge's per-warp buffers: two rows' kGroup partials (values then
  // ids), nb sets
  static __host__ __device__ size_t merge_bytes(int k, int nb) {
    return (size_t)kWarps * nb * 4 * kGroup * k * 4;
  }
  static __host__ __device__ size_t bytes(int d, int k, int nb) {
    const size_t a = compute_bytes(d, k), b = merge_bytes(k, nb);
    return a > b ? a : b;
  }
};

// the output order: larger value first, then the lower id
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The best of N (value, id) pairs and its slot, as a tournament of
// log2(N) rounds (a short dependency chain, unlike a scan).
template <int N>
__device__ __forceinline__ void tourney(const float (&v)[N],
                                        const int (&id)[N], float& bv,
                                        int& bi, int& bs) {
  float tv[N];
  int ti[N], ts[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    tv[j] = v[j];
    ti[j] = id[j];
    ts[j] = j;
  }
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
      if (better(tv[j + w], ti[j + w], tv[j], ti[j])) {
        tv[j] = tv[j + w];
        ti[j] = ti[j + w];
        ts[j] = ts[j + w];
      }
    }
  }
  bv = tv[0];
  bi = ti[0];
  bs = ts[0];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// rows [r0, r0 + rows) × depth [c0, c0 + kKC) of src (row stride Dm) into
// dst (row stride ld); rows past rlim and depth past Dm are zero. vec:
// 16-byte cp.async (the caller commits), else plain element copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int r0,
                                      int rows, int rlim, int c0, int Dm,
                                      bool vec, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int cv = kKC / V;
    for (int e = tid; e < rows * cv; e += nthreads) {
      const int r = e / cv, col = (e % cv) * V;
      const int g = r0 + r, dd = c0 + col;
      const bool ok = g < rlim && dd < Dm;
      cp_async16(dst + r * ld + col, src + (ok ? (size_t)g * Dm + dd : 0),
                 ok);
    }
  } else {
    for (int e = tid; e < rows * kKC; e += nthreads) {
      const int r = e / kKC, col = e % kKC;
      const int g = r0 + r, dd = c0 + col;
      dst[r * ld + col] =
          (g < rlim && dd < Dm) ? src[(size_t)g * Dm + dd] : T(0.f);
    }
  }
}

// The number of entries of arr (sorted best first, n of them) better
// than (v, i).
__device__ __forceinline__ int count_better(const float* av, const int* ai,
                                            int n, float v, int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(av[mid], ai[mid], v, i))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Merge the run (rv, ri) of R new candidates (sorted best first) into the
// sorted list (tv, ti) of length K <= 64: the list becomes the best K of
// both. One half warp per list (lane & 15 takes entries h, h + 16, ...);
// every key is distinct (empty slots, all (NEG, IDX_PAD), rank below every
// candidate), so each entry's rank is its index plus the entries of the
// other side better than it. Called by all 32 lanes.
__device__ __forceinline__ void merge_half(float* tv, int* ti,
                                           const float* rv, const int* ri,
                                           int K, int R, int lane) {
  const int h = lane & 15;
  float ov[4], nv[4];
  int oi[4], ni[4], orank[4], nrank[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int e = h + 16 * s;
    orank[s] = nrank[s] = K;
    if (R > 0 && e < K) {
      ov[s] = tv[e];
      oi[s] = ti[e];
      orank[s] = e + count_better(rv, ri, R, ov[s], oi[s]);
    }
    if (e < R) {
      nv[s] = rv[e];
      ni[s] = ri[e];
      nrank[s] = e + count_better(tv, ti, K, nv[s], ni[s]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (orank[s] < K) {
      tv[orank[s]] = ov[s];
      ti[orank[s]] = oi[s];
    }
    if (nrank[s] < K) {
      tv[nrank[s]] = nv[s];
      ti[nrank[s]] = ni[s];
    }
  }
  __syncwarp();
}

// acc[i][j] += x row i · class row j over one staged depth chunk, one
// fmaf per d in increasing d; FULL: every class lane of the tile is live,
// else only j < jn.
template <typename T, int TM, int CLD, bool FULL>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][kTN],
                                          const T* xk, int xld,
                                          const T* cs, int jn) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    float4 xv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) xv[i] = ld4(xk + 2 * i * xld + kk);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (FULL || j < jn) {
        const float4 cv = ld4(cs + 16 * j * CLD + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(xv[i].x, cv.x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, cv.y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, cv.z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, cv.w, acc[i][j]);
        }
      }
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(TopkLayout<T, BM>::kThreads)
topk_kernel(const T* __restrict__ x, const T* __restrict__ c, float inv_tau,
            int B, int N, int NV, int Dm, int K, int chunk, int P, int NB,
            float* __restrict__ part_v, int* __restrict__ part_i,
            float* __restrict__ group_v, int* __restrict__ group_i,
            unsigned* __restrict__ counters, float* __restrict__ out_v,
            int* __restrict__ out_i) {
  using L = TopkLayout<T, BM>;
  constexpr int NTH = L::kThreads;
  constexpr int TM = L::TM;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int XLD = L::xld(Dm);
  T* Xs = reinterpret_cast<T*>(smem);
  T* ring = Xs + (size_t)BM * XLD;
  float* TV = reinterpret_cast<float*>(ring + (size_t)L::S * kBN * L::CLD);
  int* TI = reinterpret_cast<int*>(TV + BM * K);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ry = lane >> 4, cx = lane & 15;
  // this half warp's run: values [k], ids [k] (all runs' values first)
  float* RV = reinterpret_cast<float*>(TI + BM * K) + (warp * 2 + ry) * K;
  int* RI = reinterpret_cast<int*>(RV + L::kWarps * 2 * K);
  const int part = blockIdx.x, rb = blockIdx.y, row0 = rb * BM;
  const int c_lo = part * chunk, c_hi = min(N, c_lo + chunk);
  const int tiles = (c_hi - c_lo + kBN - 1) / kBN;
  const int nK = (Dm + kKC - 1) / kKC;
  const int Q = tiles * nK;               // staged chunks in all
  const bool vec = (Dm * (int)sizeof(T)) % 16 == 0 &&
                   (((size_t)x | (size_t)c) & 15) == 0;

  for (int e = tid; e < BM * K; e += NTH) {
    TV[e] = kNeg;
    TI[e] = kIdxPad;
  }

  // chunk q: class tile q / nK, depth chunk q % nK (with the image block's
  // depth chunk during the first tile)
  auto issue = [&](int q) {
    if (q < Q) {
      const int t = q / nK, kc = q % nK;
      const int cls0 = c_lo + t * kBN;
      const int rows = min(kBN, (c_hi - cls0 + 15) / 16 * 16);
      stage<T>(ring + (size_t)(q % L::S) * kBN * L::CLD, L::CLD, c, cls0,
               rows, c_hi, kc * kKC, Dm, vec, tid, NTH);
      if (t == 0)
        stage<T>(Xs + kc * kKC, XLD, x, row0, BM, B, kc * kKC, Dm, vec, tid,
                 NTH);
    }
    cp_async_commit();
  };

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const T* xrow = Xs + (size_t)(warp * L::RW + ry) * XLD;

  for (int q = 0; q < L::S - 1; ++q) issue(q);
  for (int q = 0; q < Q; ++q) {
    cp_async_wait<L::S - 2>();
    __syncthreads();          // chunk q is in; chunk q - 1's slot is free
    issue(q + L::S - 1);
    const int t = q / nK, kc = q % nK;
    const int cls0 = c_lo + t * kBN;
    const int jn = min(kTN, (c_hi - cls0 + 15) / 16);   // live class lanes
    const T* Cs = ring + (size_t)(q % L::S) * kBN * L::CLD + cx * L::CLD;
    const T* Xk = xrow + kc * kKC;
    if (jn == kTN)
      fma_chunk<T, TM, L::CLD, true>(acc, Xk, XLD, Cs, jn);
    else
      fma_chunk<T, TM, L::CLD, false>(acc, Xk, XLD, Cs, jn);
    if (kc != nK - 1) continue;

    // the tile's logits into this warp's rows' lists, a half warp per row:
    // the candidates that beat the row's k-th entry leave best first into
    // a run (at most k), which then merges into the list once
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int rl = warp * L::RW + ry + 2 * i;
      float* tv = TV + rl * K;
      int* ti = TI + rl * K;
      const float thv = tv[K - 1];
      const int thi = ti[K - 1];
      float val[kTN];
      int id[kTN];
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        id[j] = cls0 + cx + 16 * j;
        // a column at or past n_valid scores kNeg under its own id
        val[j] = id[j] < NV ? acc[i][j] * inv_tau : kNeg;
        if (row0 + rl < B && j < jn && id[j] < c_hi &&
            better(val[j], id[j], thv, thi))
          live |= 1u << j;
        acc[i][j] = 0.f;
      }
      int nr = 0;                        // the run's length (per half)
      while (__any_sync(kFull, live != 0u)) {
        float cv[kTN];
        int ci[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const bool in = (live >> j) & 1u;
          cv[j] = in ? val[j] : kNeg;
          ci[j] = in ? id[j] : kIdxPad;
        }
        float bv;
        int bi, bj;
        tourney<kTN>(cv, ci, bv, bi, bj);
        if (bi == kIdxPad) bj = -1;
        float hv = bv;
        int hi = bi;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, hv, off);
          const int oi = __shfl_xor_sync(kFull, hi, off);
          if (better(ov, oi, hv, hi)) {
            hv = ov;
            hi = oi;
          }
        }
        if (bj >= 0 && bi == hi) live &= ~(1u << bj);
        if (hi != kIdxPad) {             // live only held candidates
          if (cx == 0) {
            RV[nr] = hv;
            RI[nr] = hi;
          }
          if (++nr == K) live = 0u;
        }
      }
      __syncwarp();
      merge_half(tv, ti, RV, RI, K, nr, lane);
    }
  }
  cp_async_wait<0>();

  // this CTA's partial: (rows, k) with global class ids
  __syncthreads();
  const int PKS = (P * K + 3) / 4 * 4;     // a row's partials, 16-B padded
  for (int e = tid; e < BM * K; e += NTH) {
    const int rl = e / K, g = row0 + rl;
    if (g < B) {
      const size_t o = (size_t)g * PKS + (size_t)part * K + e % K;
      part_v[o] = TV[e];
      part_i[o] = TI[e];
    }
  }
  // the merge, a tree of two levels: the last CTA of each group of kGroup
  // partials to finish (a device counter per group, raised after
  // __threadfence, which that CTA resets) merges the group's partials into
  // a group partial; the last group to finish merges the groups into the
  // output. Each merging CTA reads at most kGroup partials per row.
  const int NG = (P + kGroup - 1) / kGroup;
  const int GKS = (NG * K + 3) / 4 * 4;    // a row's group partials
  const int grp = part / kGroup;
  const int gsize = min(kGroup, P - grp * kGroup);
  unsigned* cnt = counters + (size_t)rb * (NG + 1);
  const int nrows = min(BM, B - row0);
  const int npairs = (nrows + 1) / 2;
  const int h = lane & 15;
  // rows [row0, row0 + nrows) of src (row stride sks), partials
  // [first, first + n), into dst (row stride dks) at doff: a half warp per
  // row, two rows per warp, the rows' partials staged in the warp's buffer
  // (the next two rows' while these merge, NB = 2); k rounds of an arg-max
  // over the partials' heads, lane h holding partial h's.
  auto merge_rows = [&](const float* sv, const int* si, int sks, int first,
                        int n, float* dv, int* di, int dks, int doff) {
    const int seg = kGroup * K;              // staged floats per row
    const int span = (n * K + 3) / 4 * 4;    // of which read
    float* wbuf = reinterpret_cast<float*>(smem) + (size_t)warp * NB * 4 * seg;
    auto load_pair = [&](int pr, int buf) {
      float* bv = wbuf + (size_t)buf * 4 * seg;
      for (int r = 0; r < 2; ++r) {
        const int rl = 2 * pr + r;
        if (rl >= nrows) break;
        const size_t o = (size_t)(row0 + rl) * sks + (size_t)first * K;
        for (int e = lane; e < span / 4; e += 32) {
          cp_async16(bv + r * 2 * seg + 4 * e, sv + o + 4 * e, true);
          cp_async16(bv + r * 2 * seg + seg + 4 * e, si + o + 4 * e, true);
        }
      }
      cp_async_commit();
    };
    if (warp < npairs) load_pair(warp, 0);
    int buf = 0;
    for (int pr = warp; pr < npairs; pr += L::kWarps) {
      const int nx = pr + L::kWarps;
      if (NB == 2) {
        if (nx < npairs)
          load_pair(nx, buf ^ 1);
        else
          cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int rl = 2 * pr + ry;
      const bool row_ok = rl < nrows;
      const float* bv = wbuf + (size_t)buf * 4 * seg + ry * 2 * seg;
      const int* bi = reinterpret_cast<const int*>(bv + seg);
      // this lane's partial (lane h takes partial h): its head
      float cv = kNeg;
      int ci = kIdxPad, hd = 0;
      if (row_ok && h < n) {
        cv = bv[h * K];
        ci = bi[h * K];
      }
      const size_t g = (size_t)(row0 + rl);
      for (int e = 0; e < K; ++e) {
        float wv = cv;
        int wi = ci;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, wv, off);
          const int oi = __shfl_xor_sync(kFull, wi, off);
          if (better(ov, oi, wv, wi)) {
            wv = ov;
            wi = oi;
          }
        }
        if (h == 0 && row_ok) {
          dv[g * dks + doff + e] = wv;
          di[g * dks + doff + e] = wi;
        }
        if (ci != kIdxPad && ci == wi) {   // the winner's partial moves on
          ++hd;
          cv = hd < K ? bv[h * K + hd] : kNeg;
          ci = hd < K ? bi[h * K + hd] : kIdxPad;
        }
      }
      __syncwarp();
      if (NB == 2)
        buf ^= 1;
      else if (nx < npairs)
        load_pair(nx, 0);
    }
    cp_async_wait<0>();
  };

  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt + grp, 1u) == (unsigned)(gsize - 1);
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) cnt[grp] = 0u;          // ready for the next call
  __threadfence();
  if (NG == 1) {
    merge_rows(part_v, part_i, PKS, 0, P, out_v, out_i, K, 0);
    return;
  }
  merge_rows(part_v, part_i, PKS, grp * kGroup, gsize, group_v, group_i, GKS,
             grp * K);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt + NG, 1u) == (unsigned)(NG - 1);
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) cnt[NG] = 0u;
  __threadfence();
  merge_rows(group_v, group_i, GKS, 0, NG, out_v, out_i, K, 0);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* c, int b, int n, int n_valid,
                   int d, int k, float inv_tau, int chunk, int parts,
                   int nb, void* part_v, void* part_i, void* group_v,
                   void* group_i,
                   void* counters, void* out_v, void* out_i,
                   cudaStream_t stream) {
  using L = TopkLayout<T, BM>;
  const size_t smem = L::bytes(d, k, nb);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // the shared-memory limit, once per instantiation and device
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(topk_kernel<T, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemMax);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  const dim3 grid(parts, (b + BM - 1) / BM);
  topk_kernel<T, BM><<<grid, L::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c), inv_tau, b, n,
      n_valid, d, k, chunk, parts, nb, static_cast<float*>(part_v),
      static_cast<int*>(part_i), static_cast<float*>(group_v),
      static_cast<int*>(group_i), static_cast<unsigned*>(counters),
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. block_m: image rows per CTA, 16 or 64.
// n_valid in [0, n]: classes at or past it score -1e30 under their own id
// (the reference's runtime mask; n_valid = n masks nothing).
// CTA p takes classes [p·chunk, (p+1)·chunk); parts CTAs cover n. merge_nb: 1 or 2 row buffers
// per warp in a merge. part_v/part_i: (b, pks) fp32 / int32 scratch, pks =
// parts·k rounded up to a multiple of 4; group_v/group_i: (b, gks), gks =
// ceil(parts / 16)·k rounded up likewise; counters: ceil(parts / 16) + 1
// uint32 per row block, 0 before the call and 0 after it; out_v/out_i:
// (b, k). Returns the CUDA error code of the launch.
extern "C" int repro_similarity_topk(const void* x, const void* c, int dtype,
                                     int b, int n, int d, int k,
                                     int n_valid, float inv_tau, int block_m, int chunk,
                                     int parts, int merge_nb,
                                     void* part_v, void* part_i,
                                     void* group_v, void* group_i,
                                     void* counters, void* out_v,
                                     void* out_i, void* stream) {
  if (b < 1 || n < 1 || d < 1 || k < 1 || k > kMaxK || k > n || n_valid < 0 ||
      n_valid > n || chunk < 1 ||
      parts < 1 || parts > kMaxParts || (long long)chunk * parts < n ||
      (long long)chunk * (parts - 1) >= n || merge_nb < 1 || merge_nb > 2 ||
      (b + block_m - 1) / block_m > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TOPK_LAUNCH(T, DT, BM)                                        \
  if (dtype == DT && block_m == BM)                                         \
    return (int)launch<T, BM>(x, c, b, n, n_valid, d, k, inv_tau, chunk,   \
                              parts, merge_nb, part_v, part_i, group_v,     \
                              group_i, counters, out_v, out_i, st);
  REPRO_TOPK_LAUNCH(float, 0, 16)
  REPRO_TOPK_LAUNCH(float, 0, 64)
  REPRO_TOPK_LAUNCH(__nv_bfloat16, 1, 16)
  REPRO_TOPK_LAUNCH(__nv_bfloat16, 1, 64)
#undef REPRO_TOPK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

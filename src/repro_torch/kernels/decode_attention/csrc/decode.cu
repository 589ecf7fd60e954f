// Single-token GQA decode attention over a KV cache for Hopper (sm_90a),
// split over the cache length; plain C interface.
//
// Replaces: repro/kernels/decode_attention/kernel.py, decode_attention_bkv
// (:72) and its body _decode_kernel (:32). Same function: per (batch, kv
// head) row, the g query heads of the GQA group attend over the row's
// cache of t keys under a per-key validity mask, out = softmax(q·kᵀ·d^-1/2
// masked)·v in fp32, with NEG_INF = -1e30 scores and p set to exactly 0 at
// masked keys, and a max(l, 1e-30) guard so that a row with no valid key
// gives exact zeros. The output is in q's dtype. On request the merge also
// writes each row's fp32 log-sum-exp of its scaled valid scores (-1e30 for
// a row with none): a rank holding a slice of a cache's sequence merges
// its partial with the other ranks' through it (models/attention.py,
// merge_partials). The lse store is the only work the request adds.
//
// What bounds it on this card: device-memory bandwidth, over the keys the
// mask leaves. Each row reads its valid keys and values once and does
// 4·g·d flops per key, about g/2 flops per byte in bf16 (2 at g = 4), far
// below the card's ~295 flops per byte. A serving cache is mostly dead (8
// slots of ~550 tokens in a ring of 8192 leave ~7% valid), so a sweep of
// the whole cache moves ~15× the bytes the answer needs. This design does
// not reach the bandwidth at a full cache yet: each warp's 16-key step is
// a chain of dependent work (scores, softmax shuffles, p·v) that sets the
// pace (PERF.md, scripts/serving_anatomy.py).
//
// What the design does about it:
// - Split-K ("flash decoding"): each row's keys fall into chunks of
//   chunk_len keys, a function of t alone (never of the batch or the
//   mask), and each chunk yields a partial (m, l, acc) that a second
//   kernel merges in chunk order, with no atomics, so a result is the same
//   on every run (a merge by the row's last CTA inside the split kernel
//   measured slower: it runs after the row's sweep, on one CTA). A CTA (4
//   warps) takes chunks y, y + C, y + 2C, ... of one row; C is sized by
//   the wrapper so that the grid fills the card once. A chunk's partial
//   does not depend on the CTA that computes it, so a row's result does
//   not depend on its batch, and a (b, t) mask with equal rows gives the
//   shared-mask result bit for bit.
// - Skip what the mask kills, exactly: the CTA first reads its keys' mask
//   bytes into validity bits in shared memory (one coalesced pass). A chunk
//   with no valid key writes (NEG_INF, 0) at once; within a live chunk each
//   warp steps over units of 16 keys and skips a unit with no valid key:
//   no load, no math. Sweeping such a unit would change nothing (its
//   maximum leaves m as it is, alpha = exp(0) = 1 and p = 0), so skipping
//   it changes no bit; the merge reads no acc of a chunk whose l is 0.
// - K and V stay in their own dtype in shared memory, copied with 16-byte
//   cp.async into a per-warp ring of 2 stages, so a warp's next unit loads
//   while it computes the current one, with no barrier between warps
//   inside a chunk (3 and 4 stages measured slower at a full cache; more
//   CTAs fit an SM with 2). Values reach fp32 in registers.
// - bf16 scores on the tensor cores: K·Qᵀ with mma.m16n8k16 (16 keys in
//   M, the query heads in N, q's fragments held in registers), fp32
//   accumulators, the scale d^-1/2 applied to the fp32 scores. bf16
//   products are exact in fp32, so the scores keep fp32 accuracy. f32
//   inputs take fp32 FMAs (two lanes per key). p·v stays fp32 FMA in both.
// - Each warp keeps its own online softmax (m, l, acc[g][d]) over its
//   units; at a chunk's end the four warps' states fold in warp order into
//   the chunk's partial.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "../../flash_attention/csrc/tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnit = 16;          // keys per warp step (the mma's M)
constexpr int kMaxWords = 256;     // validity words per CTA: 8192 keys
constexpr int kMaxChunks = 64;
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <typename T, int D, int GP>
struct DecLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int KLD = D + 16 / (int)sizeof(T);  // padded key rows
  static constexpr int S = 2;                          // ring stages
  static constexpr int NT = (GP + 7) / 8;              // mma N tiles (bf16)
  static constexpr int GPAD = kBf16 ? 8 * NT : GP;     // p row width
  static constexpr size_t stage = (size_t)kUnit * (KLD + D) * sizeof(T);
  static constexpr size_t ring = stage * S * kWarps;
  // per warp: p [16][GPAD] and alpha [GPAD]; at a chunk's end the same
  // bytes hold warps 1..3's acc [3][GP][D]
  static constexpr size_t scratch = cmax(
      sizeof(float) * kWarps * (kUnit * GPAD + GPAD),
      sizeof(float) * 3 * GP * D);
  static constexpr size_t qbytes =
      kBf16 ? 0 : sizeof(float) * GP * 2 * (D / 2 + 4);
  // then m and l [warps][GP], validity words, chunk flags
  static constexpr size_t bytes = ring + scratch + qbytes +
                                  sizeof(float) * 2 * kWarps * GP +
                                  sizeof(unsigned) * kMaxWords +
                                  sizeof(int) * kMaxChunks;
};

// CPL consecutive values of T at p as fp32
template <int CPL>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if (CPL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
}
template <int CPL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float* out) {
  if (CPL == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    out[0] = __uint_as_float(u << 16);
    out[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int G, int Tk,
                    int chunk_len, int n_chunks, int C, int mask_div,
                    float scale) {
  using L = DecLayout<T, D, GP>;
  constexpr int CPL = D / 32;        // output columns per lane in p·v
  constexpr int KS = D / 16;         // mma k steps over d
  constexpr int NT = L::NT;
  constexpr int GPAD = L::GPAD;
  constexpr size_t STAGE = L::stage / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scr = reinterpret_cast<float*>(smem + L::ring);
  float* Qs = reinterpret_cast<float*>(smem + L::ring + L::scratch);
  float* Rm = reinterpret_cast<float*>(smem + L::ring + L::scratch +
                                       L::qbytes);
  float* Rl = Rm + kWarps * GP;
  unsigned* VB = reinterpret_cast<unsigned*>(Rl + kWarps * GP);
  int* live_chunk = reinterpret_cast<int*>(VB + kMaxWords);

  const int row = blockIdx.x;
  const int y = blockIdx.y;
  const int h0 = blockIdx.z * GP;
  const int gn = min(GP, G - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ncta = (n_chunks - y + C - 1) / C;   // chunks of this CTA
  const int wpc = chunk_len / 32;                // validity words per chunk
  const int upw = chunk_len / (kUnit * kWarps);  // units per warp per chunk
  const int nj = ncta * upw;
  const unsigned char* vmask =
      valid + (mask_div > 0 ? (size_t)(row / mask_div) * Tk : 0);
  const T* krow = k + (size_t)row * Tk * D;
  const T* vrow = v + (size_t)row * Tk * D;

  // 0. the query heads (their loads in flight during the mask scan): bf16
  //    as mma B fragments in registers, f32 in Qs
  unsigned qb[NT][KS][2];
  if constexpr (L::kBf16) {
    const int hg = lane >> 2, dt = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int hi = nt * 8 + hg;
      const T* qr = q + ((size_t)row * G + h0 + hi) * D;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qb[nt][ks][0] = hi < gn ? *reinterpret_cast<const unsigned*>(
                                      qr + ks * 16 + dt)
                                : 0u;
        qb[nt][ks][1] = hi < gn ? *reinterpret_cast<const unsigned*>(
                                      qr + ks * 16 + dt + 8)
                                : 0u;
      }
    }
  } else {
    for (int e = tid; e < GP * D; e += kThreads) {
      const int gi = e / D, dd = e % D;
      Qs[(gi * 2 + dd / (D / 2)) * (D / 2 + 4) + dd % (D / 2)] =
          gi < gn ? to_f32(q[((size_t)row * G + h0 + gi) * D + dd]) : 0.f;
    }
  }
  // 1. validity bits of this CTA's keys, 32 keys a word (keys past t: 0),
  //    eight independent mask loads in flight per lane
  for (int w0 = warp; w0 < ncta * wpc; w0 += 8 * kWarps) {
    bool ok[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * kWarps;
      const int key =
          (y + (w / wpc) * C) * chunk_len + (w % wpc) * 32 + lane;
      ok[u] = w < ncta * wpc && key < Tk && vmask[key] != 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned bits = __ballot_sync(kFull, ok[u]);
      if (lane == 0 && w0 + u * kWarps < ncta * wpc) VB[w0 + u * kWarps] = bits;
    }
  }
  __syncthreads();
  // 2. a chunk with no valid key: its partial is (NEG_INF, 0) at once
  if (tid < ncta) {
    int live = 0;
    for (int w = 0; w < wpc; ++w) live |= VB[tid * wpc + w] != 0u;
    live_chunk[tid] = live;
    if (!live) {
      const int chunk = y + tid * C;
      for (int gi = 0; gi < gn; ++gi) {
        const size_t o = ((size_t)row * G + h0 + gi) * n_chunks + chunk;
        part_m[o] = kNegInf;
        part_l[o] = 0.f;
      }
    }
  }
  __syncthreads();

  // this warp's units: j -> chunk slot j / upw, unit (j % upw)·4 + warp
  auto unit_bits = [&](int j) -> unsigned {
    const int s = j / upw, u = (j % upw) * kWarps + warp;
    return (VB[s * wpc + (u >> 1)] >> ((u & 1) * 16)) & 0xffffu;
  };
  auto next_live = [&](int j) {
    while (j < nj && unit_bits(j) == 0u) ++j;
    return j;
  };
  auto unit_key0 = [&](int j) {
    const int s = j / upw, u = (j % upw) * kWarps + warp;
    return (y + s * C) * chunk_len + u * kUnit;
  };
  T* wring = ring + (size_t)warp * L::S * STAGE;
  auto issue = [&](int j, int slot) {
    if (j < nj) {
      T* Ks = wring + slot * STAGE;
      T* Vs = Ks + kUnit * L::KLD;
      constexpr int EPV = 16 / (int)sizeof(T);
      constexpr int VPR = D / EPV;           // 16-byte pieces per row
      const int key0 = unit_key0(j);
#pragma unroll
      for (int e = lane; e < kUnit * VPR; e += 32) {
        const int r = e / VPR, col = (e % VPR) * EPV;
        const bool ok = key0 + r < Tk;
        const size_t off = ok ? (size_t)(key0 + r) * D + col : 0;
        cp_async16(Ks + r * L::KLD + col, krow + off, ok);
        cp_async16(Vs + r * D + col, vrow + off, ok);
      }
    }
    cp_async_commit();
  };

  float* Ps = scr + warp * (kUnit * GPAD + GPAD);   // p [16][GPAD]
  float* Al = Ps + kUnit * GPAD;                      // alpha [GPAD]
  float* Racc = scr;                                  // [3][GP][D]
  // the warp's running state: bf16 — lane (g, t) holds heads
  // nt·8 + 2t + {0, 1}; f32 — every lane holds every head
  constexpr int NS = L::kBf16 ? 2 * NT : GP;
  float m[NS], l[NS];
  float acc[GP][CPL];

  int jc = next_live(0);     // the next unit to compute
  int jp = jc;               // the next unit to load
  for (int i = 0; i < L::S - 1; ++i) {
    issue(jp, i);
    if (jp < nj) jp = next_live(jp + 1);
  }
  int n = 0;                 // live units computed so far (ring position)
  for (int s = 0; s < ncta; ++s) {
    if (!live_chunk[s]) continue;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < GP; ++gi)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[gi][c] = 0.f;

    while (jc < nj && jc / upw == s) {
      cp_async_wait<L::S - 2>();
      __syncwarp();
      issue(jp, (n + L::S - 1) % L::S);
      if (jp < nj) jp = next_live(jp + 1);
      const T* Ks = wring + (n % L::S) * STAGE;
      const T* Vs = Ks + kUnit * L::KLD;
      const unsigned bits = unit_bits(jc);

      // scores, online softmax and p of this unit's 16 keys
      if constexpr (L::kBf16) {
        float sc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
        const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          unsigned a[4];
          ldsm_x4(a, Ks + ((lm & 1) * 8 + lr) * L::KLD + ks * 16 +
                         (lm >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma16816(sc[nt], a, qb[nt][ks][0], qb[nt][ks][1]);
        }
        const int g = lane >> 2, t = lane & 3;
        const bool ok0 = (bits >> g) & 1u, ok1 = (bits >> (g + 8)) & 1u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int si = 2 * nt + e;
            const float s0 = ok0 ? sc[nt][e] * scale : kNegInf;
            const float s1 = ok1 ? sc[nt][2 + e] * scale : kNegInf;
            float mx = fmaxf(s0, s1);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
            const float m_new = fmaxf(m[si], mx);
            const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
            const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
            float sum = p0 + p1;
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              sum += __shfl_xor_sync(kFull, sum, off);
            const float alpha = expf(m[si] - m_new);
            l[si] = l[si] * alpha + sum;
            m[si] = m_new;
            const int hc = nt * 8 + 2 * t + e;
            Ps[g * GPAD + hc] = p0;
            Ps[(g + 8) * GPAD + hc] = p1;
            if (g == 0) Al[hc] = alpha;
          }
        }
      } else {
        const int key = lane & 15, half = lane >> 4;
        const float* kr = reinterpret_cast<const float*>(Ks) +
                          key * L::KLD + half * (D / 2);
        float sv[GP];
#pragma unroll
        for (int gi = 0; gi < GP; ++gi) sv[gi] = 0.f;
#pragma unroll 4
        for (int dd = 0; dd < D / 2; dd += 4) {
          const float4 kx = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
          for (int gi = 0; gi < GP; ++gi) {
            const float4 qx = *reinterpret_cast<const float4*>(
                Qs + (gi * 2 + half) * (D / 2 + 4) + dd);
            sv[gi] = fmaf(qx.x, kx.x, sv[gi]);
            sv[gi] = fmaf(qx.y, kx.y, sv[gi]);
            sv[gi] = fmaf(qx.z, kx.z, sv[gi]);
            sv[gi] = fmaf(qx.w, kx.w, sv[gi]);
          }
        }
        const bool ok = (bits >> key) & 1u;
#pragma unroll
        for (int gi = 0; gi < GP; ++gi) {
          const float full = sv[gi] + __shfl_xor_sync(kFull, sv[gi], 16);
          const float sk = ok ? full * scale : kNegInf;
          float mx = sk;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float m_new = fmaxf(m[gi], mx);
          const float p = ok ? expf(sk - m_new) : 0.f;
          float sum = p;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1)
            sum += __shfl_xor_sync(kFull, sum, off);
          const float alpha = expf(m[gi] - m_new);
          l[gi] = l[gi] * alpha + sum;
          m[gi] = m_new;
          if (half == 0) Ps[key * GPAD + gi] = p;
          if (lane == 0) Al[gi] = alpha;
        }
      }
      __syncwarp();
      // acc = acc·alpha + p·v over the unit's keys; this lane's columns
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        const float a = Al[gi];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[gi][c] *= a;
      }
#pragma unroll 4
      for (int r = 0; r < kUnit; ++r) {
        float vv[CPL];
        load_cols<CPL>(Vs + r * D + lane * CPL, vv);
#pragma unroll
        for (int g4 = 0; g4 < GP; g4 += 4) {
          const float4 p = *reinterpret_cast<const float4*>(
              Ps + r * GPAD + g4);
          const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[g4 + i][c] = fmaf(pp[i], vv[c], acc[g4 + i][c]);
        }
      }
      ++n;
      jc = next_live(jc + 1);
    }

    // 3. fold the four warps' states into the chunk's partial, in warp
    //    order (a warp that saw no valid key has m = NEG_INF, l = 0,
    //    acc = 0 and weight 0)
    __syncthreads();   // every warp is done with the chunk's p scratch
    if constexpr (L::kBf16) {
      if (lane < 4) {
#pragma unroll
        for (int si = 0; si < NS; ++si) {
          const int hc = (si >> 1) * 8 + 2 * lane + (si & 1);
          if (hc < GP) {
            Rm[warp * GP + hc] = m[si];
            Rl[warp * GP + hc] = l[si];
          }
        }
      }
    } else {
      if (lane == 0) {
#pragma unroll
        for (int gi = 0; gi < GP; ++gi) {
          Rm[warp * GP + gi] = m[gi];
          Rl[warp * GP + gi] = l[gi];
        }
      }
    }
    if (warp > 0) {
#pragma unroll
      for (int gi = 0; gi < GP; ++gi)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          Racc[((warp - 1) * GP + gi) * D + lane * CPL + c] = acc[gi][c];
    }
    __syncthreads();
    if (warp == 0) {
      const int chunk = y + s * C;
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        if (gi < gn) {
          float M = Rm[gi];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) M = fmaxf(M, Rm[w * GP + gi]);
          float wt[kWarps];
          float lsum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            wt[w] = expf(Rm[w * GP + gi] - M);
            lsum = fmaf(Rl[w * GP + gi], wt[w], lsum);
          }
          const size_t o = ((size_t)row * G + h0 + gi) * n_chunks + chunk;
          float out[CPL];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float a = acc[gi][c] * wt[0];
#pragma unroll
            for (int w = 1; w < kWarps; ++w)
              a = fmaf(Racc[((w - 1) * GP + gi) * D + lane * CPL + c], wt[w],
                       a);
            out[c] = a;
          }
          float* dst = part_acc + o * D + lane * CPL;
          if (CPL == 2)
            *reinterpret_cast<float2*>(dst) = make_float2(out[0], out[1]);
          else
            *reinterpret_cast<float4*>(dst) =
                make_float4(out[0], out[1], out[2], out[3]);
          if (lane == 0) {
            part_m[o] = M;
            part_l[o] = lsum;
          }
        }
      }
    }
    __syncthreads();   // Racc is read before the next chunk writes p
  }
  cp_async_wait<0>();
}

// One CTA per (row, head), one thread per output column: merges the row's
// chunk partials in chunk order. The chunks' (m, l) and weights go through
// shared memory first, and only the chunks with a valid key (l != 0; the
// acc of the others was never written) are read, several loads in flight
// per thread. All chunks empty: L = 0, acc = 0, so the output is
// 0 / 1e-30 = 0. A non-null lse also takes the row's log-sum-exp of its
// scaled valid scores, M + log L, or kNegInf where L = 0 (no valid key).
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    float* __restrict__ lse, int G, int n_chunks) {
  __shared__ float Wt[kMaxChunks];
  __shared__ float Lc[kMaxChunks];
  __shared__ int live[kMaxChunks];
  __shared__ float ML[2];          // the row's max and sum
  __shared__ int n_live;
  const int row = blockIdx.x;
  const int gi = blockIdx.y;
  const int c = threadIdx.x;
  const size_t base = ((size_t)row * G + gi) * n_chunks;
  const float mc = c < n_chunks ? part_m[base + c] : kNegInf;
  const float lc = c < n_chunks ? part_l[base + c] : 0.f;
  if (c < n_chunks) {
    Wt[c] = mc;
    Lc[c] = lc;
  }
  __syncthreads();
  if (c == 0) {
    float mx = kNegInf;
    for (int ch = 0; ch < n_chunks; ++ch) mx = fmaxf(mx, Wt[ch]);
    ML[0] = mx;
  }
  __syncthreads();
  if (c < n_chunks) Wt[c] = lc != 0.f ? expf(mc - ML[0]) : 0.f;
  if (c < n_chunks) live[c] = lc != 0.f;
  __syncthreads();
  if (c == 0) {
    float lsum = 0.f;
    int nl = 0;
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (live[ch]) {
        lsum = fmaf(Lc[ch], Wt[ch], lsum);
        live[nl++] = ch;      // compacted in chunk order
      }
    }
    ML[1] = lsum;
    n_live = nl;
    if (lse != nullptr)
      lse[(size_t)row * G + gi] =
          lsum > 0.f ? ML[0] + logf(lsum) : kNegInf;
  }
  __syncthreads();
  const float* acc = part_acc + base * D + c;
  float a = 0.f;
  const int nl = n_live;
  int i = 0;
  for (; i + 8 <= nl; i += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = acc[(size_t)live[i + u] * D];
#pragma unroll
    for (int u = 0; u < 8; ++u) a = fmaf(x[u], Wt[live[i + u]], a);
  }
  for (; i < nl; ++i) a = fmaf(acc[(size_t)live[i] * D], Wt[live[i]], a);
  store(out + ((size_t)row * G + gi) * D + c, a / fmaxf(ML[1], 1e-30f));
}

// cudaFuncSetAttribute for the split kernel's shared memory, once per
// instantiation and device
template <typename T, int D, int GP>
cudaError_t allow_smem() {
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_kernel<T, D, GP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DecLayout<T, D, GP>::bytes);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <typename T, int D, int GP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, float* lse, float* part,
                   int bkv, int g, int t, int mask_div, int chunk_len,
                   int n_chunks, int C, float scale, cudaStream_t stream) {
  constexpr size_t smem = DecLayout<T, D, GP>::bytes;
  cudaError_t err = allow_smem<T, D, GP>();
  if (err != cudaSuccess) return err;
  const size_t ml = (size_t)bkv * g * n_chunks;
  const dim3 grid(bkv, C, (g + GP - 1) / GP);
  decode_split_kernel<T, D, GP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      part, part + ml, part + 2 * ml, g, t, chunk_len, n_chunks, C, mask_div,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(bkv, g), D, 0, stream>>>(
      part, part + ml, part + 2 * ml, static_cast<T*>(out), lse, g,
      n_chunks);
  return cudaGetLastError();
}

template <typename T, int D, int GP>
cudaError_t occupancy(int* blocks) {
  cudaError_t err = allow_smem<T, D, GP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_split_kernel<T, D, GP>, kThreads,
      DecLayout<T, D, GP>::bytes);
}

// the instantiation for (dtype, d, group): f(Launcher<T, D, GP>)
template <typename F>
cudaError_t dispatch(int dtype, int d, int gp, F&& f) {
#define REPRO_DEC(T, DT, D, GP) \
  if (dtype == DT && d == D && gp == GP) return f.template run<T, D, GP>();
  REPRO_DEC(float, 0, 64, 4)
  REPRO_DEC(float, 0, 64, 8)
  REPRO_DEC(float, 0, 64, 16)
  REPRO_DEC(float, 0, 128, 4)
  REPRO_DEC(float, 0, 128, 8)
  REPRO_DEC(float, 0, 128, 16)
  REPRO_DEC(__nv_bfloat16, 1, 64, 4)
  REPRO_DEC(__nv_bfloat16, 1, 64, 8)
  REPRO_DEC(__nv_bfloat16, 1, 64, 16)
  REPRO_DEC(__nv_bfloat16, 1, 128, 4)
  REPRO_DEC(__nv_bfloat16, 1, 128, 8)
  REPRO_DEC(__nv_bfloat16, 1, 128, 16)
#undef REPRO_DEC
  return cudaErrorInvalidValue;
}

struct LaunchArgs {
  const void *q, *k, *v, *valid;
  void* out;
  float* lse;
  float* part;
  int bkv, g, t, mask_div, chunk_len, n_chunks, C;
  float scale;
  cudaStream_t stream;
  template <typename T, int D, int GP>
  cudaError_t run() {
    return launch<T, D, GP>(q, k, v, valid, out, lse, part, bkv, g, t,
                            mask_div, chunk_len, n_chunks, C, scale, stream);
  }
};

struct OccupancyArgs {
  int* blocks;
  template <typename T, int D, int GP>
  cudaError_t run() {
    return occupancy<T, D, GP>(blocks);
  }
};

}  // namespace

// q (bkv, g, d); k/v (bkv, t, d); valid: bool bytes, one row of t shared
// by every cache row (mask_div = 0) or one row per group of mask_div
// consecutive cache rows (row r reads mask row r / mask_div); out
// (bkv, g, d) in q's dtype; lse: null, or fp32 (bkv, g), each row's
// log-sum-exp of its scaled valid scores (-1e30 where it has none); part:
// fp32 scratch, m and l (bkv, g, n_chunks)
// each, then acc (bkv, g, n_chunks, d). Keys [c·chunk_len,
// (c+1)·chunk_len) go to chunk c; a CTA takes chunks y, y + C, ... of its
// row, at most kMaxWords·32 keys in all. group: query heads per CTA (4, 8
// or 16). dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, void* lse, void* part,
                                      int dtype,
                                      int bkv, int g, int t, int d,
                                      int mask_div, int chunk_len,
                                      int n_chunks, int ctas_per_row,
                                      int group, float scale, void* stream) {
  const int C = ctas_per_row;
  if (bkv < 1 || g < 1 || t < 1 || mask_div < 0 || chunk_len < 1 ||
      chunk_len % (kUnit * kWarps * 2) != 0 ||
      n_chunks != (t + chunk_len - 1) / chunk_len ||
      n_chunks > kMaxChunks || C < 1 || C > n_chunks ||
      (long long)((n_chunks + C - 1) / C) * chunk_len >
          (long long)kMaxWords * 32 ||
      (g + group - 1) / group > 65535)
    return (int)cudaErrorInvalidValue;
  LaunchArgs a{q, k, v, valid, out, static_cast<float*>(lse),
               static_cast<float*>(part), bkv, g, t, mask_div, chunk_len,
               n_chunks, C, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, d, group, a);
}

// Resident split-kernel CTAs per SM for (dtype, d, group), into *blocks.
extern "C" int repro_decode_blocks_per_sm(int dtype, int d, int group,
                                          int* blocks) {
  OccupancyArgs a{blocks};
  return (int)dispatch(dtype, d, group, a);
}

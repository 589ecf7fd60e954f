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
// Both dtypes take one design:
//   delta  one warp per query row: delta = rowsum(dout·out) in fp32;
//   main   one CTA per (kv row, block of 16·W keys), W warps, each warp
//          owning 16 keys. k and v of the block stay in shared memory for
//          the whole CTA; 32-row q and dout tiles of every query head of the
//          GQA group stream through a double-buffered ring of 16-byte
//          cp.async copies, the next tile loading while the current one is
//          multiplied. Per tile each warp computes its sᵀ = k·qᵀ and
//          dpᵀ = v·doutᵀ (16 × 32, fp32 accumulators), turns them into pᵀ
//          and dsᵀ in registers and feeds them straight back as the A
//          operands of dv += pᵀ·dout and dk += dsᵀ·q; dsᵀ also goes to
//          shared memory, where all warps then compute the tile's dq = ds·k.
//          The d^-1/2 scale is applied to the fp32 scores and to the dk and
//          dq accumulators. Each product runs once: five in all, nothing
//          recomputed. When one block holds every key it writes dq itself;
//          longer t splits the keys over CTAs, each writing an fp32 dq
//          partial, and
//   dq_sum sums the partials in key-block order (only rows a block can
//          reach), scales them and writes dq in the input dtype.
// No atomics anywhere, so every run gives the same bits; masked-out q tiles
// are skipped, and the ragged tail is zero-filled as it is staged.
//
// bf16 inputs (the training path): mma.sync.m16n8k16 bf16 -> fp32 fed by
// ldmatrix from rows padded by 16 bytes against bank conflicts; p and ds
// are rounded to bf16 where they become mma operands, as the plain version
// does for bf16 inputs. W = 4 when t <= 64, else 16 at d 64 (256 keys) and
// 8 at d 128 (ops.bwd_plan).
//
// f32 inputs (--precision f32 training): every product is split 3×TF32 on
// mma.sync.m16n8k8 tf32 (tc.cuh: each fp32 operand split into tf32 hi and
// lo by cvt.rna, ah·bl + al·bh + ah·bh summed in fp32, small products
// first), about 2^-21 of each product's size against 2^-24 for an fp32
// FMA, inside the f32 limit (2e-4 on dq, dk, dv); plain TF32 would not hold
// it. Operands stay fp32 in shared memory in rows of D + 4 floats (the
// 32-bit fragment loads touch 32 banks). Once a q/dout tile lands, the
// CTA's threads split it together (hi in place, lo beside it), so each of
// its elements is split once per CTA, not once per warp and product; k and
// v (A operands, a warp's own 16 rows) and k in dq = ds·k are split as
// their fragments load, and dsᵀ is stored split, as tf32 hi and lo planes.
// The C fragment gives a thread columns 2t and 2t + 1, the A fragment
// wants t and t + 4, so where a C fragment becomes an A fragment (pᵀ, dsᵀ)
// A's columns stand for the queries in that order and the B operand (dout,
// q) is read in the same order, as are ds's keys and k's rows in
// dq = ds·k, whose even and odd k-steps sum into separate accumulators.
// The key block is t rounded up to 16 while the shared memory allows (208
// keys at d 64, 96 at d 128: k and v of a whole tower head stay resident,
// and the image tower's s = 196 costs 208 keys in 13 warps), else 208 / 96
// with dq partials; q tiles are masked at the row, so s = 196 costs 7
// tiles of 32 rows. p is exp(s·d^-1/2 + bias − lse) by expf, fp32 as the
// plain version. dv and dk sum each q tile from zero in the mma
// accumulators and add that to their running sums in fp32: the tensor
// core's accumulation truncates, and a running sum kept in the C operand
// over every tile of a long causal GQA group drifted (tile_product). What bounds it: the splits left (k, v and the dq
// phase's k, split per warp) and the dq phase, where 8 of 13 warps work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#include "tc.cuh"

namespace {

constexpr int kThreads = 128;           // delta kernel: 4 rows per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
// blocks that hold a key the row attends, in dq's dtype T; one thread per
// element. Shared by the bf16 and f32 designs.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum_kernel(const float* __restrict__ part,
                        T* __restrict__ dq, int rows, int S,
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
  store(dq + idx, acc * scale);
}

template <int D, int W>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* bias, const void* out, const void* dout,
                      const void* lse, void* delta, void* dq, void* dk,
                      void* dv, void* dq_part, int bh, int s, int t,
                      int smem, int group, int bias_group, int causal,
                      int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int nkb = (t + 16 * W - 1) / (16 * W);
  if ((nkb > 1 && dq_part == nullptr) ||
      (size_t)smem != TcLayout<D, W>::bytes)
    return cudaErrorInvalidValue;
  const int rows = bh * s;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<bf16, D>
      <<<(rows + rows_per_cta - 1) / rows_per_cta, kThreads, 0, stream>>>(
          static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
          static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

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
  flash_bwd_dq_sum_kernel<bf16, D>
      <<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(dq_part), static_cast<bf16*>(dq), rows, s,
          t, 16 * W, nkb, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the split 3×TF32 tensor-core backward
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 32;       // query rows per streamed tile

// Shared-memory layout of the f32 main kernel, fp32 rows of D + 4 (the
// 32-bit fragment loads touch 32 banks): k, v [BK]; q, dout [2 stages][BQ]
// (a landed tile is split in place: its tf32 hi there, its lo in the next
// plane); the lo of q and dout [2][BQ]; dsᵀ as tf32 hi and lo planes
// [BK][BQ + 4]; lse, delta [2][BQ] and bias [BK]. BK = 16·W keys, W at
// most kMaxW: the largest block that fits one CTA (kSmemLimit), 208 keys
// at d 64 and 96 at d 128.
template <int D>
struct F32Bwd {
  static constexpr int kMaxW = D == 64 ? 13 : 6;
  static constexpr int LD = D + 4;
  static constexpr int LDS = kF32BQ + 4;
  static constexpr size_t bytes(int bk) {
    return sizeof(float) * (2 * (size_t)bk * LD + 6 * (size_t)kF32BQ * LD +
                            2 * (size_t)bk * LDS + 4 * kF32BQ + bk);
  }
};
constexpr size_t kSmemLimit = 232448;   // what one CTA may hold (227 KB)
static_assert(F32Bwd<64>::bytes(16 * F32Bwd<64>::kMaxW) <= kSmemLimit &&
                  F32Bwd<64>::bytes(16 * F32Bwd<64>::kMaxW + 16) > kSmemLimit,
              "kMaxW at d 64 is the largest block that fits");
static_assert(F32Bwd<128>::bytes(16 * F32Bwd<128>::kMaxW) <= kSmemLimit &&
                  F32Bwd<128>::bytes(16 * F32Bwd<128>::kMaxW + 16) >
                      kSmemLimit,
              "kMaxW at d 128 is the largest block that fits");

// out (16 keys × D) = aᵀ · b over one tile's kF32BQ queries, from zero, in
// split 3×TF32: a is a warp's C fragments (keys × queries, fp32: pᵀ or
// dsᵀ), b a split q or dout tile (tf32 hi and lo planes, rows of D + 4)
template <int D>
__device__ __forceinline__ void tile_product(float (&out)[D / 8][4],
                                             float (&a)[kF32BQ / 8][4],
                                             const unsigned* bh,
                                             const unsigned* bl, int gq,
                                             int tq) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[dn][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kF32BQ / 8; ++j) {
    unsigned ah[4], al[4];
    split_tf32(a[j][0], ah[0], al[0]);   // key g,     query 2t
    split_tf32(a[j][2], ah[1], al[1]);   // key g + 8, query 2t
    split_tf32(a[j][1], ah[2], al[2]);   // key g,     query 2t + 1
    split_tf32(a[j][3], ah[3], al[3]);   // key g + 8, query 2t + 1
    const int br = (8 * j + 2 * tq) * LD + gq;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int b0 = br + dn * 8, b1 = br + LD + dn * 8;
      mma_3xtf32(out[dn], ah, al, bh[b0], bh[b1], bl[b0], bl[b1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * F32Bwd<D>::kMaxW, 1)
flash_bwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, float* __restrict__ dk,
                        float* __restrict__ dv, float* __restrict__ dq_part,
                        int S, int Tk, int group, int bias_group, int causal,
                        int window, float scale) {
  using L = F32Bwd<D>;
  constexpr int BQ = kF32BQ;
  constexpr int LD = L::LD;
  constexpr int LDS = L::LDS;
  constexpr int DN = D / 8;        // n-tiles of d; k-steps of sᵀ and dpᵀ
  constexpr int QN = BQ / 8;       // n-tiles of a q tile; k-steps of dv, dk
  constexpr int DQ_UNITS = (BQ / 16) * (DN / 2);   // 16 rows × 16 columns
  const int W = blockDim.x >> 5;
  const int BK = 16 * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BK][LD]
  float* Vs = Ks + (size_t)BK * LD;                 // [BK][LD]
  float* Qs = Vs + (size_t)BK * LD;                 // [2][BQ][LD]
  float* dOs = Qs + 2 * BQ * LD;                    // [2][BQ][LD]
  unsigned* QDl = reinterpret_cast<unsigned*>(dOs + 2 * BQ * LD);
  const unsigned* Ql = QDl;                         // [BQ][LD] lo of q
  const unsigned* dOl = QDl + BQ * LD;              // [BQ][LD] lo of dout
  unsigned* dSh = QDl + 2 * BQ * LD;
  unsigned* dSl = dSh + (size_t)BK * LDS;           // [BK][LDS] each
  float* lse_s = reinterpret_cast<float*>(dSl + (size_t)BK * LDS);  // [2][BQ]
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
  const int tq = lane & 3;      // thread in group: fragment column
  const int kw0 = 16 * warp;    // this warp's first key (block-local)
  const bool active = kw0 < nk;
  const bool split = gridDim.y > 1;

  stage_rows_f32<D>(Ks, k + (size_t)kvr * Tk * D, k0, BK, Tk);
  stage_rows_f32<D>(Vs, v + (size_t)kvr * Tk * D, k0, BK, Tk);
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
    stage_rows_f32<D>(Qs + st * BQ * LD, q + (size_t)bh * S * D, q0, BQ, S);
    stage_rows_f32<D>(dOs + st * BQ * LD, dout + (size_t)bh * S * D, q0, BQ,
                      S);
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
      for (int e = tid; e < BK; e += blockDim.x) {
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
    __syncthreads();   // this tile landed; the last tile's readers are done

    // split q and dout once for every warp: tf32 hi in place, lo beside
    for (int e = tid; e < 2 * BQ * (D / 4); e += blockDim.x) {
      const int isd = e >= BQ * (D / 4);
      const int r = (e / (D / 4)) % BQ, c = (e % (D / 4)) * 4;
      float* x = (isd ? dOs : Qs) + (st * BQ + r) * LD + c;
      const float4 f = *reinterpret_cast<const float4*>(x);
      uint4 h, l;
      split_tf32(f.x, h.x, l.x);
      split_tf32(f.y, h.y, l.y);
      split_tf32(f.z, h.z, l.z);
      split_tf32(f.w, h.w, l.w);
      *reinterpret_cast<uint4*>(x) = h;
      *reinterpret_cast<uint4*>(QDl + (isd * BQ + r) * LD + c) = l;
    }
    __syncthreads();

    const unsigned* Qh = reinterpret_cast<const unsigned*>(Qs + st * BQ * LD);
    const unsigned* dOh =
        reinterpret_cast<const unsigned*>(dOs + st * BQ * LD);
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;

    if (active) {
      // sᵀ = k·qᵀ and dpᵀ = v·doutᵀ for this warp's 16 keys × BQ queries;
      // A holds rows g, g + 8 and columns t, t + 4 of each 8-wide k-step
      float s_acc[QN][4], p_acc[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] = p_acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DN; ++kk) {
        const int ar = (kw0 + gq) * LD + kk * 8 + tq;
        unsigned ah[4], al[4];
        split_tf32(Ks[ar], ah[0], al[0]);
        split_tf32(Ks[ar + 8 * LD], ah[1], al[1]);
        split_tf32(Ks[ar + 4], ah[2], al[2]);
        split_tf32(Ks[ar + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int br = (8 * j + gq) * LD + kk * 8 + tq;
          mma_3xtf32(s_acc[j], ah, al, Qh[br], Qh[br + 4], Ql[br],
                     Ql[br + 4]);
        }
        split_tf32(Vs[ar], ah[0], al[0]);
        split_tf32(Vs[ar + 8 * LD], ah[1], al[1]);
        split_tf32(Vs[ar + 4], ah[2], al[2]);
        split_tf32(Vs[ar + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int br = (8 * j + gq) * LD + kk * 8 + tq;
          mma_3xtf32(p_acc[j], ah, al, dOh[br], dOh[br + 4], dOl[br],
                     dOl[br + 4]);
        }
      }

      // pᵀ = exp(sᵀ·d^-1/2 + bias − lse) on the valid entries (0 elsewhere)
      // and dsᵀ = pᵀ·(dpᵀ − delta), in place of sᵀ and dpᵀ; dsᵀ also goes
      // to shared memory as tf32 hi and lo planes for dq = ds·k
#pragma unroll
      for (int j = 0; j < QN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kw0 + gq + (e >> 1) * 8;
          const int ql = 8 * j + 2 * tq + (e & 1);
          const int kcol = k0 + kl, qrow = q0 + ql;
          bool ok = qrow < S && kcol < Tk;
          if (causal) ok = ok && kcol <= qrow;
          if (window > 0) ok = ok && (qrow - kcol) < window;
          const float pv =
              ok ? expf(s_acc[j][e] * scale + bias_s[kl] - lse_t[ql]) : 0.f;
          s_acc[j][e] = pv;
          p_acc[j][e] = pv * (p_acc[j][e] - delta_t[ql]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2 hi, lo;
          split_tf32(p_acc[j][2 * h], hi.x, lo.x);
          split_tf32(p_acc[j][2 * h + 1], hi.y, lo.y);
          const int off = (kw0 + gq + 8 * h) * LDS + 8 * j + 2 * tq;
          *reinterpret_cast<uint2*>(dSh + off) = hi;
          *reinterpret_cast<uint2*>(dSl + off) = lo;
        }
      }

      // dv += pᵀ·dout and dk += dsᵀ·q over the 8 queries of each n-tile.
      // The C fragment gives this thread queries 2t and 2t + 1; A's columns
      // t and t + 4 stand for them, and dout and q are read in that order.
      // Each product sums this tile's queries from zero in the mma's
      // accumulators, then joins the running dv / dk by an fp32 add: the
      // tensor core's accumulating adds truncate, so a running sum kept in
      // the C operand over every tile of every head of the GQA group
      // drifts by about an ulp of the sum per mma (dk, dv 2e-4 to 4e-4
      // from exact at 32 heads over 8, s 1024, the plain fp32 version
      // 1e-5), where a tile's 32 queries do not
      float tile[DN][4];
      tile_product<D>(tile, s_acc, dOh, dOl, gq, tq);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dv[dn][e] += tile[dn][e];
      tile_product<D>(tile, p_acc, Qh, Ql, gq, tq);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_dk[dn][e] += tile[dn][e];
    }
    __syncthreads();   // dsᵀ of every warp is in shared memory

    // dq (BQ × D) = ds (BQ × nk) · k in units of 16 queries × 16 columns,
    // the warps in turn; per 8-key k-step, A's columns t and t + 4 stand for
    // keys 2t and 2t + 1, and k's B fragment is read in that order. Even and
    // odd k-steps sum into their own accumulators (two chains of dependent
    // products, not one), added at the end
    const int ksteps = (nk + 7) / 8;
    for (int u = warp; u < DQ_UNITS; u += W) {
      const int mt = u % (BQ / 16);
      const int c0 = (u / (BQ / 16)) * 16;
      float acc[2][2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][h][e] = 0.f;
      auto kstep = [&](int ks, float (&a)[2][4]) {
        const int ar = (8 * ks + 2 * tq) * LDS + mt * 16 + gq;
        const unsigned ah[4] = {dSh[ar], dSh[ar + 8], dSh[ar + LDS],
                                dSh[ar + LDS + 8]};
        const unsigned al[4] = {dSl[ar], dSl[ar + 8], dSl[ar + LDS],
                                dSl[ar + LDS + 8]};
        const int br = (8 * ks + 2 * tq) * LD + c0 + gq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(Ks[br + 8 * h], bh0, bl0);
          split_tf32(Ks[br + LD + 8 * h], bh1, bl1);
          mma_3xtf32(a[h], ah, al, bh0, bh1, bl0, bl1);
        }
      };
      int ks = 0;
      for (; ks + 1 < ksteps; ks += 2) {
        kstep(ks, acc[0]);
        kstep(ks + 1, acc[1]);
      }
      if (ks < ksteps) kstep(ks, acc[0]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 8 * h + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qrow = q0 + mt * 16 + gq + 8 * r;
          if (qrow >= S) continue;
          const float x0 = acc[0][h][2 * r] + acc[1][h][2 * r];
          const float x1 = acc[0][h][2 * r + 1] + acc[1][h][2 * r + 1];
          const size_t off = ((size_t)bh * S + qrow) * D + col;
          if (split) {
            *reinterpret_cast<float2*>(
                dq_part + (size_t)kb * gridDim.x * group * S * D + off) =
                make_float2(x0, x1);
          } else {
            *reinterpret_cast<float2*>(dq + off) =
                make_float2(x0 * scale, x1 * scale);
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
        for (int e = threadIdx.x; e < BQ * D; e += blockDim.x) {
          const int qrow = qt * BQ + e / D;
          if (qrow < S) dq[((size_t)bh * S + qrow) * D + e % D] = 0.f;
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
        *reinterpret_cast<float2*>(dk + off) =
            make_float2(acc_dk[j][2 * h] * scale, acc_dk[j][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + off) =
            make_float2(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
      }
    }
  }
}

// cudaFuncSetAttribute for the f32 main kernel's largest key block, once
// per instantiation and device
template <int D>
cudaError_t allow_f32_smem() {
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      flash_bwd_3xtf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F32Bwd<D>::bytes(16 * F32Bwd<D>::kMaxW));
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, const void* out, const void* dout,
                       const void* lse, void* delta, void* dq, void* dk,
                       void* dv, void* dq_part, int bh, int s, int t,
                       int key_block, int smem, int group, int bias_group,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  using L = F32Bwd<D>;
  const int warps = key_block / 16;
  if (key_block % 16 != 0 || warps < 1 || warps > L::kMaxW ||
      (size_t)smem != L::bytes(key_block))
    return cudaErrorInvalidValue;
  const int nkb = (t + key_block - 1) / key_block;
  if (nkb > 65535 || (nkb > 1 && dq_part == nullptr))
    return cudaErrorInvalidValue;
  const int rows = bh * s;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_delta_kernel<float, D>
      <<<(rows + rows_per_cta - 1) / rows_per_cta, kThreads, 0, stream>>>(
          static_cast<const float*>(out), static_cast<const float*>(dout),
          static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = flash_bwd_3xtf32_kernel<D>;
  err = allow_f32_smem<D>();
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh / group, nkb), 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq_part), s, t, group, bias_group, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nkb == 1) return err;
  const size_t n = (size_t)rows * D;
  flash_bwd_dq_sum_kernel<float, D>
      <<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(dq_part), static_cast<float*>(dq), rows, s,
          t, key_block, nkb, causal, window, scale);
  return cudaGetLastError();
}

// bf16 key blocks (16 keys per warp) the tensor-core kernel is built for.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        const void* bias, const void* out, const void* dout,
                        const void* lse, void* delta, void* dq, void* dk,
                        void* dv, void* dq_part, int bh, int s, int t, int d,
                        int key_block, int smem, int group, int bias_group,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  if (key_block < 1 || (t + key_block - 1) / key_block > 65535)
    return cudaErrorInvalidValue;
#define REPRO_TC(D, W)                                                      \
  if (d == D && key_block == 16 * W)                                        \
    return launch_tc<D, W>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv, \
                           dq_part, bh, s, t, smem, group, bias_group,       \
                           causal, window, scale, stream);
  REPRO_TC(64, 4)
  REPRO_TC(64, 16)
  REPRO_TC(128, 4)
  REPRO_TC(128, 8)
#undef REPRO_TC
  return cudaErrorInvalidValue;
}

// f32 key blocks (16 keys per warp, at most 16 · F32Bwd<D>::kMaxW: 208 at
// d 64 and 96 at d 128).
cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* bias, const void* out, const void* dout,
                         const void* lse, void* delta, void* dq, void* dk,
                         void* dv, void* dq_part, int bh, int s, int t, int d,
                         int key_block, int smem, int group, int bias_group,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  if (d == 64)
    return launch_f32<64>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                          dq_part, bh, s, t, key_block, smem, group,
                          bias_group, causal, window, scale, stream);
  if (d == 128)
    return launch_f32<128>(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                           dq_part, bh, s, t, key_block, smem, group,
                           bias_group, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (split 3×TF32 tensor cores), 1 = bfloat16 (tensor
// cores). window <= 0: no window. delta is a (bh, s) fp32 scratch the
// caller allocates. key_block is the keys per CTA (ops.bwd_plan picks it:
// bf16 64 or 256 at d 64, 64 or 128 at d 128; f32 a multiple of 16 up to
// 208 at d 64, 96 at d 128), smem the main kernel's dynamic shared memory
// for that block (ops.bwd_plan too), which must be the bytes of this file's
// layout (TcLayout, F32Bwd): the launch takes the plan's bytes and refuses
// any other, before launching anything. dq_part is an fp32 scratch of
// ceil(t / key_block) * bh * s * d entries when t > key_block, else unused.
// q, k, v and dout must start 16-byte aligned. Returns the CUDA error code
// of the launches (0 on success).
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* out,
                               const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               void* dq_part, int dtype, int bh, int s, int t,
                               int d, int key_block, int smem, int group,
                               int bias_group, int causal, int window,
                               float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || group < 1 || bias_group < 1 ||
      bh % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, bias, out, dout, lse, delta, dq, dk,
                             dv, dq_part, bh, s, t, d, key_block, smem,
                             group, bias_group, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_tc(q, k, v, bias, out, dout, lse, delta, dq, dk, dv,
                            dq_part, bh, s, t, d, key_block, smem, group,
                            bias_group, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

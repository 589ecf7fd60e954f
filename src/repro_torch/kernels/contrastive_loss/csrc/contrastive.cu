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
// (row_col_lse too: its tiles compute A once) and the backward
// 3·2·B²·D on 2·B·D inputs, far above the card's flops-per-byte line. The
// f32 limits (dX/dY 1e-6) keep these products on the fp32 FMA units, so
// what decides the time is how many FMAs each shared-memory load feeds and
// whether the card is full.
//
// What the design does about it: the TPU kernels carry full-length column
// statistics (forward) and a VMEM-resident (B, D) dY (backward) across a
// sequential grid axis; CTAs here run in parallel and in no order, so
// nothing is carried between them and no fp32 atomics are used, which
// keeps every result the same from run to run:
//   forward   fwd_fused and row_col_lse compute the same function, so one
//             launch sequence serves both entries. The TPU's row_col_lse
//             runs two sweeps (_row_lse_kernel, _col_lse_kernel) that each
//             compute all of A, its fwd_fused one sweep that carries column
//             statistics; here one sweep over T × T tiles of A computes it
//             once (2·B²·D flops). One CTA of 256 threads per tile (T =
//             128, or 64 / 32 where ⌈B/T⌉² tiles of 128 would leave most of
//             the 132 SMs idle; ops.lse_plan picks T) holds a (T/16)×(T/16)
//             score block per thread (8×8 at T = 128: 16-byte loads of 8 X
//             rows, the same across each half-warp, and of 8 Y rows feed 256
//             FMAs; two CTAs per SM), over 32-wide chunks of D that 16-byte
//             cp.async copies stage double-buffered, the next chunk landing
//             while this one is multiplied. From its tile
//             it writes partial row (max, sum) over its T columns (shuffles
//             within the half-warp that holds a row) and partial column
//             (max, sum) over its T rows (shuffles, then the 8 warps' values
//             in warp order through shared memory); a combine kernel folds
//             the partials in a fixed order into row_lse and col_lse. D is
//             never split across CTAs or warps: each score is one fmaf per d
//             in increasing d, then times inv_tau, the order the forward and
//             backward tiles use too, so A is bit-identical in every kernel
//             and the backward's dA = exp(A − lse_r) + exp(A − lse_c) − 2
//             cancels exactly at B = 1;
//   backward  one launch does both sweeps: blockIdx.y picks the roles
//             (self = X, other = Y for dX; self = Y, other = X for dY) and
//             blockIdx.z one of a few fixed slices of the other rows, as
//             many as it takes to give the card about two waves of CTAs
//             (3 at B = 2048: 384 CTAs; 1 from B = 4193). A CTA of 8 warps
//             owns 32 self rows and walks its slice's 256-row other tiles.
//             Per tile it computes the 32 × 256 scores with 8×4 per thread
//             (16-byte loads of 8 self rows, the same across the warp, and
//             of 4 other rows feed 128 FMAs), over 16-wide chunks of D that
//             16-byte cp.async copies stage double-buffered, the next chunk
//             landing while this one is multiplied; forms dA (rounded to
//             bf16 as the operand when the inputs are bf16) into shared
//             memory, transposed; then adds dA · other to the CTA's 32 × D
//             accumulator in 16-row by 256-column pieces, also
//             double-buffered, each thread holding an 8×4 block in
//             registers (three 16-byte loads, two of them broadcast, feed
//             32 FMAs) and adding it to the shared accumulator once per
//             piece range and tile. With one slice the CTA writes its dX
//             (dY) rows itself; with more, each writes an fp32 partial
//             (scratch: slices × (dX + dY), slices <= 8) and a second
//             kernel sums them in slice order. dlog_tau: one partial per
//             dX CTA, summed by a one-CTA kernel in a fixed order. The
//             TPU's grads (_dx_kernel, _dy_kernel) are the same two sweeps,
//             so repro_contrastive_grads launches this sequence as it is.
//             What it does not do: the other tile is staged twice per tile
//             (for the scores, then for the contraction), since a whole
//             256 × D fp32 tile beside the 32 × D accumulator does not fit
//             in shared memory at D = 1024; and A is computed once per
//             sweep, 4·2·B²·D flops against the 3·2·B²·D least work.
// Any B >= 1 is taken: rows and columns past B are zero-filled as they are
// staged and masked out of every statistic. inv_tau is read from device
// memory, so the host never synchronises. Inputs are f32 or bf16, converted
// to fp32 as they are used; every accumulation is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The contraction operand: dA as the TPU feeds it to the MXU.
__device__ __forceinline__ float as_operand(float x, float) { return x; }
__device__ __forceinline__ float as_operand(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// lse = logsumexp over the n partials (max, sum) of each of B rows and B
// columns, folded in partial order: one thread per row or column. The fold
// of both forwards (fwd_fused's and row_col_lse's launch sequence).
__global__ void __launch_bounds__(kThreads)
contrastive_lse_combine_kernel(const float* __restrict__ row_m,
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
// backward: one launch, blockIdx.y picks the sweep (0: self = X, other = Y
// -> dX; 1: self = Y, other = X -> dY) and blockIdx.z a slice of the other
// rows; 32 self rows per CTA walk the slice's 256-row other tiles
// ---------------------------------------------------------------------------

constexpr int kGT = 256;    // threads of the backward CTA
constexpr int kGS = 32;     // self rows per CTA
constexpr int kGO = 256;    // other rows per tile
constexpr int kGC = 16;     // score chunk of the embedding dim
constexpr int kGP = 16;     // other rows per contraction piece
constexpr int kGW = 256;    // embedding columns per contraction piece
constexpr int kMaxD = 1024; // the CTA's dX rows live in shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive shared values as fp32 (one 16-byte or 8-byte load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  using h2 = __nv_bfloat162;
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const h2*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const h2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage the rows [r0, r0 + rows) x columns [c0, c0 + cols) of a (B, D)
// matrix into shared rows of stride ld (elements of T); entries past B or D
// are zero. 16-byte cp.async when D is a whole number of them (the caller
// then commits and waits), else plain element copies.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, int ld, const T* src,
                                            int r0, int rows, int c0,
                                            int cols, int B, int D,
                                            bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int cv = cols / V;
    for (int e = threadIdx.x; e < rows * cv; e += kGT) {
      const int row = e / cv, col = (e % cv) * V;
      const int g = r0 + row, d = c0 + col;
      const bool ok = g < B && d < D;
      cp_async16(dst + row * ld + col,
                 src + (ok ? (size_t)g * D + d : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kGT) {
      const int row = e / cols, col = e % cols;
      const int g = r0 + row, d = c0 + col;
      dst[row * ld + col] =
          (g < B && d < D) ? src[(size_t)g * D + d] : T(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// row_col_lse: one T × T tile of A per CTA -> partial row / column (max, sum)
// ---------------------------------------------------------------------------

constexpr int kLC = 32;     // staged chunk of the embedding dim

template <typename T, int TILE>
struct LseLayout {
  static constexpr int SLD = kLC + 16 / (int)sizeof(T);  // staged rows
  static constexpr size_t stage = (size_t)2 * TILE * SLD; // X rows, Y rows
  // ring [2 stages] (T), then fp32 column max and sum [8 warps][TILE] each
  static constexpr size_t bytes =
      2 * stage * sizeof(T) + sizeof(float) * 2 * 8 * TILE;
};

template <typename T, int TILE>
__global__ void __launch_bounds__(kGT, 2)
contrastive_lse_tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const float* __restrict__ inv_tau_p,
                            float* __restrict__ row_m,
                            float* __restrict__ row_s,
                            float* __restrict__ col_m,
                            float* __restrict__ col_s, int B, int D) {
  using L = LseLayout<T, TILE>;
  constexpr int TM = TILE / 16;   // score rows and columns per thread
  constexpr int SLD = L::SLD;
  static_assert(TILE % 16 == 0 && kGT == 256, "16 × 16 threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red_m = reinterpret_cast<float*>(smem_raw + 2 * L::stage * sizeof(T));
  float* red_s = red_m + 8 * TILE;                 // [8 warps][TILE] each

  const int i0 = blockIdx.x * TILE;   // rows of A (X)
  const int j0 = blockIdx.y * TILE;   // columns of A (Y)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4;            // rows ty + 16 i: one per half-warp
  const int tx = tid & 15;            // columns tx + 16 j
  const bool vec = D % (16 / (int)sizeof(T)) == 0 &&
                   (((size_t)x | (size_t)y) & 15) == 0;
  const float inv_tau = *inv_tau_p;

  auto stage_chunk = [&](int c, int buf) {
    T* Xs = ring + buf * L::stage;
    stage_block<T>(Xs, SLD, x, i0, TILE, c * kLC, kLC, B, D, vec);
    stage_block<T>(Xs + TILE * SLD, SLD, y, j0, TILE, c * kLC, kLC, B, D,
                   vec);
    cp_async_commit();
  };
  // each score is one fmaf per d in increasing d (the order of every other
  // kernel that forms A), so no d is split off
  float a[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) a[i][j] = 0.f;
  const int nc = (D + kLC - 1) / kLC;
  stage_chunk(0, 0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage_chunk(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Xs = ring + (c & 1) * L::stage;
    const T* Ys = Xs + TILE * SLD;
#pragma unroll
    for (int k = 0; k < kLC; k += 4) {
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = load4(Xs + (ty + 16 * i) * SLD + k);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float4 yv = load4(Ys + (tx + 16 * j) * SLD + k);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a[i][j] = fmaf(xv[i].x, yv.x, a[i][j]);
          a[i][j] = fmaf(xv[i].y, yv.y, a[i][j]);
          a[i][j] = fmaf(xv[i].z, yv.z, a[i][j]);
          a[i][j] = fmaf(xv[i].w, yv.w, a[i][j]);
        }
      }
    }
    __syncthreads();   // this stage is free for the chunk after next
  }

  // A of the tile; entries outside B take no part in any statistic
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      a[i][j] = (i0 + ty + 16 * i < B && j0 + tx + 16 * j < B)
                    ? a[i][j] * inv_tau
                    : kNeg;

  // rows: a row's TILE columns lie in the 16 lanes of one half-warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m = kNeg;
#pragma unroll
    for (int j = 0; j < TM; ++j) m = fmaxf(m, a[i][j]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j) s += expf(a[i][j] - m);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    const int g = i0 + ty + 16 * i;
    if (tx == 0 && g < B) {
      row_m[(size_t)blockIdx.y * B + g] = m;
      row_s[(size_t)blockIdx.y * B + g] = s;
    }
  }

  // columns: a column's TILE rows lie in the two half-warps of each warp
  // (lane ^ 16), then across the 8 warps, folded in warp order
  float cm[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    float m = kNeg;
#pragma unroll
    for (int i = 0; i < TM; ++i) m = fmaxf(m, a[i][j]);
    m = fmaxf(m, __shfl_xor_sync(kFull, m, 16));
    if (lane < 16) red_m[warp * TILE + tx + 16 * j] = m;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    float m = red_m[tx + 16 * j];
    for (int w = 1; w < 8; ++w) m = fmaxf(m, red_m[w * TILE + tx + 16 * j]);
    cm[j] = m;
  }
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) s += expf(a[i][j] - cm[j]);
    s += __shfl_xor_sync(kFull, s, 16);
    if (lane < 16) red_s[warp * TILE + tx + 16 * j] = s;
  }
  __syncthreads();
  if (tid < TILE) {
    const int g = j0 + tid;
    if (g < B) {
      float m = kNeg, s = 0.f;
      for (int w = 0; w < 8; ++w) {
        m = fmaxf(m, red_m[w * TILE + tid]);
        s += red_s[w * TILE + tid];
      }
      col_m[(size_t)blockIdx.x * B + g] = m;
      col_s[(size_t)blockIdx.x * B + g] = s;
    }
  }
}

template <typename T>
struct GradLayout {
  static constexpr int SLD = kGC + 16 / (int)sizeof(T);  // score chunk rows
  static constexpr int PLD = kGW + 16 / (int)sizeof(T);  // piece rows
  static constexpr int ALD = kGS + 4;                    // dAᵀ rows (fp32)
  static constexpr size_t score_stage = (size_t)(kGS + kGO) * SLD;
  static constexpr size_t piece_stage = (size_t)kGP * PLD;
  static constexpr size_t ring =
      2 * (score_stage > piece_stage ? score_stage : piece_stage);
  // acc [kGS][dp] fp32, ring (T), dAᵀ [kGO][ALD] fp32, lse [kGS], sums [8]
  static size_t bytes(int dp) {
    return sizeof(float) * ((size_t)kGS * dp + (size_t)kGO * ALD + kGS + 8) +
           sizeof(T) * ring;
  }
};

template <typename T>
__global__ void __launch_bounds__(kGT, 1)
contrastive_grad_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        const float* __restrict__ inv_tau_p,
                        const float* __restrict__ row_lse,
                        const float* __restrict__ col_lse,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ part,
                        float* __restrict__ dtau_part, int B, int D,
                        float two_bn, int with_diag, int tiles_per_slice) {
  using L = GradLayout<T>;
  constexpr int SLD = L::SLD, PLD = L::PLD, ALD = L::ALD;
  const int dp = (D + 3) & ~3;    // acc row stride: whole float4s
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);              // [kGS][dp]
  float* dAt = acc + (size_t)kGS * dp;                          // [kGO][ALD]
  float* lse_s = dAt + kGO * ALD;                               // [kGS]
  float* warp_sum = lse_s + kGS;                                // [8]
  T* ring = reinterpret_cast<T*>(warp_sum + 8);

  const int role = blockIdx.y;
  const int slice = blockIdx.z;
  const T* self = role ? y : x;
  const T* other = role ? x : y;
  const float* lse_self = role ? col_lse : row_lse;
  const float* lse_other = role ? row_lse : col_lse;
  const int s0 = blockIdx.x * kGS;
  const int o_begin = slice * tiles_per_slice * kGO;
  const int o_end = min(B, o_begin + tiles_per_slice * kGO);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sg = warp & 3;                      // self row group
  const int og = 128 * (warp >> 2) + lane;      // first other row (scores)
  const int cg = 128 * (warp >> 2) + 4 * lane;  // first column (contraction)
  const bool vec = D % (16 / (int)sizeof(T)) == 0 &&
                   (((size_t)x | (size_t)y) & 15) == 0;
  const float inv_tau = *inv_tau_p;

  for (int e = tid; e < kGS * dp; e += kGT) acc[e] = 0.f;
  if (tid < kGS) lse_s[tid] = s0 + tid < B ? lse_self[s0 + tid] : 0.f;

  const int nc = (D + kGC - 1) / kGC;        // score chunks
  const int ndr = (D + kGW - 1) / kGW;       // contraction column ranges
  float dtau = 0.f;
  for (int o0 = o_begin; o0 < o_end; o0 += kGO) {
    const int npc = (min(kGO, o_end - o0) + kGP - 1) / kGP;  // pieces / range
    // --- a = self · otherᵀ (32 × 256): warp w -> self rows (w & 3) + 4 i
    // (i < 8, the same for the whole warp, so their loads broadcast), lane
    // -> other rows 128 (w >> 2) + lane + 32 j (j < 4); each chunk is loaded
    // while the one before it is multiplied
    auto stage_chunk = [&](int c, int buf) {
      T* Ss = ring + buf * L::score_stage;
      stage_block<T>(Ss, SLD, self, s0, kGS, c * kGC, kGC, B, D, vec);
      stage_block<T>(Ss + kGS * SLD, SLD, other, o0, kGO, c * kGC, kGC, B, D,
                     vec);
      cp_async_commit();
    };
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
    stage_chunk(0, 0);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        stage_chunk(c + 1, (c + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* Ss = ring + (c & 1) * L::score_stage;
      const T* Os = Ss + kGS * SLD;
#pragma unroll
      for (int k = 0; k < kGC; k += 4) {
        float4 sv[8], ov[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) sv[i] = load4(Ss + (sg + 4 * i) * SLD + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) ov[j] = load4(Os + (og + 32 * j) * SLD + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[i][j] = fmaf(sv[i].x, ov[j].x, a[i][j]);
            a[i][j] = fmaf(sv[i].y, ov[j].y, a[i][j]);
            a[i][j] = fmaf(sv[i].z, ov[j].z, a[i][j]);
            a[i][j] = fmaf(sv[i].w, ov[j].w, a[i][j]);
          }
      }
      __syncthreads();   // this stage is free for the chunk after next
    }

    // the first contraction piece loads while dA is formed
    auto stage_piece = [&](int p, int buf) {
      const int dr = p / npc, oc = p % npc;
      stage_block<T>(ring + buf * L::piece_stage, PLD, other,
                     o0 + oc * kGP, kGP, dr * kGW, kGW, B, D, vec);
      cp_async_commit();
    };
    stage_piece(0, 0);

    // --- dA, rounded as the contraction's operand, transposed into dAᵀ
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int sl = sg + 4 * i, srow = s0 + sl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ol = og + 32 * j, orow = o0 + ol;
        float da = 0.f;
        if (srow < B && orow < o_end) {
          const float av = a[i][j] * inv_tau;
          da = expf(av - lse_s[sl]) + expf(av - lse_other[orow]);
          if (with_diag && srow == orow) da -= 2.f;
          da = da / two_bn;
          dtau -= da * av;
        }
        dAt[ol * ALD + sl] = as_operand(da, T());
      }
    }
    __syncthreads();

    // --- acc += dA · other: warp w -> self rows 8 (w & 3).. (their dA
    // loads broadcast), lane -> columns 128 (w >> 2) + 4 lane.. of each
    // 256-wide range, 8×4 in registers, added to acc once per range and tile
    const int np = ndr * npc;
    float cacc[8][4];
    for (int p = 0; p < np; ++p) {
      const int dr = p / npc, oc = p % npc;
      if (oc == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cacc[i][j] = 0.f;
      }
      if (p + 1 < np) {
        stage_piece(p + 1, (p + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* Ps = ring + (p & 1) * L::piece_stage;
      const float* dA = dAt + oc * kGP * ALD + 8 * sg;
#pragma unroll 4
      for (int o = 0; o < kGP; ++o) {
        const float4 d0 = load4(dA + o * ALD);
        const float4 d1 = load4(dA + o * ALD + 4);
        const float4 ov = load4(Ps + o * PLD + cg);
        const float d4[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cacc[i][0] = fmaf(d4[i], ov.x, cacc[i][0]);
          cacc[i][1] = fmaf(d4[i], ov.y, cacc[i][1]);
          cacc[i][2] = fmaf(d4[i], ov.z, cacc[i][2]);
          cacc[i][3] = fmaf(d4[i], ov.w, cacc[i][3]);
        }
      }
      const int col = dr * kGW + cg;
      if (oc == npc - 1 && col < D) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4* r = reinterpret_cast<float4*>(acc + (8 * sg + i) * dp + col);
          float4 v = *r;
          v.x += cacc[i][0];
          v.y += cacc[i][1];
          v.z += cacc[i][2];
          v.w += cacc[i][3];
          *r = v;
        }
      }
      __syncthreads();   // this stage and, after the last piece, dAᵀ free
    }
  }
  __syncthreads();

  const size_t slab = (size_t)B * D;
  const bool split = gridDim.z > 1;
  float* out = split ? part + ((size_t)slice * 2 + role) * slab
                     : (role ? dy : dx);
  const float mul = split ? 1.f : inv_tau;
  for (int e = tid; e < kGS * D; e += kGT) {
    const int row = e / D, col = e % D;
    if (s0 + row < B)
      out[(size_t)(s0 + row) * D + col] = acc[row * dp + col] * mul;
  }
  if (role == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dtau += __shfl_xor_sync(kFull, dtau, off);
    if (lane == 0) warp_sum[warp] = dtau;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kGT / 32; ++w) s += warp_sum[w];
      dtau_part[(size_t)slice * gridDim.x + blockIdx.x] = s;
    }
  }
}

// dX, dY = inv_tau · the sum of the slices' partials, in slice order.
__global__ void __launch_bounds__(256)
contrastive_grad_sum_kernel(const float* __restrict__ part,
                            const float* __restrict__ inv_tau_p,
                            float* __restrict__ dx, float* __restrict__ dy,
                            size_t slab, int slices) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= 2 * slab) return;
  const int role = idx >= slab;
  const size_t e = idx - role * slab;
  float s = 0.f;
  for (int p = 0; p < slices; ++p) s += part[((size_t)p * 2 + role) * slab + e];
  (role ? dy : dx)[e] = s * *inv_tau_p;
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

template <typename T, int TILE>
cudaError_t lse_tiles(const void* x, const void* y, const void* inv_tau,
                      void* row_lse, void* col_lse, void* part, int B, int D,
                      cudaStream_t stream) {
  const int n = (B + TILE - 1) / TILE;
  if (n > 65535) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* row_m = p;
  float* row_s = p + (size_t)n * B;
  float* col_m = p + 2 * (size_t)n * B;
  float* col_s = p + 3 * (size_t)n * B;
  constexpr size_t smem = LseLayout<T, TILE>::bytes;
  auto kernel = contrastive_lse_tile_kernel<T, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n, n), kGT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(inv_tau), row_m, row_s, col_m, col_s, B, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  contrastive_lse_combine_kernel<<<(2 * B + kThreads - 1) / kThreads,
                                   kThreads, 0, stream>>>(
      row_m, row_s, col_m, col_s, static_cast<float*>(row_lse),
      static_cast<float*>(col_lse), B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_col_lse(const void* x, const void* y, const void* inv_tau,
                        void* row_lse, void* col_lse, void* part, int B,
                        int D, int tile, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {   // bf16 at 128 spills (ops.lse_plan)
    if (tile == 128)
      return lse_tiles<T, 128>(x, y, inv_tau, row_lse, col_lse, part, B, D,
                               stream);
  }
  if (tile == 64)
    return lse_tiles<T, 64>(x, y, inv_tau, row_lse, col_lse, part, B, D,
                            stream);
  if (tile == 32)
    return lse_tiles<T, 32>(x, y, inv_tau, row_lse, col_lse, part, B, D,
                            stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd(const void* x, const void* y, const void* inv_tau,
                const void* row_lse, const void* col_lse, void* dx, void* dy,
                void* dtau, void* part, int B, int D, float two_bn,
                int with_diag, int slices, cudaStream_t stream) {
  const int nb = (B + kGS - 1) / kGS;
  const int tiles = (B + kGO - 1) / kGO;
  if (slices < 1 || slices > tiles || slices > 65535)
    return cudaErrorInvalidValue;
  const int tps = (tiles + slices - 1) / slices;
  if ((tiles + tps - 1) / tps != slices) return cudaErrorInvalidValue;
  const size_t smem = GradLayout<T>::bytes((D + 3) & ~3);
  auto kernel = contrastive_grad_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t slab = (size_t)B * D;
  float* p = static_cast<float*>(part);
  float* partials = slices > 1 ? p : nullptr;
  float* dtau_part = p + (slices > 1 ? 2 * slab * slices : 0);
  const float* it = static_cast<const float*>(inv_tau);
  kernel<<<dim3(nb, 2, slices), kGT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), it,
      static_cast<const float*>(row_lse), static_cast<const float*>(col_lse),
      static_cast<float*>(dx), static_cast<float*>(dy), partials, dtau_part,
      B, D, two_bn, with_diag, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (slices > 1) {
    contrastive_grad_sum_kernel<<<(unsigned)((2 * slab + 255) / 256), 256, 0,
                                  stream>>>(partials, it,
                                            static_cast<float*>(dx),
                                            static_cast<float*>(dy), slab,
                                            slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  contrastive_dtau_sum_kernel<<<1, 256, 0, stream>>>(
      dtau_part, static_cast<float*>(dtau), nb * slices);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: (B, D); inv_tau: one fp32 on the
// device; row_lse, col_lse: (B,) fp32 outputs, from one sweep over tile ×
// tile tiles of A (tile 128 in f32, 64 or 32; ops.lse_plan picks it) and
// the combine, the launches of repro_contrastive_row_col_lse; part: fp32
// scratch of 4 * ceil(B / tile) * B entries; any D. Returns the CUDA error
// code (0 on success).
extern "C" int repro_contrastive_fwd(const void* x, const void* y,
                                     const void* inv_tau, void* row_lse,
                                     void* col_lse, void* part, int dtype,
                                     int B, int D, int tile, void* stream) {
  if (B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)row_col_lse<float>(x, y, inv_tau, row_lse, col_lse, part, B,
                                   D, tile, st);
  if (dtype == 1)
    return (int)row_col_lse<__nv_bfloat16>(x, y, inv_tau, row_lse, col_lse,
                                           part, B, D, tile, st);
  return (int)cudaErrorInvalidValue;
}

// dx, dy: (B, D) fp32 outputs; dtau: one fp32 output; slices: the number of
// slices of the other rows (ops.bwd_plan; 1 <= slices <= ceil(B / 256),
// none empty); part: fp32 scratch of 2 * B * D * slices entries when
// slices > 1, then ceil(B / 32) * slices more; two_bn = 2 * b_norm. D may be
// at most 1024 (the dX/dY rows live in shared memory). Returns the CUDA
// error code.
extern "C" int repro_contrastive_bwd(const void* x, const void* y,
                                     const void* inv_tau,
                                     const void* row_lse,
                                     const void* col_lse, void* dx, void* dy,
                                     void* dtau, void* part, int dtype, int B,
                                     int D, float two_bn, int with_diag,
                                     int slices, void* stream) {
  if (B < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(x, y, inv_tau, row_lse, col_lse, dx, dy, dtau,
                           part, B, D, two_bn, with_diag, slices, st);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(x, y, inv_tau, row_lse, col_lse, dx, dy,
                                   dtau, part, B, D, two_bn, with_diag,
                                   slices, st);
  return (int)cudaErrorInvalidValue;
}

// The legacy pair's forward, the TPU's row_col_lse: the same function as
// the fused forward, so this runs that sequence with the same arguments and
// limits as repro_contrastive_fwd.
extern "C" int repro_contrastive_row_col_lse(const void* x, const void* y,
                                             const void* inv_tau,
                                             void* row_lse, void* col_lse,
                                             void* part, int dtype, int B,
                                             int D, int tile, void* stream) {
  return repro_contrastive_fwd(x, y, inv_tau, row_lse, col_lse, part, dtype,
                               B, D, tile, stream);
}

// The legacy pair's backward, the TPU's grads: its dX sweep and dY sweep
// are the backward's two roles above, so this runs that launch with the
// same arguments and limits as repro_contrastive_bwd.
extern "C" int repro_contrastive_grads(const void* x, const void* y,
                                       const void* inv_tau,
                                       const void* row_lse,
                                       const void* col_lse, void* dx,
                                       void* dy, void* dtau, void* part,
                                       int dtype, int B, int D, float two_bn,
                                       int with_diag, int slices,
                                       void* stream) {
  return repro_contrastive_bwd(x, y, inv_tau, row_lse, col_lse, dx, dy, dtau,
                               part, dtype, B, D, two_bn, with_diag, slices,
                               stream);
}

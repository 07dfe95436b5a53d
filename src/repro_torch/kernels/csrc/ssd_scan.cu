// Mamba-2 SSD chunked scan for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface and loaded through ctypes.
//
// Replaces the Pallas kernel ssd_scan (_kernel) in
// repro/kernels/ssd_scan.py: x[Bb, L, H, P], dt[Bb, L, H] float32, A[H]
// float32 (A < 0), B / C[Bb, L, N] (B and C shared by the heads) ->
// y[Bb, L, H, P] in x's type.  Per chunk of Q = min(128, L) steps, with
// cum[t] = sum_{u <= t} A dt[u] inside the chunk and h the float32 state
// [P, N] carried from chunk to chunk:
//   y[t, p] = (sum_n C[t, n] h[p, n]) exp(cum[t])
//           + sum_{u <= t} exp(cum[t] - cum[u]) (C[t] . B[u]) dt[u] x[u, p]
//   h[p, n] <- exp(cum[Q-1]) h[p, n]
//           + sum_u (x[u, p] exp(cum[Q-1] - cum[u]) dt[u]) B[u, n]
// exp(cum[t] - cum[u]) is evaluated only for t >= u, where the exponent is
// <= 0: the reference's jnp.where hides an inf in the unselected branch,
// which these kernels never form.
//
// Parallel split.  The TPU grid is (batch, head) with the chunks
// sequential; that is too few CTAs for 132 SMs (160 for mamba2 at Bb = 2,
// 50 for hymba).  The P rows of the state evolve independently (y[., p]
// reads only row p of h and column p of x), so a CTA owns one (batch,
// head) and a block of the P columns (32, or 16 in the mma variant where
// 32-wide blocks give fewer than two CTAs per SM, as at hymba's 50
// heads), and walks the chunks in order with its rows of h on chip.
// Inputs are read through their element strides, so x, B and C are read
// in place (B and C are column slices of the model's input projection).
// Chunks shorter than 128 (L < 128) are zero-padded in shared memory.
// Two variants, chosen by the launcher from the type and N:
//
// * mma (bfloat16, N <= 128: the models' path).  4 warps; the chunk's four
//   products run on the tensor cores (mma.sync m16n8k16, bf16 operands
//   through ldmatrix, float32 sums):
//     - scores C . B^T, 16 x 16 blocks on and below the diagonal only,
//       in a first launch (below); warp w owns the t rows of m tiles w
//       and 7 - w (9 blocks each, so the causal work is balanced) in both
//       launches, and reads all of an m tile's blocks back at once;
//     - W . x: each score block becomes its weight block W[t, u] =
//       exp(cum[t] - cum[u]) s dt[u] in float32 (exp2f of the log2(e)-
//       scaled difference), rounded to bf16, and is the A operand of its
//       16-deep step of W . x straight from the accumulator registers;
//     - C . h^T, scaled by exp(cum[t]) before W . x is added (both in
//       two partial sums, even and odd steps, to halve the chains);
//     - the hand-off (x w_u)^T B, with x w_u rounded to bf16; the float32
//       state h stays in the warps' accumulator registers from chunk to
//       chunk (warp w owns 8 kNT of the padded N columns), and a bf16 copy
//       in shared memory is the B operand of the next chunk's C . h^T.
//   So W, x w_u and the copy of h are rounded to bf16 (2^-9 relative)
//   where the reference keeps float32; x, B and C are bf16 already, and
//   every product and sum is float32.  ref.ssd_scan_mma_ref rounds where
//   this kernel rounds.  The score tile is shared by all heads, so a
//   first launch (ssd_scores_kernel) forms it once per (batch, chunk)
//   into a small scratch (in fragment order, 37 KB a chunk) that every
//   CTA of the batch reads back from L2; on an H100 recomputing it in
//   every CTA was the slower at mamba2's N = 128 and no faster at
//   hymba's N = 16 (PERF.md).  The next chunk's C and x are requested
//   during the hand-off and its B after it, and its dt is read ahead.
//   Shared memory: C and B of the chunk, x and x w_u of the P block, the
//   bf16 h and the chunk's scalars, 101 KB at N = 128, so two CTAs fit on
//   an SM.  C, B and x are staged with 16-byte cp.async where their rows
//   allow it (unit stride, 16-byte aligned), else element by element
//   (hymba's B and C rows are 3257 elements apart).
// * ffma (float32, or N > 128): the first port's kernel, kept as it was
//   because only the float32 gates run it.  256 threads, per chunk: dt,
//   cum by a warp-shuffle scan and the hand-off weights; x of the P block
//   in shared memory (float32); over N in blocks of 32, C and B staged
//   transposed, each thread accumulating an 8 x 8 micro-tile of the 128 x
//   128 score tile and its 16 (t, p) partial sums of C . h^T in FFMA, then
//   the block's columns of h take their hand-off; the causal weight tile
//   in shared memory; y = (C . h^T) exp(cum) + W x.  float32 throughout,
//   in the reference's order of operations, expf (not the fast
//   intrinsic).  134 KB of shared memory at N = 128.
//
// What bounds it.  The chunked algorithm with the score tile formed once
// per (batch, chunk) needs Bb (L / Q) 2 Q^2 N + Bb H (L / Q) (2 Q^2 P +
// 4 Q P N) FLOPs: at mamba2's layer shape ([2, 4096, 80, 64], N = 128,
// bf16) 32.5 GFLOP, 33 us at the bf16 tensor-core peak, against 175 MB
// of x, dt, B, C and y (52 us): the bytes bound it.  hymba's layer
// ([2, 2048, 25, 64], N = 16): 8 us of bytes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;          // the largest chunk
constexpr int kPB = 32;          // P columns per CTA
constexpr int kNB = 32;          // N columns per staged block
constexpr int kQS = kQ + 4;      // row stride of the staged C / B blocks
constexpr int kWS = kQ + 1;      // row stride of W
constexpr int kTG = kThreads / kPB;  // row groups of the (t, p) outputs
constexpr int kRY = kQ / kTG;        // (t, p) outputs per thread

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  int64_t Bb, L, H, P, N, Q;
  int64_t x_sb, x_sl, x_sh, x_sp;
  int64_t dt_sb, dt_sl, dt_sh;
  int64_t b_sb, b_sl, b_sn;
  int64_t c_sb, c_sl, c_sn;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__host__ __device__ constexpr int64_t smem_floats(int64_t N) {
  return 3 * kQ + 8                      // cum, dt, hand-off weights, warp sums
         + 2 * kNB * kQS                 // Ct, Bt [kNB][kQS]
         + static_cast<int64_t>(kQ) * kWS  // W [kQ][kWS]
         + kQ * kPB                      // xs [kQ][kPB]
         + kPB * (N + 1);                // hs [kPB][N + 1]
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;               // [kNB][kQS], 16-byte aligned rows
  float* Bt = Ct + kNB * kQS;     // [kNB][kQS]
  float* W = Bt + kNB * kQS;      // [kQ][kWS]
  float* xs = W + kQ * kWS;       // [kQ][kPB]
  float* cum = xs + kQ * kPB;     // [kQ]
  float* dts = cum + kQ;          // [kQ]
  float* wu = dts + kQ;           // [kQ]
  float* wsum = wu + kQ;          // [8]
  float* hs = wsum + 8;           // [kPB][N + 1]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.H;
  const int64_t h = bh - b * p.H;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * kPB;
  const int64_t N = p.N;
  const int64_t HS = N + 1;
  const int Q = static_cast<int>(p.Q);
  const float a = p.A[h];

  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bb_ = static_cast<const T*>(p.B) + b * p.b_sb;
  const T* Cb = static_cast<const T*>(p.C) + b * p.c_sb;
  T* yb = static_cast<T*>(p.y) + (b * p.L * p.H + h) * p.P;

  for (int64_t i = tid; i < kPB * HS; i += kThreads) hs[i] = 0.f;

  // score micro-tile: rows ti * 8 + i, columns ui * 8 + j
  const int ti = tid >> 4;
  const int ui = tid & 15;
  // (t, p) outputs: column pp, rows tg + kTG * r
  const int pp = tid % kPB;
  const int tg = tid / kPB;

  for (int64_t c0 = 0; c0 < p.L; c0 += Q) {
    // 1. dt, cum (inclusive scan of A dt), hand-off weights
    float v = 0.f;
    if (tid < kQ) {
      const float d = tid < Q ? dtb[(c0 + tid) * p.dt_sl] : 0.f;
      dts[tid] = d;
      v = a * d;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
      }
      if (lane == 31) wsum[warp] = v;
    }
    // 2. x of the chunk and the P block
    for (int i = tid; i < kQ * kPB; i += kThreads) {
      const int u = i / kPB;
      const int c = i - u * kPB;
      const int64_t gp = p0 + c;
      xs[i] = (u < Q && gp < p.P)
                  ? to_f32(xb[(c0 + u) * p.x_sl + gp * p.x_sp])
                  : 0.f;
    }
    __syncthreads();
    if (tid < kQ) {
      for (int w = 0; w < warp; ++w) v += wsum[w];
      cum[tid] = v;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    if (tid < kQ) wu[tid] = tid < Q ? expf(cum_last - cum[tid]) * dts[tid] : 0.f;
    const float decay_tot = expf(cum_last);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float ys[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) ys[r] = 0.f;

    // 3. over N in blocks: scores, C . h^T, state hand-off
    for (int64_t n0 = 0; n0 < N; n0 += kNB) {
      const int nb = static_cast<int>(N - n0 < kNB ? N - n0 : kNB);
      for (int i = tid; i < kQ * kNB; i += kThreads) {
        const int u = i / kNB;
        const int nn = i - u * kNB;
        const bool ok = u < Q && nn < nb;
        const int64_t g = c0 + u;
        Ct[nn * kQS + u] = ok ? to_f32(Cb[g * p.c_sl + (n0 + nn) * p.c_sn]) : 0.f;
        Bt[nn * kQS + u] = ok ? to_f32(Bb_[g * p.b_sl + (n0 + nn) * p.b_sn]) : 0.f;
      }
      __syncthreads();
      for (int nn = 0; nn < nb; ++nn) {
        const float4* cr = reinterpret_cast<const float4*>(Ct + nn * kQS + ti * 8);
        const float4* br = reinterpret_cast<const float4*>(Bt + nn * kQS + ui * 8);
        const float4 c01 = cr[0], c23 = cr[1], b01 = br[0], b23 = br[1];
        const float cv[8] = {c01.x, c01.y, c01.z, c01.w, c23.x, c23.y, c23.z, c23.w};
        const float bv[8] = {b01.x, b01.y, b01.z, b01.w, b23.x, b23.y, b23.z, b23.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        const float hv = hs[pp * HS + n0 + nn];
#pragma unroll
        for (int r = 0; r < kRY; ++r)
          ys[r] = fmaf(Ct[nn * kQS + tg + kTG * r], hv, ys[r]);
      }
      __syncthreads();  // every thread has read this block's old state
      for (int i = tid; i < kPB * nb; i += kThreads) {
        const int c = i % kPB;
        const int nn = i / kPB;
        float s = 0.f;
        for (int u = 0; u < Q; ++u)
          s = fmaf(xs[u * kPB + c] * wu[u], Bt[nn * kQS + u], s);
        float* hp = hs + c * HS + n0 + nn;
        *hp = decay_tot * *hp + s;
      }
      __syncthreads();  // before the next block overwrites Ct / Bt
    }

    // 4. the causal weight tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ti * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = ui * 8 + j;
        W[t * kWS + u] = (t >= u && t < Q)
                             ? expf(cum[t] - cum[u]) * acc[i][j] * dts[u]
                             : 0.f;
      }
    }
    __syncthreads();

    // 5. y = (C . h^T) exp(cum) + W x
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      const int t = tg + kTG * r;
      if (t >= Q) continue;
      float s = 0.f;
      for (int u = 0; u <= t; ++u) s = fmaf(W[t * kWS + u], xs[u * kPB + pp], s);
      const float out = ys[r] * expf(cum[t]) + s;
      if (p0 + pp < p.P) yb[(c0 + t) * p.H * p.P + p0 + pp] = from_f32<T>(out);
    }
    __syncthreads();  // before the next chunk overwrites xs, W, cum
  }
}

template <typename T>
int launch_typed(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(p.N)) * sizeof(float);
  auto* kern = ssd_scan_kernel<T>;
  // above 48 KB a CTA's dynamic shared memory must be allowed explicitly
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.Bb * p.H),
                  static_cast<unsigned int>((p.P + kPB - 1) / kPB));
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// mma variant (bfloat16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kBlocks = 9;        // score blocks per warp and chunk
constexpr float kLog2e = 1.4426950408889634f;

// kNT: n8 tiles of the state per warp; N is padded to NP = 32 kNT.  Rows
// of the staged tiles are padded by 16 bytes, so ldmatrix is free of bank
// conflicts.
template <int kNT>
struct Mma {
  static constexpr int NP = 32 * kNT;
  static constexpr int NS = NP + 8;   // row stride of Cs, Bs and Hs
  static constexpr int KS = NP / 16;  // k16 steps over N
};

// row stride (elements) of Xs and XWs for kPB P columns per CTA; rows
// padded by 16 bytes, so ldmatrix is free of bank conflicts
__host__ __device__ constexpr int x_stride(int pb) { return pb + 8; }

__host__ __device__ constexpr int64_t mma_smem_bytes(int64_t np,
                                                     int64_t pb) {
  return 2 * (2 * 128 * (np + 8) + pb * (np + 8) + 2 * 128 * (pb + 8))
         + 4 * (4 * 128 + 4);
}

// the mma variant's arguments beyond Params
struct MmaArgs {
  int vec_x, vec_b, vec_c;  // 16-byte staging allowed (see the launcher)
  float* scores;            // the score fragments (ssd_scores_kernel)
  int64_t n_chunks;
};

// Rows [0, 128) x columns [0, kCols) of a strided bf16 matrix into shared
// memory (row stride ld), zero outside rows_valid x cols_valid.  With vec
// (unit column stride, 16-byte aligned rows, cols_valid % 8 == 0) in
// 16-byte cp.async pieces, which the caller commits and waits for; else
// element by element.
template <int kCols>
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      int64_t s_row, int64_t s_col,
                                      int rows_valid, int cols_valid,
                                      bool vec) {
  if (vec) {
    constexpr int kPieces = kCols / 8;
    for (int i = threadIdx.x; i < 128 * kPieces; i += kMmaThreads) {
      const int r = i / kPieces;
      const int c = (i - r * kPieces) * 8;
      const bool ok = r < rows_valid && c < cols_valid;
      sm90::cp_async16(dst + r * ld + c, ok ? src + r * s_row + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 128 * kCols; i += kMmaThreads) {
      const int r = i / kCols;
      const int c = i - r * kCols;
      dst[r * ld + c] = (r < rows_valid && c < cols_valid)
                            ? src[r * s_row + c * s_col]
                            : __float2bfloat16(0.f);
    }
  }
}

// C (or B: the same layout) of the chunk starting at c0 of batch b
template <int kNT>
__device__ __forceinline__ void stage_n(bf16* dst, const void* src,
                                        int64_t s_b, int64_t s_l,
                                        int64_t s_n, int vec, const Params& p,
                                        int64_t b, int64_t c0) {
  stage<Mma<kNT>::NP>(dst, Mma<kNT>::NS,
                      static_cast<const bf16*>(src) + b * s_b + c0 * s_l,
                      s_l, s_n, static_cast<int>(p.Q), static_cast<int>(p.N),
                      vec);
}

// A fragments of C's rows of m tile mt, over all of (padded) N
template <int kNT>
__device__ __forceinline__ void load_c(uint32_t (&ca)[Mma<kNT>::KS][4],
                                       const bf16* Cs, int mt, int lane) {
#pragma unroll
  for (int ks = 0; ks < Mma<kNT>::KS; ++ks)
    sm90::ldsm_x4(ca[ks], Cs + (mt * 16 + (lane & 15)) * Mma<kNT>::NS +
                              ks * 16 + (lane >> 4) * 8);
}

// The 16 x 16 score blocks ub and, with two, ub + 1 (rows of m tile mt,
// columns u of the block) of C . B^T: m16n8 float32 accumulators, four
// independent chains.  B's rows are the B operand without transposition,
// as K's rows in attention.
template <int kNT>
__device__ __forceinline__ void score_blocks(
    float (&sc)[2][2][4], const uint32_t (&ca)[Mma<kNT>::KS][4],
    const bf16* Bs, int ub, bool two, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][j][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Mma<kNT>::KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && !two) break;
      uint32_t bb[4];
      sm90::ldsm_x4(bb, Bs + ((ub + i) * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                 Mma<kNT>::NS +
                             ks * 16 + ((lane >> 3) & 1) * 8);
      sm90::mma_bf16(sc[i][0], ca[ks], bb[0], bb[1], sc[i][0]);
      sm90::mma_bf16(sc[i][1], ca[ks], bb[2], bb[3], sc[i][1]);
    }
  }
}

// One weight block: W[t, u] = exp(cum[t] - cum[u]) s dt[u] in float32
// (exp2f of the log2(e)-scaled difference, formed only where t >= u, so
// its exponent is <= 0), rounded to bf16 as the A operand of its 16-deep
// step of W . x (two n8 accumulator tiles make one k16 A fragment); x's
// rows u are the B operand through .trans, as V in attention.
template <int kPB>
__device__ __forceinline__ void weight_block(float (&yacc)[kPB / 8][4],
                                             const float (&sc)[2][4], int ub,
                                             int t_lo, float c_lo,
                                             float c_hi, const float* cum,
                                             const float* dts, const bf16* Xs,
                                             int lane) {
  const int t_hi = t_lo + 8;
  uint32_t wa[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int u0 = ub * 16 + j * 8 + 2 * (lane & 3);
    const float cu0 = cum[u0];
    const float cu1 = cum[u0 + 1];
    const float d0 = dts[u0];
    const float d1 = dts[u0 + 1];
    const float w00 =
        t_lo >= u0 ? exp2f((c_lo - cu0) * kLog2e) * sc[j][0] * d0 : 0.f;
    const float w01 =
        t_lo >= u0 + 1 ? exp2f((c_lo - cu1) * kLog2e) * sc[j][1] * d1 : 0.f;
    const float w10 =
        t_hi >= u0 ? exp2f((c_hi - cu0) * kLog2e) * sc[j][2] * d0 : 0.f;
    const float w11 =
        t_hi >= u0 + 1 ? exp2f((c_hi - cu1) * kLog2e) * sc[j][3] * d1 : 0.f;
    wa[2 * j] = sm90::pack_bf16(w00, w01);
    wa[2 * j + 1] = sm90::pack_bf16(w10, w11);
  }
#pragma unroll
  for (int np = 0; np < kPB / 16; ++np) {
    uint32_t xv[4];
    sm90::ldsm_x4_trans(xv, Xs + (ub * 16 + (lane & 15)) * x_stride(kPB) +
                                np * 16 + (lane >> 4) * 8);
    sm90::mma_bf16(yacc[2 * np], wa, xv[0], xv[1], yacc[2 * np]);
    sm90::mma_bf16(yacc[2 * np + 1], wa, xv[2], xv[3], yacc[2 * np + 1]);
  }
}

// Slot (in float4s) of one half of a warp's score block in the shared
// scratch: [batch x chunk][warp][block][half][lane].  Block k of warp w is
// block ub = k of m tile w for k <= w, block ub = k - w - 1 of m tile
// 7 - w after.
__device__ __forceinline__ int64_t score_slot(int64_t bc, int warp, int blk,
                                              int half, int lane) {
  return (((bc * 4 + warp) * kBlocks + blk) * 2 + half) * 32 + lane;
}

// The score blocks of one (batch, chunk), grid Bb x n_chunks: formed once
// and read back by every head's CTAs.
template <int kNT>
__global__ void __launch_bounds__(kMmaThreads) ssd_scores_kernel(Params p,
                                                                 MmaArgs e) {
  using S = Mma<kNT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = Cs + 128 * S::NS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bc = blockIdx.x;
  const int64_t b = bc / e.n_chunks;
  const int64_t c0 = (bc - b * e.n_chunks) * p.Q;
  stage_n<kNT>(Cs, p.C, p.c_sb, p.c_sl, p.c_sn, e.vec_c, p, b, c0);
  stage_n<kNT>(Bs, p.B, p.b_sb, p.b_sl, p.b_sn, e.vec_b, p, b, c0);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  const int nq = static_cast<int>((p.Q + 15) / 16);
  auto* dst = reinterpret_cast<float4*>(e.scores);
  for (int pass = 0; pass < 2; ++pass) {
    const int mt = pass == 0 ? warp : 7 - warp;
    if (mt >= nq) continue;
    uint32_t ca[S::KS][4];
    load_c<kNT>(ca, Cs, mt, lane);
    for (int ub = 0; ub <= mt; ub += 2) {
      const bool two = ub < mt;
      float sc[2][2][4];
      score_blocks<kNT>(sc, ca, Bs, ub, two, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) break;
        const int blk = (pass == 0 ? 0 : warp + 1) + ub + i;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dst[score_slot(bc, warp, blk, j, lane)] = make_float4(
              sc[i][j][0], sc[i][j][1], sc[i][j][2], sc[i][j][3]);
      }
    }
  }
}

template <int kNT, int kPB>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_mma_kernel(Params p, MmaArgs e) {
  using S = Mma<kNT>;
  constexpr int kXS = x_stride(kPB);
  constexpr int kMP = kPB / 16;  // m16 tiles of the state, n16 pairs of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [128][NS]
  bf16* Bs = Cs + 128 * S::NS;                   // [128][NS]
  bf16* Hs = Bs + 128 * S::NS;                   // [kPB][NS]: h in bf16
  bf16* Xs = Hs + kPB * S::NS;                  // [128][kXS]
  bf16* XWs = Xs + 128 * kXS;                    // [128][kXS]: x w_u
  float* cum = reinterpret_cast<float*>(XWs + 128 * kXS);  // [128]
  float* ecum = cum + 128;                       // exp(cum)
  float* dts = ecum + 128;                       // dt
  float* wu = dts + 128;                         // hand-off weights
  float* wsum = wu + 128;                        // [4] warp sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.H;
  const int64_t h = bh - b * p.H;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * kPB;
  const int Q = static_cast<int>(p.Q);
  const int nq = (Q + 15) / 16;
  const int pv = static_cast<int>(p.P - p0 < kPB ? p.P - p0 : kPB);
  const float a = p.A[h];
  const bf16* xb =
      static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + p0 * p.x_sp;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  bf16* yb = static_cast<bf16*>(p.y) + (b * p.L * p.H + h) * p.P + p0;
  const int64_t y_sl = p.H * p.P;
  const bool pairs = (p.P & 1) == 0;  // 4-byte aligned column pairs of y
  const int nb = warp * kNT * 8;      // the warp's first state column

  for (int i = tid; i < kPB * S::NS; i += kMmaThreads)
    Hs[i] = __float2bfloat16(0.f);
  float hacc[kMP][kNT][4];
#pragma unroll
  for (int i = 0; i < kMP; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[i][j][c] = 0.f;

  // chunk 0's tiles; every later chunk's are requested while the one
  // before finishes (C and x during its hand-off, B after it)
  stage_n<kNT>(Cs, p.C, p.c_sb, p.c_sl, p.c_sn, e.vec_c, p, b, 0);
  stage_n<kNT>(Bs, p.B, p.b_sb, p.b_sl, p.b_sn, e.vec_b, p, b, 0);
  stage<kPB>(Xs, kXS, xb, p.x_sl, p.x_sp, Q, pv, e.vec_x);
  sm90::cp_async_commit();
  float d = tid < Q ? dtb[tid * p.dt_sl] : 0.f;  // dt of the chunk
  int64_t ci = 0;
  for (int64_t c0 = 0; c0 < p.L; c0 += Q, ++ci) {
    const bool more = c0 + Q < p.L;
    // 1. the warps' scans of A dt; the chunk's tiles arrive
    float v = a * d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) wsum[warp] = v;
    sm90::cp_async_wait<0>();
    __syncthreads();
    // 2. cum (summed as the FFMA kernel sums it; padding adds -0),
    //    exp(cum) and the hand-off weights
    for (int w = 0; w < warp; ++w) v += wsum[w];
    const float cum_last = ((wsum[3] + wsum[0]) + wsum[1]) + wsum[2];
    cum[tid] = v;
    ecum[tid] = expf(v);
    dts[tid] = d;
    wu[tid] = tid < Q ? expf(cum_last - v) * d : 0.f;
    const float decay = expf(cum_last);
    __syncthreads();
    // 3. x w_u in bf16, the A operand of the hand-off
    for (int i = tid; i < 128 * kPB / 2; i += kMmaThreads) {
      const int r = i / (kPB / 2);
      const int c = (i - r * (kPB / 2)) * 2;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Xs + r * kXS + c));
      const float w = wu[r];
      *reinterpret_cast<__nv_bfloat162*>(XWs + r * kXS + c) =
          __floats2bfloat162_rn(xv.x * w, xv.y * w);
    }
    // 4. y of the warp's two m tiles
    for (int pass = 0; pass < 2; ++pass) {
      const int mt = pass == 0 ? warp : 7 - warp;
      if (mt >= nq) continue;
      uint32_t ca[S::KS][4];
      load_c<kNT>(ca, Cs, mt, lane);
      // two partial sums (even / odd k steps, even / odd blocks) halve
      // the dependent mma chains
      float yacc[2 * kMP][4];
      float yalt[2 * kMP][4];
#pragma unroll
      for (int j = 0; j < 2 * kMP; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[j][c] = yalt[j][c] = 0.f;
      // C . h^T: h's rows p are the B operand without transposition
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        float (&acc)[2 * kMP][4] = ks & 1 ? yalt : yacc;
#pragma unroll
        for (int np = 0; np < kMP; ++np) {
          uint32_t hb[4];
          sm90::ldsm_x4(hb, Hs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     S::NS +
                                 ks * 16 + ((lane >> 3) & 1) * 8);
          sm90::mma_bf16(acc[2 * np], ca[ks], hb[0], hb[1], acc[2 * np]);
          sm90::mma_bf16(acc[2 * np + 1], ca[ks], hb[2], hb[3],
                         acc[2 * np + 1]);
        }
      }
      const int t_lo = mt * 16 + g;
      const float e_lo = ecum[t_lo];
      const float e_hi = ecum[t_lo + 8];
#pragma unroll
      for (int j = 0; j < 2 * kMP; ++j) {
        yacc[j][0] = (yacc[j][0] + yalt[j][0]) * e_lo;
        yacc[j][1] = (yacc[j][1] + yalt[j][1]) * e_lo;
        yacc[j][2] = (yacc[j][2] + yalt[j][2]) * e_hi;
        yacc[j][3] = (yacc[j][3] + yalt[j][3]) * e_hi;
#pragma unroll
        for (int c = 0; c < 4; ++c) yalt[j][c] = 0.f;
      }
      const float c_lo = cum[t_lo];
      const float c_hi = cum[t_lo + 8];
      // the pass's score blocks, read back from the scratch (blocks past
      // mt are skipped, warp-uniformly)
      const auto* src = reinterpret_cast<const float4*>(e.scores);
      const int64_t bc = b * e.n_chunks + ci;
      const int blk0 = pass == 0 ? 0 : warp + 1;
      float sc[8][2][4];
#pragma unroll
      for (int ub = 0; ub < 8; ++ub) {
        if (ub > mt) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 s4 = src[score_slot(bc, warp, blk0 + ub, j, lane)];
          sc[ub][j][0] = s4.x;
          sc[ub][j][1] = s4.y;
          sc[ub][j][2] = s4.z;
          sc[ub][j][3] = s4.w;
        }
      }
#pragma unroll
      for (int ub = 0; ub < 8; ++ub) {
        if (ub > mt) continue;
        weight_block<kPB>(ub & 1 ? yalt : yacc, sc[ub], ub, t_lo, c_lo, c_hi,
                          cum, dts, Xs, lane);
      }
#pragma unroll
      for (int j = 0; j < 2 * kMP; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[j][c] += yalt[j][c];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t_lo + 8 * half;
        if (t >= Q) continue;
        bf16* yr = yb + (c0 + t) * y_sl;
#pragma unroll
        for (int j = 0; j < 2 * kMP; ++j) {
          const int c = j * 8 + 2 * tq;
          const float v0 = yacc[j][2 * half];
          const float v1 = yacc[j][2 * half + 1];
          if (pairs && c + 1 < pv) {
            *reinterpret_cast<__nv_bfloat162*>(yr + c) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < pv) yr[c] = __float2bfloat16(v0);
            if (c + 1 < pv) yr[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();  // every warp has read Cs, Xs and Hs; XWs is complete
    float d_next = 0.f;
    if (more) {
      stage_n<kNT>(Cs, p.C, p.c_sb, p.c_sl, p.c_sn, e.vec_c, p, b, c0 + Q);
      stage<kPB>(Xs, kXS, xb + (c0 + Q) * p.x_sl, p.x_sl, p.x_sp, Q, pv,
                 e.vec_x);
      sm90::cp_async_commit();
      if (tid < Q) d_next = dtb[(c0 + Q + tid) * p.dt_sl];
    }
    // 5. the hand-off: h = exp(cum[Q-1]) h + (x w_u)^T B, x w_u's rows u
    //    as the A operand and B's rows u as the B operand, both through
    //    .trans
#pragma unroll
    for (int i = 0; i < kMP; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) hacc[i][j][c] *= decay;
    for (int ks = 0; ks < nq; ++ks) {
      uint32_t xa[kMP][4];
#pragma unroll
      for (int mp = 0; mp < kMP; ++mp)
        sm90::ldsm_x4_trans(
            xa[mp], XWs + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * kXS +
                        mp * 16 + ((lane >> 3) & 1) * 8);
      if constexpr (kNT == 1) {
        uint32_t bb[2];
        sm90::ldsm_x2_trans(bb, Bs + (ks * 16 + (lane & 15)) * S::NS + nb);
#pragma unroll
        for (int mp = 0; mp < kMP; ++mp)
          sm90::mma_bf16(hacc[mp][0], xa[mp], bb[0], bb[1], hacc[mp][0]);
      } else {
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          uint32_t bb[4];
          sm90::ldsm_x4_trans(bb, Bs + (ks * 16 + (lane & 15)) * S::NS + nb +
                                      jj * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mp = 0; mp < kMP; ++mp) {
            sm90::mma_bf16(hacc[mp][2 * jj], xa[mp], bb[0], bb[1],
                           hacc[mp][2 * jj]);
            sm90::mma_bf16(hacc[mp][2 * jj + 1], xa[mp], bb[2], bb[3],
                           hacc[mp][2 * jj + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int mp = 0; mp < kMP; ++mp) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = nb + j * 8 + 2 * tq;
        const int r = mp * 16 + g;
        *reinterpret_cast<uint32_t*>(Hs + r * S::NS + n) =
            sm90::pack_bf16(hacc[mp][j][0], hacc[mp][j][1]);
        *reinterpret_cast<uint32_t*>(Hs + (r + 8) * S::NS + n) =
            sm90::pack_bf16(hacc[mp][j][2], hacc[mp][j][3]);
      }
    }
    __syncthreads();  // every warp has read Bs and XWs, and written Hs
    if (more) {
      stage_n<kNT>(Bs, p.B, p.b_sb, p.b_sl, p.b_sn, e.vec_b, p, b, c0 + Q);
      sm90::cp_async_commit();
    }
    d = d_next;
  }
}

template <int kNT, int kPB>
int launch_mma(const Params& p, const MmaArgs& e, cudaStream_t stream) {
  auto* sk = ssd_scores_kernel<kNT>;
  const size_t ssmem = 2 * 128 * Mma<kNT>::NS * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      sk, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(ssmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sk<<<static_cast<unsigned int>(p.Bb * e.n_chunks), kMmaThreads, ssmem,
       stream>>>(p, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* kern = ssd_mma_kernel<kNT, kPB>;
  const size_t smem =
      static_cast<size_t>(mma_smem_bytes(Mma<kNT>::NP, kPB));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.Bb * p.H),
                  static_cast<unsigned int>((p.P + kPB - 1) / kPB));
  kern<<<grid, kMmaThreads, smem, stream>>>(p, e);
  return static_cast<int>(cudaGetLastError());
}

template <int kNT>
int launch_mma(const Params& p, const MmaArgs& e, int pb,
               cudaStream_t stream) {
  return pb == 16 ? launch_mma<kNT, 16>(p, e, stream)
                  : launch_mma<kNT, 32>(p, e, stream);
}

// n8 tiles of the state per warp for state width N (0: too wide)
constexpr int mma_tiles(int64_t N) {
  return N <= 32 ? 1 : N <= 64 ? 2 : N <= 128 ? 4 : 0;
}


}  // namespace

// Dynamic shared memory (bytes) one CTA needs for state width N.
extern "C" int64_t ssd_scan_smem_bytes(int64_t N) {
  return smem_floats(N) * static_cast<int64_t>(sizeof(float));
}

// C entry point.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success; -1 for a type that is not
// instantiated) so that a refused launch surfaces in the Python wrapper.
// ``strides`` holds the 13 element strides (x: b, l, h, p; dt: b, l, h;
// B: b, l, n; C: b, l, n); y is contiguous [Bb, L, H, P].  dtype (of x, B,
// C and y): 0 = float32, 1 = bfloat16.  The caller guarantees Q =
// min(128, L) dividing L >= 1, the shared-memory limit and the grid
// limits.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* B, const void* C,
                               void* y, int64_t Bb, int64_t L, int64_t H,
                               int64_t P, int64_t N, int64_t Q,
                               const int64_t* strides, void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           B, C, y, Bb, L, H, P, N, Q,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6],
           strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12]};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(p, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, s);
  return -1;
}

// Dynamic shared memory (bytes) one CTA of the mma variant needs for state
// width N and pb P columns (0 when N is too wide for it).
extern "C" int64_t ssd_scan_mma_smem_bytes(int64_t N, int64_t pb) {
  const int nt = mma_tiles(N);
  return nt ? mma_smem_bytes(32 * nt, pb) : 0;
}

// Floats of the shared score scratch for Bb batches of n_chunks chunks.
extern "C" int64_t ssd_scan_scores_floats(int64_t Bb, int64_t n_chunks) {
  return Bb * n_chunks * 4 * kBlocks * 2 * 32 * 4;
}

// C entry point of the mma variant (bfloat16 x, B, C and y).  As
// ssd_scan_launch, plus vec (three ints: x, B and C may be staged in
// 16-byte pieces), pb (P columns per CTA: 16 or 32) and scores (a
// scratch of ssd_scan_scores_floats floats, which a first launch fills
// with the score tile of every (batch, chunk)).
// Returns -2 for N > 128.
extern "C" int ssd_scan_mma_launch(const void* x, const void* dt,
                                   const void* A, const void* B,
                                   const void* C, void* y, int64_t Bb,
                                   int64_t L, int64_t H, int64_t P,
                                   int64_t N, int64_t Q,
                                   const int64_t* strides, const int* vec,
                                   int pb, void* scores, void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           B, C, y, Bb, L, H, P, N, Q,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6],
           strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12]};
  const MmaArgs e{vec[0], vec[1], vec[2], static_cast<float*>(scores), L / Q};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mma_tiles(N)) {
    case 1: return launch_mma<1>(p, e, pb, s);
    case 2: return launch_mma<2>(p, e, pb, s);
    case 4: return launch_mma<4>(p, e, pb, s);
    default: return -2;
  }
}

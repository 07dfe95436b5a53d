// Fused attention forward (online softmax) for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface and loaded through ctypes.
//
// Replaces the Pallas kernel _flash_fwd / _kernel in
// repro/kernels/flash_attention.py: q[B, Hq, S, D], k/v[B, Hkv, T, D]
// (float32 or bfloat16) -> o[B, Hq, S, D] in q's type, with causal
// masking, GQA (query head h reads kv head h / (Hq / Hkv)), a sliding
// window, a logit softcap c * tanh(s / c), and the queries at the tail of
// the sequence (query i sits at position i + T - S, as in decode).
//
// Order of operations, as in the reference: s = (q . k) * scale ->
// softcap -> mask to -1e30 -> online softmax with float32 running max m,
// sum l and accumulator -> acc / max(l, 1e-30) -> cast.  Keys past the
// end (the ragged last tile, or the end of a key split) are -inf, so they
// add nothing, as in the reference where they do not exist.  tanhf, and
// exp2f of the log2(e)-scaled argument, not the fast intrinsics.  Tiles
// wholly outside the causal / window band of a CTA's rows are skipped:
// every row keeps its own key (causal) or the last key, so its running
// max is a real logit, and exp(-1e30 - m) is exactly 0 for what a skipped
// tile would have added.  Inputs are read through explicit strides (last
// dimension contiguous, rows on 16-byte boundaries), so a KV cache sliced
// along time is read in place.
//
// What bounds it.  kratos-dd prefill ([8, 12, 512, 64] bf16, causal):
// 3.2 GFLOP of visible (q, k) pairs against 25 MB of q, k, v and o, so
// the bytes bound it (7.5 us; the bf16 tensor-core operations take 3.3
// us).  gemma2-2b's local prefill ([2, 8, 4608, 256], window 4096): 172
// GFLOP, operations (0.174 ms).  Decode (S = 1) reads the whole cache
// slice for one query row per head: bytes, 4.2 us at kratos-dd's 576
// keys.  whisper-small's serving encoder ([8, 12, 1500, 64] float32, not
// causal): 55.3 GFLOP as float32 products, 3 x 55.3 on the tf32 tensor
// cores (0.335 ms at 495 TFLOP/s) against 44 us of bytes: operations.
//
// Design: three variants, chosen by the launcher from the type, S and
// G = Hq / Hkv.
//
// * mma (bfloat16, G * S > 16).  One CTA of 4 warps owns 64 query rows
//   of one (batch, head), 16 per warp, and walks the key / value tiles of
//   its band in order.  Q.K^T and P.V run on the tensor cores (mma.sync
//   m16n8k16, operands from shared memory through ldmatrix, float32
//   accumulators); the online-softmax state (m, l and the 16 x D output
//   per warp) stays in float32 registers, and P is rounded to bf16 for
//   P.V (about 2^-9 relative).  Q is staged once; K and V tiles are
//   double-buffered with 16-byte cp.async (rows padded by 16 bytes, so
//   ldmatrix is free of bank conflicts).  Query tiles are launched
//   heaviest (latest) first.  BK = 64 keys per tile up to D = 128, 32 at
//   D = 256 (the register budget: 128 accumulators per thread).  At
//   D = 64 the softmax's scalar work per score costs as much as the
//   products, so blocks of keys that every row of a warp sees skip the
//   mask, and exp is exp2f of a log2(e)-scaled argument.
// * split (bfloat16, G * S <= 16: decode), as in flash-decoding.  The grid
//   is (batch x kv head, key split): one CTA takes all G * S query rows of
//   its kv group (one 16-row tile) and a contiguous slice of the keys
//   visible to them; its 4 warps take 16 keys each of every 64-key tile.
//   The warps' states are merged in shared memory, in warp order, into a
//   float32 partial (m, l, acc) per split; a second launch combines the
//   splits in split order, so every run gives the same bits (a single
//   split writes the output itself).  The launcher picks the split count
//   so that the grid fills the card once with two CTAs per SM, or one
//   where only one fits (D = 256: its 64-key K / V double buffer takes
//   135 KB); more, shorter splits lose more to each CTA's fixed costs
//   and to the partials than they gain in parallelism.
// * tf32x3 (float32): float32 operands on the tensor cores at float32
//   accuracy, in the mma variant's shape (4 warps, heaviest query tiles
//   first, tiles outside the band skipped, the same softmax code).  Each
//   operand x splits into hi = tf32(x) and lo = tf32(x - hi), both
//   rounded to nearest with ties away from zero (11 + 11 significant
//   bits, x to about 2^-22), and each product is a_lo b_hi + a_hi b_lo +
//   a_hi b_hi (small terms first; only a_lo b_lo is dropped) with
//   mma.sync m16n8k8 tf32.  The split is the bound in practice: K and V
//   tiles are staged as float32 (double-buffered, 16-byte cp.async) and
//   each warp splits the fragments it reads in registers (splitting a
//   tile once in shared memory would double what the warps read from
//   it).  So up to D = 64 a warp owns two 16-row tiles (128 rows a CTA)
//   and splits each K and V fragment once for both, which halves the
//   reads and splits per row (32-key tiles keep the second tile's scores
//   and P in registers).  The registers that take the second tile
//   are those Q's fragments would hold, so Q is split once per CTA into
//   hi / lo rows in shared memory at every D, and read from there.  Rows
//   are padded by 4 floats, so the fragment reads of Q, K (rows g, column
//   t) and V (rows 2t and 2t + 1, column g) are free of bank conflicts.
//   P never leaves registers: the C fragment of Q.K^T gives a thread keys
//   2t and 2t + 1 of an 8-key block, the A fragment of P.V wants k = t
//   and t + 4, so key 2t is taken as k = t and key 2t + 1 as k = t + 4,
//   and V's rows are read in that order for the B fragment.  The tensor
//   cores' internal sums round toward zero, so over 1,500 keys P.V would
//   drift: each 8-column block of a tile's P.V is summed in fresh
//   registers (two blocks at a time, two independent chains of mma) and
//   added to the running output with one float32 fma (which also applies
//   the softmax's rescale).  BK = 32 keys per tile up to D = 64, 64 at
//   D = 128 (one 16-row tile a warp), 16 at D = 256, where Q's hi and lo
//   rows (133 KB) leave room for no larger K / V double buffer in the
//   227 KB of shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaRows = 64;      // query rows per mma CTA
constexpr int kSplitBK = 64;      // split variant: 16 keys per warp
constexpr int kSplitRows = 16;    // split variant: one 16-row tile
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t B, Hq, Hkv, S, T;
  // element strides of the batch, head and sequence axes (the last axis
  // is contiguous): q, k, v, o
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale;
  float softcap;
  int has_softcap;
  int causal;
  int has_window;
  int64_t window;  // at most T + 1 (a wider window masks nothing)
  // split variant: the first key any query can see, keys per split, the
  // number of splits, and float32 partials m / l [B * Hkv, n_splits, R]
  // and acc [B * Hkv, n_splits, R, D], R = G * S rows
  int64_t k_first, kps, n_splits;
  float* part_m;
  float* part_l;
  float* part_acc;
};

// The (scaled, softcapped) logit x of (query at qpos, key at kpos) after
// the mask; keys at or past k_stop do not exist (-inf).
__device__ __forceinline__ float masked(float x, int qpos, int kpos,
                                        int k_stop, const Params& p) {
  bool vis = true;
  if (p.causal) vis = kpos <= qpos;
  if (p.has_window) vis = vis && kpos > qpos - static_cast<int>(p.window);
  x = vis ? x : kMasked;
  return kpos >= k_stop ? -INFINITY : x;
}

// The softmax half of a warp's tile, shared by the variants.  s holds the
// C fragments of the warp's q . k (rows g = lane / 4 and g + 8; keys 2t
// and 2t + 1, t = lane % 4, of each 8-key block, the first at position
// key0): scale -> softcap -> mask, then the online-softmax update of rows
// g and g + 8, whose running max is m and this thread's part of the row
// sum l (summed over the quad at the end).  s becomes p = exp(s - m_new)
// and alpha the factor the output accumulators are to be rescaled by.
// The warp's rows sit at positions [q_lo, q_hi]: when every key of the
// block is visible to all of them (and exists), the mask is skipped.
template <int NK>
__device__ __forceinline__ void online_softmax(
    float (&s)[NK / 8][4], int key0, int k_stop, const int (&qpos)[2],
    int q_lo, int q_hi, const Params& p, int lane, float (&m)[2],
    float (&l)[2], float (&alpha)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
  // scale -> softcap -> mask, each a loop of its own behind a uniform
  // branch, so that every step's code exists once
#pragma unroll
  for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] *= p.scale;
  if (p.has_softcap) {
#pragma unroll
    for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nb][e] = p.softcap * tanhf(s[nb][e] / p.softcap);
  }
  const bool interior =
      key0 + NK <= k_stop && (!p.causal || key0 + NK - 1 <= q_lo) &&
      (!p.has_window || key0 > q_hi - static_cast<int>(p.window));
  if (!interior) {
#pragma unroll
    for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = key0 + nb * 8 + 2 * (lane & 3) + (e & 1);
        s[nb][e] = masked(s[nb][e], qpos[e >> 1], kpos, k_stop, p);
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = exp2f((s[nb][e] - m[e >> 1]) * kLog2e);
      l[e >> 1] += pv;
      s[nb][e] = pv;
    }
}

// One warp of a bf16 variant: its 16 query rows (Qs) against NK keys
// (rows of Ks and Vs, the first at position key0), updating the
// online-softmax state m, l (see online_softmax) and acc (the C fragments
// of the 16 x D output).  Shared-memory rows are D + 8 bf16 apart.
template <int D, int NK>
__device__ __forceinline__ void warp_attend(
    const bf16* Qs, const bf16* Ks, const bf16* Vs, int key0, int k_stop,
    const int (&qpos)[2], int q_lo, int q_hi, const Params& p, int lane,
    float (&m)[2], float (&l)[2], float (&acc)[D / 8][4]) {
  constexpr int RS = D + 8;
  float s[NK / 8][4];
#pragma unroll
  for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  // S = Q K^T: A from Q rows, B from K rows (k = d), both without .trans
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    sm90::ldsm_x4(qa, Qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb2 = 0; nb2 < NK / 16; ++nb2) {
      uint32_t kb[4];
      sm90::ldsm_x4(kb, Ks + (nb2 * 16 + (lane >> 4) * 8 + (lane & 7)) * RS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
      sm90::mma_bf16(s[2 * nb2], qa, kb[0], kb[1], s[2 * nb2]);
      sm90::mma_bf16(s[2 * nb2 + 1], qa, kb[2], kb[3], s[2 * nb2 + 1]);
    }
  }
  float alpha[2];
  online_softmax<NK>(s, key0, k_stop, qpos, q_lo, q_hi, p, lane, m, l,
                     alpha);
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] *= alpha[e >> 1];
  // O += P V: the C fragments of two key blocks are the A fragment of a
  // 16-key step; B from V rows (k = key) through ldmatrix .trans
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t pa[4] = {sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int db2 = 0; db2 < D / 16; ++db2) {
      uint32_t vb[4];
      sm90::ldsm_x4_trans(vb, Vs + (kk * 16 + (lane & 15)) * RS + db2 * 16 +
                                  (lane >> 4) * 8);
      sm90::mma_bf16(acc[2 * db2], pa, vb[0], vb[1], acc[2 * db2]);
      sm90::mma_bf16(acc[2 * db2 + 1], pa, vb[2], vb[3], acc[2 * db2 + 1]);
    }
  }
}

// One warp of the tf32x3 variant: MT tiles of 16 query rows against NK
// keys, as warp_attend; each K and V fragment is split once for all MT
// tiles.  Q's fragments come split, from the hi / lo rows Qh, Ql (tile
// mt from row 16 mt).  Shared-memory rows are D + 4 floats apart.
template <int D, int NK, int MT>
__device__ __forceinline__ void warp_attend_tf32(
    const float* Qh, const float* Ql, const float* Ks, const float* Vs,
    int key0, int k_stop, const int (&qpos)[MT][2], const int (&q_lo)[MT],
    const Params& p, int lane, float (&m)[MT][2], float (&l)[MT][2],
    float (&acc)[MT][D / 8][4]) {
  constexpr int RS = D + 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  float s[MT][NK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.f;
  // S = Q K^T, three passes per 8-deep step, small terms first; B from K
  // rows (k = d)
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[MT][2][4];  // hi, lo
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off =
            (16 * mt + g + 8 * (i & 1)) * RS + kk * 8 + t + 4 * (i >> 1);
        a[mt][0][i] = __float_as_uint(Qh[off]);
        a[mt][1][i] = __float_as_uint(Ql[off]);
      }
#pragma unroll
    for (int nb = 0; nb < NK / 8; ++nb) {
      const float* kr = Ks + (nb * 8 + g) * RS + kk * 8 + t;
      uint32_t bh[2], bl[2];
      sm90::split_tf32(kr[0], bh[0], bl[0]);
      sm90::split_tf32(kr[4], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sm90::mma_tf32(s[mt][nb], a[mt][1], bh[0], bh[1], s[mt][nb]);
        sm90::mma_tf32(s[mt][nb], a[mt][0], bl[0], bl[1], s[mt][nb]);
        sm90::mma_tf32(s[mt][nb], a[mt][0], bh[0], bh[1], s[mt][nb]);
      }
    }
  }
  float alpha[MT][2];
  uint32_t ph[MT][NK / 8][4], pl[MT][NK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    online_softmax<NK>(s[mt], key0, k_stop, qpos[mt], q_lo[mt],
                       q_lo[mt] + 15, p, lane, m[mt], l[mt], alpha[mt]);
    // P's A fragments, split: a[i] is (row g + 8 (i & 1), k t + 4 (i >> 1)),
    // and key 2t of a block is taken as k = t, key 2t + 1 as k = t + 4, so
    // a[i] is the C fragment's element 2 (i & 1) + (i >> 1)
#pragma unroll
    for (int kb = 0; kb < NK / 8; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sm90::split_tf32(s[mt][kb][2 * (i & 1) + (i >> 1)], ph[mt][kb][i],
                         pl[mt][kb][i]);
  }
  // O = alpha O + P V, two 8-column blocks at a time: each block's sum over
  // the tile in fresh registers, then one float32 fma into the running
  // output; B from V rows 2t (k = t) and 2t + 1 (k = t + 4), column g
#pragma unroll
  for (int db = 0; db < D / 8; db += 2) {
    float f[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[mt][u][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NK / 8; ++kb) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* vr = Vs + (kb * 8 + 2 * t) * RS + (db + u) * 8 + g;
        uint32_t bh[2], bl[2];
        sm90::split_tf32(vr[0], bh[0], bl[0]);
        sm90::split_tf32(vr[RS], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sm90::mma_tf32(f[mt][u], pl[mt][kb], bh[0], bh[1], f[mt][u]);
          sm90::mma_tf32(f[mt][u], ph[mt][kb], bl[0], bl[1], f[mt][u]);
          sm90::mma_tf32(f[mt][u], ph[mt][kb], bh[0], bh[1], f[mt][u]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][db + u][e] =
              fmaf(acc[mt][db + u][e], alpha[mt][e >> 1], f[mt][u][e]);
  }
}

// rows [t0, t0 + n) of a [*, D] tensor (row stride ld) into shared rows
// padded by 16 bytes (D + 8 bf16, D + 4 floats); rows at or past t_stop
// are zero-filled
template <int D, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ld,
                                          int t0, int n, int t_stop,
                                          int tid) {
  constexpr int EL = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / EL;          // chunks per row
  for (int c = tid; c < n * CH; c += kMmaThreads) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int t = t0 + r;
    const bool valid = t < t_stop;
    sm90::cp_async16(dst + r * (D + EL) + ch * EL,
                     src + (valid ? static_cast<int64_t>(t) * ld : 0) +
                         ch * EL,
                     valid);
  }
}

// The key tiles of BK keys that a tile of BQ query rows from q0 walks:
// those of the rows' causal / window band, from k_begin (rounded down to
// a tile) to k_end
template <int BQ, int BK>
struct KeyBand {
  int k_begin, k_end, n_tiles;
  __device__ __forceinline__ KeyBand(const Params& p, int q0) {
    const int S = static_cast<int>(p.S);
    const int T = static_cast<int>(p.T);
    const int t_off = T - S;
    const int q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
    k_begin = 0;
    k_end = T;
    if (p.causal && q_last + t_off + 1 < k_end) k_end = q_last + t_off + 1;
    if (p.has_window) {
      const int first = q0 + t_off - static_cast<int>(p.window) + 1;
      if (first > k_begin) k_begin = first;
    }
    k_begin = (k_begin / BK) * BK;
    n_tiles = (k_end - k_begin + BK - 1) / BK;
  }
};

template <int D, int BK>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kMmaRows + 4 * BK) * (D + 8) * sizeof(bf16);
}

template <int D, int BK>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(Params p) {
  constexpr int RS = D + 8;
  constexpr int BQ = kMmaRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * RS;      // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;  // [2][BK][RS]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.Hq;
  const int64_t h = bh - b * p.Hq;
  const int64_t hk = h / (p.Hq / p.Hkv);
  const int S = static_cast<int>(p.S);
  const int T = static_cast<int>(p.T);
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int t_off = T - S;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyBand<BQ, BK> band(p, q0);

  load_rows<D>(Qs, qb, p.q_ss, q0, BQ, S, tid);
  if (band.n_tiles > 0) {
    load_rows<D>(Ks, kb, p.k_ss, band.k_begin, BK, band.k_end, tid);
    load_rows<D>(Vs, vb, p.v_ss, band.k_begin, BK, band.k_end, tid);
  }
  sm90::cp_async_commit();

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int qpos[2] = {row0 + t_off, row0 + 8 + t_off};
  const int q_lo = q0 + warp * 16 + t_off;  // the warp's 16 positions

  for (int j = 0; j < band.n_tiles; ++j) {
    if (j + 1 < band.n_tiles) {  // prefetch the next tile, other buffer
      const int nb = (j + 1) & 1;
      const int t0 = band.k_begin + (j + 1) * BK;
      load_rows<D>(Ks + nb * BK * RS, kb, p.k_ss, t0, BK, band.k_end, tid);
      load_rows<D>(Vs + nb * BK * RS, vb, p.v_ss, t0, BK, band.k_end, tid);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = j & 1;
    warp_attend<D, BK>(Qs + warp * 16 * RS, Ks + cb * BK * RS,
                       Vs + cb * BK * RS, band.k_begin + j * BK, T, qpos,
                       q_lo, q_lo + 15, p, lane, m, l, acc);
    __syncthreads();  // the buffer is free for the prefetch after next
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int srow = row0 + 8 * i;
    if (srow < S) {
      const float den = fmaxf(l[i], 1e-30f);
      bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh +
                static_cast<int64_t>(srow) * p.o_ss + 2 * (lane & 3);
#pragma unroll
      for (int db = 0; db < D / 8; ++db)
        *reinterpret_cast<uint32_t*>(o + db * 8) = sm90::pack_bf16(
            acc[db][2 * i] / den, acc[db][2 * i + 1] / den);
    }
  }
}

// tf32x3 tiling by head dimension: 16-row tiles per warp (MT; a CTA's 4
// warps take 64 MT query rows) and keys per tile.  Up to D = 64 two
// tiles per warp halve the K / V fragment reads and splits per row, and
// 32-key tiles keep the second tile's scores and P in registers; D = 256
// takes 16 keys, where Q's hi and lo rows (133 KB) leave room for no
// larger K / V double buffer.
template <int D>
__host__ __device__ constexpr int tf32_mt() {
  return D <= 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int tf32_bk() {
  return D <= 64 ? 32 : D == 128 ? 64 : 16;
}
template <int D>
__host__ __device__ constexpr int tf32_rows() {
  return kMmaRows * tf32_mt<D>();
}

// Q's hi and lo rows, then the K / V double buffers
template <int D>
__host__ __device__ constexpr size_t tf32_smem_bytes() {
  return static_cast<size_t>(2 * tf32_rows<D>() + 4 * tf32_bk<D>()) *
         (D + 4) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_tf32x3_kernel(Params p) {
  constexpr int RS = D + 4;
  constexpr int MT = tf32_mt<D>();
  constexpr int BQ = tf32_rows<D>();
  constexpr int BK = tf32_bk<D>();
  static_assert(tf32_smem_bytes<D>() <= 232448, "shared memory per CTA");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [BQ][RS]
  float* Ql = Qh + BQ * RS;                        // [BQ][RS]
  float* Ks = Ql + BQ * RS;                        // [2][BK][RS]
  float* Vs = Ks + 2 * BK * RS;                    // [2][BK][RS]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.Hq;
  const int64_t h = bh - b * p.Hq;
  const int64_t hk = h / (p.Hq / p.Hkv);
  const int S = static_cast<int>(p.S);
  const int T = static_cast<int>(p.T);
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int t_off = T - S;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const KeyBand<BQ, BK> band(p, q0);

  load_rows<D>(Qh, qb, p.q_ss, q0, BQ, S, tid);
  if (band.n_tiles > 0) {
    load_rows<D>(Ks, kb, p.k_ss, band.k_begin, BK, band.k_end, tid);
    load_rows<D>(Vs, vb, p.v_ss, band.k_begin, BK, band.k_end, tid);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  // split q once, in place, into its hi and lo rows
  for (int i = tid; i < BQ * D; i += kMmaThreads) {
    const int off = (i / D) * RS + i % D;
    uint32_t hi, lo;
    sm90::split_tf32(Qh[off], hi, lo);
    Qh[off] = __uint_as_float(hi);
    Ql[off] = __uint_as_float(lo);
  }
  __syncthreads();

  // the warp's tiles: rows q0 + 16 (warp MT + mt) ..., at positions q_lo
  float m[MT][2], l[MT][2], acc[MT][D / 8][4];
  int qpos[MT][2], q_lo[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    q_lo[mt] = q0 + (warp * MT + mt) * 16 + t_off;
    qpos[mt][0] = q_lo[mt] + g;
    qpos[mt][1] = q_lo[mt] + g + 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kMasked;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][db][e] = 0.f;
  }

  for (int j = 0; j < band.n_tiles; ++j) {
    if (j + 1 < band.n_tiles) {  // prefetch the next tile, other buffer
      const int nb = (j + 1) & 1;
      const int t0 = band.k_begin + (j + 1) * BK;
      load_rows<D>(Ks + nb * BK * RS, kb, p.k_ss, t0, BK, band.k_end, tid);
      load_rows<D>(Vs + nb * BK * RS, vb, p.v_ss, t0, BK, band.k_end, tid);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = j & 1;
    warp_attend_tf32<D, BK, MT>(
        Qh + warp * MT * 16 * RS, Ql + warp * MT * 16 * RS,
        Ks + cb * BK * RS, Vs + cb * BK * RS, band.k_begin + j * BK, T, qpos,
        q_lo, p, lane, m, l, acc);
    __syncthreads();  // the buffer is free for the prefetch after next
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int srow = qpos[mt][i] - t_off;
      if (srow < S) {
        const float den = fmaxf(li, 1e-30f);
        float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                   static_cast<int64_t>(srow) * p.o_ss + 2 * t;
#pragma unroll
        for (int db = 0; db < D / 8; ++db)
          *reinterpret_cast<float2*>(o + db * 8) = make_float2(
              acc[mt][db][2 * i] / den, acc[mt][db][2 * i + 1] / den);
      }
    }
}

template <int D>
constexpr size_t split_smem_bytes() {
  return static_cast<size_t>(kSplitRows + 4 * kSplitBK) * (D + 8) *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_split_kernel(Params p) {
  constexpr int RS = D + 8;
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kSplitRows * RS;  // [2][kSplitBK][RS]
  bf16* Vs = Ks + 2 * kSplitBK * RS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = blockIdx.x;  // (batch, kv head)
  const int64_t b = bh / p.Hkv;
  const int64_t hk = bh - b * p.Hkv;
  const int64_t split = blockIdx.y;
  const int G = static_cast<int>(p.Hq / p.Hkv);
  const int S = static_cast<int>(p.S);
  const int T = static_cast<int>(p.T);
  const int R = G * S;  // live rows: row r is head hk * G + r / S, query r % S
  const int t_off = T - S;
  const int ks0 = static_cast<int>(p.k_first + split * p.kps);
  const int ks1 = ks0 + static_cast<int>(p.kps) < T
                      ? ks0 + static_cast<int>(p.kps) : T;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int c = tid; c < kSplitRows * CH; c += kMmaThreads) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const bool valid = r < R;
    const bf16* src = static_cast<const bf16*>(p.q);
    if (valid)
      src += b * p.q_sb + (hk * G + r / S) * p.q_sh + (r % S) * p.q_ss;
    sm90::cp_async16(Qs + r * RS + ch * 8, src + ch * 8, valid);
  }
  const int n_tiles = (ks1 - ks0 + kSplitBK - 1) / kSplitBK;
  load_rows<D>(Ks, kb, p.k_ss, ks0, kSplitBK, ks1, tid);
  load_rows<D>(Vs, vb, p.v_ss, ks0, kSplitBK, ks1, tid);
  sm90::cp_async_commit();

  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (lane >> 2) + 8 * i;
    qpos[i] = (r < R ? r % S : 0) + t_off;
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      const int t0 = ks0 + (j + 1) * kSplitBK;
      load_rows<D>(Ks + nb * kSplitBK * RS, kb, p.k_ss, t0, kSplitBK, ks1,
                   tid);
      load_rows<D>(Vs + nb * kSplitBK * RS, vb, p.v_ss, t0, kSplitBK, ks1,
                   tid);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = ks0 + j * kSplitBK + warp * 16;
    if (key0 < ks1) {  // warp-uniform: a ragged last tile idles warps
      const int cb = j & 1;
      warp_attend<D, 16>(Qs, Ks + (cb * kSplitBK + warp * 16) * RS,
                         Vs + (cb * kSplitBK + warp * 16) * RS, key0, ks1,
                         qpos, t_off, t_off + S - 1, p, lane, m, l, acc);
    }
    __syncthreads();
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' states, in warp order, through the K / V buffers
  float* cacc = reinterpret_cast<float*>(Ks);  // [4][16][D]
  float* cm = cacc + 4 * kSplitRows * D;       // [4][16]
  float* cl = cm + 4 * kSplitRows;             // [4][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = (lane >> 2) + 8 * i;
    float* dst = cacc + (warp * kSplitRows + r) * D + 2 * (lane & 3);
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<float2*>(dst + db * 8) =
          make_float2(acc[db][2 * i], acc[db][2 * i + 1]);
    if ((lane & 3) == 0) {
      cm[warp * kSplitRows + r] = m[i];
      cl[warp * kSplitRows + r] = li;
    }
  }
  __syncthreads();
  const int64_t slot = (bh * p.n_splits + split) * R;
  for (int idx = tid; idx < R * D; idx += kMmaThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float mm = cm[r];
#pragma unroll
    for (int w = 1; w < 4; ++w) mm = fmaxf(mm, cm[w * kSplitRows + r]);
    float ll = 0.f;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = expf(cm[w * kSplitRows + r] - mm);
      ll += cl[w * kSplitRows + r] * f;
      aa += cacc[(w * kSplitRows + r) * D + d] * f;
    }
    if (p.n_splits == 1) {  // the only split: the output itself
      bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb +
                (hk * G + r / S) * p.o_sh + (r % S) * p.o_ss;
      o[d] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
      continue;
    }
    p.part_acc[(slot + r) * D + d] = aa;
    if (d == 0) {
      p.part_m[slot + r] = mm;
      p.part_l[slot + r] = ll;
    }
  }
}

// One CTA per (batch x kv head, row), one thread per output column: the
// splits' partials combined in split order, normalised and cast.
__global__ void flash_combine_kernel(Params p) {
  const int G = static_cast<int>(p.Hq / p.Hkv);
  const int S = static_cast<int>(p.S);
  const int R = G * S;
  const int64_t bh = blockIdx.x / R;
  const int r = static_cast<int>(blockIdx.x - bh * R);
  const int d = threadIdx.x;
  const int D = blockDim.x;
  const int64_t b = bh / p.Hkv;
  const int64_t hk = bh - b * p.Hkv;
  const int64_t base = bh * p.n_splits * R + r;
  float mm = p.part_m[base];
#pragma unroll 8  // independent loads, issued together
  for (int64_t i = 1; i < p.n_splits; ++i)
    mm = fmaxf(mm, p.part_m[base + i * R]);
  float ll = 0.f;
  float aa = 0.f;
#pragma unroll 8
  for (int64_t i = 0; i < p.n_splits; ++i) {
    const float f = expf(p.part_m[base + i * R] - mm);
    ll += p.part_l[base + i * R] * f;
    aa += p.part_acc[(base + i * R) * D + d] * f;
  }
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + (hk * G + r / S) * p.o_sh +
            (r % S) * p.o_ss;
  o[d] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
}

// One CTA of kMmaThreads per (batch x head, tile of `rows` queries): the
// mma and tf32x3 variants' grid
template <typename Kernel>
int launch_query_tiles(Kernel* kern, size_t smem, int rows, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.B * p.Hq),
                  static_cast<unsigned int>((p.S + rows - 1) / rows));
  kern<<<grid, kMmaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BK>
int launch_mma(const Params& p, cudaStream_t stream) {
  return launch_query_tiles(flash_mma_kernel<D, BK>, mma_smem_bytes<D, BK>(),
                            kMmaRows, p, stream);
}

template <int D>
int launch_tf32x3(const Params& p, cudaStream_t stream) {
  return launch_query_tiles(flash_tf32x3_kernel<D>, tf32_smem_bytes<D>(),
                            tf32_rows<D>(), p, stream);
}

template <int D>
int launch_split(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D>();
  static_assert(4 * kSplitRows * (D + 2) * sizeof(float) <=
                    4 * kSplitBK * (D + 8) * sizeof(bf16),
                "the warps' merge must fit in the K / V buffers");
  auto* kern = flash_split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.B * p.Hkv),
                  static_cast<unsigned int>(p.n_splits));
  kern<<<grid, kMmaThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return static_cast<int>(err);
  const int64_t rows = p.B * p.Hkv * (p.Hq / p.Hkv) * p.S;
  flash_combine_kernel<<<static_cast<unsigned int>(rows), D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int split_blocks_per_sm() {
  constexpr size_t smem = split_smem_bytes<D>();
  auto* kern = flash_split_kernel<D>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kMmaThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

int launch_variant(int variant, int64_t D, const Params& p,
                   cudaStream_t stream) {
  if (variant == 0) {
    switch (D) {
      case 16: return launch_tf32x3<16>(p, stream);
      case 32: return launch_tf32x3<32>(p, stream);
      case 64: return launch_tf32x3<64>(p, stream);
      case 128: return launch_tf32x3<128>(p, stream);
      case 256: return launch_tf32x3<256>(p, stream);
      default: return -1;
    }
  }
  if (variant == 1) {
    switch (D) {
      case 16: return launch_mma<16, 64>(p, stream);
      case 32: return launch_mma<32, 64>(p, stream);
      case 64: return launch_mma<64, 64>(p, stream);
      case 128: return launch_mma<128, 64>(p, stream);
      case 256: return launch_mma<256, 32>(p, stream);
      default: return -1;
    }
  }
  if (variant == 2) {
    switch (D) {
      case 16: return launch_split<16>(p, stream);
      case 32: return launch_split<32>(p, stream);
      case 64: return launch_split<64>(p, stream);
      case 128: return launch_split<128>(p, stream);
      case 256: return launch_split<256>(p, stream);
      default: return -1;
    }
  }
  return -1;
}

}  // namespace

// Split CTAs one SM holds at once for head dimension D (-1 on an error or
// a D that is not instantiated): the launcher caps its split count by it.
extern "C" int flash_split_blocks_per_sm(int64_t D) {
  switch (D) {
    case 16: return split_blocks_per_sm<16>();
    case 32: return split_blocks_per_sm<32>();
    case 64: return split_blocks_per_sm<64>();
    case 128: return split_blocks_per_sm<128>();
    case 256: return split_blocks_per_sm<256>();
    default: return -1;
  }
}

// C entry point.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success; -1 for a head dimension,
// variant or type that is not instantiated) so that a refused launch
// surfaces in the Python wrapper.  variant: 0 = tf32x3 (float32), 1 = mma
// (bfloat16), 2 = split (bfloat16; k_first, kps, n_splits and the float32
// partials part_m / part_l [B * Hkv * n_splits * G * S] and part_acc
// [... * D] are used only here).  ``strides`` holds the 12 element strides
// (q_sb, q_sh, q_ss, k_*, v_*, o_*).  The caller guarantees the shapes
// (Hq % Hkv == 0, T >= S >= 1, T < 2^31, window <= T + 1, G * S <= 16 for
// the split), rows of q, k and v on 16-byte boundaries, and the grid
// limits.
extern "C" int flash_attention_launch(
    int variant, const void* q, const void* k, const void* v, void* o,
    int64_t B, int64_t Hq, int64_t Hkv, int64_t S, int64_t T, int64_t D,
    const int64_t* strides, float scale, int has_softcap, float softcap,
    int causal, int has_window, int64_t window, int64_t k_first,
    int64_t kps, int64_t n_splits, void* part_m, void* part_l,
    void* part_acc, void* stream) {
  Params p{q, k, v, o, B, Hq, Hkv, S, T,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8],
           strides[9], strides[10], strides[11],
           scale, softcap, has_softcap, causal, has_window, window,
           k_first, kps, n_splits, static_cast<float*>(part_m),
           static_cast<float*>(part_l), static_cast<float*>(part_acc)};
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_variant(variant, D, p, s);
}

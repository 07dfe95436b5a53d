// Bit-parallel LUT evaluation over packed test-vector lanes, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded through ctypes.
//
// Three kernels:
//
// * lut_eval6_kernel<V> replaces the Pallas kernel lut_eval6 (_kernel6) in
//   repro/kernels/lut_eval.py: inputs[M, 6, N], two table words
//   tt_lo[M] / tt_hi[M] -> out[M, N], out bit = table bit
//   (p0 + 2 p1 + 4 p2 + 8 p3 + 16 p4 + 32 p5), bits 0-31 in tt_lo and
//   32-63 in tt_hi.  LUTs narrower than 6 inputs carry their table
//   replicated in both words and constant-0 padded pins.
// * lut_eval6_level_kernel<V> is one whole level of the fused evaluator
//   (the reference's level body _fused_body in repro/core/eval_jax.py:
//   gather -> lut_eval6 -> .at[].set): it reads each LUT's six pin rows
//   straight from the value buffer vals[R, N] through ins_idx[M, 6] and
//   writes the result in place to row out_idx[M].
// * lut_eval_kernel<K> replaces the Pallas kernel lut_eval (_kernel):
//   inputs[M, K, N] with K <= 5, one table word tts[M] -> out[M, N].
//
// Lanes are 32-bit words; the host side keeps them as int32 bit patterns
// and the kernels work on them as uint32.
//
// Design of the two 6-input kernels.  The TPU's 256 x 128 BlockSpec tiling
// is not carried over.  The table words are constant along a row, so a
// CTA of 128 threads owns one row and a run of kIter x 128 x V lane words
// of it:
//   1. threads 0-63 expand the row's 64 table bits once into 64 masks
//      (0 or all-ones) in shared memory;
//   2. every thread then streams V = 4 consecutive lane words of each pin
//      per step with 128-bit loads and stores (V = 1, 32-bit, when N is not
//      a multiple of 4 or a base pointer is not 16-byte aligned), kIter
//      steps strided by the CTA so that a warp's accesses coalesce;
//   3. each word goes through a Shannon mux tree over pins 0..5: 32 leaves
//      mux(p0, m[2k + 1], m[2k]), then 16, 8, 4, 2 and 1 muxes on pins 1..5,
//      63 selects in all, each one three-input LOP3 (0xCA:
//      (s & a) | (~s & b)), issued by inline PTX so that the compiler cannot
//      split it.  The tree runs depth first, so a word holds at most six
//      partial results; the leaves read their mask pair from shared memory
//      (a broadcast 64-bit load shared by the V words).
// The index of the last step is clamped rather than guarded, so the loads
// of all steps can issue before the first tree; only the store is masked.
// Row offsets are 64-bit (grouped value buffers hold G (S + 1) N words).
//
// What bounds it.  Per output word lut_eval6 reads 6 input words and
// writes one (24 B in, 4 B out; the table words are read once per CTA):
// at N = 4096 and conv2d-fu's widest level (M = 2330) one call moves
// ~267 MB, ~80 us at the H100's 3.35 TB/s.  The mux tree's 63 LOP3s per
// word are ~36 us at the card's int32 logic rate (132 SMs x 64 lanes x
// 1.98 GHz), so the bytes bound it; the earlier design, a 32-minterm sum
// of products per table word (~260 logic ops per word), was bound by
// operations at ~2.3x the byte time.  The level kernel moves at most the
// same 28 B per output word: the unfused level also materialised the gathered
// [M, 6, N] pins (written once, read again) and scattered the output with a
// second copy, 84 B per word in three launches.
//
// The level kernel reads and writes vals in one launch.  That is sound
// because no LUT of a level reads the output of another LUT of the same
// level (the levelisation guarantees it), so the rows read and the rows
// written are disjoint; the two views of vals are declared __restrict__ on
// that ground.  Padded LUT rows (tables 0, pins on the CONST0 row) all
// write 0 to their member's sink row, concurrently: harmless, because
// every writer stores the same value and no real pin reads a sink row.
//
// In the level kernel a row whose table words are both 0 (the level's
// padding, nearly half the rows of the widest grouped level, or a
// constant-0 LUT) evaluates to 0 whatever its pins: its CTA stores zeros
// and skips the loads, the table expansion and the tree.  The test is
// uniform over the CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // lut_eval_kernel
constexpr int kThreads6 = 128;  // the 6-input kernels: one row per CTA
constexpr int kIter = 2;        // steps of V words per thread
constexpr int64_t kMaxGrid = 0x7fffffff;  // CTAs along the grid's x axis

// Sum over the 2^K minterms of one table word.  in[j] / inv[j] are pin j's
// lane and its complement; every minterm mask is built from the table bit
// as 0 or all-ones, matching the Pallas kernel's where(bit == 1, full, 0).
template <int K>
__device__ __forceinline__ uint32_t sum_of_minterms(uint32_t tt,
                                                    const uint32_t* in,
                                                    const uint32_t* inv) {
  uint32_t out = 0u;
#pragma unroll
  for (int m = 0; m < (1 << K); ++m) {
    uint32_t term = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < K; ++j) term &= ((m >> j) & 1) ? in[j] : inv[j];
    const uint32_t mask = 0u - ((tt >> m) & 1u);
    out |= mask & term;
  }
  return out;
}

// Bitwise s ? a : b, one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t s, uint32_t a, uint32_t b) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(d) : "r"(s), "r"(a), "r"(b));
  return d;
}

// The subtree of level L (pins 0..L) whose leaves cover table bits
// [2^(L+1) I, 2^(L+1) (I + 1)), for V words at once; mask2[k] holds the
// masks of table bits 2k and 2k + 1.
template <int L, int I, int V>
__device__ __forceinline__ void subtree(const uint2* mask2,
                                        const uint32_t (&p)[6][V],
                                        uint32_t (&r)[V]) {
  if constexpr (L == 0) {
    const uint2 m = mask2[I];
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = mux(p[0][v], m.y, m.x);
  } else {
    uint32_t lo[V], hi[V];
    subtree<L - 1, 2 * I, V>(mask2, p, lo);
    subtree<L - 1, 2 * I + 1, V>(mask2, p, hi);
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = mux(p[L][v], hi[v], lo[v]);
  }
}

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* src,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    w[0] = *src;
  }
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *dst = w[0];
  }
}

// Step 1: the row's 64 masks into shared memory (the caller syncs).
__device__ __forceinline__ void expand_table(uint32_t* masks, uint32_t lo,
                                             uint32_t hi) {
  const int b = threadIdx.x;
  if (b < 64) {
    const uint32_t t = b < 32 ? lo : hi;
    masks[b] = 0u - ((t >> (b & 31)) & 1u);
  }
}

// A zero-table row: zeros over the CTA's run of lane units.
template <int V>
__device__ __forceinline__ void zero_row(uint32_t* dst, int64_t n_units,
                                         int64_t unit0) {
  const uint32_t z[V] = {};
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int64_t u = unit0 + it * kThreads6 + threadIdx.x;
    if (u < n_units) store_words<V>(dst + u * V, z);
  }
}

// Steps 2-3 for one row: pin rows pin[0..5], output row dst, N words, the
// CTA's run of lane units starting at unit0 (a unit is V words).
template <int V>
__device__ __forceinline__ void lut6_row(const uint32_t* const (&pin)[6],
                                         uint32_t* dst, const uint2* mask2,
                                         int64_t n_units, int64_t unit0) {
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int64_t u = unit0 + it * kThreads6 + threadIdx.x;
    const int64_t uc = u < n_units ? u : n_units - 1;
    uint32_t p[6][V];
#pragma unroll
    for (int j = 0; j < 6; ++j) load_words<V>(pin[j] + uc * V, p[j]);
    uint32_t r[V];
    subtree<5, 0, V>(mask2, p, r);
    if (u < n_units) store_words<V>(dst + u * V, r);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads6)
lut_eval6_kernel(const uint32_t* __restrict__ inputs,
                 const uint32_t* __restrict__ tt_lo,
                 const uint32_t* __restrict__ tt_hi,
                 uint32_t* __restrict__ out, int64_t N, int64_t per_row) {
  __shared__ __align__(16) uint32_t masks[64];
  const int64_t r = blockIdx.x / per_row;
  const int64_t unit0 = (blockIdx.x - r * per_row) * (kIter * kThreads6);
  expand_table(masks, __ldg(tt_lo + r), __ldg(tt_hi + r));
  const uint32_t* row = inputs + r * 6 * N;
  const uint32_t* const pin[6] = {row, row + N, row + 2 * N, row + 3 * N,
                                  row + 4 * N, row + 5 * N};
  __syncthreads();
  lut6_row<V>(pin, out + r * N, reinterpret_cast<const uint2*>(masks),
              N / V, unit0);
}

// src and dst are the same buffer: see the note at the top for why the
// rows read and written are disjoint within a level.
template <int V>
__global__ void __launch_bounds__(kThreads6)
lut_eval6_level_kernel(const uint32_t* __restrict__ src,
                       uint32_t* __restrict__ dst,
                       const int64_t* __restrict__ ins_idx,
                       const uint32_t* __restrict__ tt_lo,
                       const uint32_t* __restrict__ tt_hi,
                       const int64_t* __restrict__ out_idx, int64_t N,
                       int64_t per_row) {
  __shared__ __align__(16) uint32_t masks[64];
  const int64_t r = blockIdx.x / per_row;
  const int64_t unit0 = (blockIdx.x - r * per_row) * (kIter * kThreads6);
  uint32_t* row_out = dst + __ldg(out_idx + r) * N;
  const uint32_t lo = __ldg(tt_lo + r), hi = __ldg(tt_hi + r);
  if ((lo | hi) == 0u) {
    zero_row<V>(row_out, N / V, unit0);
    return;
  }
  expand_table(masks, lo, hi);
  const int64_t* idx = ins_idx + r * 6;
  const uint32_t* const pin[6] = {
      src + __ldg(idx) * N,     src + __ldg(idx + 1) * N,
      src + __ldg(idx + 2) * N, src + __ldg(idx + 3) * N,
      src + __ldg(idx + 4) * N, src + __ldg(idx + 5) * N};
  __syncthreads();
  lut6_row<V>(pin, row_out, reinterpret_cast<const uint2*>(masks), N / V,
              unit0);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
lut_eval_kernel(const uint32_t* __restrict__ inputs,
                const uint32_t* __restrict__ tts,
                uint32_t* __restrict__ out, int64_t M, int64_t N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= M * N) return;
  const int64_t r = idx / N;
  const int64_t n = idx - r * N;
  const uint32_t tt = __ldg(tts + r);
  const uint32_t* row = inputs + r * K * N + n;
  uint32_t in[K], inv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    in[j] = __ldg(row + j * N);
    inv[j] = ~in[j];
  }
  out[idx] = sum_of_minterms<K>(tt, in, inv);
}

inline unsigned int n_blocks(int64_t M, int64_t N) {
  return static_cast<unsigned int>((M * N + kThreads - 1) / kThreads);
}

// CTAs per row of N words in units of V words.
inline int64_t ctas_per_row(int64_t N, int vec) {
  const int64_t per_cta = static_cast<int64_t>(kIter) * kThreads6;
  return (N / vec + per_cta - 1) / per_cta;
}

}  // namespace

// C entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success) so that a
// refused launch surfaces in the Python wrapper.  The caller guarantees
// contiguous tensors on one device, M * N > 0, indices inside vals, and
// for vec == 4 that N is a multiple of 4 and every base pointer of lane
// words is 16-byte aligned.  A grid of more than 2^31 - 1 CTAs is refused.

// Lane words each thread of a 6-input kernel evaluates (for a reading of
// instructions per word from the compiled code).
extern "C" int lut_eval6_words_per_thread(int vec) { return kIter * vec; }

extern "C" int lut_eval6_launch(const void* inputs, const void* tt_lo,
                                const void* tt_hi, void* out, int64_t M,
                                int64_t N, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t per_row = ctas_per_row(N, vec);
  if (M * per_row > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned int>(M * per_row);
  const auto* in = static_cast<const uint32_t*>(inputs);
  const auto* lo = static_cast<const uint32_t*>(tt_lo);
  const auto* hi = static_cast<const uint32_t*>(tt_hi);
  auto* o = static_cast<uint32_t*>(out);
  if (vec == 4) {
    lut_eval6_kernel<4><<<grid, kThreads6, 0, s>>>(in, lo, hi, o, N, per_row);
  } else if (vec == 1) {
    lut_eval6_kernel<1><<<grid, kThreads6, 0, s>>>(in, lo, hi, o, N, per_row);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lut_eval6_level_launch(void* vals, const void* ins_idx,
                                      const void* tt_lo, const void* tt_hi,
                                      const void* out_idx, int64_t M,
                                      int64_t N, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t per_row = ctas_per_row(N, vec);
  if (M * per_row > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned int>(M * per_row);
  auto* v = static_cast<uint32_t*>(vals);
  const auto* ins = static_cast<const int64_t*>(ins_idx);
  const auto* lo = static_cast<const uint32_t*>(tt_lo);
  const auto* hi = static_cast<const uint32_t*>(tt_hi);
  const auto* oi = static_cast<const int64_t*>(out_idx);
  if (vec == 4) {
    lut_eval6_level_kernel<4><<<grid, kThreads6, 0, s>>>(v, v, ins, lo, hi,
                                                         oi, N, per_row);
  } else if (vec == 1) {
    lut_eval6_level_kernel<1><<<grid, kThreads6, 0, s>>>(v, v, ins, lo, hi,
                                                         oi, N, per_row);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lut_eval_launch(const void* inputs, const void* tts,
                               void* out, int64_t M, int64_t K, int64_t N,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(inputs);
  const auto* tt = static_cast<const uint32_t*>(tts);
  auto* o = static_cast<uint32_t*>(out);
  const unsigned int blocks = n_blocks(M, N);
  switch (K) {
    case 1: lut_eval_kernel<1><<<blocks, kThreads, 0, s>>>(in, tt, o, M, N); break;
    case 2: lut_eval_kernel<2><<<blocks, kThreads, 0, s>>>(in, tt, o, M, N); break;
    case 3: lut_eval_kernel<3><<<blocks, kThreads, 0, s>>>(in, tt, o, M, N); break;
    case 4: lut_eval_kernel<4><<<blocks, kThreads, 0, s>>>(in, tt, o, M, N); break;
    case 5: lut_eval_kernel<5><<<blocks, kThreads, 0, s>>>(in, tt, o, M, N); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bit-parallel LUT evaluation over packed test-vector lanes, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded through ctypes.
//
// Two kernels:
//
// * lut_eval6_kernel replaces the Pallas kernel lut_eval6 (_kernel6) in
//   repro/kernels/lut_eval.py: inputs[M, 6, N], two table words
//   tt_lo[M] / tt_hi[M] -> out[M, N].  A 32-minterm sum of products over
//   pins 0-4 for each table word, then a Shannon select on pin 5:
//   out = (sel & hi) | (~sel & lo).  LUTs narrower than 6 inputs carry
//   their table replicated in both words (tt_lo == tt_hi) and constant-0
//   padded pins, so the select is a no-op for them.
// * lut_eval_kernel<K> replaces the Pallas kernel lut_eval (_kernel):
//   inputs[M, K, N] with K <= 5, one table word tts[M] -> out[M, N].
//
// Lanes are 32-bit words; the host side keeps them as int32 bit patterns
// and the kernels work on them as uint32.
//
// Design.  The TPU's 256 x 128 BlockSpec tiling is not carried over.  One
// thread computes one output word (row r, lane word n); the flat index
// runs along n, so neighbouring threads load neighbouring words of each
// pin row and the loads and the store coalesce.  Each thread loads its
// row's table words once, inverts its input lanes once, and masks the
// ragged edge of M * N itself (no padding is required of the caller).
//
// What bounds it.  Per output word lut_eval6 reads 6 input words and two
// table words shared by the whole row, and writes one word: 24 B in and
// 4 B out, so at N = 4096 and conv2d-fu's widest level (M = 2330) one
// call moves ~267 MB, ~80 us at the H100's 3.35 TB/s.  The sum of
// products as written costs ~260 two-input logic ops per word (32 minterm
// products over 5 literals plus 2 x 32 mask-and-or steps and the select);
// at the card's int32 rate that is about twice the byte time, so this
// formulation is bounded by operations.  The function itself needs far
// fewer: a Shannon mux tree evaluates a 6-LUT in 63 three-input LOP3s per
// word, under which the bytes bound again.  That tree, or fusing the gather
// from the value buffer into the kernel, is a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
lut_eval6_kernel(const uint32_t* __restrict__ inputs,
                 const uint32_t* __restrict__ tt_lo,
                 const uint32_t* __restrict__ tt_hi,
                 uint32_t* __restrict__ out, int64_t M, int64_t N) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= M * N) return;
  const int64_t r = idx / N;
  const int64_t n = idx - r * N;
  const uint32_t lo_t = __ldg(tt_lo + r);
  const uint32_t hi_t = __ldg(tt_hi + r);
  const uint32_t* row = inputs + r * 6 * N + n;
  uint32_t in[5], inv[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    in[j] = __ldg(row + j * N);
    inv[j] = ~in[j];
  }
  const uint32_t sel = __ldg(row + 5 * N);
  const uint32_t lo = sum_of_minterms<5>(lo_t, in, inv);
  const uint32_t hi = sum_of_minterms<5>(hi_t, in, inv);
  out[idx] = (sel & hi) | (~sel & lo);
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

}  // namespace

// C entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success) so that a
// refused launch surfaces in the Python wrapper.  The caller guarantees
// contiguous int32 tensors on one device and M * N > 0.
extern "C" int lut_eval6_launch(const void* inputs, const void* tt_lo,
                                const void* tt_hi, void* out, int64_t M,
                                int64_t N, void* stream) {
  lut_eval6_kernel<<<n_blocks(M, N), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(inputs),
      static_cast<const uint32_t*>(tt_lo),
      static_cast<const uint32_t*>(tt_hi), static_cast<uint32_t*>(out), M,
      N);
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

// Binary matrix product through AND / XOR and population counts, for
// Hopper (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface and loaded through ctypes.
//
// Replaces the Pallas kernel popcount_matmul (_kernel_and, _kernel_xnor)
// in repro/kernels/popcount_matmul.py: x[M, W] and w[N, W] hold K bits
// packed into W 32-bit words (they cross as int32 bit patterns and are
// read as uint32_t here) ->
//   mode "and":  y[m, n] = sum_k popc(x[m, k] & w[n, k])
//   mode "xnor": y[m, n] = k_bits - 2 sum_k popc(x[m, k] ^ w[n, k])
// as int32.  Integer arithmetic: bit-exact against the plain version.
//
// Design.  The TPU's SWAR popcount over a (128, 128) block and the
// fori_loop over words become the hardware __popc over a register tile.
// CTA tile 64 x 64 outputs, 256 threads as 16 x 16, a 4 x 4 micro-tile
// per thread (rows ty * 4 + i, columns tx + 16 j so that a half-warp
// writes 16 consecutive outputs).  Words are staged in shared memory in
// steps of kBW = 32, x transposed (padded) and w transposed, so each word
// step is 8 shared loads for 16 popcounts.  Ragged M, N and W are masked
// in the kernel.
//
// What bounds it.  The CUDA C++ Programming Guide's table of arithmetic
// instruction throughput gives 16 population counts per clock per SM for
// compute capability 9.0, so an H100 SXM (132 SMs, 1.98 GHz boost) counts
// 4.18e12 words a second.  At the main shape (a binarised kratos-dd FFN
// wi: x[4096, 24] x w[4096, 24], 768 bits) the 403 M counts take 96 us
// against 68 MB of x, w and y (20 us): the counts bound it.  Each count
// also costs a LOP3 and an IADD on the integer pipes, which run at 64
// per clock and are not the limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, a 4 x 4 micro-tile each
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBW = 32;        // words per staged step
constexpr int kMicro = 4;

template <bool kXnor>
__global__ void __launch_bounds__(kThreads)
popcount_matmul_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ w,
                       int32_t* __restrict__ y, int64_t M, int64_t N,
                       int64_t W, int k_bits) {
  __shared__ uint32_t Xs[kBW][kBM + 1];  // x tile, transposed: Xs[k][m]
  __shared__ uint32_t Ws[kBW][kBN + 1];  // w tile, transposed: Ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  int acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < W; k0 += kBW) {
    // padding words are 0: popc(0 & .) = popc(0 ^ 0) = 0
    for (int i = tid; i < kBM * kBW; i += kThreads) {
      const int r = i / kBW;
      const int c = i - r * kBW;
      const int64_t gk = k0 + c;
      const int64_t gm = m0 + r;
      const int64_t gn = n0 + r;
      Xs[c][r] = (gm < M && gk < W) ? x[gm * W + gk] : 0u;
      Ws[c][r] = (gn < N && gk < W) ? w[gn * W + gk] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBW; ++kk) {
      uint32_t a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = Xs[kk][ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] += __popc(kXnor ? (a[i] ^ b[j]) : (a[i] & b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int64_t gm = m0 + ty * kMicro + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int64_t gn = n0 + tx + 16 * j;
      if (gn < N) y[gm * N + gn] = kXnor ? k_bits - 2 * acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace

// C entry point.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success) so that a refused launch
// surfaces in the Python wrapper.  mode: 0 = and, 1 = xnor.  The caller
// guarantees contiguous int32 tensors on one device, M, N, W >= 1 and the
// grid limits.
extern "C" int popcount_matmul_launch(const void* x, const void* w, void* y,
                                      int64_t M, int64_t N, int64_t W,
                                      int mode, int k_bits, void* stream) {
  const dim3 grid(static_cast<unsigned int>((N + kBN - 1) / kBN),
                  static_cast<unsigned int>((M + kBM - 1) / kBM));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  auto* yp = static_cast<int32_t*>(y);
  if (mode == 1)
    popcount_matmul_kernel<true><<<grid, kThreads, 0, s>>>(xp, wp, yp, M, N, W, k_bits);
  else
    popcount_matmul_kernel<false><<<grid, kThreads, 0, s>>>(xp, wp, yp, M, N, W, k_bits);
  return static_cast<int>(cudaGetLastError());
}

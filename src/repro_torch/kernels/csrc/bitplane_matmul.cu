// Constant-weight matrix product through weight bit-planes, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded through ctypes.
//
// Replaces the Pallas kernel bitplane_matmul (_kernel) in
// repro/kernels/bitplane_matmul.py:
//   y[M, N] = (x[M, K] @ W[K, N]) * scale[N],  W = sum_b c_b * planes[b],
// with planes[B, K, N] float32 in {0, 1}, c_b = 2^b and the top plane
// c_(B-1) = -2^(B-1) (two's complement; B = 1 gives the single plane -1).
//
// Design.  The algebra is that of the plain version: each CTA builds the
// tile of W in shared memory from the B planes, in plane order, which is
// exact in float32 (integers below 2^B), then runs an FFMA tiled product
// with float32 accumulators (no TF32) and scales the result in the
// epilogue.  The TPU's 128^3 blocks and the per-plane MXU products are not
// carried over: one plane product per plane would cost B times the FLOPs
// for the same result.  CTA tile 64 x 64 over K steps of 16, 256 threads,
// a 4 x 4 micro-tile per thread; x is staged transposed (padded) and W
// row-major.  The K, M and N tails are masked in the kernel: the
// reference's zero padding of K is a Pallas block artefact.
//
// What bounds it.  At the main path's large shape ([4096, 768] x
// [6, 768, 4096]) the product needs 25.8 GFLOP against 101 MB of planes,
// x and y: the float32 operations bound it (0.39 ms at the card's 67
// TFLOP/s CUDA-core peak).  At the decode shape ([8, 768]) the 75.5 MB of
// planes bound it (22.5 us at 3.35 TB/s); this kernel then launches only
// 64 CTAs with no load pipelining.  Packing planes into bits, and
// tensor-core mma with ieee float32 semantics, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, a 4 x 4 micro-tile each
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kMicro = 4;

__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ planes,
                       const float* __restrict__ scale,
                       float* __restrict__ y, int64_t M, int64_t K,
                       int64_t N, int n_planes) {
  __shared__ float As[kBK][kBM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Ws[kBK][kBN];      // W tile: Ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const float top = -ldexpf(1.f, n_planes - 1);

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      const int64_t gm = m0 + r;
      const int64_t gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i - r * kBN;
      const int64_t gk = k0 + r;
      const int64_t gn = n0 + c;
      float w = 0.f;
      if (gk < K && gn < N) {
        const float* pl = planes + gk * N + gn;
        for (int b = 0; b < n_planes; ++b) {
          const float cb = b == n_planes - 1 ? top : ldexpf(1.f, b);
          w += cb * pl[b * K * N];  // exact: cb * {0, 1} and |W| < 2^B
        }
      }
      Ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kMicro], w[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = As[kk][ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
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
      if (gn < N) y[gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// C entry point.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success) so that a refused launch
// surfaces in the Python wrapper.  The caller guarantees contiguous
// float32 tensors on one device, M, K, N >= 1, 1 <= B, and the grid
// limits.
extern "C" int bitplane_matmul_launch(const void* x, const void* planes,
                                      const void* scale, void* y, int64_t M,
                                      int64_t K, int64_t N, int64_t B,
                                      void* stream) {
  const dim3 grid(static_cast<unsigned int>((N + kBN - 1) / kBN),
                  static_cast<unsigned int>((M + kBM - 1) / kBM));
  bitplane_matmul_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(planes),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N,
      static_cast<int>(B));
  return static_cast<int>(cudaGetLastError());
}

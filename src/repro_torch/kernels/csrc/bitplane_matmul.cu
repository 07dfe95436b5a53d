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
// What bounds it.  At the quantized flow's large shape ([4096, 768] x
// [6, 768, 4096]) the product needs 25.8 GFLOP against 101 MB of planes,
// x and y: operations bound it.  At the decode shape ([8, 768]) the 75.5
// MB of planes bound it (22.6 us at 3.35 TB/s).
//
// Design: three variants, chosen by the launcher from B and M.
//
// * tensor cores (B <= 8, M > 16).  For B <= 8, W is an integer in
//   [-128, 127], which bfloat16 holds exactly, and x splits exactly into
//   three bfloat16 parts, x = hi + mid + lo (3 x 8 significant bits for a
//   normal float).  So x @ W = hi @ W + mid @ W + lo @ W with every
//   partial product exact in float32; only the order of the sums differs
//   from the plain version.  The tensor cores run bf16 at twice the TF32
//   rate, so three bf16 passes cost one and a half TF32 passes, less than
//   the two of a hi + lo TF32 split, which is not exact either (11 + 13
//   bits of a 24-bit significand).  A first pass folds the
//   planes once per call into a bf16 W (75.5 MB read, 6.3 MB written),
//   padded to whole tiles, and another splits x into its three parts,
//   padded likewise; the product then streams x's parts and W through
//   shared memory with a 3-stage cp.async ring, 128 x 256 CTA tiles (the
//   wide side on W: x's parts are the heavier operand), 8 warps of 64 x
//   64, mma.sync m16n8k16 with float32 accumulators.  Each
//   16-deep k step sums its three passes in fresh registers (lo, mid,
//   then hi) and adds them to the running sum with one float32 add, so
//   the tensor cores never accumulate over the whole of K: their internal
//   sums round toward zero, and over 3 x K / 16 accumulating products
//   that would drift by tens of ulps.
// * streaming small M (B <= 8, M <= 16, the decode shape).  Bound by the
//   planes' bytes: a grid of (N slice of 64 threads x 4 columns) x (K
//   slice) CTAs, at least 4 per SM, reads each plane element once with
//   16-byte loads, forms W in registers in plane order and multiplies it
//   by x rows staged in shared memory.  Each K slice writes float32
//   partial sums; a second launch adds them in slice order and applies
//   the scale, so every run gives the same bits (no atomics).
// * FFMA (B > 8, where W may not fit in bfloat16): each CTA builds the
//   tile of W in shared memory from the planes, in plane order, and runs
//   a 64 x 64 FFMA tiled product with float32 accumulators.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// FFMA variant (B > 8)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// tensor-core variant (B <= 8, M > 16)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kTcBM = 128;
constexpr int kTcBN = 256;
constexpr int kTcBK = 32;
constexpr int kTcStages = 3;
constexpr int kAS = kTcBK + 8;  // smem row strides (bf16): the 16-byte pad
constexpr int kWS = kTcBN + 8;  // keeps ldmatrix free of bank conflicts
constexpr int kAStage = 3 * kTcBM * kAS;  // hi, mid, lo tiles
constexpr int kWStage = kTcBK * kWS;
constexpr size_t kTcSmem =
    static_cast<size_t>(kTcStages) * (kAStage + kWStage) * sizeof(bf16);

// planes[B, K, N] -> W[Kp, Np] bf16, zero outside [K, N]; VEC columns per
// thread (4: 16-byte plane loads, for N % 4 == 0; else 1)
template <int VEC>
__global__ void fold_planes_kernel(const float* __restrict__ planes,
                                   bf16* __restrict__ w, int64_t K,
                                   int64_t N, int64_t Kp, int64_t Np,
                                   int n_planes) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (i >= Kp * Np) return;
  const int64_t k = i / Np;
  const int64_t n = i - k * Np;  // Np % VEC == 0: one row per thread
  float v[VEC] = {};
  if (k < K && n < N) {
    const float* pl = planes + k * N + n;
    for (int b = 0; b < n_planes; ++b) {
      const float cb =
          b == n_planes - 1 ? -ldexpf(1.f, b) : ldexpf(1.f, b);
      if constexpr (VEC == 4) {  // n + 3 < N: N % 4 == 0
        const float4 q = __ldg(reinterpret_cast<const float4*>(pl + b * K * N));
        v[0] += cb * q.x;  // plane order, exact: |W| <= 128
        v[1] += cb * q.y;
        v[2] += cb * q.z;
        v[3] += cb * q.w;
      } else {
        v[0] += cb * pl[b * K * N];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    w[i + j] = __float2bfloat16_rn(v[j]);  // exact: an integer in [-128, 127]
}

// x[M, K] -> x3[3, Mp, Kp] bf16 (hi, mid, lo), zero outside [M, K].
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): each
// difference is exact in float32, and for a normal float the three parts
// hold its 24 significant bits, so hi + mid + lo == x.
__global__ void split_x_kernel(const float* __restrict__ x,
                               bf16* __restrict__ x3, int64_t M, int64_t K,
                               int64_t Mp, int64_t Kp) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= Mp * Kp) return;
  const int64_t m = i / Kp;
  const int64_t k = i - m * Kp;
  const float v = (m < M && k < K) ? x[m * K + k] : 0.f;
  const bf16 hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  const bf16 mid = __float2bfloat16_rn(r);
  const bf16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
  const int64_t plane = Mp * Kp;
  x3[i] = hi;
  x3[plane + i] = mid;
  x3[2 * plane + i] = lo;
}

__global__ void __launch_bounds__(kTcThreads, 1)
bitplane_tc_kernel(const bf16* __restrict__ x3, const bf16* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int64_t M, int64_t N, int64_t Mp, int64_t Kp,
                   int64_t Np) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + kTcStages * kAStage;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // rows wm * 64 of the CTA tile
  const int wn = warp & 3;   // columns wn * 64
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kTcBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTcBN;
  const int64_t plane = Mp * Kp;
  const int n_kt = static_cast<int>(Kp / kTcBK);

  // The operands are padded to whole tiles, so no load is masked.
  auto load_stage = [&](int kt, int st) {
    const int64_t k0 = static_cast<int64_t>(kt) * kTcBK;
    bf16* a = As + st * kAStage;
    bf16* b = Ws + st * kWStage;
    for (int c = tid; c < 3 * kTcBM * (kTcBK / 8); c += kTcThreads) {
      const int r = c >> 2;  // row of the stacked [3 x 128] tile
      const int ch = c & 3;
      const int p = r / kTcBM;
      const int64_t gm = m0 + (r - p * kTcBM);
      sm90::cp_async16(a + r * kAS + ch * 8,
                       x3 + p * plane + gm * Kp + k0 + ch * 8, true);
    }
    for (int c = tid; c < kTcBK * (kTcBN / 8); c += kTcThreads) {
      const int r = c / (kTcBN / 8);
      const int ch = c - r * (kTcBN / 8);
      sm90::cp_async16(b + r * kWS + ch * 8,
                       w + (k0 + r) * Np + n0 + ch * 8, true);
    }
  };

  float acc[4][8][4];  // 4 x 8 m16n8 tiles: the warp's 64 x 64
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    sm90::cp_async_wait<kTcStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; stage kt - 1 is free
    const int nk = kt + kTcStages - 1;
    if (nk < n_kt) load_stage(nk, nk % kTcStages);
    sm90::cp_async_commit();
    const bf16* a = As + (kt % kTcStages) * kAStage;
    const bf16* b = Ws + (kt % kTcStages) * kWStage;
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t bf[8][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        sm90::ldsm_x4_trans(r, b + (ks * 16 + (lane & 15)) * kWS + wn * 64 +
                                   nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // this 16-deep step of rows mi: lo, mid, hi in fresh registers
        float part[8][4];
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          uint32_t af[4];
          sm90::ldsm_x4(af, a + (p * kTcBM + wm * 64 + mi * 16 + (lane & 15)) *
                                    kAS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            if (p == 2)
              sm90::mma_bf16(part[ni], af, bf[ni][0], bf[ni][1], zero);
            else
              sm90::mma_bf16(part[ni], af, bf[ni][0], bf[ni][1], part[ni]);
          }
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[ni][e];
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int64_t gc = n0 + wn * 64 + ni * 8 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t gm = m0 + wm * 64 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int64_t gn = gc + (e & 1);
        if (gm < M && gn < N) y[gm * N + gn] = acc[mi][ni][e] * scale[gn];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// streaming small-M variant (B <= 8, M <= 16)
// ---------------------------------------------------------------------------

constexpr int kSmThreads = 64;
constexpr int kSmMaxM = 16;

// part[split, M, N] = x[:, slice] @ W[slice, n-columns]; VEC columns per
// thread (4: one 16-byte load per plane and k; 1 for a ragged N).
template <int VEC, int NB>
__global__ void __launch_bounds__(kSmThreads)
bitplane_small_m_kernel(const float* __restrict__ x,
                        const float* __restrict__ planes,
                        float* __restrict__ part, int64_t M, int64_t K,
                        int64_t N, int64_t kps) {
  extern __shared__ float xs[];  // [M][kps]
  const int64_t k_lo = static_cast<int64_t>(blockIdx.y) * kps;
  const int64_t k_hi = k_lo + kps < K ? k_lo + kps : K;
  const int klen = static_cast<int>(k_hi - k_lo);
  for (int i = threadIdx.x; i < M * klen; i += kSmThreads) {
    const int m = i / klen;
    const int kk = i - m * klen;
    xs[m * kps + kk] = x[m * K + k_lo + kk];
  }
  __syncthreads();
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * kSmThreads + threadIdx.x) * VEC;
  if (n >= N) return;

  float acc[kSmMaxM][VEC];
#pragma unroll
  for (int m = 0; m < kSmMaxM; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;
  const int64_t KN = K * N;
  // the plane loads of U rows of k are issued before any is used, so each
  // thread keeps U x NB loads in flight
  constexpr int U = VEC == 4 ? (NB <= 6 ? 4 : 3) : 8;
  for (int k0 = 0; k0 < klen; k0 += U) {
    float pv[U][NB][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < klen) {
        const float* pk = planes + (k_lo + k0 + u) * N + n;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if constexpr (VEC == 4) {
            const float4 q =
                __ldg(reinterpret_cast<const float4*>(pk + b * KN));
            pv[u][b][0] = q.x;
            pv[u][b][1] = q.y;
            pv[u][b][2] = q.z;
            pv[u][b][3] = q.w;
          } else {
            pv[u][b][0] = __ldg(pk + b * KN);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < klen) {
        float w[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          w[v] = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float cb = b == NB - 1 ? -static_cast<float>(1 << b)
                                         : static_cast<float>(1 << b);
            w[v] += cb * pv[u][b][v];  // plane order, exact
          }
        }
#pragma unroll
        for (int m = 0; m < kSmMaxM; ++m) {
          if (m < M) {
            const float xv = xs[m * kps + k0 + u];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[m][v] = fmaf(xv, w[v], acc[m][v]);
          }
        }
      }
    }
  }
  float* out = part + static_cast<int64_t>(blockIdx.y) * M * N + n;
#pragma unroll
  for (int m = 0; m < kSmMaxM; ++m) {
    if (m < M) {
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(out + m * N) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      } else {
        out[m * N] = acc[m][0];
      }
    }
  }
}

// y[M, N] = (sum over slices of part, in slice order) * scale
__global__ void bitplane_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ scale,
                                       float* __restrict__ y, int64_t MN,
                                       int64_t N, int n_splits) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < n_splits; ++j) s += part[j * MN + i];
  y[i] = s * scale[i % N];
}

template <int VEC, int NB>
int launch_small_m(const float* x, const float* planes, float* part,
                   int64_t M, int64_t K, int64_t N, int64_t kps,
                   int64_t n_splits, cudaStream_t stream) {
  const int64_t cols = kSmThreads * VEC;
  const dim3 grid(static_cast<unsigned int>((N + cols - 1) / cols),
                  static_cast<unsigned int>(n_splits));
  const size_t smem = static_cast<size_t>(M) * kps * sizeof(float);
  bitplane_small_m_kernel<VEC, NB><<<grid, kSmThreads, smem, stream>>>(
      x, planes, part, M, K, N, kps);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_small_m_planes(int64_t B, const float* x, const float* planes,
                          float* part, int64_t M, int64_t K, int64_t N,
                          int64_t kps, int64_t n_splits,
                          cudaStream_t stream) {
  switch (B) {
    case 1: return launch_small_m<VEC, 1>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 2: return launch_small_m<VEC, 2>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 3: return launch_small_m<VEC, 3>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 4: return launch_small_m<VEC, 4>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 5: return launch_small_m<VEC, 5>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 6: return launch_small_m<VEC, 6>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 7: return launch_small_m<VEC, 7>(x, planes, part, M, K, N, kps, n_splits, stream);
    case 8: return launch_small_m<VEC, 8>(x, planes, part, M, K, N, kps, n_splits, stream);
    default: return -1;
  }
}

}  // namespace

// C entry points.  Each launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success, -1 for an
// argument no kernel is instantiated for) so that a refused launch
// surfaces in the Python wrapper.  The caller guarantees contiguous
// float32 x[M, K], planes[B, K, N], scale[N] and y[M, N] on one device,
// M, K, N >= 1, and the grid limits.

// FFMA variant, any B >= 1.
extern "C" int bitplane_ffma_launch(const void* x, const void* planes,
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

// Tensor-core variant, B <= 8.  Scratch from the caller: x3 bf16
// [3, Mp, Kp] and w bf16 [Kp, Np], with Mp a multiple of 128, Np of 256
// and Kp of 32, at least M, N and K.
extern "C" int bitplane_tc_launch(const void* x, const void* planes,
                                  const void* scale, void* y, void* x3,
                                  void* w, int64_t M, int64_t K, int64_t N,
                                  int64_t B, int64_t Mp, int64_t Kp,
                                  int64_t Np, void* stream) {
  if (B < 1 || B > 8 || Mp % kTcBM || Np % kTcBN || Kp % kTcBK) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  constexpr int kEw = 256;
  const auto* pf = static_cast<const float*>(planes);
  auto* wb = static_cast<bf16*>(w);
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0)
    fold_planes_kernel<4>
        <<<static_cast<unsigned int>((Kp * Np / 4 + kEw - 1) / kEw), kEw, 0,
           st>>>(pf, wb, K, N, Kp, Np, static_cast<int>(B));
  else
    fold_planes_kernel<1>
        <<<static_cast<unsigned int>((Kp * Np + kEw - 1) / kEw), kEw, 0,
           st>>>(pf, wb, K, N, Kp, Np, static_cast<int>(B));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_x_kernel<<<static_cast<unsigned int>((Mp * Kp + kEw - 1) / kEw), kEw,
                   0, st>>>(static_cast<const float*>(x),
                            static_cast<bf16*>(x3), M, K, Mp, Kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bitplane_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(Np / kTcBN),
                  static_cast<unsigned int>(Mp / kTcBM));
  bitplane_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
      static_cast<const bf16*>(x3), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, N, Mp, Kp,
      Np);
  return static_cast<int>(cudaGetLastError());
}

// Streaming small-M variant, B <= 8, M <= 16.  part: float32 scratch
// [n_splits, M, N]; K slices of kps rows (n_splits = ceil(K / kps),
// M * kps * 4 bytes of shared memory, at most 48 KB); vec 4 needs N % 4 ==
// 0 and 16-byte aligned planes, else 1.
extern "C" int bitplane_small_m_launch(const void* x, const void* planes,
                                       const void* scale, void* y,
                                       void* part, int64_t M, int64_t K,
                                       int64_t N, int64_t B, int64_t kps,
                                       int64_t n_splits, int vec,
                                       void* stream) {
  if (M < 1 || M > kSmMaxM) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(planes);
  auto* partf = static_cast<float*>(part);
  int err = vec == 4
      ? launch_small_m_planes<4>(B, xf, pf, partf, M, K, N, kps, n_splits, st)
      : vec == 1
      ? launch_small_m_planes<1>(B, xf, pf, partf, M, K, N, kps, n_splits, st)
      : -1;
  if (err != 0) return err;
  constexpr int kEw = 256;
  bitplane_reduce_kernel<<<static_cast<unsigned int>((M * N + kEw - 1) / kEw),
                           kEw, 0, st>>>(partf,
                                         static_cast<const float*>(scale),
                                         static_cast<float*>(y), M * N, N,
                                         static_cast<int>(n_splits));
  return static_cast<int>(cudaGetLastError());
}

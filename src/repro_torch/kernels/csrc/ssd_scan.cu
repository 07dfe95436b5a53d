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
// in the reference's order of operations, float32 throughout, expf (not
// the fast intrinsic).  exp(cum[t] - cum[u]) is evaluated only for t >= u,
// where the exponent is <= 0: the reference's jnp.where hides an inf in
// the unselected branch, which this loop never forms.
//
// Design.  The TPU grid is (batch, head) with the chunks sequential; that
// is too few CTAs for 132 SMs (160 for mamba2 at Bb = 2, 50 for hymba).
// The P rows of the state evolve independently (y[., p] reads only row p
// of h and column p of x), so a CTA owns one (batch, head) and a block of
// kPB = 32 of the P columns, and walks the chunks in order with its rows
// of h in shared memory.  The price of the split is that every P block
// recomputes the chunk's C . B^T score tile.  Per chunk, 256 threads:
//   1. dt of the chunk, cum by a warp-shuffle scan, and the hand-off
//      weights exp(cum[Q-1] - cum[u]) dt[u];
//   2. x[chunk, P block] into shared memory (float32);
//   3. over N in blocks of kNB = 32: C and B of the block staged
//      transposed; each thread accumulates an 8 x 8 micro-tile of the
//      128 x 128 score tile in registers and its 16 (t, p) partial sums of
//      C . h^T; then the block's columns of h take their hand-off (after a
//      barrier, so every thread has read the old state first);
//   4. the causal weight tile W[t, u] = exp(cum[t] - cum[u]) s dt[u] into
//      shared memory (zero above the diagonal);
//   5. y = (C . h^T) exp(cum) + W x, written in x's type.
// Shared memory: the staged C / B blocks (33 KB), W (66 KB), x (16 KB),
// h (32 (N + 1) floats) and the chunk's scalars: 134 KB at N = 128, so it
// is requested as dynamic shared memory.  Inputs are read through their
// element strides, so x, B and C are read in place (B and C are column
// slices of the model's input projection).  Chunks shorter than 128 (L <
// 128) are zero-padded in shared memory.
//
// What bounds it.  The Pallas algorithm needs Bb H (L / Q) (2 Q^2 N +
// 2 Q^2 P + 4 Q P N) FLOPs: at mamba2's layer shape ([2, 4096, 80, 64],
// N = 128, bf16) 54 GFLOP, 54 us at the bf16 tensor-core peak, against
// 172 MB of x, dt, B, C and y (51 us).  This kernel does FFMA on the CUDA
// cores (float32 inputs keep the reference's precision; bf16 inputs are
// upcast), recomputes the score tile once per P block, and reads most
// operands from shared memory, so it runs far below that bound.  Tensor
// cores with one shared C . B^T per (batch, chunk) are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

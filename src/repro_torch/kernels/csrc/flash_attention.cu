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
// sum l and accumulator -> acc / max(l, 1e-30) -> cast.  Keys past T (the
// ragged last tile) are -inf, so they add nothing, as in the reference
// where they do not exist.  expf / tanhf, not the fast intrinsics.
//
// Design.  The TPU's 128 x 128 blocks with a VMEM accumulator carried
// across a sequential kv grid axis are not carried over.  One CTA of 256
// threads owns a tile of 64 query rows of one (batch, head) and walks the
// key/value tiles itself, in order, with the running statistics in
// registers.  Threads form 16 row groups x 16 column lanes: each thread
// holds 4 query rows; for a BK-key tile it computes 4 x BK/16 scores and
// keeps 4 x D/16 output accumulators.  Row max and row sum are reduced
// over the 16 lanes of a half-warp with shuffles.  Q is staged once,
// transposed, in shared memory; each K tile is staged transposed and each
// V tile row-major (padded strides keep the accesses free of bank
// conflicts), converted to float32 on the way in.  The products are FFMA
// on the CUDA cores in float32, so float32 inputs keep the reference's
// precision and bfloat16 inputs are computed exactly as the reference
// computes them (upcast, float32 math, one rounding at the end).
// Tiles wholly outside the causal / window band of the CTA's rows are
// skipped: every row keeps its own key (causal) or the last key, so its
// running max is a real logit before any skipped tile would have been
// added, and exp(-1e30 - m) is exactly 0.  Query tiles are launched
// heaviest (latest) first.  Inputs are read through explicit strides
// (last dimension contiguous), so a KV cache sliced along time is read in
// place.
//
// What bounds it.  At the main path's prefill shape (kratos-dd,
// [8, 12, 512, 64] bf16, causal) the visible (q, k) pairs need ~3.3 GFLOP
// against 6.3 MB of q, k, v and o: far above the card's ridge, so the
// operations bound it: against the bf16 tensor-core peak the bound is
// ~3 us.  This kernel does FFMA at the float32 CUDA-core rate, and one
// shared-memory load feeds two FMAs in the inner loops, so it runs well
// below even that rate.  Tensor cores (mma / wgmma on bf16 tiles), TMA
// and a split-K decode are later work.  Decode (S = 1) launches only
// B * Hq CTAs with one live row each.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kRows = 4;       // query rows per thread
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
  int64_t window;
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

template <int D, int BK>
constexpr size_t smem_floats() {
  return static_cast<size_t>(D) * (kBQ + 1)    // Qt [D][kBQ + 1]
         + static_cast<size_t>(D) * (BK + 1)   // Kt [D][BK + 1]
         + static_cast<size_t>(BK) * D         // Vs [BK][D]
         + static_cast<size_t>(kBQ) * (BK + 1);  // Ps [kBQ][BK + 1]
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int kCols = BK / 16;  // score columns per thread
  constexpr int kOut = D / 16;    // output columns per thread
  constexpr int QS = kBQ + 1;
  constexpr int KS = BK + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + D * QS;
  float* Vs = Kt + D * KS;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / p.Hq;
  const int64_t h = bh - b * p.Hq;
  const int64_t hk = h / (p.Hq / p.Hkv);
  const int64_t n_qt = (p.S + kBQ - 1) / kBQ;
  const int64_t q0 = (n_qt - 1 - static_cast<int64_t>(blockIdx.y)) * kBQ;
  const int64_t t_off = p.T - p.S;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int64_t s = q0 + r;
    Qt[d * QS + r] = s < p.S ? to_f32(qb[s * p.q_ss + d]) : 0.f;
  }

  // keys any live row of this tile can see
  const int64_t q_last = (q0 + kBQ < p.S ? q0 + kBQ : p.S) - 1;
  int64_t k_begin = 0;
  int64_t k_end = p.T;
  if (p.causal && q_last + t_off + 1 < k_end) k_end = q_last + t_off + 1;
  if (p.has_window) {
    const int64_t first = q0 + t_off - p.window + 1;
    if (first > k_begin) k_begin = first;
  }
  k_begin = (k_begin / BK) * BK;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      const int64_t t = k0 + c;
      const bool live = t < p.T;
      Kt[d * KS + c] = live ? to_f32(kb[t * p.k_ss + d]) : 0.f;
      Vs[c * D + d] = live ? to_f32(vb[t * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qt[d * QS + ty * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qpos = q0 + ty * kRows + i + t_off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool vis = true;
        if (p.causal) vis = vis && kpos <= qpos;
        if (p.has_window) vis = vis && kpos > qpos - p.window;
        x = vis ? x : kMasked;
        if (kpos >= p.T) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pv = expf(s[i][j] - m_new);
        Ps[(ty * kRows + i) * PS + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * PS + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t srow = q0 + ty * kRows + i;
    if (srow < p.S) {
      const float den = fmaxf(l[i], 1e-30f);
      T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + srow * p.o_ss;
#pragma unroll
      for (int j = 0; j < kOut; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int D, int BK>
int launch_typed(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<D, BK>() * sizeof(float);
  auto* kern = flash_fwd_kernel<T, D, BK>;
  // above 48 KB a CTA's dynamic shared memory must be allowed explicitly
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(p.B * p.Hq),
                  static_cast<unsigned int>((p.S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int64_t D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16, 64>(p, stream);
    case 32: return launch_typed<T, 32, 64>(p, stream);
    case 64: return launch_typed<T, 64, 64>(p, stream);
    case 128: return launch_typed<T, 128, 32>(p, stream);
    case 256: return launch_typed<T, 256, 32>(p, stream);
    default: return -1;
  }
}

}  // namespace

// C entry point.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (0 on success; -1 for a head dimension
// or type that is not instantiated) so that a refused launch surfaces in
// the Python wrapper.  ``strides`` holds the 12 element strides
// (q_sb, q_sh, q_ss, k_*, v_*, o_*).  dtype: 0 = float32, 1 = bfloat16.
// The caller guarantees the shapes (Hq % Hkv == 0, T >= S >= 1) and the
// grid limits.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int64_t B, int64_t Hq, int64_t Hkv, int64_t S, int64_t T, int64_t D,
    const int64_t* strides, float scale, int has_softcap, float softcap,
    int causal, int has_window, int64_t window, void* stream) {
  Params p{q, k, v, o, B, Hq, Hkv, S, T,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8],
           strides[9], strides[10], strides[11],
           scale, softcap, has_softcap, causal, has_window, window};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(D, p, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(D, p, s);
  return -1;
}

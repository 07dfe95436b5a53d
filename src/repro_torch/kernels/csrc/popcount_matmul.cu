// Binary matrix product on the tensor cores, for Hopper (sm_90a).  Built
// by repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface and loaded through ctypes.
//
// Replaces the Pallas kernel popcount_matmul (_kernel_and, _kernel_xnor)
// in repro/kernels/popcount_matmul.py: x[M, W] and w[N, W] hold K bits
// packed into W 32-bit words (they cross as int32 bit patterns and are
// read as uint32_t here) ->
//   mode "and":  y[m, n] = sum_k popc(x[m, k] & w[n, k])
//   mode "xnor": y[m, n] = k_bits - 2 sum_k popc(x[m, k] ^ w[n, k])
// as int32, counted over all 32 W bits of the words, as the reference
// counts them.  Integer arithmetic: bit-exact against the plain version
// for every M, N, W and k_bits.
//
// Design.  The TPU's SWAR popcount over a (128, 128) block becomes an
// exact integer product on the tensor cores: sum_k popc(x & w) is the dot
// product of the 0/1 bit vectors, which wgmma m64n128k32 (u8 operands,
// int32 sums) takes 32 bits, one packed word, at a time.  Mode "xnor"
// needs no second product: popc(x ^ w) = popc(x) + popc(w) - 2 popc(x & w),
// so
//   y = k_bits - 2 (popc(x row) + popc(w row)) + 4 (x . w)
// with the rows' counts taken once per CTA.  CTA tile 128 x 128 outputs,
// two warpgroups of 64 rows each, two CTAs per SM:
//   1. the tile's words (up to 32 per row at a time) arrive in shared
//      memory by 4-byte cp.async, all in flight at once;
//   2. per chunk of kC = 4 words, every thread expands two words of its
//      row of w into bytes in shared memory, in wgmma's K-major layout
//      without swizzle (core matrices of 8 rows x 16 bytes; a word's 32
//      bytes are two core matrices along K).  The tensor core sums over k
//      in any order, so the low 16 bytes hold bits t + 8j at byte 4t + j
//      and the high 16 bytes bits t + 4 + 8j: each 4 bytes are
//      (word >> s) & 0x01010101.  x's fragments go straight to registers
//      in the same order (a shift and a mask per register);
//   3. each warpgroup issues one wgmma per word (A from registers, B from
//      shared memory through a descriptor) while the next chunk of w is
//      expanded into the other of two buffers;
//   4. the tile goes through shared memory so that a warp writes whole
//      512-byte rows with 16-byte streaming stores.
// Ragged M, N and W are zero-filled and masked at the store.  Tried on
// the card in throwaway builds and slower at the main shape: mma.sync
// m16n8k32 with both operands in registers, A expanded to shared memory
// as B is, and a persistent CTA that prefetches its next tile's words.
//
// What bounds it.  At the main shape (a binarised kratos-dd FFN wi: x[4096,
// 24] x w[4096, 24], 768 bits) the int32 output alone is 67 MB, 20 us at
// 3.35 TB/s; the 25.8 G int8 operations take 13 us at the dense int8
// tensor-core peak (1,979 TOP/s): the bytes bound it.  With K only 24
// words deep, each CTA's fixed costs (staging, expansion, epilogue) weigh
// as much as its products.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // CTA tile rows (x), 64 per warpgroup
constexpr int kBN = 128;       // CTA tile columns (w)
constexpr int kC = 4;          // words per expanded chunk (two buffers)
constexpr int kWordBytes = 128 * 32;      // one operand's bytes per word
constexpr int kHalf = kWordBytes / 2;     // K offset of the high 16 bytes
constexpr uint32_t kBytes = 0x01010101u;
// descriptor strides: core matrices along K one half-word apart, 8-row
// groups 128 bytes apart
constexpr uint32_t kLBO = kHalf;
constexpr uint32_t kSBO = 128;
// the output tile's row stride (ints) in shared memory: 8 words past a
// multiple of 32, so a half-warp's 8-byte fragment stores hit 32 banks
constexpr int kYS = kBN + 8;
constexpr int kWB = 32;        // words per staged block
constexpr int kWS = kWB + 1;   // row stride (words) of the staged words
constexpr size_t kCnt = kThreads * sizeof(int);
constexpr size_t kWords = 2 * kBM * kWS * sizeof(uint32_t);
constexpr size_t kOperands = 2 * kC * kWordBytes;
constexpr size_t kYBytes = kBM * kYS * sizeof(int);
constexpr size_t kSmem = kCnt + (kWords + kOperands > kYBytes
                                     ? kWords + kOperands : kYBytes);

static_assert(kBM == kThreads / 2 && kBN == kThreads / 2,
              "two threads expand each row of each tile");

// Shared-memory matrix descriptor: K-major, no swizzle; lbo: bytes between
// core matrices along K, sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = sm90::smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d += a . b for a 64 x 32 (u8) A from registers and a 32 x 128 B from
// shared memory, int32 sums.  Each warp of the warpgroup holds 16 rows of
// A as mma.sync m16n8k32 holds them: a[0] (row g, k 4t..4t+3), a[1] (row
// g + 8, k 4t..), a[2] (row g, k 16 + 4t..), a[3] (row g + 8, k 16 + 4t..)
// (g = lane / 4, t = lane % 4; the lower k in the lower byte).  d is this
// thread's part of the 64 x 128 tile: d[4j + i] at row 16 (warp % 4) + g
// + 8 (i / 2), column 8j + 2t + i % 2.  a and d must stay untouched until
// the wgmma has completed (wgmma.wait_group).
__device__ __forceinline__ void wgmma_u8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving the accumulators across the wgmma fences
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <bool kXnor>
__global__ void __launch_bounds__(kThreads)
popcount_wgmma_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w,
                      int32_t* __restrict__ y, int64_t M, int64_t N,
                      int64_t W, int k_bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // row counts: x, then w
  unsigned char* Bx = smem + kCnt;                 // [2][kC][kWordBytes]
  uint32_t* Xw = reinterpret_cast<uint32_t*>(Bx + 2 * kC * kWordBytes);
  uint32_t* Ww = Xw + kBM * kWS;                   // [kBM][kWS] words
  int* Ys = reinterpret_cast<int*>(smem + kCnt);   // [kBM][kYS], at the end
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wr = ((tid >> 5) & 3) * 16 + (lane >> 2);  // row in the wg tile
  const int ar = wg * (kBM / 2) + wr;  // this thread's rows of A: ar, ar + 8
  const int tq = lane & 3;
  const int r = tid & (kBM - 1);  // the row this thread expands, counts
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // row r's 16-byte slot in a word's low half: 8-row group, then row
  const int slot = (r >> 3) * 128 + (r & 7) * 16;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int count = 0;  // popc of row r of x (tid < kBM) or of w

  for (int64_t kb = 0; kb < W; kb += kWB) {
    // the block's words of both tiles by 4-byte cp.async, all in flight
    // at once (a warp reads one row's contiguous words); rows past M / N
    // and words past W are zeros
    const int kwb = static_cast<int>(W - kb < kWB ? W - kb : kWB);
#pragma unroll 4
    for (int i = tid; i < kBM * kWB; i += kThreads) {
      const int rr = i / kWB;
      const int c = i % kWB;
      const int64_t xm = m0 + rr;
      const int64_t wn = n0 + rr;
      const bool in = c < kwb;
      sm90::cp_async4(Xw + rr * kWS + c,
                      x + (in && xm < M ? xm * W + kb + c : 0),
                      in && xm < M);
      sm90::cp_async4(Ww + rr * kWS + c,
                      w + (in && wn < N ? wn * W + kb + c : 0),
                      in && wn < N);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (kXnor) {
      const uint32_t* words = tid < kBM ? Xw + r * kWS : Ww + r * kWS;
      for (int c = 0; c < kwb; ++c) count += __popc(words[c]);
    }

    // chunk c (kC words) of w into buffer buf: bytes of row r's words
    // kk = tid / 128, + 2, ...
    auto expand = [&](int c0, int buf) {
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) {
        const int kk = 2 * i + (tid >> 7);
        const uint32_t wv = Ww[r * kWS + c0 + kk];
        unsigned char* b = Bx + (buf * kC + kk) * kWordBytes + slot;
        *reinterpret_cast<uint4*>(b) =
            make_uint4(wv & kBytes, (wv >> 1) & kBytes, (wv >> 2) & kBytes,
                       (wv >> 3) & kBytes);
        *reinterpret_cast<uint4*>(b + kHalf) =
            make_uint4((wv >> 4) & kBytes, (wv >> 5) & kBytes,
                       (wv >> 6) & kBytes, (wv >> 7) & kBytes);
      }
      // the generic-proxy stores must be visible to the tensor cores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    expand(0, 0);
    __syncthreads();
    int buf = 0;
    for (int c0 = 0; c0 < kwb; c0 += kC, buf ^= 1) {
      // x's fragments in registers (bits t + 8j / t + 4 + 8j as B's
      // bytes hold them), the chunk's kC wgmmas (zero words add nothing),
      // then the next chunk's expansion into the other buffer while they
      // run
      uint32_t a[kC][4];
#pragma unroll
      for (int kk = 0; kk < kC; ++kk) {
        const uint32_t lo = Xw[ar * kWS + c0 + kk] >> tq;
        const uint32_t hi = Xw[(ar + 8) * kWS + c0 + kk] >> tq;
        a[kk][0] = lo & kBytes;
        a[kk][1] = hi & kBytes;
        a[kk][2] = (lo >> 4) & kBytes;
        a[kk][3] = (hi >> 4) & kBytes;
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < kC; ++kk)
        wgmma_u8(acc, a[kk],
                 smem_desc(Bx + (buf * kC + kk) * kWordBytes, kLBO, kSBO));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (c0 + kC < kwb) expand(c0 + kC, buf ^ 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < kC; ++kk)  // a stays put until here
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
      __syncthreads();  // both buffers settled before the next round
    }
  }

  if (kXnor) {
    cnt[tid] = count;
    __syncthreads();
  }
  // the tile through shared memory (the operands are dead), so that a
  // warp writes whole 512-byte rows with 16-byte streaming stores
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wg * (kBM / 2) + wr + 8 * half;
    const int px = kXnor ? cnt[rl] : 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int cl = j * 8 + 2 * tq;
      int v0 = acc[4 * j + 2 * half];
      int v1 = acc[4 * j + 2 * half + 1];
      if (kXnor) {
        v0 = k_bits - 2 * (px + cnt[kBM + cl]) + 4 * v0;
        v1 = k_bits - 2 * (px + cnt[kBM + cl + 1]) + 4 * v1;
      }
      *reinterpret_cast<int2*>(Ys + rl * kYS + cl) = make_int2(v0, v1);
    }
  }
  __syncthreads();
  const bool vec = (N & 3) == 0;  // 16-byte aligned rows of y
  for (int i = tid; i < kBM * kBN / 4; i += kThreads) {
    const int rl = i / (kBN / 4);
    const int cl = (i - rl * (kBN / 4)) * 4;
    const int64_t row = m0 + rl;
    const int64_t col = n0 + cl;
    if (row >= M) continue;
    const int4 v = *reinterpret_cast<const int4*>(Ys + rl * kYS + cl);
    int32_t* yr = y + row * N;
    if (vec && col + 3 < N) {
      __stcs(reinterpret_cast<int4*>(yr + col), v);
    } else {
      if (col < N) yr[col] = v.x;
      if (col + 1 < N) yr[col + 1] = v.y;
      if (col + 2 < N) yr[col + 2] = v.z;
      if (col + 3 < N) yr[col + 3] = v.w;
    }
  }
}

template <bool kXnor>
int launch(const uint32_t* x, const uint32_t* w, int32_t* y, int64_t M,
           int64_t N, int64_t W, int k_bits, cudaStream_t s) {
  auto* kern = popcount_wgmma_kernel<kXnor>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((N + kBN - 1) / kBN),
                  static_cast<unsigned int>((M + kBM - 1) / kBM));
  kern<<<grid, kThreads, kSmem, s>>>(x, w, y, M, N, W, k_bits);
  return static_cast<int>(cudaGetLastError());
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  auto* yp = static_cast<int32_t*>(y);
  return mode == 1 ? launch<true>(xp, wp, yp, M, N, W, k_bits, s)
                   : launch<false>(xp, wp, yp, M, N, W, k_bits, s);
}

// The f32 product tile shared by K1 (fused_head.cu, fused_head_f32), K2
// (fused_head_nopf.cu, fused_head_nopf_f32) and K4 (cnblock.cu,
// cnblock_gemm_f32): a block computes one BM x BN tile of A (rows x K, K
// contiguous) times B, with B either K-major (N rows of K, nn.Linear's
// weight layout: K4's w1t and w2t) or N-major (K rows of N: the heads'
// prototype kernel (D, P)).  The tile's A rows come from one base, or its
// upper and lower halves from two (K2: a view-1 row tile above the same rows
// of view 2, so one load of each K slice serves both views).
//
// What bounds it.  f32 products run on the SIMT FMA units (TF32 would miss
// the 1e-5 bars against the plain versions), 67 TFLOP/s on an H100: every
// K4 f32 and K1 f32 shape of the model is bound by its operations, not its
// bytes.  So the tile does what keeps the FMA units busy:
//   - 256 threads, 16 x 16, each owning an 8 x 8 block of the output in
//     registers: per four depth steps a thread loads eight float4 of A and
//     eight float4 of B from shared memory for 256 FMAs (one shared load
//     every 16 FMAs);
//   - a ring of STAGES depth slices of BK = 32 filled by 16-byte cp.async
//     (cache-global, no registers), so the next slices load while this one
//     multiplies, with one barrier a slice;
//   - padded rows (KLD = BK + 4 floats) so that the float4 reads of a
//     quarter warp hit distinct banks; an N-major B tile is read along N,
//     128 contiguous bytes a quarter warp;
//   - the ring (at most 110.6 KB) and at most 128 registers a thread leave
//     room for two blocks an SM, so one block's epilogue overlaps the
//     other's products.
// It runs the products at 55-60% of the f32 rate on the card (PERF.md).
// Built for one block an SM (no register spills), with 2-deep vectors and
// double-buffered fragments, or with warps of 4 x 8 lanes over 32 x 64
// outputs (one 128-byte wavefront a fragment read), it ran no faster:
// neither the spills at the 128-register cap nor the shared-memory
// wavefronts hold it back.
// Rows past the operand's rows, columns past its columns and depth past K
// load as zeros (a cp.async of 0 source bytes), so a ragged edge is
// computed and simply not stored.  K, the row strides and the base
// addresses must be multiples of 4 floats (16 bytes); an N-major B must
// have its column count a multiple of 4 too.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace simt {

constexpr int BM = 128;       // output rows of a tile
constexpr int BN = 128;       // output columns of a tile
constexpr int BK = 32;        // depth of a ring stage
constexpr int STAGES = 3;     // ring depth
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int TR = 8;         // output rows a thread
constexpr int TC = 8;         // output columns a thread
constexpr int KLD = BK + 4;   // row stride of a K-major shared tile (floats)
constexpr int MIN_BLOCKS = 2;  // blocks an SM (__launch_bounds__: 128 registers)

enum BLayout { B_KMAJOR = 0, B_NMAJOR = 1 };

// Raise KERNEL's dynamic shared-memory limit to `bytes`, on the first launch
// that needs more than the device's last raise only (the flags are the
// template's own, one set per kernel).
template <auto KERNEL>
cudaError_t raise_smem(int bytes) {
  static int raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised[dev] = bytes;
  return err;
}

// Shared-memory plan of the ring: STAGES x (A tile, B tile), in floats.
template <int BL>
struct Ring {
  static constexpr int A_FLOATS = BM * KLD;
  static constexpr int B_FLOATS = BL == B_KMAJOR ? BN * KLD : BK * BN;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(2 * (BYTES + 1024) <= 233472, "two blocks an SM must fit");
};

// The tile rows and columns of thread t's outputs acc[i][j]: rows
// 8 (t / 16) + i; columns t % 16 + 16 j for a K-major B (the float4 reads
// of B then walk 16 rows 36 floats apart: distinct banks), or 4 (t % 16) +
// j % 4 + 64 (j / 4) for an N-major B (two float4 along N a depth step).
__device__ __forceinline__ int frag_row(int i) { return (threadIdx.x / 16) * TR + i; }

template <int BL>
__device__ __forceinline__ int frag_col(int j) {
  const int tx = threadIdx.x % 16;
  return BL == B_KMAJOR ? tx + 16 * j : 4 * tx + (j & 3) + 64 * (j >> 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Ring stage `st` <- depth slice kt: rows [0, a_rows) of A (row stride
// lda) or, with SPLIT, the tile's upper half from rows [0, a_rows) of A over
// its lower half from rows [0, hi_rows) of A_hi; rows [0, b_cols) of a
// K-major B (row stride ldb), or depth rows of an N-major B (columns [0,
// b_cols)); zeros elsewhere.  One 16-byte copy per thread and step, eight
// neighbouring threads on a row's 128 bytes.
template <int BL, bool SPLIT>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ A,
                                           const float* __restrict__ A_hi, size_t lda,
                                           int a_rows, int hi_rows, const float* __restrict__ B,
                                           size_t ldb, int b_cols, int K, int kt) {
  constexpr int CHUNKS = BK / 4;   // 16-byte chunks of a K-major row slice
  constexpr int A_STEPS = BM * CHUNKS / THREADS;
  static_assert(A_STEPS % 2 == 0, "each copy step stays within one half of the A tile");
  const int k0 = kt * BK;
  float* As = st;
  float* Bs = st + Ring<BL>::A_FLOATS;
#pragma unroll
  for (int l = 0; l < A_STEPS; ++l) {
    const int idx = threadIdx.x + l * THREADS, r = idx / CHUNKS, c = (idx % CHUNKS) * 4;
    const bool hi = SPLIT && l >= A_STEPS / 2;   // rows BM / 2 .. BM - 1
    const int hr = hi ? r - BM / 2 : r;          // the row within its half's base
    const bool ok = hr < (hi ? hi_rows : a_rows) && k0 + c < K;
    cp_async16(As + r * KLD + c, ok ? (hi ? A_hi : A) + (size_t)hr * lda + k0 + c : A, ok);
  }
  if constexpr (BL == B_KMAJOR) {
#pragma unroll
    for (int l = 0; l < BN * CHUNKS / THREADS; ++l) {
      const int idx = threadIdx.x + l * THREADS, n = idx / CHUNKS, c = (idx % CHUNKS) * 4;
      const bool ok = n < b_cols && k0 + c < K;
      cp_async16(Bs + n * KLD + c, ok ? B + (size_t)n * ldb + k0 + c : B, ok);
    }
  } else {
    constexpr int ROW = BN / 4;      // 16-byte chunks of an N-major depth row
#pragma unroll
    for (int l = 0; l < BK * ROW / THREADS; ++l) {
      const int idx = threadIdx.x + l * THREADS, k = idx / ROW, c = (idx % ROW) * 4;
      const bool ok = k0 + k < K && c < b_cols;
      cp_async16(Bs + k * BN + c, ok ? B + (size_t)(k0 + k) * ldb + c : B, ok);
    }
  }
}

// acc += the stage's A slice times its B slice, depth in order (one fmaf a
// term, as the plain product's sum runs k = 0, 1, ...).
template <int BL>
__device__ __forceinline__ void mma_stage(const float* st, float (&acc)[TR][TC]) {
  const float* As = st + frag_row(0) * KLD;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 a[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = *reinterpret_cast<const float4*>(As + i * KLD + kk);
    if constexpr (BL == B_KMAJOR) {
      const float* Bs = st + Ring<BL>::A_FLOATS + frag_col<BL>(0) * KLD + kk;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + 16 * j * KLD);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    } else {
      const float* Bs = st + Ring<BL>::A_FLOATS + kk * BN + frag_col<BL>(0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + q * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + q * BN + 64);
        const float b[TC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
}

// acc (thread's 8 x 8 outputs, frag_row / frag_col) = the tile's rows (of
// A, or with SPLIT its halves from A and A_hi as load_stage takes them)
// times its columns of B over the depth K, through the ring in `smem`
// (Ring<BL>::BYTES).  Ends with every copy landed and a barrier: the caller
// may reuse the ring's shared memory at once.
template <int BL, bool SPLIT>
__device__ __forceinline__ void product_rows(float* smem, const float* __restrict__ A,
                                             const float* __restrict__ A_hi, size_t lda,
                                             int a_rows, int hi_rows,
                                             const float* __restrict__ B, size_t ldb, int b_cols,
                                             int K, float (&acc)[TR][TC]) {
  constexpr int SF = Ring<BL>::STAGE_FLOATS;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<BL, SPLIT>(smem + s * SF, A, A_hi, lda, a_rows, hi_rows, B, ldb, b_cols, K, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // slice kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and slice kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < KT)
      load_stage<BL, SPLIT>(smem + (next % STAGES) * SF, A, A_hi, lda, a_rows, hi_rows, B, ldb,
                            b_cols, K, next);
    cp_async_commit();             // an empty group keeps the count at the tail
    mma_stage<BL>(smem + (kt % STAGES) * SF, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's rows are rows [0, a_rows) of A.
template <int BL>
__device__ __forceinline__ void product(float* smem, const float* __restrict__ A, size_t lda,
                                        int a_rows, const float* __restrict__ B, size_t ldb,
                                        int b_cols, int K, float (&acc)[TR][TC]) {
  product_rows<BL, false>(smem, A, A, lda, a_rows, a_rows, B, ldb, b_cols, K, acc);
}

// The tile's upper half is rows [0, a_rows) of A, its lower half rows [0,
// hi_rows) of A_hi.
template <int BL>
__device__ __forceinline__ void product(float* smem, const float* __restrict__ A,
                                        const float* __restrict__ A_hi, size_t lda, int a_rows,
                                        int hi_rows, const float* __restrict__ B, size_t ldb,
                                        int b_cols, int K, float (&acc)[TR][TC]) {
  product_rows<BL, true>(smem, A, A_hi, lda, a_rows, hi_rows, B, ldb, b_cols, K, acc);
}

}  // namespace simt

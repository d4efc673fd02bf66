// Device code shared by the prototype-head kernels (K1 fused_head.cu, K2
// fused_head_nopf.cu): the z tile product and the per-node softmax of one
// row tile.  Both kernels use the same block plan: one block owns one column
// group (a run of whole nodes of one bucket, <= TN columns, planned on the
// host by ops/fused_head.py::column_groups) of one image, and loops over the
// patch rows in tiles of TM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace head_tile {

constexpr int TM = 64;        // rows (patches) per row tile
constexpr int TN = 128;       // prototype columns per block
constexpr int TK = 32;        // depth per shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int ZLD = TN + 4;   // row stride of the f32 z tile in shared memory
constexpr int ALD_F32 = TM + 1;   // [TK][TM+1] f32 A tile (conflict-free stores)
constexpr int LD_BF16 = TK + 8;   // [rows][TK+8] bf16 A and B^T tiles

// bytes of the product's staging tiles, and of one f32 z tile
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return std::is_same<T, float>::value ? (TK * ALD_F32 + TK * TN) * 4
                                       : (TM + TN) * LD_BF16 * 2;
}
constexpr int Z_BYTES = TM * ZLD * 4;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// z tile (rows r0..r0+TM-1, columns c0..c0+TN-1) / tau into Z[TM][ZLD].
// Rows >= HW, columns >= ncols and depth >= D enter as zeros.  `smem` holds
// the staging tiles (stage_bytes<T>()); Z may alias it, since the staging
// tiles are dead once the depth loop has ended.
template <typename T>
__device__ __forceinline__ void z_tile(const T* __restrict__ Fb, const T* __restrict__ K,
                                       int r0, int HW, int D, int P, int c0, int ncols,
                                       float tau, unsigned char* smem, float* Z) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    float* As = reinterpret_cast<float*>(smem);            // [TK][ALD_F32]
    float* Bs = As + TK * ALD_F32;                         // [TK][TN]
    const int tx = tid % 16, ty = tid / 16;                // cols tx+16j, rows ty+16i
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll
      for (int l = 0; l < (TM * TK) / THREADS; ++l) {
        const int idx = tid + l * THREADS, kk = idx % TK, r = idx / TK;
        const int row = r0 + r, k = k0 + kk;
        As[kk * ALD_F32 + r] = (row < HW && k < D) ? Fb[(size_t)row * D + k] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (TK * TN) / THREADS; ++l) {
        const int idx = tid + l * THREADS, c = idx % TN, kk = idx / TN;
        const int k = k0 + kk;
        Bs[kk * TN + c] = (c < ncols && k < D) ? K[(size_t)k * P + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * ALD_F32 + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[kk * TN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Z[(ty + 16 * i) * ZLD + tx + 16 * j] = acc[i][j] / tau;
  } else {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [TM][LD_BF16]
    __nv_bfloat16* Bs = As + TM * LD_BF16;                         // [TN][LD_BF16] = K^T
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;        // warp tile 32 x 32
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll
      for (int l = 0; l < (TM * TK) / THREADS; ++l) {
        const int idx = tid + l * THREADS, kk = idx % TK, r = idx / TK;
        const int row = r0 + r, k = k0 + kk;
        As[r * LD_BF16 + kk] = (row < HW && k < D) ? Fb[(size_t)row * D + k] : zero;
      }
#pragma unroll
      for (int l = 0; l < (TK * TN) / THREADS; ++l) {
        const int idx = tid + l * THREADS, c = idx % TN, kk = idx / TN;
        const int k = k0 + kk;
        Bs[c * LD_BF16 + kk] = (c < ncols && k < D) ? K[(size_t)k * P + c0 + c] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < TK; kb += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* base = As + (wm + mi * 16 + g) * LD_BF16 + kb + 2 * t;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD_BF16);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD_BF16 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* base = Bs + (wn + ni * 8 + g) * LD_BF16 + kb + 2 * t;
          b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
          b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int row = wm + mi * 16 + g, col = wn + ni * 8 + 2 * t;
        Z[row * ZLD + col] = acc[mi][ni][0] / tau;
        Z[row * ZLD + col + 1] = acc[mi][ni][1] / tau;
        Z[(row + 8) * ZLD + col] = acc[mi][ni][2] / tau;
        Z[(row + 8) * ZLD + col + 1] = acc[mi][ni][3] / tau;
      }
  }
}

// Per-(row, node) softmax in place over the node's valid slots, for `rows`
// rows of Z holding `nodes` nodes of `width` columns each.  Shifts by the
// true per-node max (the Pallas kernels' tile-row max underflows a node whose
// logits sit ~87 below another node's), clips the exponent to [-80, 60] and
// floors the denominator at 1e-18, as the plain segment_softmax does.
// Invalid (padded) slots come out exactly 0.
__device__ __forceinline__ void softmax_rows(float* Z, const uint8_t* valid_s, int rows,
                                             int nodes, int width) {
  for (int q = threadIdx.x; q < rows * nodes; q += THREADS) {
    float* zr = Z + (q / nodes) * ZLD + (q % nodes) * width;
    const uint8_t* v = valid_s + (q % nodes) * width;
    float m = -INFINITY;
    for (int s = 0; s < width; ++s)
      if (v[s]) m = fmaxf(m, zr[s]);
    float sum = 0.f;
    for (int s = 0; s < width; ++s) {
      const float e = v[s] ? expf(fminf(fmaxf(zr[s] - m, -80.f), 60.f)) : 0.f;
      zr[s] = e;
      sum += e;
    }
    const float denom = fmaxf(sum, 1e-18f);
    for (int s = 0; s < width; ++s) zr[s] = zr[s] / denom;
  }
}

}  // namespace head_tile

// every kernel library exports this for ops/build.py::check_cuda
#define PIPNET_EXPORT_ERROR_STRING                                    \
  extern "C" const char* pipnet_cuda_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }

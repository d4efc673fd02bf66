// K1: fused prototype head forward, hand-written for Hopper (sm_90a).
//
// Replaces pipnet_tpu/ops/pallas_head.py::_head_kernel (the Pallas TPU
// kernel reached from fused_head_forward).  For every image b and every
// prototype column p of the compiled tree:
//
//   z[b, hw, p]  = (F[b, hw, :] . K[:, p]) / tau            (f32 accumulation)
//   pf[b, hw, p] = per-node softmax of z over the node's valid slots
//   pooled[b, p] = max over hw of pf (f32, before the cast to the input type)
//
// Padded slots inside a node and the padded tail beyond the last bucket
// come out exactly 0.
//
// Design (right and simple first).  One block per (column group, image).  A
// column group is a run of whole nodes of one bucket whose widths fit
// TN = 128 columns (6 x 20 at the flagship), so a node's softmax never
// crosses blocks; groups of width 0 are the padded tail and only write zeros.
// The block loops over the HW rows in tiles of TM = 64 and keeps the running
// column max in a register, so the pooled max needs no cross-block reduction
// and no atomics: the loop takes the place of the TPU's sequential grid.
// Each row tile is a shared-memory-tiled product with f32 accumulation:
// SIMT FMA for f32 inputs (TF32 would miss the f32 tolerance) and
// mma.sync.m16n8k16 bf16 tensor-core tiles for bf16 inputs.  The softmax
// shifts by the true per-node max (not the Pallas kernel's tile-row max,
// which underflows a node whose logits sit ~87 below another node's).
//
// Bound at the flagship serving shape (B=8, HW=676, D=768, P=3840 bf16):
// the product is 2*8*676*768*3840 = 32 GFLOP, 32 us at the 989 TFLOP/s bf16
// dense peak; memory is ~56 MB (F 8.3 MB + K 5.9 MB + pf 41.5 MB), 17 us at
// 3.35 TB/s, so the product bounds it.  What this simple design leaves on
// the table: no wgmma/TMA, no cp.async pipeline (each K step waits on its
// global loads), and every block re-reads its image's F and its K column
// tile from L2 once per row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TM = 64;        // rows (patches) per row tile
constexpr int TN = 128;       // prototype columns per block
constexpr int TK = 32;        // depth per shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int ZLD = TN + 4;   // row stride of the f32 z tile in shared memory
constexpr int ALD_F32 = TM + 1;   // [TK][TM+1] f32 A tile (conflict-free stores)
constexpr int LD_BF16 = TK + 8;   // [rows][TK+8] bf16 A and B^T tiles

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// z tile (rows r0..r0+TM-1, columns c0..c0+TN-1) / tau into Z[TM][ZLD].
// Rows >= HW, columns >= ncols and depth >= D enter as zeros.
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

// groups: G triples (col_start, ncols, width); width 0 marks the padded tail.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_head_kernel(const T* __restrict__ F, const T* __restrict__ K,
                  const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                  T* __restrict__ pf, float* __restrict__ pooled,
                  int HW, int D, int P, float tau) {
  // the z tile aliases the product's staging tiles: they are dead by then
  constexpr int STAGE_BYTES = std::is_same<T, float>::value
                                  ? (TK * ALD_F32 + TK * TN) * 4
                                  : (TM + TN) * LD_BF16 * 2;
  constexpr int Z_BYTES = TM * ZLD * 4;
  __shared__ __align__(16) unsigned char smem[STAGE_BYTES > Z_BYTES ? STAGE_BYTES : Z_BYTES];
  __shared__ uint8_t valid_s[TN];
  float* Z = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int c0 = groups[3 * blockIdx.x], ncols = groups[3 * blockIdx.x + 1];
  const int width = groups[3 * blockIdx.x + 2];
  const int b = blockIdx.y;
  T* pfb = pf + (size_t)b * HW * P;

  if (width == 0) {   // padded tail beyond the last bucket
    for (int idx = tid; idx < HW * ncols; idx += THREADS)
      pfb[(size_t)(idx / ncols) * P + c0 + idx % ncols] = from_f32<T>(0.f);
    if (tid < ncols) pooled[(size_t)b * P + c0 + tid] = 0.f;
    return;
  }

  if (tid < TN) valid_s[tid] = tid < ncols ? valid[c0 + tid] : 0;
  const int nodes = ncols / width;
  const T* Fb = F + (size_t)b * HW * D;
  float colmax = 0.f;   // pf >= 0, and every column sees at least one row

  for (int r0 = 0; r0 < HW; r0 += TM) {
    const int rows = min(TM, HW - r0);
    z_tile<T>(Fb, K, r0, HW, D, P, c0, ncols, tau, smem, Z);
    __syncthreads();

    // per-(row, node) softmax in place over the node's valid slots
    for (int q = tid; q < rows * nodes; q += THREADS) {
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
    __syncthreads();

    for (int idx = tid; idx < rows * ncols; idx += THREADS) {
      const int r = idx / ncols, c = idx % ncols;
      pfb[(size_t)(r0 + r) * P + c0 + c] = from_f32<T>(Z[r * ZLD + c]);
    }
    if (tid < ncols)
      for (int r = 0; r < rows; ++r) colmax = fmaxf(colmax, Z[r * ZLD + tid]);
    __syncthreads();   // Z is overwritten by the next tile's staging
  }
  if (tid < ncols) pooled[(size_t)b * P + c0 + tid] = colmax;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns
// cudaGetLastError() so a refused launch is reported to the caller.
int pipnet_fused_head_forward(const void* features, const void* kernel, const void* valid,
                              const void* groups, void* pf, void* pooled, int B, int HW,
                              int D, int P, int G, float tau, int dtype, void* stream) {
  const dim3 grid(G, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_head_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(features), static_cast<const float*>(kernel),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(groups),
        static_cast<float*>(pf), static_cast<float*>(pooled), HW, D, P, tau);
  } else if (dtype == 1) {
    fused_head_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(features), static_cast<const __nv_bfloat16*>(kernel),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(groups),
        static_cast<__nv_bfloat16*>(pf), static_cast<float*>(pooled), HW, D, P, tau);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pipnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

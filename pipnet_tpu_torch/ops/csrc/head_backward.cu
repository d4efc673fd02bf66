// K1b: the fused prototype head's adjoint (softmax + spatial max-pool),
// hand-written for Hopper (sm_90a).
//
// Replaces the analytic backward of pipnet_tpu/ops/pallas_head.py::
// make_fused_head (pallas_head.py:436-448, XLA in the JAX package) up to
// dz; dF = dz K^T and dK = F^T dz stay plain matrix products.  For every
// image b and prototype column p, over the HW patch rows:
//
//   is_max[hw, p] = (pf[hw, p] == max_hw pf[., p])   max taken again from pf
//   counts[p]     = sum_hw is_max                     ties split evenly
//   g_tot[hw, p]  = g_pf[hw, p] + is_max / counts * g_pooled[p]
//   dz[hw, p]     = pf * (g_tot - sum_{q in node(p)} g_tot[hw, q] pf[hw, q]) / tau
//
// g_pf may be null (zero).  The per-node sums accumulate in f32; dz is
// written in pf's dtype.  The max is compared against pf itself, never the
// f32 pooled output: bf16 pf == pooled almost never holds.  Padded slots
// have pf = 0 and so dz = 0; the padded tail's groups (width 0) write zeros.
//
// Design (right and simple first).  The block plan of K1: one block per
// (column group of whole nodes, image), looping over the HW rows itself, so
// the column max, its tie count and the per-(row, node) sums live in
// registers and shared memory with no atomics.  Pass 1 reads the block's pf
// slice for the column max and count; pass 2 reads pf and g_pf again in row
// tiles of TR, forms g_tot and g_tot*pf in shared memory, sums each node per
// row (into the node's first slot), and writes dz.  Loads and stores run
// along the columns of a row, so a warp touches consecutive addresses.
//
// Bound at the flagship train step (B=128, HW=676, P=3840, bf16): the
// function reads pf and g_pf and writes dz, 3 x 664.6 MB = 1.99 GB, 0.59 ms
// at 3.35 TB/s; its arithmetic is a few operations per element, so bytes
// bound it.  This design reads pf twice (the second read usually hits L2: a
// block's slice is 173 KB and it is read again right away) and does not
// vectorise its loads.

#include "head_tile.cuh"

namespace {

using head_tile::from_f32;
using head_tile::THREADS;
using head_tile::TN;
using head_tile::to_f32;

constexpr int TR = 32;          // rows per pass-2 tile
constexpr int SLD = TN + 1;     // row stride of the f32 tiles in shared memory
constexpr int HALVES = THREADS / TN;

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_backward_kernel(const T* __restrict__ pf, const T* __restrict__ g_pf,
                     const float* __restrict__ g_pooled, const int* __restrict__ groups,
                     T* __restrict__ dz, int HW, int P, float inv_tau) {
  __shared__ float gt_s[TR * SLD];      // g_tot
  __shared__ float gp_s[TR * SLD];      // g_tot * pf; then each node's sum in its first slot
  __shared__ float max_s[HALVES][TN];
  __shared__ int cnt_s[HALVES][TN];
  __shared__ float route_s[TN];         // g_pooled / counts

  const int tid = threadIdx.x;
  const int c0 = groups[3 * blockIdx.x], ncols = groups[3 * blockIdx.x + 1];
  const int width = groups[3 * blockIdx.x + 2];
  const int b = blockIdx.y;
  const size_t base = (size_t)b * HW * P + c0;
  const T* pfb = pf + base;
  const T* gb = g_pf ? g_pf + base : nullptr;
  T* dzb = dz + base;

  if (width == 0) {   // padded tail beyond the last bucket
    for (int idx = tid; idx < HW * ncols; idx += THREADS)
      dzb[(size_t)(idx / ncols) * P + idx % ncols] = from_f32<T>(0.f);
    return;
  }

  // pass 1: each column's max over the rows and how many rows reach it
  {
    const int c = tid % TN, half = tid / TN;
    float m = -INFINITY;
    int cnt = 0;
    if (c < ncols)
      for (int r = half; r < HW; r += HALVES) {
        const float v = to_f32(pfb[(size_t)r * P + c]);
        if (v > m) {
          m = v;
          cnt = 1;
        } else if (v == m) {
          ++cnt;
        }
      }
    max_s[half][c] = m;
    cnt_s[half][c] = cnt;
  }
  __syncthreads();
  if (tid < ncols) {
    float m = max_s[0][tid];
    for (int h = 1; h < HALVES; ++h) m = fmaxf(m, max_s[h][tid]);
    int cnt = 0;
    for (int h = 0; h < HALVES; ++h) cnt += max_s[h][tid] == m ? cnt_s[h][tid] : 0;
    max_s[0][tid] = m;
    route_s[tid] = g_pooled[(size_t)b * P + c0 + tid] / (float)max(cnt, 1);
  }
  __syncthreads();

  // pass 2: g_tot, the per-(row, node) sums, dz
  const int nodes = ncols / width;
  for (int r0 = 0; r0 < HW; r0 += TR) {
    const int rows = min(TR, HW - r0);
    for (int idx = tid; idx < rows * ncols; idx += THREADS) {
      const int r = idx / ncols, c = idx % ncols;
      const size_t off = (size_t)(r0 + r) * P + c;
      const float p = to_f32(pfb[off]);
      float g = gb ? to_f32(gb[off]) : 0.f;
      if (p == max_s[0][c]) g += route_s[c];
      gt_s[r * SLD + c] = g;
      gp_s[r * SLD + c] = g * p;
    }
    __syncthreads();
    for (int q = tid; q < rows * nodes; q += THREADS) {
      float* seg = gp_s + (q / nodes) * SLD + (q % nodes) * width;
      float s = 0.f;
      for (int k = 0; k < width; ++k) s += seg[k];
      seg[0] = s;           // only this thread touches the node's segment
    }
    __syncthreads();
    for (int idx = tid; idx < rows * ncols; idx += THREADS) {
      const int r = idx / ncols, c = idx % ncols;
      const size_t off = (size_t)(r0 + r) * P + c;
      const float p = to_f32(pfb[off]);
      const float node_sum = gp_s[r * SLD + c / width * width];
      dzb[off] = from_f32<T>(p * (gt_s[r * SLD + c] - node_sum) * inv_tau);
    }
    __syncthreads();   // the tiles are refilled by the next row tile
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; g_pf may be null.  Launches on
// `stream`; returns cudaGetLastError() so a refused launch is reported.
int pipnet_head_backward(const void* pf, const void* g_pf, const void* g_pooled,
                         const void* groups, void* dz, int B, int HW, int P, int G,
                         float tau, int dtype, void* stream) {
  const dim3 grid(G, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_tau = 1.0f / tau;
  if (dtype == 0) {
    head_backward_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(pf), static_cast<const float*>(g_pf),
        static_cast<const float*>(g_pooled), static_cast<const int*>(groups),
        static_cast<float*>(dz), HW, P, inv_tau);
  } else if (dtype == 1) {
    head_backward_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(pf), static_cast<const __nv_bfloat16*>(g_pf),
        static_cast<const float*>(g_pooled), static_cast<const int*>(groups),
        static_cast<__nv_bfloat16*>(dz), HW, P, inv_tau);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

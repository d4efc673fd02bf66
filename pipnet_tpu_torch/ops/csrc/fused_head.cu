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

#include "head_tile.cuh"

namespace {

using namespace head_tile;

// groups: G triples (col_start, ncols, width); width 0 marks the padded tail.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_head_kernel(const T* __restrict__ F, const T* __restrict__ K,
                  const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                  T* __restrict__ pf, float* __restrict__ pooled,
                  int HW, int D, int P, float tau) {
  // the z tile aliases the product's staging tiles: they are dead by then
  constexpr int STAGE_BYTES = stage_bytes<T>();
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

    softmax_rows(Z, valid_s, rows, nodes, width);
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

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

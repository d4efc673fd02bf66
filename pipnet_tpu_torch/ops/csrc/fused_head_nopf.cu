// K2: the no-pf fused prototype head, hand-written for Hopper (sm_90a).
//
// Replaces pipnet_tpu/ops/pallas_head.py::_head_nopf_kernel (the Pallas TPU
// kernel reached from fused_head_nopf_forward).  Features hold two views
// stacked, F (2B, HW, D); image b of view 1 pairs with image B + b of view 2.
// For every pair b, prototype column p and node n of the compiled tree:
//
//   pf_v[hw, p]   = per-node softmax of (F_v[hw, :] . K[:, p]) / tau     (v = 1, 2)
//   pooled[b, p], pooled[B + b, p] = max over hw of pf_1, pf_2          (f32)
//   logsum[b, n]  = sum_hw log(sum_{p in n} pf_1[hw, p] pf_2[hw, p] + eps)
//
// The softmaxed maps never leave the chip.  logsum is written at the tree's
// node index (proto_node of the node's first slot), so no scatter follows.
// The softmax shifts by the true per-node max, clips the exponent to
// [-80, 60] and floors the denominator at 1e-18, as segment_softmax does (the
// Pallas kernel's tile-row max zeroes a node whose logits sit ~87 below
// another node's).
//
// Design (right and simple first).  K1's block plan and tile product
// (head_tile.cuh): one block per (column group of whole nodes, image pair)
// loops over the HW rows in tiles of TM.  Per row tile it forms view 1's z
// tile and softmax (kept in shared memory), then view 2's, updates both
// running column maxima in registers, and adds each (row, node) log term
// into a per-node register sum, so nothing crosses blocks and no atomics are
// needed.  The two f32 z tiles and the product's staging take 66 KB of
// dynamic shared memory (view 2's tile aliases the staging).
//
// Bound at the flagship train step (64 pairs, HW=676, D=768, 3780 real
// columns, bf16): the products are 2*128*676*768*3780 = 502 GFLOP, 0.51 ms at
// the 989 TFLOP/s bf16 dense peak; the bytes are F 132.9 MB + K 5.9 MB +
// outputs 2 MB, 0.04 ms at 3.35 TB/s, so the operations bound it.  This
// design leaves wgmma/TMA, a cp.async pipeline, and reuse of the F and K
// tiles across row tiles to later work.

#include "head_tile.cuh"

namespace {

using namespace head_tile;

template <typename T>
constexpr int dyn_smem_bytes() {
  return Z_BYTES + (stage_bytes<T>() > Z_BYTES ? stage_bytes<T>() : Z_BYTES);
}

// groups: G triples (col_start, ncols, width); width 0 marks the padded tail.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_head_nopf_kernel(const T* __restrict__ F, const T* __restrict__ K,
                       const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                       const int* __restrict__ proto_node, float* __restrict__ pooled,
                       float* __restrict__ logsum, int B, int HW, int D, int P, int N,
                       float tau, float eps) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* Z1 = reinterpret_cast<float*>(dyn);        // view 1's softmaxed tile
  unsigned char* stage = dyn + Z_BYTES;             // the product's staging tiles
  float* Z2 = reinterpret_cast<float*>(stage);      // view 2's tile aliases them
  __shared__ uint8_t valid_s[TN];

  const int tid = threadIdx.x;
  const int c0 = groups[3 * blockIdx.x], ncols = groups[3 * blockIdx.x + 1];
  const int width = groups[3 * blockIdx.x + 2];
  const int b = blockIdx.y;
  float* pooled1 = pooled + (size_t)b * P + c0;
  float* pooled2 = pooled + (size_t)(B + b) * P + c0;

  if (width == 0) {   // padded tail beyond the last bucket
    if (tid < ncols) pooled1[tid] = pooled2[tid] = 0.f;
    return;
  }

  if (tid < TN) valid_s[tid] = tid < ncols ? valid[c0 + tid] : 0;
  const int nodes = ncols / width;
  const T* F1 = F + (size_t)b * HW * D;
  const T* F2 = F + (size_t)(B + b) * HW * D;
  float colmax1 = 0.f, colmax2 = 0.f;   // pf >= 0, every column sees a row
  float node_log = 0.f;                 // thread n < nodes: node n's sum

  for (int r0 = 0; r0 < HW; r0 += TM) {
    const int rows = min(TM, HW - r0);
    z_tile<T>(F1, K, r0, HW, D, P, c0, ncols, tau, stage, Z1);
    __syncthreads();
    softmax_rows(Z1, valid_s, rows, nodes, width);
    z_tile<T>(F2, K, r0, HW, D, P, c0, ncols, tau, stage, Z2);   // syncs inside
    __syncthreads();
    softmax_rows(Z2, valid_s, rows, nodes, width);
    __syncthreads();

    if (tid < ncols)
      for (int r = 0; r < rows; ++r) {
        colmax1 = fmaxf(colmax1, Z1[r * ZLD + tid]);
        colmax2 = fmaxf(colmax2, Z2[r * ZLD + tid]);
      }
    __syncthreads();   // the log terms below overwrite Z1

    for (int q = tid; q < rows * nodes; q += THREADS) {
      const int off = (q / nodes) * ZLD + (q % nodes) * width;
      float ip = 0.f;
      for (int s = 0; s < width; ++s) ip += Z1[off + s] * Z2[off + s];
      Z1[off] = logf(ip + eps);   // only this thread touches the node's segment
    }
    __syncthreads();
    if (tid < nodes)
      for (int r = 0; r < rows; ++r) node_log += Z1[r * ZLD + tid * width];
    __syncthreads();   // Z1 and Z2 are refilled by the next row tile
  }
  if (tid < ncols) {
    pooled1[tid] = colmax1;
    pooled2[tid] = colmax2;
  }
  if (tid < nodes) logsum[(size_t)b * N + proto_node[c0 + tid * width]] = node_log;
}

template <typename T>
int launch(const void* features, const void* kernel, const void* valid, const void* groups,
           const void* proto_node, void* pooled, void* logsum, int B, int HW, int D, int P,
           int N, int G, float tau, float eps, cudaStream_t s) {
  constexpr int bytes = dyn_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(fused_head_nopf_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_head_nopf_kernel<T><<<dim3(G, B), THREADS, bytes, s>>>(
      static_cast<const T*>(features), static_cast<const T*>(kernel),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(groups),
      static_cast<const int*>(proto_node), static_cast<float*>(pooled),
      static_cast<float*>(logsum), B, HW, D, P, N, tau, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B is the number of image pairs (features hold 2B images).  dtype: 0 =
// float32, 1 = bfloat16.  Launches on `stream`; returns the CUDA error code
// so a refused launch is reported to the caller.
int pipnet_fused_head_nopf_forward(const void* features, const void* kernel,
                                   const void* valid, const void* groups,
                                   const void* proto_node, void* pooled, void* logsum,
                                   int B, int HW, int D, int P, int N, int G, float tau,
                                   float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(features, kernel, valid, groups, proto_node, pooled, logsum, B, HW,
                         D, P, N, G, tau, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(features, kernel, valid, groups, proto_node, pooled, logsum,
                                 B, HW, D, P, N, G, tau, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

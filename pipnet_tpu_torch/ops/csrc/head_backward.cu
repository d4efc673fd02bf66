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
// What bounds it on an H100, at the flagship train step (B=128, HW=676,
// P=3840, bf16): it reads pf and g_pf and writes dz, 3 x 664.6 MB = 1.99 GB,
// 0.59 ms at 3.35 TB/s; a few operations per element.  Bytes bound it.
//
// Design.  One block per (column group, image).  A group is whole nodes of
// one bucket (ops/fused_head.py::backward_plan), seen from the 16-byte
// boundary at or below its start as `sv` 16-byte vectors, and where the
// window allows a run of nodes whose dz bytes start and end on 32-byte
// sectors, so that no sector is written by two blocks (at the flagship
// shape 4 nodes, 80 bf16 columns: sv = 10).
// - pf is read from device memory once: the block's slice (HW rows of sv
//   vectors, 108 KB at the flagship shape, so two blocks share an SM) is
//   copied into shared memory by cp.async, 16 bytes a copy, all in flight
//   together.  Where the slice does not fit (large HW), the block reads pf
//   from device memory in both passes instead (RESIDENT false).
// - Pass 1: each column's max and tie count over the rows, in registers,
//   met across the rows of a warp by shuffles and across warps by shared
//   memory atomics.
// - Pass 2: a row is sv lanes of a warp, one 16-byte vector each (32 / sv
//   rows a warp), so g_pf is loaded and dz stored as 16-byte vectors,
//   coalesced along the row, with g_pf of the next four rows in flight.  A
//   lane keeps its columns' max and route in registers.  The per-(row,
//   node) sums are segmented: a scan over the lane's own columns, then each
//   node's partials from the lanes on either side of it by shuffles (a node
//   spans a fixed set of lanes, so the chain lengths are set once).  No
//   shared memory and no barrier in pass 2.
//
// Nodes wider than the window (flat PIP-Net's 768 prototypes) come as
// parts of it (head_tile.cuh).  The column reduction (pass 1) never crosses
// columns, so a part runs it alone; the row reduction spans the node, so it
// is split: a STATS launch writes each row's sum of g_tot * pf over each
// part to `inner` (B * HW, G), and a FINAL launch adds the node's parts'
// sums and writes dz.  Both launches run pass 1, and pf and g_pf are read
// twice; groups of whole nodes take the WHOLE launch (the design above).
//
// What the previous design (scalar loads, pf read twice, a serial walk per
// node with three barriers per 32-row tile) lost, from clock64() timers on
// an H100 (PERF.md): 59% of a block's time in pass 2's loads and 23%
// in its dz stores.  Groups whose edges fall inside a sector cost this
// design about a fifth of its time (PERF.md).

#include "head_tile.cuh"

namespace {

using head_tile::from_f32;
using head_tile::to_f32;
using hopper::smem_u32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // rows a thread loads ahead in pass 2

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a 16-byte vector of T as f32
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
}

// store the elements [lo, hi) of a VEC-vector at dst (dst 16-byte aligned)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const float (&v)[VEC], int lo, int hi) {
  if (lo == 0 && hi == VEC) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    __stcs(reinterpret_cast<uint4*>(dst), raw);     // dz is not read again here
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i >= lo && i < hi) dst[i] = from_f32<T>(v[i]);
  }
}

// a float's bits as an int that orders as the float does (its own inverse)
__device__ __forceinline__ int ordered(int bits) { return bits >= 0 ? bits : bits ^ 0x7fffffff; }

// groups: G records of GF ints (head_tile.cuh); STATS and FINAL run over
// parts of wide nodes, with their row sums in inner (B * HW, G).
template <typename T, bool RESIDENT, int MODE>
__global__ void __launch_bounds__(THREADS)
head_backward_kernel(const T* __restrict__ pf, const T* __restrict__ g_pf,
                     const float* __restrict__ g_pooled, const int* __restrict__ groups,
                     float* __restrict__ inner, T* __restrict__ dz, int HW, int P, int G, int sv,
                     float inv_tau) {
  constexpr int VEC = 16 / sizeof(T);      // columns per 16-byte vector
  extern __shared__ __align__(16) uint8_t smem[];
  const int ws = sv * VEC;                 // window columns, the slice's row stride
  // per window column: the max (ordered bits, then the float) and the tie
  // count (then the route, as a float)
  int* max_s = reinterpret_cast<int*>(smem);                    // [ws]
  int* cnt_s = max_s + ws;                                      // [ws]
  T* slice = reinterpret_cast<T*>(cnt_s + ws);                  // [HW][ws] if RESIDENT

  // a row team is sv lanes of a warp, one 16-byte vector each; a warp holds
  // 32 / sv rows side by side
  const int tid = threadIdx.x, per_warp = 32 / sv;
  const int slot = tid % 32 / sv, lane = tid % 32 % sv;
  const bool in_row = slot < per_warp;
  const int row0 = tid / 32 * per_warp + slot, rows_step = WARPS * per_warp;
  const int* rec = groups + GF * blockIdx.x;
  const int c0 = rec[0], ncols = rec[1];
  const int width = MODE == WHOLE ? rec[2] : rec[2] ? ncols : 0;   // a part: one segment
  const int b = blockIdx.y;
  const int a0 = c0 - c0 % VEC, off = c0 - a0;        // window start; the group sits `off` in
  const int nvec = (off + ncols + VEC - 1) / VEC;     // vectors of the window the group touches
  const size_t base = (size_t)b * HW * P + a0;

  if (width == 0) {   // padded tail beyond the last bucket: zeros
    if (MODE == STATS) return;
    const float z[VEC] = {};
    for (int idx = tid; idx < HW * nvec; idx += THREADS) {
      const int r = idx / nvec, v = idx % nvec;
      store_vec<T, VEC>(dz + base + (size_t)r * P + v * VEC, z, max(off - v * VEC, 0),
                        min(off + ncols - v * VEC, VEC));
    }
    return;
  }

  if (RESIDENT)
    for (int idx = tid; idx < HW * nvec; idx += THREADS) {
      const int r = idx / nvec, v = idx % nvec;
      cp_async16(slice + (size_t)r * ws + v * VEC, pf + base + (size_t)r * P + v * VEC);
    }
  for (int c = tid; c < ws; c += THREADS) {
    max_s[c] = ordered(__float_as_int(-INFINITY));
    cnt_s[c] = 0;
  }
  if (RESIDENT) cp_async_wait_all();
  __syncthreads();
  const bool loads = in_row && lane < nvec;   // this thread's vector lies in the group's window
  auto pf_vec = [&](int r) -> uint4 {
    if (RESIDENT) return *reinterpret_cast<const uint4*>(slice + (size_t)r * ws + lane * VEC);
    return *reinterpret_cast<const uint4*>(pf + base + (size_t)r * P + lane * VEC);
  };

  // pass 1: each column's max over the rows and how many rows reach it
  {
    float m[VEC];
    int cnt[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = -INFINITY, cnt[i] = 0;
    if (loads)
      for (int r = row0; r < HW; r += rows_step) {
        float p[VEC];
        unpack<T, VEC>(pf_vec(r), p);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const bool gt = p[i] > m[i];
          cnt[i] = gt ? 1 : cnt[i] + (p[i] == m[i]);
          m[i] = gt ? p[i] : m[i];
        }
      }
    // the rows of a warp meet in its first row's lanes (sv lanes apart) ...
    for (int k = 1; k < per_warp; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float om = __shfl_down_sync(0xffffffffu, m[i], k * sv);
        const int oc = __shfl_down_sync(0xffffffffu, cnt[i], k * sv);
        if (slot == 0) {
          cnt[i] = om > m[i] ? oc : om == m[i] ? cnt[i] + oc : cnt[i];
          m[i] = fmaxf(m[i], om);
        }
      }
    // ... and the warps in shared memory: the max first, then the ties at it
    const bool first = slot == 0 && loads;
    if (first)
#pragma unroll
      for (int i = 0; i < VEC; ++i) atomicMax(&max_s[lane * VEC + i], ordered(__float_as_int(m[i])));
    __syncthreads();
    if (first)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (ordered(__float_as_int(m[i])) == max_s[lane * VEC + i])
          atomicAdd(&cnt_s[lane * VEC + i], cnt[i]);
  }
  __syncthreads();
  for (int c = tid; c < ws; c += THREADS) {
    const bool in = c >= off && c < off + ncols;
    const float route = in ? g_pooled[(size_t)b * P + a0 + c] / (float)max(cnt_s[c], 1) : 0.f;
    max_s[c] = ordered(max_s[c]);          // the max's own bits
    cnt_s[c] = __float_as_int(route);
  }
  __syncthreads();

  // this thread's columns: window columns v0 .. v0 + VEC - 1, of which [lo,
  // hi) are the group's; node ids relative to the group (-1 before it, a
  // large id after it), so out-of-group columns form segments of their own
  const int v0 = lane * VEC;
  const int lo = min(max(off - v0, 0), VEC), hi = max(min(off + ncols - v0, VEC), lo);
  float mx[VEC], rt[VEC];
  int node[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mx[i] = __int_as_float(max_s[v0 + i]);
    rt[i] = __int_as_float(cnt_s[v0 + i]);
    node[i] = i < lo ? -1 : i >= hi ? 1 << 20 : (v0 + i - off) / width;
  }
  const bool active = in_row && lo < hi;
  const int n_lo = active ? (v0 + lo - off) / width : -2;
  const int n_hi = active ? (v0 + hi - 1 - off) / width : -2;
  // lanes to the right that hold part of node n_hi, to the left of n_lo
  // (all in this row's team)
  const int right_len = active ? (off + (n_hi + 1) * width - 1) / VEC - lane : 0;
  const int left_len = active ? lane - (off + n_lo * width) / VEC : 0;
  const int chain = (width + 2 * VEC - 2) / VEC - 1;   // most lanes a node spans, less one

  // pass 2: g_tot, the per-(row, node) sums and dz
  const T* gb = g_pf ? g_pf + base : nullptr;
  T* dzb = dz + base;
  // a part of a wide node: its rows' sums in inner[row * G + g], the node's
  // parts g0 .. g0 + parts - 1; the part's first lane writes them
  float* inner_b = MODE == WHOLE ? nullptr : inner + (size_t)b * HW * G;
  const int g_self = blockIdx.x, g0 = MODE == WHOLE ? 0 : g_self - rec[4];
  const int parts = MODE == WHOLE ? 1 : rec[5];
  const bool first_lane = lane == off / VEC;
  // g_pf (and pf, when it is not resident) of the next UNROLL rows is in
  // flight while these are computed
  constexpr int PF = RESIDENT ? 1 : UNROLL;
  auto load_next = [&](int r0, uint4 (&graw)[UNROLL], uint4 (&praw)[PF]) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * rows_step + row0;
      const bool ok = loads && r < HW;
      graw[u] = make_uint4(0, 0, 0, 0);
      if (gb && ok) graw[u] = __ldcs(reinterpret_cast<const uint4*>(gb + (size_t)r * P + v0));
      if constexpr (!RESIDENT) praw[u] = ok ? pf_vec(r) : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 gcur[UNROLL], gnext[UNROLL], pcur[PF], pnext[PF];
  load_next(0, gcur, pcur);
  for (int r0 = 0; r0 < HW; r0 += rows_step * UNROLL) {
    if (r0 + rows_step * UNROLL < HW) load_next(r0 + rows_step * UNROLL, gnext, pnext);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * rows_step + row0;
      float p[VEC], g[VEC], run[VEC], tot[VEC];
      if constexpr (RESIDENT)
        unpack<T, VEC>(loads && r < HW ? pf_vec(r) : make_uint4(0, 0, 0, 0), p);
      else
        unpack<T, VEC>(pcur[u], p);
      unpack<T, VEC>(gcur[u], g);
      // g_tot, its products with pf, and their running sum within each node
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        g[i] += p[i] == mx[i] ? rt[i] : 0.f;
        const float prod = i >= lo && i < hi ? g[i] * p[i] : 0.f;
        run[i] = (i > 0 && node[i] == node[i - 1] ? run[i - 1] : 0.f) + prod;
      }
      // each column's node total over this thread's columns
#pragma unroll
      for (int i = VEC - 1; i >= 0; --i)
        tot[i] = i < VEC - 1 && node[i + 1] == node[i] ? tot[i + 1] : run[i];
      float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (i == lo) s_lo = tot[i];
        if (i == hi - 1) s_hi = run[i];
      }
      // the partials of n_hi from the lanes to the right, of n_lo from the left
      float right = 0.f, left = 0.f;
      for (int k = 1; k <= chain; ++k) {
        const float x = __shfl_down_sync(0xffffffffu, s_lo, k);
        const float y = __shfl_up_sync(0xffffffffu, s_hi, k);
        if (k <= right_len) right += x;
        if (k <= left_len) left += y;
      }
      if constexpr (MODE == STATS) {
        // the part is one segment: its first lane's sum is s_lo plus the
        // partials to its right
        if (active && first_lane && r < HW) inner_b[(size_t)r * G + g_self] = s_lo + right;
        continue;
      }
      float node_sum = 0.f;     // FINAL: the sum over every part of the node
      if constexpr (MODE == FINAL)
        if (active && r < HW)
          for (int k = 0; k < parts; ++k) node_sum += inner_b[(size_t)r * G + g0 + k];
      float d[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float sum = MODE == FINAL ? node_sum
                          : tot[i] + (node[i] == n_lo ? left : 0.f) + (node[i] == n_hi ? right : 0.f);
        d[i] = p[i] * (g[i] - sum) * inv_tau;
      }
      if (active && r < HW) store_vec<T, VEC>(dzb + (size_t)r * P + v0, d, lo, hi);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) gcur[u] = gnext[u];
#pragma unroll
    for (int u = 0; u < PF; ++u) pcur[u] = pnext[u];
  }
}

// dynamic shared memory of a block: the per-column tables, and the slice
// of sv vectors a row when RESIDENT
template <typename T>
size_t smem_bytes(int HW, int sv, bool resident) {
  return (size_t)sv * (16 / sizeof(T)) * 8 + (resident ? (size_t)HW * sv * 16 : 0);
}

constexpr size_t SMEM_MAX = 232448;   // a block's shared memory on sm_90

template <typename T, bool RESIDENT, int MODE>
cudaError_t launch_kernel(const void* pf, const void* g_pf, const float* g_pooled,
                          const int* groups, int G, float* inner, void* dz, int B, int HW, int P,
                          int sv, float inv_tau, cudaStream_t s) {
  auto kernel = head_backward_kernel<T, RESIDENT, MODE>;
  const size_t bytes = smem_bytes<T>(HW, sv, RESIDENT);
  if (bytes > 48 * 1024) {           // above 48 KB only once allowed, on the current device;
    // the whole carveout as shared memory, so that two resident slices share an SM
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(G, B), THREADS, bytes, s>>>(static_cast<const T*>(pf),
                                            static_cast<const T*>(g_pf), g_pooled, groups, inner,
                                            static_cast<T*>(dz), HW, P, G, sv, inv_tau);
  return cudaGetLastError();
}

// pf kept in shared memory where its slice fits, else read twice
template <typename T, int MODE>
cudaError_t launch_mode(const void* pf, const void* g_pf, const float* g_pooled,
                        const int* groups, int G, float* inner, void* dz, int B, int HW, int P,
                        int sv, float inv_tau, cudaStream_t s) {
  if (smem_bytes<T>(HW, sv, true) <= SMEM_MAX)
    return launch_kernel<T, true, MODE>(pf, g_pf, g_pooled, groups, G, inner, dz, B, HW, P, sv,
                                        inv_tau, s);
  return launch_kernel<T, false, MODE>(pf, g_pf, g_pooled, groups, G, inner, dz, B, HW, P, sv,
                                       inv_tau, s);
}

// STATS and FINAL over the parts of wide nodes, then WHOLE over the rest
template <typename T>
cudaError_t launch(const void* pf, const void* g_pf, const float* g_pooled, const int* whole,
                   int Gw, const int* wide, int Gp, float* inner, void* dz, int B, int HW, int P,
                   int sv, float inv_tau, cudaStream_t s) {
  if (sv < 1 || sv > 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (Gp)
    err = launch_mode<T, STATS>(pf, g_pf, g_pooled, wide, Gp, inner, dz, B, HW, P, sv, inv_tau, s);
  if (Gp && err == cudaSuccess)
    err = launch_mode<T, FINAL>(pf, g_pf, g_pooled, wide, Gp, inner, dz, B, HW, P, sv, inv_tau, s);
  if (Gw && err == cudaSuccess)
    err = launch_mode<T, WHOLE>(pf, g_pf, g_pooled, whole, Gw, inner, dz, B, HW, P, sv, inv_tau, s);
  return err;
}

}  // namespace

extern "C" {

// pf, g_pf, dz (B, HW, P) with P * sizeof(dtype) a multiple of 16 and
// 16-byte aligned bases; whole (Gw groups) and wide (Gp parts of wide
// nodes) from ops/fused_head.py::backward_plan and split_plan, whose groups
// each fit `sv` 16-byte vectors from the boundary at or below their start
// (1 <= sv <= 32); inner: (B * HW, Gp) f32 scratch.  dtype: 0 = float32,
// 1 = bfloat16; g_pf may be null.  Launches on `stream`; returns the CUDA
// error code so a refused launch is reported.
int pipnet_head_backward(const void* pf, const void* g_pf, const void* g_pooled,
                         const void* whole, int Gw, const void* wide, int Gp, void* inner,
                         void* dz, int B, int HW, int P, int sv, float tau, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g_pooled);
  const int* gw = static_cast<const int*>(whole);
  const int* gx = static_cast<const int*>(wide);
  float* in = static_cast<float*>(inner);
  if (B == 0 || HW == 0 || Gw + Gp == 0) return 0;
  const float inv_tau = 1.0f / tau;
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(pf, g_pf, gp, gw, Gw, gx, Gp, in, dz, B, HW, P, sv, inv_tau, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(pf, g_pf, gp, gw, Gw, gx, Gp, in, dz, B, HW, P, sv, inv_tau, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

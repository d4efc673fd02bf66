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
// What bounds it.  The two views' products: at the flagship train step (64
// pairs, HW=676, D=768, 3780 real columns, bf16) 2*128*676*768*3780 =
// 502 GFLOP, 0.51 ms at the 989 TFLOP/s bf16 dense peak; the bytes (F
// 133 MB, K 5.9 MB, outputs 2 MB) take 0.04 ms.
//
// bf16 design: K1's Hopper core (head_tile.cuh, namespace hopper) over
// items (one column group of whole nodes <= 128 columns, image pair).  Each
// ring stage holds both views' 128-row F tiles and one 64 x 128 K tile, so
// the two views share every K load; each consumer warpgroup runs two
// wgmma m64n128k16 per 16-deep step (one per view, 64 f32 registers each),
// then the per-node softmax of both on the registers and both column
// maxima, and forms each (row, node) inner product by the same segmented
// sums.  The log terms of a row tile go to a shared table and one thread per
// node adds them in row order, so logsum is the same on every run (a float
// atomicAdd would not be).  mma.sync tiles fed by scalar loads that every
// 32-deep step waited on, with a serial shared-memory softmax and inner
// product, ran 27x this bound.
//
// f32 keeps the SIMT tile of head_tile.cuh: one block per (column group
// <= 128 columns, pair), both views' softmaxed tiles in 66 KB of dynamic
// shared memory.
//
// Nodes wider than the tile (flat PIP-Net's 768 prototypes) come as parts
// (head_tile.cuh).  A STATS launch writes both views' (max, sum) a row and
// part; a FINAL launch recomputes the products, normalises both views by the
// merged node statistics, takes the column maxima and writes each row's
// inner product over the part to `ip` (B * HW, G); a third launch
// (nopf_wide_logsum) adds a row's parts, takes the log and sums the rows in
// a fixed order.  Groups of whole nodes take the WHOLE launch.

#include "head_tile.cuh"

namespace {

// K2's wgmma width: one column group of up to 128 columns, per view
using K2Plan = hopper::Plan<hopper::HALF, 2>;

constexpr int F32_SMEM = head_tile::Z_BYTES + (head_tile::STAGE_BYTES > head_tile::Z_BYTES
                                                   ? head_tile::STAGE_BYTES
                                                   : head_tile::Z_BYTES);

// groups: G records of GF ints (head_tile.cuh); width 0 marks the padded
// tail.  STATS and FINAL run over parts of wide nodes: stats (2B * HW, G)
// holds each view-image row's (max, sum) a part, ip (B * HW, G) each pair
// row's inner product over a part.
template <int MODE>
__global__ void __launch_bounds__(head_tile::THREADS)
fused_head_nopf_f32(const float* __restrict__ F, const float* __restrict__ K,
                    const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                    const int* __restrict__ proto_node, float2* __restrict__ stats,
                    float* __restrict__ ip_parts, float* __restrict__ pooled,
                    float* __restrict__ logsum, int B, int HW, int D, int P, int N, int G,
                    float tau, float eps) {
  using namespace head_tile;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* Z1 = reinterpret_cast<float*>(dyn);        // view 1's softmaxed tile
  unsigned char* stage = dyn + Z_BYTES;             // the product's staging tiles
  float* Z2 = reinterpret_cast<float*>(stage);      // view 2's tile aliases them
  __shared__ uint8_t valid_s[TN];

  const int tid = threadIdx.x, g = blockIdx.x;
  const int* rec = groups + GF * g;
  const int c0 = rec[0], ncols = rec[1];
  const int width = MODE == WHOLE ? rec[2] : rec[2] ? ncols : 0;   // a part: one segment
  const int b = blockIdx.y;
  float* pooled1 = pooled + (size_t)b * P + c0;
  float* pooled2 = pooled + (size_t)(B + b) * P + c0;

  if (width == 0) {   // padded tail beyond the last bucket
    if (MODE != STATS && tid < ncols) pooled1[tid] = pooled2[tid] = 0.f;
    return;
  }
  // a part's statistics: view 1's rows of image b, view 2's of image B + b
  const int g0 = g - rec[4], parts = rec[5];

  if (tid < TN) valid_s[tid] = tid < ncols ? valid[c0 + tid] : 0;
  const int nodes = ncols / width;
  const float* F1 = F + (size_t)b * HW * D;
  const float* F2 = F + (size_t)(B + b) * HW * D;
  float colmax1 = 0.f, colmax2 = 0.f;   // pf >= 0, every column sees a row
  float node_log = 0.f;                 // thread n < nodes: node n's sum

  for (int r0 = 0; r0 < HW; r0 += TM) {
    const int rows = min(TM, HW - r0);
    z_tile(F1, K, r0, HW, D, P, c0, ncols, tau, stage, Z1);
    __syncthreads();
    if (MODE == WHOLE)
      softmax_rows(Z1, valid_s, rows, nodes, width);
    else
      wide_rows<MODE>(Z1, valid_s, rows, ncols, stats + ((size_t)b * HW + r0) * G, G, g, g0,
                      parts);
    z_tile(F2, K, r0, HW, D, P, c0, ncols, tau, stage, Z2);   // syncs inside
    __syncthreads();
    if (MODE == WHOLE)
      softmax_rows(Z2, valid_s, rows, nodes, width);
    else
      wide_rows<MODE>(Z2, valid_s, rows, ncols, stats + ((size_t)(B + b) * HW + r0) * G, G, g,
                      g0, parts);
    __syncthreads();
    if (MODE == STATS) continue;   // the next tile's staging overwrites Z2 after this barrier

    if (tid < ncols)
      for (int r = 0; r < rows; ++r) {
        colmax1 = fmaxf(colmax1, Z1[r * ZLD + tid]);
        colmax2 = fmaxf(colmax2, Z2[r * ZLD + tid]);
      }
    __syncthreads();   // the log terms below overwrite Z1

    if (MODE == FINAL) {   // each row's inner product over the part
      for (int r = tid; r < rows; r += THREADS) {
        float ip = 0.f;
        for (int s = 0; s < ncols; ++s) ip += Z1[r * ZLD + s] * Z2[r * ZLD + s];
        ip_parts[((size_t)b * HW + r0 + r) * G + g] = ip;
      }
      __syncthreads();
      continue;
    }
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
  if (MODE != STATS && tid < ncols) {
    pooled1[tid] = colmax1;
    pooled2[tid] = colmax2;
  }
  if (MODE == WHOLE && tid < nodes) logsum[(size_t)b * N + proto_node[c0 + tid * width]] = node_log;
}

// groups: G records of GF ints (head_tile.cuh), each inside a 128-column
// tile that starts on a multiple of 8 columns, at most NMAX nodes.  STATS
// and FINAL run over parts of wide nodes (stats, ip as in fused_head_nopf_f32).
template <int MODE>
__global__ void __launch_bounds__(hopper::THREADS, 1)
fused_head_nopf_bf16(const __grid_constant__ CUtensorMap tmF,
                     const __grid_constant__ CUtensorMap tmK, const uint8_t* __restrict__ valid,
                     const int* __restrict__ groups, const int* __restrict__ proto_node,
                     float2* __restrict__ stats, float* __restrict__ ip_parts,
                     float* __restrict__ pooled, float* __restrict__ logsum, int B, int HW,
                     int P, int N, int G, int KT, float inv_tau, float eps) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K2Plan::BARS);
  uint64_t* empty = full + STAGES;
  uint32_t* colmax_s = reinterpret_cast<uint32_t*>(sm + K2Plan::COLMAX);   // [2][128]
  float* nodesum = reinterpret_cast<float*>(sm + K2Plan::NODESUM);        // [2][NMAX]
  uint8_t* valid_s = sm + K2Plan::VALID;
  uint8_t* touch_s = sm + K2Plan::TOUCH;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < COLRED; i += THREADS) colmax_s[i] = 0;
  if (tid < 2 * NMAX) nodesum[tid] = 0.f;
  __syncthreads();

  const int RT = (HW + BM - 1) / BM, items = G * B;
  if (wg == 2) {   // producer
    setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      Ring ring;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = it / G, g = it - b * G;
        if (groups[GF * g + 2] == 0) continue;
        const int c0 = groups[GF * g] & ~7;   // TMA: a 16-byte aligned start
        for (int rt = 0; rt < RT; ++rt)
          for (int kt = 0; kt < KT; ++kt) {
            mbar_wait(&empty[ring.stage], ring.phase ^ 1);
            uint8_t* st = sm + ring.stage * K2Plan::STAGE;
            mbar_expect_tx(&full[ring.stage], K2Plan::STAGE);
            tma_load_2d(st, &tmF, &full[ring.stage], kt * BK, b * HW + rt * BM);
            tma_load_2d(st + A_BYTES, &tmF, &full[ring.stage], kt * BK, (B + b) * HW + rt * BM);
#pragma unroll
            for (int a = 0; a < K2Plan::NB; ++a)
              tma_load_2d(st + 2 * A_BYTES + a * ATOM_BYTES, &tmK, &full[ring.stage],
                          c0 + 64 * a, kt * BK);
            ring.advance();
          }
      }
    }
  } else {         // consumers
    setmaxnreg_inc<240>();
    const int t = tid & 127, lane = t & 31, q = lane & 3;
    const int rr0 = (t >> 5) * 16 + (lane >> 2);   // the warpgroup's row of h = 0
    float* part = reinterpret_cast<float*>(sm + K2Plan::PART) + wg * 64 * PLD;
    float* comb = reinterpret_cast<float*>(sm + K2Plan::COMB) + wg * 64 * CLD;
    float* logs = reinterpret_cast<float*>(sm + K2Plan::LOGS) + wg * 64 * CLD;
    Ring ring;
    float acc1[FR], acc2[FR];
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / G, g = it - b * G;
      const int* rec = groups + GF * g;
      const int c0 = rec[0], ncols = rec[1];
      const int width = MODE == WHOLE ? rec[2] : rec[2] ? ncols : 0;   // a part: one segment
      if (width == 0) {   // padded tail beyond the last bucket
        if (MODE == STATS) continue;
        if (tid < ncols) pooled[(size_t)b * P + c0 + tid] = 0.f;
        else if (tid >= 128 && tid - 128 < ncols) pooled[(size_t)(B + b) * P + c0 + tid - 128] = 0.f;
        continue;
      }
      const int nodes = ncols / width, shift = c0 & 7;
      if (tid < K2Plan::NB * 64)
        valid_s[tid] = tid >= shift && tid - shift < ncols ? valid[c0 - shift + tid] : 0;
      if (tid < nodes) touch_s[tid] = touch_mask(tid, width, shift);
      named_bar(1, CONSUMERS);
      const uint32_t magic = node_magic(width);
      const int base = 2 * q - shift;
      const Frag fr = make_frag(base, shift, ncols, magic, valid_s);

      for (int rt = 0; rt < RT; ++rt) {
        const int r_wg = rt * BM + wg * 64;   // the warpgroup's first row
        consume_tile(ring, full, empty, sm, K2Plan::STAGE, KT, lane,
                     [&](uint32_t st, int kt) {
                       fence_regs(acc1);
                       fence_regs(acc2);
#pragma unroll
                       for (int k = 0; k < BK / 16; ++k) {
                         const uint64_t kb = desc_b(st + 2 * A_BYTES, k);
                         wgmma_m64n128k16(acc1, desc_a(st + wg * (A_BYTES / 2), k), kb,
                                          (kt | k) != 0);
                         wgmma_m64n128k16(acc2, desc_a(st + A_BYTES + wg * (A_BYTES / 2), k),
                                          kb, (kt | k) != 0);
                       }
                     });
        if (r_wg >= HW) continue;   // the warpgroup's rows all lie past HW
        fence_regs(acc1);
        fence_regs(acc2);
        // a part's statistics: view 1's rows of image b, view 2's of image B + b
        WideRows w1{}, w2{};
        if (MODE != WHOLE) {
          w1 = {stats, G, g, g - rec[4], rec[5], (long long)b * HW + r_wg, HW - r_wg};
          w2 = w1;
          w2.row0 = (long long)(B + b) * HW + r_wg;
        }
        softmax_frag<MODE>(acc1, fr, q, base, magic, rr0, part, comb, touch_s, nodes, t,
                           2 + wg, inv_tau, w1);
        softmax_frag<MODE>(acc2, fr, q, base, magic, rr0, part, comb, touch_s, nodes, t,
                           2 + wg, inv_tau, w2);
        if (MODE == STATS) continue;
        const bool ok0 = r_wg + rr0 < HW, ok1 = r_wg + rr0 + 8 < HW;
        colmax_rows(acc1, fr, ok0, ok1, base, lane, colmax_s);
        colmax_rows(acc2, fr, ok0, ok1, base, lane, colmax_s + HALF);
        // each (row, node)'s inner product of the two views, by segmented sums
        const uint32_t part0 = smem_u32(part + rr0 * PLD + q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float run = 0.f;
#pragma unroll
          for (int b2 = 0; b2 < 2 * FJ; ++b2)
            seg_step<false>(run, acc1[frag_idx(b2, h)] * acc2[frag_idx(b2, h)], fr, 1u << b2,
                            base, col_off(b2), magic, part0 + 8 * h * PLD * 4);
        }
        named_bar(2 + wg, 128);
        if (MODE == FINAL) {   // each row's inner product over the part
          if (t < 64 && r_wg + t < HW) {
            const float* p = part + t * PLD;
            const uint32_t tm = touch_s[0];
            float ip = 0.f;
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
              if ((tm >> qq) & 1) ip += p[qq];
            ip_parts[((size_t)b * HW + r_wg + t) * G + g] = ip;
          }
          named_bar(2 + wg, 128);   // the next tile's scans rewrite the partials
          continue;
        }
        // each (row, node)'s log term; rows past HW add nothing
        for (int idx = t; idx < 64 * nodes; idx += 128) {
          const int r = idx / nodes, n = idx - r * nodes;
          const float* p = part + r * PLD + n * 4;
          const uint32_t tm = touch_s[n];
          float ip = 0.f;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            if ((tm >> qq) & 1) ip += p[qq];
          logs[r * CLD + n] = r_wg + r < HW ? logf(ip + eps) : 0.f;
        }
        named_bar(2 + wg, 128);
        if (t < nodes) {
          float s = nodesum[wg * NMAX + t];
          for (int r = 0; r < 64; ++r) s += logs[r * CLD + t];
          nodesum[wg * NMAX + t] = s;
        }
      }
      named_bar(1, CONSUMERS);
      if (MODE == STATS) continue;
      if (tid < ncols) {
        pooled[(size_t)b * P + c0 + tid] = __uint_as_float(colmax_s[tid]);
        colmax_s[tid] = 0;
      } else if (tid >= 128 && tid - 128 < ncols) {
        pooled[(size_t)(B + b) * P + c0 + tid - 128] = __uint_as_float(colmax_s[tid]);
        colmax_s[tid] = 0;
      }
      if (MODE == WHOLE && tid < nodes) {
        logsum[(size_t)b * N + proto_node[c0 + tid * width]] = nodesum[tid] + nodesum[NMAX + tid];
        nodesum[tid] = nodesum[NMAX + tid] = 0.f;
      }
    }
  }
}

// logsum[b, n] = sum_hw log(sum_k ip[b, hw, part k of n] + eps) for every wide
// node n (one block per node's first part and pair; other groups exit), the
// rows added in a fixed order, so logsum is the same on every run.
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
nopf_wide_logsum(const int* __restrict__ groups, const int* __restrict__ proto_node,
                 const float* __restrict__ ip_parts, float* __restrict__ logsum, int HW, int N,
                 int G, float eps) {
  __shared__ float red[REDUCE_THREADS];
  const int* rec = groups + GF * blockIdx.x;
  if (rec[2] == 0 || rec[4] != 0) return;   // the padded tail, or not a node's first part
  const int b = blockIdx.y, parts = rec[5], tid = threadIdx.x;
  float acc = 0.f;
  for (int r = tid; r < HW; r += REDUCE_THREADS) {
    const float* row = ip_parts + ((size_t)b * HW + r) * G + blockIdx.x;
    float ip = 0.f;
    for (int k = 0; k < parts; ++k) ip += row[k];
    acc += logf(ip + eps);
  }
  red[tid] = acc;
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) logsum[(size_t)b * N + proto_node[rec[0]]] = red[0];
}

template <int MODE>
cudaError_t launch_f32(const void* features, const void* kernel, const void* valid,
                       const int* groups, int G, const int* proto_node, float2* stats, float* ip,
                       void* pooled, void* logsum, int B, int HW, int D, int P, int N, float tau,
                       float eps, cudaStream_t s) {
  auto k = fused_head_nopf_f32<MODE>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  if (err != cudaSuccess) return err;
  k<<<dim3(G, B), head_tile::THREADS, F32_SMEM, s>>>(
      static_cast<const float*>(features), static_cast<const float*>(kernel),
      static_cast<const uint8_t*>(valid), groups, proto_node, stats, ip,
      static_cast<float*>(pooled), static_cast<float*>(logsum), B, HW, D, P, N, G, tau, eps);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bf16(const CUtensorMap& tmF, const CUtensorMap& tmK, const void* valid,
                        const int* groups, int G, const int* proto_node, float2* stats, float* ip,
                        void* pooled, void* logsum, int B, int HW, int D, int P, int N, float tau,
                        float eps, cudaStream_t s) {
  int grid = 0;
  cudaError_t err = hopper::persistent_grid<fused_head_nopf_bf16<MODE>>(K2Plan::BYTES, G * B,
                                                                         &grid);
  if (err != cudaSuccess) return err;
  fused_head_nopf_bf16<MODE><<<grid, hopper::THREADS, K2Plan::BYTES, s>>>(
      tmF, tmK, static_cast<const uint8_t*>(valid), groups, proto_node, stats, ip,
      static_cast<float*>(pooled), static_cast<float*>(logsum), B, HW, P, N, G,
      (D + hopper::BK - 1) / hopper::BK, 1.0f / tau, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B is the number of image pairs (features hold 2B images).  whole (Gw
// groups of whole nodes, maybe the padded tail) and wide (Gp parts of wide
// nodes, maybe the tail) are plans of GF ints a group (ops/fused_head.py::
// split_plan); either may be empty.  stats (2B * HW, Gp) float2 and ip
// (B * HW, Gp) f32 are scratch for the parts.  dtype: 0 = float32 (groups
// of <= 128 columns), 1 = bfloat16 (groups of <= 16 nodes, each inside a
// 128-column tile that starts on a multiple of 8 columns; D and P multiples
// of 8, 16-byte aligned features and kernel, for TMA).  Launches on `stream`
// (STATS, FINAL and the log sums over the parts, then WHOLE); returns the
// CUDA error code so a refused launch is reported to the caller.
int pipnet_fused_head_nopf_forward(const void* features, const void* kernel,
                                   const void* valid, const void* whole, int Gw,
                                   const void* wide, int Gp, const void* proto_node,
                                   void* stats, void* ip, void* pooled, void* logsum, int B,
                                   int HW, int D, int P, int N, float tau, float eps, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gw = static_cast<const int*>(whole);
  const int* gp = static_cast<const int*>(wide);
  const int* pn = static_cast<const int*>(proto_node);
  float2* st = static_cast<float2*>(stats);
  float* ipp = static_cast<float*>(ip);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    if (Gp)
      err = launch_f32<STATS>(features, kernel, valid, gp, Gp, pn, st, ipp, pooled, logsum, B,
                              HW, D, P, N, tau, eps, s);
    if (Gp && err == cudaSuccess)
      err = launch_f32<FINAL>(features, kernel, valid, gp, Gp, pn, st, ipp, pooled, logsum, B,
                              HW, D, P, N, tau, eps, s);
    if (Gw && err == cudaSuccess)
      err = launch_f32<WHOLE>(features, kernel, valid, gw, Gw, pn, st, ipp, pooled, logsum, B,
                              HW, D, P, N, tau, eps, s);
  } else if (dtype == 1) {
    CUtensorMap tmF, tmK;
    err = hopper::bf16_map(&tmF, features, D, (uint64_t)2 * B * HW, hopper::BK, hopper::BM);
    if (err == cudaSuccess) err = hopper::bf16_map(&tmK, kernel, P, D, 64, hopper::BK);
    if (Gp && err == cudaSuccess)
      err = launch_bf16<STATS>(tmF, tmK, valid, gp, Gp, pn, st, ipp, pooled, logsum, B, HW, D,
                               P, N, tau, eps, s);
    if (Gp && err == cudaSuccess)
      err = launch_bf16<FINAL>(tmF, tmK, valid, gp, Gp, pn, st, ipp, pooled, logsum, B, HW, D,
                               P, N, tau, eps, s);
    if (Gw && err == cudaSuccess)
      err = launch_bf16<WHOLE>(tmF, tmK, valid, gw, Gw, pn, st, ipp, pooled, logsum, B, HW, D,
                               P, N, tau, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Gp && err == cudaSuccess) {
    nopf_wide_logsum<<<dim3(Gp, B), REDUCE_THREADS, 0, s>>>(gp, pn, ipp,
                                                           static_cast<float*>(logsum), HW, N,
                                                           Gp, eps);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

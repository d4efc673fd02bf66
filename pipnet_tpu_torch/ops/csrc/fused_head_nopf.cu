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
// f32 design (simt_tile.cuh, shared with K1 and K4).  The products run on
// the SIMT FMA units (TF32 would miss 1e-5): 502 GFLOP at the flagship
// train step, 7.5 ms at 67 TFLOP/s; operations bound it.  One block per
// (column group <= 128 columns, row tile of PAIR_ROWS = 64 of the B * HW
// pair rows), column groups the fastest grid index (the blocks of a row
// tile share its F rows in L2), so ResNet-50's 4 pairs still make 49 row
// tiles.  The tile's 128 A rows are its 64 pair rows of view 1 over the
// same rows of view 2 (simt::product's two bases): one load of each K
// slice serves both views, and a pair row's two z rows meet in one
// shared-memory tile (128 x ZLD, over the ring; two blocks an SM).  The
// block takes the per-node softmax of all 128 rows, meets the other row
// tiles' column max in pooled by an atomicMax on the float's bits, one for
// each image its rows hold (pf >= 0; pooled is zeroed before the launch),
// and forms each (pair row, node)'s log(inner product + eps).  A tile may
// hold the end of one image and the start of the next (676 = 10 * 64 + 36):
// the log terms of each image's run of rows go, summed in row order, to
// partial[(row tile + image) * N + node] (runs of one tile hold other
// images, runs of one image other tiles, so no two runs share an index),
// and the block that counts last for an (image, group) adds that image's
// partials in row-tile order into logsum.  So logsum is the same on every
// run, and a call is one launch.  The design it replaces ran one block per
// (column group, pair) over all 676 rows on a synchronous 64-row SIMT tile:
// 120 blocks at 4 pairs, and twice the products on wide nodes.
//
// Nodes wider than the tile (flat PIP-Net's 768 prototypes) come as parts
// (head_tile.cuh).  A STATS launch writes both views' (max, sum) a row and
// part; a FINAL launch normalises both views by the merged node statistics,
// takes the column maxima and writes each pair row's inner product over the
// part to `ip` (B * HW, G); a third launch (nopf_wide_logsum) adds a row's
// parts, takes the log and sums the rows in a fixed order.  In bf16 FINAL
// recomputes the products; in f32 STATS stores its tile's z in a scratch
// (row tiles x parts x 128 x 128 f32: 266 MB at flat's 64 pairs) and FINAL
// reads it back.  Groups of whole nodes take the WHOLE launch.

#include "head_tile.cuh"
#include "simt_tile.cuh"

namespace {

// K2's wgmma width: one column group of up to 128 columns, per view
using K2Plan = hopper::Plan<hopper::HALF, 2>;

// f32: a row tile holds PAIR_ROWS pair rows, view 1's above the same rows of
// view 2; the z tile (BM x ZLD) and the log terms (PAIR_ROWS x at most TN
// nodes) lie over the product's ring, dead by then
constexpr int PAIR_ROWS = simt::BM / 2;
using F32Ring = simt::Ring<simt::B_NMAJOR>;
static_assert((simt::BM * head_tile::ZLD + PAIR_ROWS * head_tile::TN) * 4 <= F32Ring::BYTES,
              "the z tile and the log terms lie over the ring");

// float4 `i` of a z tile of BM rows of TN floats, in the shared tile (ZLD a row)
__device__ __forceinline__ float4* z4(float* Z, int i) {
  return reinterpret_cast<float4*>(Z + (i / (head_tile::TN / 4)) * head_tile::ZLD +
                                   (i % (head_tile::TN / 4)) * 4);
}

// groups: G records of GF ints (head_tile.cuh), each fitting simt::BN
// columns from c0 & ~3; width 0 marks the padded tail.  Block (g, rt): group
// g, pair rows [rt * PAIR_ROWS, (rt + 1) * PAIR_ROWS) of the B * HW.  STATS
// and FINAL run over parts of wide nodes: stats (2B * HW, G) holds each
// view-image row's (max, sum) a part, zs (row tiles, G, BM, TN) the tiles' z
// (STATS stores, FINAL reads), ip (B * HW, G) each pair row's inner product
// over a part.  WHOLE: partial (row tiles + B - 1, N) the per-node log sums
// of each (row tile, image) run, count (G, B) zero before the launch.
// pooled must be zero before the first launch.
template <int MODE>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_BLOCKS)
fused_head_nopf_f32(const float* __restrict__ F, const float* __restrict__ K,
                    const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                    const int* __restrict__ proto_node, float2* __restrict__ stats,
                    float* __restrict__ zs, float* __restrict__ ip_parts,
                    float* __restrict__ partial, int* __restrict__ count,
                    float* __restrict__ pooled, float* __restrict__ logsum, int B, int HW, int D,
                    int P, int N, int G, float tau, float eps) {
  using namespace head_tile;
  static_assert(THREADS == simt::THREADS && TN == simt::BN && THREADS == 2 * TN,
                "a thread per (view, column) takes the column maxima");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint8_t valid_s[TN];
  __shared__ int last_s;
  float* Z = reinterpret_cast<float*>(smem_raw);   // [BM][ZLD]: view 1's rows, then view 2's
  float* L = Z + simt::BM * ZLD;                   // [rows][nodes]: the log terms

  const int tid = threadIdx.x, g = blockIdx.x, rt = blockIdx.y;
  const int pair_rows = B * HW, r0 = rt * PAIR_ROWS;
  const int* rec = groups + GF * g;
  const int c0 = rec[0], ncols = rec[1];
  const int width = MODE == WHOLE ? rec[2] : rec[2] ? ncols : 0;   // a part: one segment
  if (width == 0) return;   // padded tail beyond the last bucket (pooled is already 0)
  const int rows = min(PAIR_ROWS, pair_rows - r0);

  if (tid < TN) valid_s[tid] = tid < ncols ? valid[c0 + tid] : 0;
  const int shift = c0 & 3;   // the group's first column in the tile
  float* Zg = Z + shift;
  constexpr int ZT4 = simt::BM * TN / 4;   // float4 of a stored z tile
  float4* zt =
      MODE == WHOLE ? nullptr : reinterpret_cast<float4*>(zs) + ((size_t)rt * G + g) * ZT4;
  if (MODE == FINAL) {        // z, as STATS stored it
    for (int i = tid; i < ZT4; i += THREADS) *z4(Z, i) = zt[i];
  } else {
    float acc[simt::TR][simt::TC];
    simt::product<simt::B_NMAJOR>(Z, F + (size_t)r0 * D, F + ((size_t)pair_rows + r0) * D, D,
                                  rows, rows, K + (c0 - shift), P, P - (c0 - shift), D, acc);
#pragma unroll
    for (int i = 0; i < simt::TR; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* a = acc[i] + 4 * h;
        float* z = Z + simt::frag_row(i) * ZLD + simt::frag_col<simt::B_NMAJOR>(4 * h);
        *reinterpret_cast<float4*>(z) = make_float4(a[0] / tau, a[1] / tau, a[2] / tau,
                                                    a[3] / tau);
      }
  }
  __syncthreads();

  // rows past `rows` in either half hold zeros (or STATS's copy of them):
  // softmaxed with the others, never read
  if (MODE == WHOLE) {
    softmax_rows(Zg, valid_s, simt::BM, ncols / width, width);
  } else {
    for (int r = tid; r < simt::BM; r += THREADS) {
      const int half = r / PAIR_ROWS, pr = r - half * PAIR_ROWS;   // view, pair row
      if (pr < rows)
        wide_row<MODE>(Zg + r * ZLD, valid_s, ncols,
                       stats + ((size_t)half * pair_rows + r0 + pr) * G, g, g - rec[4], rec[5]);
    }
  }
  __syncthreads();
  if (MODE == STATS) {        // z for the FINAL launch
    for (int i = tid; i < ZT4; i += THREADS) zt[i] = *z4(Z, i);
    return;
  }

  {  // each view's column max over each image's run of the tile's rows
    const int half = tid / TN, col = tid - half * TN;
    if (col < ncols) {
      const float* zc = Zg + half * PAIR_ROWS * ZLD + col;
      for (int r = 0; r < rows;) {
        const int img = (r0 + r) / HW, end = min(rows, (img + 1) * HW - r0);
        float m = 0.f;
        for (; r < end; ++r) m = fmaxf(m, zc[r * ZLD]);
        atomicMax(reinterpret_cast<int*>(pooled) + (size_t)(half * B + img) * P + c0 + col,
                  __float_as_int(m));
      }
    }
  }

  if (MODE == FINAL) {        // each pair row's inner product over the part
    for (int r = tid; r < rows; r += THREADS) {
      const float* z1 = Zg + r * ZLD;
      const float* z2 = z1 + PAIR_ROWS * ZLD;
      float ip = 0.f;
      for (int s = 0; s < ncols; ++s) ip += z1[s] * z2[s];
      ip_parts[((size_t)r0 + r) * G + g] = ip;
    }
    return;
  }

  // each (pair row, node)'s log term
  const int nodes = ncols / width;
  for (int q = tid; q < rows * nodes; q += THREADS) {
    const int r = q / nodes, n = q - r * nodes;
    const float* z1 = Zg + r * ZLD + n * width;
    const float* z2 = z1 + PAIR_ROWS * ZLD;
    float ip = 0.f;
    for (int s = 0; s < width; ++s) ip += z1[s] * z2[s];
    L[q] = logf(ip + eps);
  }
  __syncthreads();
  // each image run's per-node sums, in row order, to its partial
  const int img0 = r0 / HW, img1 = (r0 + rows - 1) / HW;
  const int node = tid < nodes ? proto_node[c0 + tid * width] : 0;
  if (tid < nodes)
    for (int img = img0; img <= img1; ++img) {
      const int end = min(rows, (img + 1) * HW - r0);
      float s = 0.f;
      for (int r = max(img * HW - r0, 0); r < end; ++r) s += L[r * nodes + tid];
      partial[((size_t)rt + img) * N + node] = s;
    }
  __threadfence();            // the partials are seen before the count that follows
  __syncthreads();
  // the last of an image's row tiles to count adds its partials in tile order
  for (int img = img0; img <= img1; ++img) {
    const int first = img * HW / PAIR_ROWS, tiles = (img * HW + HW - 1) / PAIR_ROWS - first + 1;
    if (tid == 0) {
      last_s = atomicAdd(count + (size_t)g * B + img, 1) == tiles - 1;
      __threadfence();
    }
    __syncthreads();
    if (last_s && tid < nodes) {
      float s = 0.f;
      for (int t = first; t < first + tiles; ++t)
        s += __ldcg(partial + ((size_t)t + img) * N + node);
      logsum[(size_t)img * N + node] = s;
    }
    __syncthreads();          // last_s is rewritten for the next image
  }
}

// groups: G records of GF ints (head_tile.cuh), each inside a 128-column
// tile that starts on a multiple of 8 columns, at most NMAX nodes.  STATS
// and FINAL run over parts of wide nodes: stats (2B * HW, G) holds each
// view-image row's (max, sum) a part, ip (B * HW, G) each pair row's inner
// product over a part.
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

// the f32 kernels' scratch (fused_head_nopf_f32)
struct F32Scratch {
  float2* stats;
  float* zs;
  float* ip;
  float* partial;
  int* count;
};

template <int MODE>
cudaError_t launch_f32(const void* features, const void* kernel, const void* valid,
                       const int* groups, int G, const int* proto_node, const F32Scratch& w,
                       void* pooled, void* logsum, int B, int HW, int D, int P, int N, float tau,
                       float eps, cudaStream_t s) {
  constexpr int BYTES = F32Ring::BYTES;
  const cudaError_t err = simt::raise_smem<fused_head_nopf_f32<MODE>>(BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = (B * HW + PAIR_ROWS - 1) / PAIR_ROWS;
  fused_head_nopf_f32<MODE><<<dim3(G, tiles), simt::THREADS, BYTES, s>>>(
      static_cast<const float*>(features), static_cast<const float*>(kernel),
      static_cast<const uint8_t*>(valid), groups, proto_node, w.stats, w.zs, w.ip, w.partial,
      w.count, static_cast<float*>(pooled), static_cast<float*>(logsum), B, HW, D, P, N, G, tau,
      eps);
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
// split_plan); either may be empty.  Scratch for the parts: stats (2B * HW,
// Gp) float2 and ip (B * HW, Gp) f32; in f32 also z (row tiles, Gp, 128,
// 128) f32, and for the whole-node groups partial (row tiles + B - 1, N) f32
// and count (Gw, B) int32 (ops/fused_head_nopf.py::f32_scratch_shapes; row
// tiles of 64 pair rows).  dtype: 0 = float32 (groups fitting 128 columns
// from c0 & ~3; D and P multiples of 4, 16-byte aligned features and kernel,
// for cp.async), 1 = bfloat16 (groups of <= 16 nodes, each inside a
// 128-column tile that starts on a multiple of 8 columns; D and P multiples
// of 8, 16-byte aligned features and kernel, for TMA).  Launches on `stream`
// (STATS, FINAL and the log sums over the parts, then WHOLE); returns the
// CUDA error code so a refused launch is reported to the caller.
int pipnet_fused_head_nopf_forward(const void* features, const void* kernel,
                                   const void* valid, const void* whole, int Gw,
                                   const void* wide, int Gp, const void* proto_node,
                                   void* stats, void* ip, void* z, void* partial, void* count,
                                   void* pooled, void* logsum, int B, int HW, int D, int P,
                                   int N, float tau, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gw = static_cast<const int*>(whole);
  const int* gp = static_cast<const int*>(wide);
  const int* pn = static_cast<const int*>(proto_node);
  float2* st = static_cast<float2*>(stats);
  float* ipp = static_cast<float*>(ip);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    if (D % 4 || P % 4 || reinterpret_cast<uintptr_t>(features) % 16 ||
        reinterpret_cast<uintptr_t>(kernel) % 16 || HW <= 0 ||
        (long long)B * HW > 65535LL * PAIR_ROWS)
      return static_cast<int>(cudaErrorInvalidValue);
    const F32Scratch w{st, static_cast<float*>(z), ipp, static_cast<float*>(partial),
                       static_cast<int*>(count)};
    // the row tiles meet in pooled by atomicMax over zeros, and count to
    // find each image's last tile
    err = cudaMemsetAsync(pooled, 0, (size_t)2 * B * P * sizeof(float), s);
    if (Gw && err == cudaSuccess) err = cudaMemsetAsync(count, 0, (size_t)Gw * B * sizeof(int), s);
    if (Gp && err == cudaSuccess)
      err = launch_f32<STATS>(features, kernel, valid, gp, Gp, pn, w, pooled, logsum, B, HW, D,
                              P, N, tau, eps, s);
    if (Gp && err == cudaSuccess)
      err = launch_f32<FINAL>(features, kernel, valid, gp, Gp, pn, w, pooled, logsum, B, HW, D,
                              P, N, tau, eps, s);
    if (Gw && err == cudaSuccess)
      err = launch_f32<WHOLE>(features, kernel, valid, gw, Gw, pn, w, pooled, logsum, B, HW, D,
                              P, N, tau, eps, s);
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

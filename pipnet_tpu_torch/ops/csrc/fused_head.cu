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
// come out exactly 0.  The softmax shifts by the true per-node max (not the
// Pallas kernel's tile-row max, which underflows a node whose logits sit ~87
// below another node's), clips the exponent to [-80, 60] and floors the
// denominator at 1e-18.
//
// What bounds it.  The product: at the flagship training shape (B=128,
// HW=676, D=768, 3780 real columns, bf16) 2*128*676*768*3780 = 502 GFLOP,
// 0.51 ms at the 989 TFLOP/s bf16 dense peak, against 0.21 ms for its bytes
// (F 133 MB, K 5.9 MB, pf 664 MB at 3.35 TB/s); at serving (B=8) 32 GFLOP,
// 32 us.
//
// bf16 design (head_tile.cuh, namespace hopper).  A persistent block per SM
// walks items (two consecutive column groups of whole nodes, each <= 128
// columns, of one image), image by image, so each image's F is read once per
// 256 columns (16 times at the flagship) and each K slab serves 128 rows.  A
// producer thread streams, per 128-row tile and 64-deep stage, the F tile
// and the 64 x 256 K tile (two 128-column halves, each from its group's
// 8-column aligned start) by TMA into a 3-stage ring; two consumer
// warpgroups (64 rows each) run wgmma m64n256k16 from the ring into 128 f32
// registers a thread, keeping one stage's group in flight, then per group
// the per-node softmax on those registers (segmented scans over each
// thread's columns, a shared-memory table to meet the row's other three
// threads), the column max (shuffles, then a shared-memory max on the
// float's bits: pf >= 0, so pooled needs no global atomics), and pf as
// predicated bf16 pair stores.  Rows past HW (the last tile reads the next
// image's rows or TMA's zeros) and columns outside the group are computed
// but never stored.  The epilogue does not overlap the product: both
// warpgroups finish a tile's depth loop together, so the tensor cores idle
// while they run it (PERF.md).  mma.sync tiles fed by scalar loads that
// every 32-deep step waited on, one block per (120 columns, image) and a
// serial shared-memory softmax ran 27x this bound.
//
// f32 design (simt_tile.cuh, shared with K4's f32 products).  The product
// runs on the SIMT FMA units (TF32 would miss 1e-5): at the flagship serving
// shape (B=8) 31.4 GFLOP, 0.47 ms at 67 TFLOP/s; operations bound it.  One
// block per (column group <= 128 columns, row tile of 128 of the B * HW patch
// rows), column groups the fastest grid index (the blocks of one row tile
// share its F rows in L2; K, 11.8 MB at the flagship, stays in L2), so a
// batch of 8 and flat PIP-Net's one wide node still fill the 132 SMs, and a
// tile may hold the last rows of one image and the first of the next (at
// B=8, 43 row tiles where tiles of one image would take 48).  Each block runs
// the register-tiled product (8 x 8 outputs a thread, a 3-stage cp.async
// ring of 32-deep slices of F rows and K columns, K read along its columns
// from a 16-byte aligned start c0 & ~3: the f32 plan's groups fit 128
// columns from there), writes z / tau into a shared-memory tile over the
// ring, takes the per-node softmax there (head_tile's softmax_rows), stores
// pf, and meets the other row tiles' column max in pooled by an atomicMax
// on the float's bits, one for each image its rows hold (pf >= 0; pooled is
// zeroed before the launches, and the max does not depend on the order).
// Two blocks an SM, so one block's softmax overlaps the other's product.
// What bounds it now: the tile's 55-60% of the f32 rate and, at B=8, 1376
// blocks in 5.2 waves of 264 (PERF.md).  The design it replaces ran one
// block per (column group, image) over all 676 rows, with synchronous
// staging and a 4 x 8 micro-tile, at 5-31% of its bound.
//
// Nodes wider than the tile (flat PIP-Net's 768 prototypes) come as parts
// (head_tile.cuh): a STATS launch over the parts writes each row's (max, sum)
// per part, then a FINAL launch writes the node-wide softmax, its column max
// and pf; groups of whole nodes take the WHOLE launch (the designs above).
// In bf16 FINAL recomputes the product of the parts (at the flat shape,
// B=128, 2 x 102 GFLOP): a design that keeps a row's node in registers
// cannot hold 768 f32 accumulators a row.  In f32 STATS stores z itself in
// pf (f32 too), and FINAL reads it back instead of recomputing the product:
// one 8.3 MB pass at B=8 in place of a second 6.4 GFLOP product.

#include "head_tile.cuh"
#include "simt_tile.cuh"

namespace {

// K1's wgmma width: two column groups of up to 128 columns side by side
using K1Plan = hopper::Plan<2 * hopper::HALF, 1>;

// groups: G records of GF ints (head_tile.cuh), each fitting simt::BN
// columns from c0 & ~3; width 0 marks the padded tail.  Block (g, rt): group
// g, rows [rt * BM, (rt + 1) * BM) of the B * HW patch rows.  STATS and
// FINAL run over parts of wide nodes, with their (max, sum) a row and part
// in stats (B * HW, G); STATS stores z in pf, FINAL reads it there.  pooled
// must be zero before the first launch.
template <int MODE>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_BLOCKS)
fused_head_f32(const float* __restrict__ F, const float* __restrict__ K,
               const uint8_t* __restrict__ valid, const int* __restrict__ groups,
               float2* __restrict__ stats, float* __restrict__ pf, float* __restrict__ pooled,
               int rows_total, int HW, int D, int P, int G, float tau) {
  using namespace head_tile;
  static_assert(THREADS == simt::THREADS && TN == simt::BN &&
                    simt::BM * ZLD * 4 <= simt::Ring<simt::B_NMAJOR>::BYTES,
                "the z tile lies over the ring");
  // the z tile (BM x ZLD) lies over the product's ring: dead by then
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint8_t valid_s[TN];
  float* Z = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, g = blockIdx.x, r0 = blockIdx.y * simt::BM;
  const int* rec = groups + GF * g;
  const int c0 = rec[0], ncols = rec[1];
  const int width = MODE == WHOLE ? rec[2] : rec[2] ? ncols : 0;   // a part: one segment
  const int rows = min(simt::BM, rows_total - r0);
  float* pfb = pf + (size_t)r0 * P + c0;   // the block's first pf value

  if (width == 0) {   // padded tail beyond the last bucket (pooled is already 0)
    if (MODE == STATS) return;
    for (int idx = tid; idx < rows * ncols; idx += THREADS)
      pfb[(size_t)(idx / ncols) * P + idx % ncols] = 0.f;
    return;
  }

  if (tid < TN) valid_s[tid] = tid < ncols ? valid[c0 + tid] : 0;
  const int shift = c0 & 3;   // the group's first column in the tile
  float* Zg = Z + shift;
  if (MODE == FINAL) {        // z, as STATS stored it
    for (int idx = tid; idx < rows * ncols; idx += THREADS)
      Zg[(idx / ncols) * ZLD + idx % ncols] = pfb[(size_t)(idx / ncols) * P + idx % ncols];
  } else {
    float acc[simt::TR][simt::TC];
    simt::product<simt::B_NMAJOR>(reinterpret_cast<float*>(smem_raw),
                                  F + (size_t)r0 * D, D, rows, K + (c0 - shift), P,
                                  P - (c0 - shift), D, acc);
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

  if (MODE == WHOLE)
    softmax_rows(Zg, valid_s, rows, ncols / width, width);
  else
    wide_rows<MODE>(Zg, valid_s, rows, ncols, stats + (size_t)r0 * G, G, g,
                    g - rec[4], rec[5]);
  __syncthreads();

  // STATS: z for the FINAL launch; otherwise pf and the column max
  for (int idx = tid; idx < rows * ncols; idx += THREADS)
    pfb[(size_t)(idx / ncols) * P + idx % ncols] = Zg[(idx / ncols) * ZLD + idx % ncols];
  if (MODE != STATS && tid < ncols)
    for (int r = 0; r < rows;) {   // the tile's rows of each image
      const int img = (r0 + r) / HW, end = min(rows, (img + 1) * HW - r0);
      float m = 0.f;
      for (; r < end; ++r) m = fmaxf(m, Zg[r * ZLD + tid]);
      atomicMax(reinterpret_cast<int*>(pooled) + (size_t)img * P + c0 + tid, __float_as_int(m));
    }
}

// groups: G records of GF ints (head_tile.cuh), each inside a 128-column
// tile that starts on a multiple of 8 columns, at most NMAX nodes; an item
// is two consecutive groups (the second may be missing) of one image.
// STATS and FINAL run over parts of wide nodes (stats as in fused_head_f32).
template <int MODE>
__global__ void __launch_bounds__(hopper::THREADS, 1)
fused_head_bf16(const __grid_constant__ CUtensorMap tmF, const __grid_constant__ CUtensorMap tmK,
                const uint8_t* __restrict__ valid, const int* __restrict__ groups,
                float2* __restrict__ stats, __nv_bfloat16* __restrict__ pf,
                float* __restrict__ pooled, int B, int HW, int P, int G, int KT, float inv_tau) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + K1Plan::BARS);
  uint64_t* empty = full + STAGES;
  uint32_t* colmax_s = reinterpret_cast<uint32_t*>(sm + K1Plan::COLMAX);   // [2][HALF]
  uint8_t* valid_s = sm + K1Plan::VALID;                                   // [2][HALF]
  uint8_t* touch_s = sm + K1Plan::TOUCH;                                   // [2][NMAX]

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < COLRED; i += THREADS) colmax_s[i] = 0;
  __syncthreads();

  // group g's (start, ncols, width); past the last group an empty one
  auto group = [&](int g, int k) { return g < G ? groups[GF * g + k] : 0; };
  const int pairs = (G + 1) / 2, RT = (HW + BM - 1) / BM, items = pairs * B;
  if (wg == 2) {   // producer
    setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      Ring ring;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = it / pairs, g = 2 * (it - b * pairs);
        if (group(g, 2) == 0 && group(g + 1, 2) == 0) continue;
        // TMA: each half of the K tile starts on a 16-byte aligned column
        const int k0 = group(g, 0) & ~7, k1 = group(g + 1, 0) & ~7;
        for (int rt = 0; rt < RT; ++rt)
          for (int kt = 0; kt < KT; ++kt) {
            mbar_wait(&empty[ring.stage], ring.phase ^ 1);
            uint8_t* st = sm + ring.stage * K1Plan::STAGE;
            mbar_expect_tx(&full[ring.stage], K1Plan::STAGE);
            tma_load_2d(st, &tmF, &full[ring.stage], kt * BK, b * HW + rt * BM);
#pragma unroll
            for (int a = 0; a < K1Plan::NB; ++a)
              tma_load_2d(st + A_BYTES + a * ATOM_BYTES, &tmK, &full[ring.stage],
                          (a < 2 ? k0 : k1) + 64 * (a & 1), kt * BK);
            ring.advance();
          }
      }
    }
  } else {         // consumers
    setmaxnreg_inc<240>();
    const int t = tid & 127, lane = t & 31, q = lane & 3;
    const int rr0 = (t >> 5) * 16 + (lane >> 2);   // the warpgroup's row of h = 0
    float* part = reinterpret_cast<float*>(sm + K1Plan::PART) + wg * 64 * PLD;
    float* comb = reinterpret_cast<float*>(sm + K1Plan::COMB) + wg * 64 * CLD;
    Ring ring;
    float acc[2 * FR];   // the two groups' fragments: acc[0, FR) and acc[FR, 2 FR)
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / pairs, g = 2 * (it - b * pairs);
      int c0[2], ncols[2], width[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        c0[hf] = group(g + hf, 0);
        ncols[hf] = group(g + hf, 1);
        width[hf] = group(g + hf, 2);
        if (MODE != WHOLE && width[hf]) width[hf] = ncols[hf];   // a part: one segment
        if (width[hf] == 0 && MODE != STATS) {   // the padded tail, or no group
          __nv_bfloat16* z = pf + (size_t)b * HW * P + c0[hf];
          for (int idx = tid; idx < HW * ncols[hf]; idx += CONSUMERS)
            z[(size_t)(idx / ncols[hf]) * P + idx % ncols[hf]] = __float2bfloat16(0.f);
          if (tid < ncols[hf]) pooled[(size_t)b * P + c0[hf] + tid] = 0.f;
        }
      }
      if (width[0] == 0 && width[1] == 0) continue;
      // the tile column of group column 0 is shift = c0 % 8
      const int hf_t = tid >> 7, c_t = tid & 127, shift_t = c0[hf_t] & 7;
      valid_s[tid] = width[hf_t] && c_t >= shift_t && c_t - shift_t < ncols[hf_t]
                         ? valid[c0[hf_t] - shift_t + c_t] : 0;
      if (c_t < NMAX && width[hf_t] && c_t < ncols[hf_t] / width[hf_t])
        touch_s[hf_t * NMAX + c_t] = touch_mask(c_t, width[hf_t], shift_t);
      named_bar(1, CONSUMERS);
      Frag fr[2];
      uint32_t magic[2];
      int base[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        magic[hf] = node_magic(width[hf] ? width[hf] : 1);
        base[hf] = 2 * q - (c0[hf] & 7);
        fr[hf] = make_frag(base[hf], c0[hf] & 7, width[hf] ? ncols[hf] : 0, magic[hf],
                           valid_s + hf * HALF);
      }

      for (int rt = 0; rt < RT; ++rt) {
        const int r_wg = rt * BM + wg * 64;   // the warpgroup's first row
        consume_tile(ring, full, empty, sm, K1Plan::STAGE, KT, lane,
                     [&](uint32_t st, int kt) {
                       fence_regs(acc);
#pragma unroll
                       for (int k = 0; k < BK / 16; ++k)
                         wgmma_m64n256k16(acc, desc_a(st + wg * (A_BYTES / 2), k),
                                          desc_b(st + A_BYTES, k), (kt | k) != 0);
                     });
        if (r_wg >= HW) continue;   // the warpgroup's rows all lie past HW
        fence_regs(acc);
        const bool ok0 = r_wg + rr0 < HW, ok1 = r_wg + rr0 + 8 < HW;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (width[hf] == 0) continue;
          float(&ah)[FR] = *reinterpret_cast<float(*)[FR]>(acc + hf * FR);
          WideRows w{};
          if (MODE != WHOLE)
            w = {stats, G, g + hf, g + hf - group(g + hf, 4), group(g + hf, 5),
                 (long long)b * HW + r_wg, HW - r_wg};
          softmax_frag<MODE>(ah, fr[hf], q, base[hf], magic[hf], rr0, part, comb,
                             touch_s + hf * NMAX, ncols[hf] / width[hf], t, 2 + wg, inv_tau, w);
          if (MODE == STATS) continue;
          colmax_rows(ah, fr[hf], ok0, ok1, base[hf], lane, colmax_s + hf * HALF);
          // this thread's first column of each row (pairs are 4-byte aligned:
          // the tile starts on an even column)
          __nv_bfloat16* dst = pf + ((size_t)b * HW + r_wg + rr0) * P + c0[hf] + base[hf];
          store_pf_row(ah, 0, ok0 ? fr[hf].in : 0u, dst);
          store_pf_row(ah, 1, ok1 ? fr[hf].in : 0u, dst + (size_t)8 * P);
        }
      }
      named_bar(1, CONSUMERS);
      if (MODE != STATS && width[hf_t] && c_t < ncols[hf_t]) {
        pooled[(size_t)b * P + c0[hf_t] + c_t] = __uint_as_float(colmax_s[tid]);
        colmax_s[tid] = 0;
      }
    }
  }
}

template <int MODE>
cudaError_t launch_f32(const void* features, const void* kernel, const void* valid,
                       const int* groups, int G, float2* stats, void* pf, void* pooled, int B,
                       int HW, int D, int P, float tau, cudaStream_t s) {
  constexpr int BYTES = simt::Ring<simt::B_NMAJOR>::BYTES;
  const cudaError_t err = simt::raise_smem<fused_head_f32<MODE>>(BYTES);
  if (err != cudaSuccess) return err;
  const int rows = B * HW;
  fused_head_f32<MODE><<<dim3(G, (rows + simt::BM - 1) / simt::BM), simt::THREADS, BYTES, s>>>(
      static_cast<const float*>(features), static_cast<const float*>(kernel),
      static_cast<const uint8_t*>(valid), groups, stats, static_cast<float*>(pf),
      static_cast<float*>(pooled), rows, HW, D, P, G, tau);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bf16(const CUtensorMap& tmF, const CUtensorMap& tmK, const void* valid,
                        const int* groups, int G, float2* stats, void* pf, void* pooled, int B,
                        int HW, int D, int P, float tau, cudaStream_t s) {
  int grid = 0;
  cudaError_t err =
      hopper::persistent_grid<fused_head_bf16<MODE>>(K1Plan::BYTES, (G + 1) / 2 * B, &grid);
  if (err != cudaSuccess) return err;
  fused_head_bf16<MODE><<<grid, hopper::THREADS, K1Plan::BYTES, s>>>(
      tmF, tmK, static_cast<const uint8_t*>(valid), groups, stats,
      static_cast<__nv_bfloat16*>(pf), static_cast<float*>(pooled), B, HW, P, G,
      (D + hopper::BK - 1) / hopper::BK, 1.0f / tau);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// whole (Gw groups of whole nodes and maybe the padded tail) and wide (Gp
// parts of wide nodes, maybe the tail) are plans of GF ints a group
// (ops/fused_head.py::split_plan); either may be empty.  stats: (B * HW,
// Gp) float2 scratch for the parts' row statistics.  dtype: 0 = float32
// (groups fitting 128 columns from c0 & ~3; D and P multiples of 4, 16-byte
// aligned features and kernel, for cp.async), 1 = bfloat16 (groups of <= 16 nodes, each
// inside a 128-column tile that starts on a multiple of 8 columns; D and P
// multiples of 8, 16-byte aligned features and kernel, for TMA).  Launches
// on `stream` (STATS, FINAL over the parts, then WHOLE); returns the CUDA
// error code so a refused launch is reported to the caller.
int pipnet_fused_head_forward(const void* features, const void* kernel, const void* valid,
                              const void* whole, int Gw, const void* wide, int Gp, void* stats,
                              void* pf, void* pooled, int B, int HW, int D, int P, float tau,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gw = static_cast<const int*>(whole);
  const int* gp = static_cast<const int*>(wide);
  float2* st = static_cast<float2*>(stats);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    // the row tiles meet in pooled by atomicMax over zeros
    if (D % 4 || P % 4 || reinterpret_cast<uintptr_t>(features) % 16 ||
        reinterpret_cast<uintptr_t>(kernel) % 16 || HW <= 0 ||
        (long long)B * HW > 65535LL * simt::BM)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(pooled, 0, (size_t)B * P * sizeof(float), s);
    if (Gp && err == cudaSuccess) err = launch_f32<STATS>(features, kernel, valid, gp, Gp, st, pf, pooled, B, HW, D, P, tau, s);
    if (Gp && err == cudaSuccess)
      err = launch_f32<FINAL>(features, kernel, valid, gp, Gp, st, pf, pooled, B, HW, D, P, tau, s);
    if (Gw && err == cudaSuccess)
      err = launch_f32<WHOLE>(features, kernel, valid, gw, Gw, st, pf, pooled, B, HW, D, P, tau, s);
    return static_cast<int>(err);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmF, tmK;
  err = hopper::bf16_map(&tmF, features, D, (uint64_t)B * HW, hopper::BK, hopper::BM);
  if (err == cudaSuccess) err = hopper::bf16_map(&tmK, kernel, P, D, 64, hopper::BK);
  if (Gp && err == cudaSuccess)
    err = launch_bf16<STATS>(tmF, tmK, valid, gp, Gp, st, pf, pooled, B, HW, D, P, tau, s);
  if (Gp && err == cudaSuccess)
    err = launch_bf16<FINAL>(tmF, tmK, valid, gp, Gp, st, pf, pooled, B, HW, D, P, tau, s);
  if (Gw && err == cudaSuccess)
    err = launch_bf16<WHOLE>(tmF, tmK, valid, gw, Gw, st, pf, pooled, B, HW, D, P, tau, s);
  return static_cast<int>(err);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

// K5 and K5b: the uniformity loss's pair sum and its gradient, hand-written
// for Hopper (sm_90a).
//
// No TPU kernel stands behind these: the JAX package computes the loss
// (pipnet_tpu/losses/catalog.py::uniform_loss) as a lax.scan over row
// blocks that XLA fuses.  The port's plain version (ops/uniform_pairs.py)
// made a (2048 x n) f32 block of distances per step of that scan and ran
// some 7 element-wise passes over it forward and 12 backward: at the
// flagship's n = 43,264 patch rows a view that is ~0.5 TB of device-memory
// traffic a step.  For the rows x_i (n, D) in bf16, with sq_i = |x_i|^2:
//
//   d2_ij = sq_i + sq_j - 2 x_i . x_j,   e_ij = exp(-t max(d2_ij, 0))
//   K5:  S = sum over i < j of e_ij (a rank's share on a mesh: half the sum
//        over j != i of its rows i), one f32 number;
//   K5b: dS/dx_i = 2 (x_i r_i - sum_j m_ij x_j), r_i = sum_j m_ij, with
//        m_ij = -t g e_ij tie(d2_ij), tie = 1 above 0, 1/2 at 0 and 0 below
//        (max(d2, 0)'s derivative split evenly at a tie, as jnp.maximum's),
//        m_ii = 0.
//
// What bounds them: the products.  K5 is n^2 D (the upper half of X X^T),
// K5b 2 n^2 D for the Gram it recomputes and 2 n^2 D for m X: at n =
// 43,264, D = 768 and two views 14.4 TFLOP a step, 14.6 ms at the 989
// TFLOP/s bf16 peak.  Everything else is made to stay off device memory
// or to be small beside them:
//
// - Gram tiles of 128 x 256 (two consumer warpgroups of 64 rows, wgmma
//   m64n256k16, f32 accumulators) are fed by a TMA ring of 4 slabs of 64
//   depth (128-byte swizzle), one producer thread; the grid is persistent,
//   so the producer loads the next tile while the consumers finish one.
//   Both operands are rows of X, K-major, so X is never transposed.  The
//   distances, exponentials, masks and sums are taken on the accumulator
//   registers (the epilogue): the distance matrix never reaches device
//   memory in K5.  (On an H100, 128 x 128 tiles took 22% longer in K5 at
//   the flagship's shape: a stage then feeds half the products for two
//   thirds of the bytes.)
// - K5's tiles are those holding a pair i < j (ops/uniform_pairs.py::
//   pair_tiles), in groups of 2048 x 2048 so that the rows a wave of blocks
//   reads stay in the 50 MB L2.  Each consumer warp writes one f32 partial
//   a tile; uniform_pairs_sum adds them in a fixed order, in double: the
//   loss is the same number on every run (no float atomics).
// - K5b cannot keep a 64-row tile's gradient (768 f32 a row, 384
//   registers a thread) beside a Gram accumulator, so m passes through
//   device memory in bf16, one chunk of rows at a time.
//   uniform_pairs_gram<WEIGHTS> writes m for the chunk's rows against every
//   row (rounded to bf16, as the plain version rounds it for its product),
//   staged through shared memory so that each warp stores whole 256-byte
//   rows (the fragment's own 4-byte stores took 42% longer), and each
//   row's f32 sum of the unrounded values per Gram tile.  uniform_pairs_grad
//   multiplies m (chunk x n) by X (n x D) in 128 x 128 tiles on the same
//   TMA + wgmma core (X read N-major through its descriptor; 6 stages) and
//   writes 2 (x_i r_i - (m X)_i) from its accumulators.  A chunk's rows
//   are sized (ops/uniform_pairs.py::chunk_rows) so that its output tiles
//   fill the SMs (22 row tiles x 6 column tiles = 132 at D = 768), and its
//   scratch is at most 4096 rows (2816 x 43,264 x 2 B = 244 MB at the
//   flagship's shape): m costs ~7.5 GB of traffic a view.
//
// Every sum is taken in a fixed order, so both kernels are deterministic.
// The Gram stays in f32 (the plain version rounds it to bf16 before the
// distance), so no number is computed in a lower precision than there.
// Rows past n and columns past n or past D read TMA's zero fill and are
// masked in the epilogues; D needs to be a multiple of 8 (16-byte rows).
//
// f32 rows (the f32 configuration) take the same plan and epilogues on the
// SIMT tile that K1, K2 and K4 use in f32 (simt_tile.cuh: the FMA units,
// since TF32 would round the Gram below the plain version's f32 product):
// a K5 item of 128 x 256 is two 128 x 128 tiles, m passes through the
// scratch in f32 (the plain version's m X is an f32 product) and m X is a
// SIMT tile with X N-major.  D needs to be a multiple of 4 there.

#include "head_tile.cuh"
#include "simt_tile.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 128;    // rows of every tile (= hopper::BM), columns of the product's
constexpr int GRAM_BN = 256; // columns of a Gram tile
constexpr int WARPS = 8;     // consumer warps: K5's partials a tile
constexpr int HALF_BYTES = 64 * 128 * 2;   // a warpgroup's staged half tile of m: 64 x 128 bf16
constexpr float LOG2E_F = 1.4426950408889634f;

// The shared memory of a tile of 128 rows x BN columns: S stages of an A
// tile (128 x 64) and a B tile (BN x 64), EXTRA bytes (the Gram's staged m),
// then the barriers; offsets from a 1024-byte aligned base.  The Gram
// tiles (BN = 256) take 4 stages, the product's (BN = 128) 6.
template <int BN, int EXTRA = 0>
struct Ring {
  static constexpr int S = BN == 256 ? 4 : 6;
  static constexpr int STAGE = A_BYTES + BN * BK * 2;
  static constexpr int STAGED = S * STAGE;
  static constexpr int BARS = STAGED + EXTRA;
  static constexpr int BYTES = BARS + 2 * S * 8 + 1024;   // + alignment slack
  static_assert((BN == 128 || BN == 256) && BYTES <= 232448, "the ring does not fit");
};
static_assert(2 * ATOM_BYTES == TILE * BK * 2, "the product's B tile is two 64-column slices");

enum Epi { SUM = 0, WEIGHTS = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a position in a ring of S stages
template <int S>
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// head_tile.cuh's consume_tile on a ring of S stages of `stage_bytes`
template <int S, typename Issue>
__device__ __forceinline__ void consume(Pos<S>& ring, uint64_t* full, uint64_t* empty,
                                        const uint8_t* sm, int stage_bytes, int KT, int lane,
                                        Issue issue) {
  int pending = -1;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&full[ring.stage], ring.phase);
    __syncwarp();
    wgmma_fence();
    issue(smem_u32(sm + ring.stage * stage_bytes), kt);
    wgmma_commit();
    wgmma_wait<1>();
    if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
    pending = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(&empty[pending]);
}

template <int S>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- sq_i = |x_i|^2 in f32, one warp a row, 16 bytes a lane a step --------

template <typename T>
__global__ void __launch_bounds__(256)
uniform_pairs_norms(const T* __restrict__ x, float* __restrict__ sq, int n, int D) {
  constexpr int V = 16 / sizeof(T);   // elements in 16 bytes
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= n) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int k = lane * V; k < D; k += 32 * V) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(xr + k);
      s = fmaf(f.x, f.x, s);
      s = fmaf(f.y, f.y, s);
      s = fmaf(f.z, f.z, s);
      s = fmaf(f.w, f.w, s);
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        s = fmaf(f.x, f.x, s);
        s = fmaf(f.y, f.y, s);
      }
    }
  }
  s = warp_sum(s);
  if (lane == 0) sq[row] = s;
}

// ---- the Gram tiles with their epilogues ----------------------------------

struct GramArgs {
  const int2* tiles;     // SUM: (first row past row_base, first column) of each item
  int items;
  int row_tiles;         // WEIGHTS: the chunk's row tiles; item f is (f % row_tiles, f / row_tiles)
  const float* sq;       // (n) and readable to an even index past n
  int n, row_base, row_end, KT;
  int triangle;          // SUM: keep j > i (the whole sum), else j != i (a share)
  float t;
  float* partials;       // SUM: WARPS a tile
  const float* g;        // WEIGHTS: the cotangent (device scalar), null for 1
  void* w;               // WEIGHTS: m (rows of the chunk x n, x's dtype), row stride w_ld
  int w_ld;
  float* rowpart;        // WEIGHTS: (rows of the chunk, ct) row sums by column tile
  int ct;
};

template <int EPI>
__device__ __forceinline__ int2 gram_item(const GramArgs& a, int f) {
  if constexpr (EPI == SUM) {
    const int2 v = a.tiles[f];
    return make_int2(a.row_base + v.x, v.y);
  } else {
    return make_int2(a.row_base + (f % a.row_tiles) * TILE, (f / a.row_tiles) * GRAM_BN);
  }
}

// A warpgroup's 64 rows of m, 128 columns at a time, go to global memory
// through shared memory (`stage`: 64 rows of 256 bytes, the 16-byte units
// of row r at unit u ^ (r % 8), so that neither the fragment's writes nor
// the rows' reads meet a bank twice): 16-byte stores, whole rows a warp,
// where the fragment alone would store 4 bytes a thread on 8 rows.  The
// fragment's pair of columns 8 jh + 2 q of the warpgroup's row rl goes to:
__device__ __forceinline__ uint32_t* stage_at(uint8_t* stage, int rl, int jh, int q) {
  return reinterpret_cast<uint32_t*>(stage + rl * 256 + ((jh ^ (rl & 7)) << 4) + 4 * q);
}

// the staged half (row0: the warpgroup's first row, c0: the half's first
// column) to m's rows in device memory, once every thread of the
// warpgroup has staged its part (named barrier `bar`)
__device__ __forceinline__ void store_half(const uint8_t* stage, const GramArgs& a, int row0,
                                           int c0, int t, int bar) {
  named_bar(bar, 128);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int unit = t + 128 * k, r = unit >> 4, u = unit & 15;
    const int i = row0 + r, c = c0 + 8 * u;
    if (i >= a.row_end || c >= a.n) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(stage + r * 256 + ((u ^ (r & 7)) << 4));
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(a.w) + (size_t)(i - a.row_base) * a.w_ld + c;
    if (c + 8 <= a.n) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
      for (int k2 = 0; c + k2 < a.n; ++k2) dst[k2] = e[k2];
    }
  }
}

// tmA reads boxes of 128 rows of x, tmB of GRAM_BN rows
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
uniform_pairs_gram(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                   const GramArgs a) {
  constexpr int BN = GRAM_BN;
  using R = Ring<BN, EPI == WEIGHTS ? 2 * HALF_BYTES : 0>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + R::BARS);
  uint64_t* empty = full + R::S;
  const int tid = threadIdx.x, wg = tid / 128;
  init_ring<R::S>(full, empty);

  if (wg == 2) {   // producer
    setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      Pos<R::S> ring;
      for (int f = blockIdx.x; f < a.items; f += gridDim.x) {
        const int2 it = gram_item<EPI>(a, f);
        for (int kt = 0; kt < a.KT; ++kt) {
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint8_t* st = sm + ring.stage * R::STAGE;
          mbar_expect_tx(&full[ring.stage], R::STAGE);
          tma_load_2d(st, &tmA, &full[ring.stage], kt * BK, it.x);
          tma_load_2d(st + A_BYTES, &tmB, &full[ring.stage], kt * BK, it.y);
          ring.advance();
        }
      }
    }
  } else {         // consumers
    setmaxnreg_inc<240>();
    const int t = tid & 127, lane = t & 31, q = lane & 3;
    const float k2 = -a.t * LOG2E_F;                  // e = 2^(k2 max(d2, 0))
    float scale = 0.f;
    if constexpr (EPI == WEIGHTS) scale = -a.t * (a.g ? *a.g : 1.f);
    Pos<R::S> ring;
    float acc[BN / 2];
    for (int f = blockIdx.x; f < a.items; f += gridDim.x) {
      const int2 it = gram_item<EPI>(a, f);
      // both tiles K-major, 128 bytes a row: B's descriptor has A's form
      consume(ring, full, empty, sm, R::STAGE, a.KT, lane, [&](uint32_t st, int kt) {
        fence_regs(acc);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n256k16_kmajor(acc, desc_a(st + wg * (A_BYTES / 2), k),
                                  desc_a(st + A_BYTES, k), (kt | k) != 0);
      });
      fence_regs(acc);

      // the accumulator fragment (head_tile.cuh): rows r and r + 8, columns
      // 8 j + 2 q + e at acc[4 j + 2 h + e]
      const int r = it.x + wg * 64 + (t >> 5) * 16 + (lane >> 2);
      const float sqi[2] = {r < a.row_end ? a.sq[r] : 0.f, r + 8 < a.row_end ? a.sq[r + 8] : 0.f};
      float run[2] = {0.f, 0.f};
      uint8_t* stage = sm + R::STAGED + wg * HALF_BYTES;   // WEIGHTS
      const int rl = (t >> 5) * 16 + (lane >> 2);             // r's row in the warpgroup
#pragma unroll
      for (int half = 0; half < BN / 128; ++half) {
        if constexpr (EPI == WEIGHTS) named_bar(1 + wg, 128);   // the last half is stored
#pragma unroll
        for (int jh = 0; jh < 16; ++jh) {
          const int j = 16 * half + jh, c = it.y + 8 * j + 2 * q;
          const float2 sqj = c < a.n ? *reinterpret_cast<const float2*>(a.sq + c)
                                     : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = r + 8 * h;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = c + e;
              // (-2 s + sq_i) + sq_j: the plain version's order
              const float d2 = fmaf(-2.f, acc[4 * j + 2 * h + e], sqi[h]) + (e ? sqj.y : sqj.x);
              const float x = ex2(k2 * fmaxf(d2, 0.f));
              if constexpr (EPI == SUM) {
                const bool keep = i < a.row_end && jj < a.n && (a.triangle ? jj > i : jj != i);
                run[h] += keep ? x : 0.f;
              } else {
                const float tie = d2 > 0.f ? 1.f : (d2 == 0.f ? 0.5f : 0.f);
                v[e] = jj < a.n && jj != i ? x * tie * scale : 0.f;
                run[h] += v[e];
              }
            }
            if constexpr (EPI == WEIGHTS) {
              const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
              *stage_at(stage, rl + 8 * h, jh, q) = *reinterpret_cast<const uint32_t*>(&p);
            }
          }
        }
        if constexpr (EPI == WEIGHTS)
          store_half(stage, a, it.x + wg * 64, it.y + 128 * half, t, 1 + wg);
      }
      if constexpr (EPI == SUM) {
        const float s = warp_sum(run[0] + run[1]);
        if (lane == 0) a.partials[(size_t)f * WARPS + tid / 32] = s;
      } else {
        // a row's columns of this tile lie in one quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          run[h] += __shfl_xor_sync(0xffffffffu, run[h], 1);
          run[h] += __shfl_xor_sync(0xffffffffu, run[h], 2);
          const int i = r + 8 * h;
          if (q == 0 && i < a.row_end)
            a.rowpart[(size_t)(i - a.row_base) * a.ct + it.y / GRAM_BN] = run[h];
        }
      }
    }
  }
}

// K5's total: the tiles' partials added in a fixed order, in double
__global__ void __launch_bounds__(1024)
uniform_pairs_sum(const float* __restrict__ partials, int count, float weight,
                  float* __restrict__ out) {
  __shared__ double part[1024];
  double s = 0.0;
  for (int k = threadIdx.x; k < count; k += 1024) s += partials[k];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = static_cast<float>(weight * part[0]);
}

// ---- K5b's product: dx = 2 (x r - m X) for a chunk of rows ----------------

struct GradArgs {
  const float* rowpart;  // (rows, ct)
  int ct;
  const void* x;         // x's dtype
  int D, rows, row0, out_row0, KT, grid_n, items;
  void* dx;              // (.., D), bf16 if out_bf16 else f32
  int out_bf16;
};

__global__ void __launch_bounds__(THREADS, 1)
uniform_pairs_grad(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmX,
                   const GradArgs a) {
  using R = Ring<TILE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + R::BARS);
  uint64_t* empty = full + R::S;
  const int tid = threadIdx.x, wg = tid / 128;
  init_ring<R::S>(full, empty);

  if (wg == 2) {   // producer
    setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      Pos<R::S> ring;
      for (int f = blockIdx.x; f < a.items; f += gridDim.x) {
        // column tiles fastest: neighbouring blocks share their m rows in L2
        const int m0 = (f / a.grid_n) * TILE, n0 = (f % a.grid_n) * TILE;
        for (int kt = 0; kt < a.KT; ++kt) {
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint8_t* st = sm + ring.stage * R::STAGE;
          mbar_expect_tx(&full[ring.stage], R::STAGE);
          tma_load_2d(st, &tmW, &full[ring.stage], kt * BK, m0);
          tma_load_2d(st + A_BYTES, &tmX, &full[ring.stage], n0, kt * BK);
          tma_load_2d(st + A_BYTES + ATOM_BYTES, &tmX, &full[ring.stage], n0 + 64, kt * BK);
          ring.advance();
        }
      }
    }
  } else {         // consumers
    setmaxnreg_inc<240>();
    const int t = tid & 127, lane = t & 31, q = lane & 3;
    Pos<R::S> ring;
    float acc[64];
    for (int f = blockIdx.x; f < a.items; f += gridDim.x) {
      const int m0 = (f / a.grid_n) * TILE, n0 = (f % a.grid_n) * TILE;
      // m's tile K-major, X's N-major (two 64-column slices)
      consume(ring, full, empty, sm, R::STAGE, a.KT, lane, [&](uint32_t st, int kt) {
        fence_regs(acc);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n128k16(acc, desc_a(st + wg * (A_BYTES / 2), k), desc_b(st + A_BYTES, k),
                           (kt | k) != 0);
      });
      fence_regs(acc);

      const int r = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);   // the chunk's row, h = 0
      float rs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
        if (r + 8 * h < a.rows)
          for (int c = 0; c < a.ct; ++c) s += a.rowpart[(size_t)(r + 8 * h) * a.ct + c];
        rs[h] = s;
      }
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const int d = n0 + 8 * j + 2 * q;
        if (d >= a.D) continue;   // D is a multiple of 8: a pair lies wholly in or out
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = r + 8 * h;
          if (i >= a.rows) continue;
          const float2 xi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(a.x) + (size_t)(a.row0 + i) * a.D + d));
          const float v0 = 2.f * (xi.x * rs[h] - acc[4 * j + 2 * h]);
          const float v1 = 2.f * (xi.y * rs[h] - acc[4 * j + 2 * h + 1]);
          const size_t o = (size_t)(a.out_row0 + i) * a.D + d;
          if (a.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.dx) + o) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.dx) + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

// ---- f32 rows: the Gram tiles and the product on the SIMT tile -----------

using F32GramRing = simt::Ring<simt::B_KMAJOR>;
using F32GradRing = simt::Ring<simt::B_NMAJOR>;
static_assert(simt::THREADS / 32 == WARPS && simt::BM == TILE && GRAM_BN % simt::BN == 0,
              "an f32 block writes K5's partials and K5b's row sums as a bf16 block does");

// One item of the plan a block (GramArgs as above): its 128 rows against
// its two 128-column halves, each a SIMT product with the epilogue of the
// bf16 kernel on the thread's 8 x 8 outputs (rows frag_row(i), columns
// frag_col(j)).  WEIGHTS stores m in f32 straight from the registers (16
// neighbouring lanes write 64 bytes of a row) and zeros in the columns
// [n, w_ld), which the product reads as depth; a row's 256 columns sum
// over its 16 lanes in a fixed order.
template <int EPI>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_BLOCKS)
uniform_pairs_gram_f32(const float* __restrict__ x, int D, const GramArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* smem_f = reinterpret_cast<float*>(smem_raw);
  const int2 it = gram_item<EPI>(a, blockIdx.x);
  const int lane = threadIdx.x & 31;
  const float k2 = -a.t * LOG2E_F;
  float scale = 0.f;
  if constexpr (EPI == WEIGHTS) scale = -a.t * (a.g ? *a.g : 1.f);
  float run[simt::TR] = {};   // SUM: run[0] alone
  float acc[simt::TR][simt::TC];
  for (int half = 0; half < GRAM_BN / simt::BN; ++half) {
    const int c0 = it.y + half * simt::BN;
    if (c0 >= a.n) break;   // the same for the whole block
    simt::product<simt::B_KMAJOR>(smem_f, x + (size_t)it.x * D, D, a.n - it.x,
                                  x + (size_t)c0 * D, D, a.n - c0, D, acc);
#pragma unroll
    for (int i = 0; i < simt::TR; ++i) {
      const int r = it.x + simt::frag_row(i);
      const float sqi = r < a.row_end ? a.sq[r] : 0.f;
#pragma unroll
      for (int j = 0; j < simt::TC; ++j) {
        const int c = c0 + simt::frag_col<simt::B_KMAJOR>(j);
        const float d2 = fmaf(-2.f, acc[i][j], sqi) + (c < a.n ? a.sq[c] : 0.f);
        const float e = ex2(k2 * fmaxf(d2, 0.f));
        if constexpr (EPI == SUM) {
          const bool keep = r < a.row_end && c < a.n && (a.triangle ? c > r : c != r);
          run[0] += keep ? e : 0.f;
        } else {
          const float tie = d2 > 0.f ? 1.f : (d2 == 0.f ? 0.5f : 0.f);
          const float v = c < a.n && c != r ? e * tie * scale : 0.f;
          run[i] += v;
          if (r < a.row_end && c < a.w_ld)
            static_cast<float*>(a.w)[(size_t)(r - a.row_base) * a.w_ld + c] = v;
        }
      }
    }
  }
  if constexpr (EPI == SUM) {
    const float s = warp_sum(run[0]);
    if (lane == 0) a.partials[(size_t)blockIdx.x * WARPS + threadIdx.x / 32] = s;
  } else {
#pragma unroll
    for (int i = 0; i < simt::TR; ++i) {
      float v = run[i];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int r = it.x + simt::frag_row(i);
      if ((lane & 15) == 0 && r < a.row_end)
        a.rowpart[(size_t)(r - a.row_base) * a.ct + it.y / GRAM_BN] = v;
    }
  }
}

// K5b's product for f32 rows: the block (blockIdx.x, blockIdx.y) computes
// the 128 x 128 tile of m X at columns 128 blockIdx.x and the chunk's rows
// 128 blockIdx.y, over the depth n (m's columns past n are zeros; X's rows
// past n load as zeros), and writes 2 (x r - m X) in f32, four columns a
// store (D is a multiple of 4).
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_BLOCKS)
uniform_pairs_grad_f32(const float* __restrict__ w, int w_ld, int n, const GradArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* smem_f = reinterpret_cast<float*>(smem_raw);
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * simt::BN;
  const float* x = static_cast<const float*>(a.x);
  float acc[simt::TR][simt::TC];
  simt::product<simt::B_NMAJOR>(smem_f, w + (size_t)m0 * w_ld, w_ld, a.rows - m0, x + n0, a.D,
                                a.D - n0, n, acc);
#pragma unroll
  for (int i = 0; i < simt::TR; ++i) {
    const int r = m0 + simt::frag_row(i);
    if (r >= a.rows) continue;
    float rs = 0.f;
    for (int c = 0; c < a.ct; ++c) rs += a.rowpart[(size_t)r * a.ct + c];
#pragma unroll
    for (int h = 0; h < simt::TC / 4; ++h) {
      const int d = n0 + simt::frag_col<simt::B_NMAJOR>(4 * h);
      if (d >= a.D) continue;
      const float4 xi = *reinterpret_cast<const float4*>(x + (size_t)(a.row0 + r) * a.D + d);
      const float4 v = make_float4(2.f * (xi.x * rs - acc[i][4 * h]),
                                   2.f * (xi.y * rs - acc[i][4 * h + 1]),
                                   2.f * (xi.z * rs - acc[i][4 * h + 2]),
                                   2.f * (xi.w * rs - acc[i][4 * h + 3]));
      *reinterpret_cast<float4*>(static_cast<float*>(a.dx) + (size_t)(a.out_row0 + r) * a.D + d) =
          v;
    }
  }
}

// A 2-D bf16 map of (outer, inner) with rows `row_bytes` apart (m's scratch
// rows are padded to 16 bytes past n), boxes of (box_outer, box_inner),
// 128-byte swizzle, zeros outside; not cached, since the scratch's last
// chunk has its own row count.
cudaError_t strided_map(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t outer,
                        uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the Gram tiles of `a` over x (bf16 or f32 rows, n x D)
template <int EPI>
cudaError_t launch_gram(const void* x, bool f32, int n, int D, const GramArgs& a,
                        cudaStream_t s) {
  if (f32) {
    constexpr int BYTES = F32GramRing::BYTES;
    const cudaError_t err = simt::raise_smem<uniform_pairs_gram_f32<EPI>>(BYTES);
    if (err != cudaSuccess) return err;
    uniform_pairs_gram_f32<EPI><<<a.items, simt::THREADS, BYTES, s>>>(
        static_cast<const float*>(x), D, a);
    return cudaGetLastError();
  }
  constexpr int BYTES = Ring<GRAM_BN, EPI == WEIGHTS ? 2 * HALF_BYTES : 0>::BYTES;
  CUtensorMap tmA, tmB;
  cudaError_t err = bf16_map(&tmA, x, D, n, BK, TILE);
  if (err == cudaSuccess) err = bf16_map(&tmB, x, D, n, BK, GRAM_BN);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid<uniform_pairs_gram<EPI>>(BYTES, a.items, &grid);
  if (err != cudaSuccess) return err;
  uniform_pairs_gram<EPI><<<grid, THREADS, BYTES, s>>>(tmA, tmB, a);
  return cudaGetLastError();
}

// m X for a chunk of b.rows rows whose m is in w (row stride w_ld)
cudaError_t launch_grad(bool f32, const void* x, const void* w, int w_ld, int n,
                        const GradArgs& b, cudaStream_t s) {
  if (f32) {
    constexpr int BYTES = F32GradRing::BYTES;
    const cudaError_t err = simt::raise_smem<uniform_pairs_grad_f32>(BYTES);
    if (err != cudaSuccess) return err;
    uniform_pairs_grad_f32<<<dim3(b.grid_n, ceil_div(b.rows, TILE)), simt::THREADS, BYTES, s>>>(
        static_cast<const float*>(w), w_ld, n, b);
    return cudaGetLastError();
  }
  CUtensorMap tmW, tmX;
  cudaError_t err = strided_map(&tmW, w, n, b.rows, (uint64_t)w_ld * 2, BK, TILE);
  if (err == cudaSuccess) err = bf16_map(&tmX, x, b.D, n, 64, BK);
  int grid = 0;
  if (err == cudaSuccess)
    err = persistent_grid<uniform_pairs_grad>(Ring<TILE>::BYTES, b.items, &grid);
  if (err != cudaSuccess) return err;
  uniform_pairs_grad<<<grid, THREADS, Ring<TILE>::BYTES, s>>>(tmW, tmX, b);
  return cudaGetLastError();
}

// sq (n) <- the rows' squared norms
cudaError_t launch_norms(const void* x, bool f32, int n, int D, float* sq, cudaStream_t s) {
  if (f32)
    uniform_pairs_norms<float><<<ceil_div(n, 8), 256, 0, s>>>(static_cast<const float*>(x), sq,
                                                             n, D);
  else
    uniform_pairs_norms<__nv_bfloat16><<<ceil_div(n, 8), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sq, n, D);
  return cudaGetLastError();
}

// the entries' checks of x: dtype 0 (f32, D a multiple of 4) or 1 (bf16, D
// a multiple of 8), and rows [at, at + rows) inside its n rows
bool valid_rows(int dtype, int n, int D, int at, int rows) {
  return (dtype == 0 || dtype == 1) && n > 0 && D > 0 && D % (dtype ? 8 : 4) == 0 && at >= 0 &&
         rows > 0 && at + rows <= n;
}

}  // namespace

extern "C" {

// K5: the pair sum of the rows of x (n, D), contiguous and 16-byte aligned,
// dtype 0 (f32, D a multiple of 4) or 1 (bf16, D a multiple of 8), over the
// tiles `tiles` of 128 rows x 256 columns (items x (first row past `at`,
// first column), int32; ops/uniform_pairs.py::pair_tiles) of rows [at, at
// + rows).  All rows (at = 0, rows = n): the pairs i < j; else a rank's
// share, half the sum over j != i.  out (f32 scalar) <- the sum; sq (f32,
// n rounded up to 8) and partials (f32, 8 x items) are scratch.  Three
// launches on `stream`: the row norms, the tiles, the fixed-order sum.
int pipnet_uniform_pairs(const void* x, int dtype, int n, int D, int at, int rows, float t,
                         const void* tiles, int items, void* sq, void* partials, void* out,
                         void* stream) {
  if (!valid_rows(dtype, n, D, at, rows) || items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0, whole = at == 0 && rows == n;
  cudaError_t err = launch_norms(x, f32, n, D, static_cast<float*>(sq), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  GramArgs a{};
  a.tiles = static_cast<const int2*>(tiles);
  a.items = items;
  a.sq = static_cast<const float*>(sq);
  a.n = n;
  a.row_base = at;
  a.row_end = at + rows;
  a.KT = ceil_div(D, BK);
  a.triangle = whole;
  a.t = t;
  a.partials = static_cast<float*>(partials);
  err = launch_gram<SUM>(x, f32, n, D, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  uniform_pairs_sum<<<1, 1024, 0, s>>>(static_cast<const float*>(partials), items * WARPS,
                                     whole ? 1.f : 0.5f, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K5b: dS/dx, S the whole pair sum, for rows [at, at + rows) of x (as for
// K5) into dx (rows, D): scaled by the cotangent g (f32 device scalar) and
// in x's dtype, or with g null (a mesh rank's rows, scaled by its caller)
// in f32.  By chunks of `chunk` rows (a multiple of 128): sq (f32, n
// rounded up to 8), w (m: chunk rows x w_ld in x's dtype, w_ld >= n and
// its rows 16 bytes a multiple) and rowpart (chunk rows x ceil(n / 256)
// f32, a row's sums by Gram tile) are scratch.  The row norms, then two
// launches a chunk.
int pipnet_uniform_pairs_backward(const void* x, int dtype, int n, int D, int at, int rows,
                                  float t, const void* g, void* sq, void* w, int w_ld, int chunk,
                                  void* rowpart, void* dx, void* stream) {
  if (!valid_rows(dtype, n, D, at, rows) || w_ld < n || w_ld % (dtype ? 8 : 4) != 0 ||
      chunk <= 0 || chunk % TILE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  cudaError_t err = launch_norms(x, f32, n, D, static_cast<float*>(sq), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ct = ceil_div(n, GRAM_BN), grid_n = ceil_div(D, TILE);
  for (int r0 = at; r0 < at + rows; r0 += chunk) {
    const int c = at + rows - r0 < chunk ? at + rows - r0 : chunk, rt = ceil_div(c, TILE);
    GramArgs a{};
    a.items = rt * ct;
    a.row_tiles = rt;
    a.sq = static_cast<const float*>(sq);
    a.n = n;
    a.row_base = r0;
    a.row_end = r0 + c;
    a.KT = ceil_div(D, BK);
    a.t = t;
    a.g = static_cast<const float*>(g);
    a.w = w;
    a.w_ld = w_ld;
    a.rowpart = static_cast<float*>(rowpart);
    a.ct = ct;
    err = launch_gram<WEIGHTS>(x, f32, n, D, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    GradArgs b{};
    b.rowpart = a.rowpart;
    b.ct = ct;
    b.x = x;
    b.D = D;
    b.rows = c;
    b.row0 = r0;
    b.out_row0 = r0 - at;
    b.KT = ceil_div(n, BK);
    b.grid_n = grid_n;
    b.items = rt * grid_n;
    b.dx = dx;
    b.out_bf16 = !f32 && g != nullptr;
    err = launch_grad(f32, x, w, w_ld, n, b, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

// Device and host code shared by the prototype-head kernels (K1
// fused_head.cu, K2 fused_head_nopf.cu; K1b head_backward.cu takes the f32
// block constants and the dtype helpers).  Both head kernels replace Pallas
// TPU kernels of pipnet_tpu/ops/pallas_head.py (_head_kernel,
// _head_nopf_kernel): a product z = F K / tau of every patch row with a
// run of prototype columns, a per-node softmax of each row, and reductions
// over the rows (the spatial max; K2 also a per-node log sum).
//
// Two cores live here.
//
// 1. head_tile: the f32 epilogue steps.  The f32 kernels (K1's
//    fused_head_f32, K2's fused_head_nopf_f32) run their products on
//    simt_tile.cuh's tile (the SIMT FMA units: TF32 would miss the f32
//    tolerance of 1e-5), write z / tau into a shared-memory tile of TN
//    columns and ZLD a row over the product's ring, and take the per-node
//    softmax there (softmax_rows; over the parts of a wide node wide_row).
//
// 2. hopper: the bf16 core for Hopper (sm_90a).  At the flagship shapes the
//    bf16 head is bound by its product (K1 at B=128: 502 GFLOP, 0.51 ms at
//    the 989 TFLOP/s dense peak; the bytes take 0.21 ms), so the design
//    feeds the tensor cores the way Hopper wants:
//    - a persistent grid, one block per SM, walks work items (column groups
//      x image), so the next item's loads start during an epilogue;
//    - one producer thread keeps a ring of STAGES shared-memory stages full
//      with TMA tile loads (128-byte swizzle) completing on mbarriers: F
//      row tiles straight from the (B*HW, D) layout, K tiles from (D, P),
//      which wgmma reads N-major through its descriptor, so K is not copied;
//    - two consumer warpgroups of 64 rows each issue wgmma.mma_async
//      m64nNk16 with f32 accumulators in registers (setmaxnreg moves
//      registers from the producer to them); a column group is <= 128
//      columns of whole nodes, K1 runs two groups side by side (N = 256),
//      K2 one group per view (N = 128 twice);
//    - the epilogue runs on the accumulator fragment: the per-(row, node)
//      max and sum are segmented scans over each thread's columns in
//      registers, whose segment ends meet the other three threads of the row
//      in a small shared-memory table; each row tile's column max meets the
//      block's in shared memory.
//    What still bounds it: the epilogue (about 1.5 times the depth loop's
//    time a row tile) does not overlap the product (PERF.md).
//
// Nodes wider than a column tile (flat PIP-Net: one node of 768 prototypes)
// are cut into parts, groups of one node's consecutive columns
// (ops/fused_head.py::column_groups).  A kernel runs over such parts twice:
// STATS writes each row's max and sum over each part, FINAL merges them into
// the node's max and sum (merge_parts) and normalises by those, so every
// value is the node-wide softmax and the column max is taken on it.  The
// bf16 kernels compute the product in both launches; the f32 kernels' STATS
// stores z (K1 in pf, K2 in a scratch) and FINAL reads it back.  Groups of
// whole nodes take the WHOLE instantiation in a launch of their own.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

// A kernel's column plan holds GF ints a group (ops/fused_head.py::
// plan_parts): col_start, ncols, width (0: the padded tail), node_off (the
// node's column at which the group starts), part, parts.  A group with
// parts > 1 is part `part` of a node wider than the kernel's tile, and its
// node's parts are the `parts` consecutive groups from index g - part on.
constexpr int GF = 6;

// What a launch does with its groups: WHOLE groups of whole nodes (and the
// padded tail); over the parts of wide nodes, STATS writes each row's
// (max, sum) per part and FINAL computes the node-wide softmax from them.
enum Mode { WHOLE = 0, STATS = 1, FINAL = 2 };

// A row's node statistics from its node's parts' (max, sum) pairs `row[k]`,
// each sum taken after a shift by its own part's max: the node max m and
// S = max(sum_k s_k exp((m_k - m) * scale), 1e-18), `scale` turning the
// stored maxima into the exponent's units.  A part clips its exponents at -80
// below its own max, so a slot more than 80 below the node max adds under
// exp(-80) to S where the plain softmax adds exactly exp(-80); S >= 1 (the max
// slot adds 1), so the two differ by under P exp(-80) relative, far below f32
// resolution, and the values are then taken against the true node max.  A
// part with no valid slot has m_k = -inf and s_k = 0 and adds nothing.
__device__ __forceinline__ float2 merge_parts(const float2* row, int parts, float scale) {
  float m = -INFINITY;
  for (int k = 0; k < parts; ++k) m = fmaxf(m, row[k].x);
  float s = 0.f;
  for (int k = 0; k < parts; ++k) s += row[k].y * expf((row[k].x - m) * scale);
  return make_float2(m, fmaxf(s, 1e-18f));
}

namespace head_tile {

constexpr int TN = 128;       // prototype columns per block
constexpr int THREADS = 256;  // 8 warps
constexpr int ZLD = TN + 4;   // row stride of the f32 z tile in shared memory

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// The STATS and FINAL steps of the f32 tile for a part of a wide node, on
// one row zr of Z (z = acc / tau) over the part's `ncols` columns: STATS
// writes (max, sum of exp(clip(z - max, -80, 60))) over the valid slots to
// srow[gi]; FINAL replaces z by the node-wide softmax from the node's parts'
// statistics srow[g0 .. g0 + parts), invalid slots 0.
template <int MODE>
__device__ __forceinline__ void wide_row(float* zr, const uint8_t* valid_s, int ncols,
                                         float2* srow, int gi, int g0, int parts) {
  if (MODE == STATS) {
    float m = -INFINITY;
    for (int s = 0; s < ncols; ++s)
      if (valid_s[s]) m = fmaxf(m, zr[s]);
    float sum = 0.f;
    for (int s = 0; s < ncols; ++s)
      if (valid_s[s]) sum += expf(fminf(fmaxf(zr[s] - m, -80.f), 60.f));
    srow[gi] = make_float2(m, sum);
  } else {
    const float2 st = merge_parts(srow + g0, parts, 1.f);
    for (int s = 0; s < ncols; ++s)
      zr[s] = valid_s[s] ? expf(fminf(fmaxf(zr[s] - st.x, -80.f), 60.f)) / st.y : 0.f;
  }
}

// wide_row over `rows` rows of Z, row r's statistics at stats + r * ld; one
// thread a row.
template <int MODE>
__device__ __forceinline__ void wide_rows(float* Z, const uint8_t* valid_s, int rows, int ncols,
                                          float2* stats, int ld, int gi, int g0, int parts) {
  for (int r = threadIdx.x; r < rows; r += THREADS)
    wide_row<MODE>(Z + r * ZLD, valid_s, ncols, stats + (size_t)r * ld, gi, g0, parts);
}

}  // namespace head_tile

namespace hopper {

constexpr int BM = 128;        // rows per row tile: two consumer warpgroups of 64
constexpr int BK = 64;         // depth per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;      // shared-memory ring depth
constexpr int NMAX = 16;       // nodes per column group (ops/fused_head.py::MAX_GROUP_NODES)
constexpr int PLD = 4 * NMAX + 4;   // partials table [row][node][quad lane], padded
constexpr int CLD = NMAX + 1;       // per-(row, node) table
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = BM * BK * 2;       // one F row tile of a stage
constexpr int ATOM_BYTES = BK * 64 * 2;    // one 64-column slice of a K tile
constexpr int HALF = 128;                  // columns of one column group's tile
constexpr int COLRED = 2 * HALF;           // column-max slots: two groups (K1) or views (K2)
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan of a kernel with an N-column tile and NA F tiles per
// stage (K1 one, K2 one per view).  Offsets from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 1024 bytes).
template <int N, int NA>
struct Plan {
  static constexpr int NB = (N + 63) / 64;         // 64-column K slices per stage
  static constexpr int STAGE = NA * A_BYTES + NB * ATOM_BYTES;
  static constexpr int PART = STAGES * STAGE;      // float [BM][PLD]
  static constexpr int COMB = PART + BM * PLD * 4; // float [BM][CLD]
  static constexpr int LOGS = COMB + BM * CLD * 4; // float [BM][CLD] (K2's log terms)
  static constexpr int NODESUM = LOGS + BM * CLD * 4;   // float [2][NMAX] (K2)
  static constexpr int COLMAX = NODESUM + 2 * NMAX * 4; // uint32 [COLRED]
  static constexpr int VALID = COLMAX + COLRED * 4;     // uint8 [NB * 64]
  static constexpr int TOUCH = VALID + NB * 64;         // uint8 [2][NMAX]
  static constexpr int BARS = (TOUCH + 2 * NMAX + 7) / 8 * 8;   // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024; // + alignment slack
  static_assert(N % 8 == 0 && N <= 256 && BYTES <= 232448, "tile does not fit");
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed (the
// loop stays inside one asm block, whose label is local to it: a C++ loop
// here is a divergent path in front of wgmma, which makes ptxas serialise it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2-D TMA tile load (coordinates innermost first) completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep reads of the accumulators after the wgmma wait
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// A: 64 rows x 64 depth, K-major (depth contiguous, 128 bytes a row), 8-row
// groups 1024 bytes apart; the k-th step of 16 starts 32 bytes in
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int k) {
  return desc_sw128(tile + 32 * k, 16, 1024);
}
// B: 64 depth x N columns, N-major: 64-column slices ATOM_BYTES apart, each
// 64 rows of 128 bytes (8-row groups 1024 bytes apart); the k-th step of 16
// starts 16 rows in
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int k) {
  return desc_sw128(tile + 2048 * k, ATOM_BYTES, 1024);
}

// D (64 x N, f32) += A (64 x 16) B (16 x N): bf16 operands from shared
// memory, A K-major, B N-major (imm-trans-b = 1); `accumulate` 0 zeroes D
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with B K-major (imm-trans-b = 0): B's 16 x N tile stored as N
// rows of depth, as nn.Linear keeps a weight; its descriptor has desc_a's
// form (K4's products in cnblock.cu)
__device__ __forceinline__ void wgmma_m64n256k16_kmajor(float (&d)[128], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16_kmajor(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---- the per-node softmax on the accumulator fragment -------------------
//
// wgmma's m64nN accumulator: thread (warp w, lane l) of a warpgroup holds
// rows 16w + l/4 (h = 0) and 16w + l/4 + 8 (h = 1), and in each 8-column
// chunk j the tile columns 8j + 2(l%4) + e, e = 0, 1, at d[4j + 2h + e].  A
// row's columns are spread over the four threads of a quad.  One column
// group's tile is HALF = 128 columns: FJ = 16 chunks, FR = 64 registers a
// thread, and bit b = 2j + e of a thread's 32-bit masks describes its
// column b.  TMA needs the K tile to start at a multiple of 8 columns (16
// bytes), so a group starting at c0 sits in its tile from column shift =
// c0 % 8 on: the group column of a thread's column b is col_off(b) + base,
// base = 2 (l % 4) - shift.
//
// Every per-column step is one inline PTX block: its decisions are
// predicates and its node index is computed where it is used.  Written in
// C++, the compiler branched around each column's conditional store (557
// branches, the epilogue four times the product's time) and, once those
// were predicated, kept every column's node address live across the passes
// (a kilobyte of spills a thread).

constexpr int FJ = HALF / 8;
constexpr int FR = 4 * FJ;

__device__ __forceinline__ int frag_idx(int b, int h) { return 4 * (b >> 1) + 2 * h + (b & 1); }
__device__ __forceinline__ int col_off(int b) { return 8 * (b >> 1) + (b & 1); }

// the node of column c of a group of width-w nodes: mul.hi(c, magic) with
// magic = 2^32 / w rounded up is exact for 0 <= c < 2^16
__device__ __forceinline__ uint32_t node_magic(int width) {
  return 0xFFFFFFFFu / static_cast<uint32_t>(width) + 1u;
}

struct Frag {
  uint32_t in;      // a column of the group
  uint32_t valid;   // ... and a real prototype slot
  uint32_t start;   // ... and the first of its node in this thread
  uint32_t end;     // ... and the last of its node in this thread
};

// valid_s is indexed by tile column (group column + shift)
__device__ __forceinline__ Frag make_frag(int base, int shift, int ncols, uint32_t magic,
                                          const uint8_t* valid_s) {
  uint32_t in = 0, valid = 0, start = 0;
  int prev = -1;
#pragma unroll
  for (int b = 0; b < 2 * FJ; ++b) {
    const int c = col_off(b) + base;
    if (c >= 0 && c < ncols) {
      const int n = static_cast<int>(__umulhi(static_cast<uint32_t>(c), magic));
      in |= 1u << b;
      if (valid_s[c + shift]) valid |= 1u << b;
      if (n != prev) start |= 1u << b;
      prev = n;
    }
  }
  return {in, valid, start, in & ((start >> 1) | ~(in >> 1))};
}

// which quad lanes hold columns of node n (every lane when width >= 8); the
// group sits in its tile from column `shift` on
__device__ __forceinline__ uint8_t touch_mask(int n, int width, int shift) {
  if (width >= 8) return 0xF;
  uint8_t m = 0;
  for (int c = n * width; c < (n + 1) * width; ++c) m |= 1u << (((c + shift) & 7) >> 1);
  return m;
}

// (mask & bitm) ? a : b
__device__ __forceinline__ float sel_bit(uint32_t mask, uint32_t bitm, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\n.reg .b32 t;\nand.b32 t, %1, %2;\nsetp.ne.b32 p, t, 0;\n"
      "selp.f32 %0, %3, %4, p;\n}\n"
      : "=f"(r)
      : "r"(mask), "r"(bitm), "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One column of a segmented max (MAX) or sum: run = x at the first column
// of a node, op(run, x) after it; at the node's last column in this thread
// run goes to the partials table at part_row + node * 16 bytes.
template <bool MAX>
__device__ __forceinline__ void seg_step(float& run, float x, const Frag& fr, uint32_t bitm,
                                         int base, int off, uint32_t magic, uint32_t part_row) {
  if constexpr (MAX) {
    asm volatile(
        "{\n.reg .pred ps, pe;\n.reg .b32 t, n;\n.reg .f32 o;\n"
        "and.b32 t, %2, %4;\nsetp.ne.b32 ps, t, 0;\nand.b32 t, %3, %4;\nsetp.ne.b32 pe, t, 0;\n"
        "max.f32 o, %0, %1;\nselp.f32 %0, %1, o, ps;\n"
        "add.s32 n, %5, %6;\nmul.hi.u32 n, n, %7;\nmad.lo.u32 n, n, 16, %8;\n"
        "@pe st.shared.f32 [n], %0;\n}\n"
        : "+f"(run)
        : "f"(x), "r"(fr.start), "r"(fr.end), "r"(bitm), "r"(base), "r"(off), "r"(magic),
          "r"(part_row)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred ps, pe;\n.reg .b32 t, n;\n.reg .f32 o;\n"
        "and.b32 t, %2, %4;\nsetp.ne.b32 ps, t, 0;\nand.b32 t, %3, %4;\nsetp.ne.b32 pe, t, 0;\n"
        "add.f32 o, %0, %1;\nselp.f32 %0, %1, o, ps;\n"
        "add.s32 n, %5, %6;\nmul.hi.u32 n, n, %7;\nmad.lo.u32 n, n, 16, %8;\n"
        "@pe st.shared.f32 [n], %0;\n}\n"
        : "+f"(run)
        : "f"(x), "r"(fr.start), "r"(fr.end), "r"(bitm), "r"(base), "r"(off), "r"(magic),
          "r"(part_row)
        : "memory");
  }
}

// The byte address of column b's entry in a per-(row, node) table of
// 4-byte entries at row_addr (node clamped into the table: columns outside
// the group read a real entry and are masked by the caller).  A volatile
// block, so the compiler neither hoists it above a barrier nor keeps one
// address per column live across passes; the load from it is not, so
// loads can run ahead of their use.
__device__ __forceinline__ uint32_t node_entry(int base, int off, uint32_t magic,
                                               uint32_t row_addr) {
  uint32_t a;
  asm volatile(
      "{\n.reg .b32 n;\nadd.s32 n, %1, %2;\nmul.hi.u32 n, n, %3;\nmin.u32 n, n, %5;\n"
      "mad.lo.u32 %0, n, 4, %4;\n}\n"
      : "=r"(a)
      : "r"(base), "r"(off), "r"(magic), "r"(row_addr), "n"(NMAX - 1));
  return a;
}
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The four lanes' partials of each (row, node) of a warpgroup's 64 rows,
// combined by thread t of 128: the max, or the reciprocal of the floored sum.
template <bool MAX>
__device__ __forceinline__ void combine(const float* part, float* comb, const uint8_t* touch_s,
                                        int nodes, int t) {
  for (int idx = t; idx < 64 * nodes; idx += 128) {
    const int r = idx / nodes, n = idx - r * nodes;
    const float* p = part + r * PLD + n * 4;
    const uint32_t tm = touch_s[n];
    float a = MAX ? -INFINITY : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((tm >> q) & 1) a = MAX ? fmaxf(a, p[q]) : a + p[q];
    comb[r * CLD + n] = MAX ? a : 1.f / fmaxf(a, 1e-18f);
  }
}

// Where a warpgroup's rows of a part of a wide node keep their statistics
// (STATS, FINAL): stats[(row0 + r) * ld + gi] for its rows r < rows (those
// below HW); the node's parts are groups g0 .. g0 + parts - 1.
struct WideRows {
  float2* stats;
  int ld, gi, g0, parts;
  long long row0;
  int rows;
};

// After a combine of a part of a wide node (one segment a row, so thread
// t < 64 holds row t's entry): STATS stores the part's max (MAX) or sum (its
// reciprocal is what combine left); FINAL puts the node's max, then the
// reciprocal of its sum, in the row's entry, merged from every part's
// statistics (merge_parts; the maxima are raw accumulators, so the exponent's
// scale is 1 / tau).  Rows at or past HW take harmless values; they are
// never stored.
template <int MODE, bool MAX>
__device__ __forceinline__ void wide_comb(float* comb, int t, const WideRows& w, float inv_tau) {
  if (MODE == WHOLE || t >= 64) return;
  float* e = comb + t * CLD;
  if (MODE == STATS) {
    if (t < w.rows) {
      float* st = reinterpret_cast<float*>(w.stats + (w.row0 + t) * w.ld + w.gi);
      st[MAX ? 0 : 1] = MAX ? e[0] : 1.f / e[0];
    }
  } else if (MAX) {
    const float2 s = t < w.rows ? merge_parts(w.stats + (w.row0 + t) * w.ld + w.g0, w.parts,
                                              inv_tau)
                                : make_float2(0.f, 1.f);
    e[0] = s.x;
    e[1] = 1.f / s.y;     // the entry of node 1, unused: a part is one segment
  } else {
    e[0] = e[1];
  }
}

// Per-node softmax of one warpgroup's 64 x 128 tile of one group in place:
// z = acc / tau shifted by its node's max over valid slots, exponent clipped
// at -80 (the shifted value is <= 0, so the upper clip at 60 never binds),
// divided by the sum floored at 1e-18; invalid slots and columns outside the
// group come out 0.  `part`, `comb` are the warpgroup's tables; `bar` its
// named barrier.  For a part of a wide node (MODE STATS or FINAL, `w` its
// rows) the tile is one segment a row, and wide_comb stores or replaces the
// per-row max and sum (STATS leaves the tile normalised by the part's own).
template <int MODE = WHOLE>
__device__ __forceinline__ void softmax_frag(float (&acc)[FR], const Frag& fr, int q, int base,
                                             uint32_t magic, int rr0, float* part, float* comb,
                                             const uint8_t* touch_s, int nodes, int t, int bar,
                                             float inv_tau, const WideRows& w = WideRows{}) {
  const uint32_t part0 = smem_u32(part + rr0 * PLD + q), comb0 = smem_u32(comb + rr0 * CLD);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float run = 0.f;
#pragma unroll
    for (int b = 0; b < 2 * FJ; ++b) {
      float& x = acc[frag_idx(b, h)];
      x = sel_bit(fr.valid, 1u << b, x, -INFINITY);
      seg_step<true>(run, x, fr, 1u << b, base, col_off(b), magic, part0 + 8 * h * PLD * 4);
    }
  }
  named_bar(bar, 128);
  combine<true>(part, comb, touch_s, nodes, t);
  wide_comb<MODE, true>(comb, t, w, inv_tau);
  named_bar(bar, 128);
  const float scale = inv_tau * LOG2E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = 0.f;
#pragma unroll
    for (int b = 0; b < 2 * FJ; ++b) {
      const float mb = ld_shared(node_entry(base, col_off(b), magic, comb0 + 8 * h * CLD * 4));
      m = sel_bit(fr.start, 1u << b, mb, m);
      float& x = acc[frag_idx(b, h)];
      x = sel_bit(fr.valid, 1u << b, ex2(fmaxf((x - m) * scale, -80.f * LOG2E)), 0.f);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float run = 0.f;
#pragma unroll
    for (int b = 0; b < 2 * FJ; ++b)
      seg_step<false>(run, acc[frag_idx(b, h)], fr, 1u << b, base, col_off(b), magic,
                      part0 + 8 * h * PLD * 4);
  }
  named_bar(bar, 128);
  combine<false>(part, comb, touch_s, nodes, t);
  wide_comb<MODE, false>(comb, t, w, inv_tau);
  named_bar(bar, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r = 0.f;
#pragma unroll
    for (int b = 0; b < 2 * FJ; ++b) {
      const float rb = ld_shared(node_entry(base, col_off(b), magic, comb0 + 8 * h * CLD * 4));
      r = sel_bit(fr.start, 1u << b, rb, r);
      acc[frag_idx(b, h)] *= r;
    }
  }
}

// Column max of one row tile's softmaxed rows into colmax_s, indexed by
// group column (pf >= 0, so the float's bits order as unsigned integers):
// each thread's two rows (rows past HW count as 0), then the warp's 8 row
// groups by shuffles, then warps and warpgroups by a shared-memory max from
// lanes 0-3.  Padded slots are skipped: their pf and pooled are 0.
__device__ __forceinline__ void colmax_rows(const float (&acc)[FR], const Frag& fr, bool ok0,
                                            bool ok1, int base, int lane, uint32_t* colmax_s) {
  const uint32_t col0 = smem_u32(colmax_s), mask = lane < 4 ? fr.valid : 0u;
  // eight columns at a time, so their shuffle chains overlap before the
  // shared-memory updates, which keep program order
#pragma unroll
  for (int b0 = 0; b0 < 2 * FJ; b0 += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = fmaxf(ok0 ? acc[frag_idx(b0 + i, 0)] : 0.f, ok1 ? acc[frag_idx(b0 + i, 1)] : 0.f);
#pragma unroll
    for (int s = 4; s < 32; s *= 2)
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], s));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "{\n.reg .pred p;\n.reg .b32 t, n;\nand.b32 t, %0, %1;\nsetp.ne.b32 p, t, 0;\n"
          "add.s32 n, %2, %3;\nmad.lo.u32 n, n, 4, %4;\n@p red.shared.max.u32 [n], %5;\n}\n"
          ::"r"(mask), "r"(1u << (b0 + i)), "r"(base), "r"(col_off(b0 + i)), "r"(col0),
          "r"(__float_as_uint(x[i]))
          : "memory");
  }
}

// One row's 2 x FJ bf16 pairs of pf from a thread's fragment: a pair both
// of whose columns lie in the group as one 4-byte store, a pair cut by the
// group's edge element by element; `in` is 0 for a row past HW.
__device__ __forceinline__ void store_pf_row(const float (&acc)[FR], int h, uint32_t in,
                                             __nv_bfloat16* dst) {
#pragma unroll
  for (int j = 0; j < FJ; ++j) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    asm volatile(
        "{\n.reg .pred pb, pl, ph;\n.reg .b32 t;\n.reg .b16 lo, hi;\n"
        "and.b32 t, %0, %1;\nsetp.eq.b32 pb, t, %1;\nsetp.eq.b32 pl, t, %2;\n"
        "setp.eq.b32 ph, t, %3;\nmov.b32 {lo, hi}, %5;\n"
        "@pb st.global.b32 [%4], %5;\n@pl st.global.b16 [%4], lo;\n"
        "@ph st.global.b16 [%4+2], hi;\n}\n"
        ::"r"(in), "r"(3u << (2 * j)), "r"(1u << (2 * j)), "r"(2u << (2 * j)), "l"(dst + 8 * j),
        "r"(*reinterpret_cast<const uint32_t*>(&v))
        : "memory");
  }
}

// ring position of a producer or consumer
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One consumer warpgroup's depth loop over a row tile: for each of the KT
// stages, wait for its TMA loads, issue its wgmmas (`issue(stage address,
// kt)`), and keep that group in flight while the previous stage's group
// completes and its stage goes back to the producer (one arrival per warp).
// Every warpgroup issues, even one whose rows all lie past HW: a branch
// around wgmma makes ptxas serialise every wgmma of the kernel.
template <typename Issue>
__device__ __forceinline__ void consume_tile(Ring& ring, uint64_t* full, uint64_t* empty,
                                             const uint8_t* sm, int stage_bytes, int KT,
                                             int lane, Issue issue) {
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

// ---- host: tensor maps ---------------------------------------------------
//
// cuTensorMapEncodeTiled is a driver-API call and the kernel libraries link
// no libcuda, so it is reached through the runtime's driver entry point.
// Encoding costs host time on every launch, so maps are cached by (pointer,
// shape): a map holds nothing else.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 map of a row-major (outer, inner) matrix with boxes of
// (box_outer, box_inner) elements, 128-byte swizzle, zeros outside.
inline cudaError_t bf16_map(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t outer,
                            uint32_t box_inner, uint32_t box_outer) {
  struct Entry {
    const void* ptr;
    uint64_t inner, outer;
    uint32_t box_inner, box_outer;
    CUtensorMap map;
  };
  static Entry cache[16];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.inner == inner && e.outer == outer && e.box_inner == box_inner &&
        e.box_outer == box_outer) {
      *out = e.map;
      return cudaSuccess;
    }
  }
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Entry& e = cache[next];
  e = {ptr, inner, outer, box_inner, box_outer, map};
  next = (next + 1) % 16;
  if (used < 16) ++used;
  *out = map;
  return cudaSuccess;
}

// the grid of a persistent kernel: one block per SM, at most one per item;
// the dynamic shared-memory limit is raised once per device and kernel (the
// flags are the template's own, one set per kernel)
template <auto KERNEL>
inline cudaError_t persistent_grid(int bytes, int items, int* grid) {
  static bool raised[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  *grid = items < sms[dev] ? items : sms[dev];
  return cudaSuccess;
}

}  // namespace hopper

// every kernel library exports this for ops/build.py::check_cuda
#define PIPNET_EXPORT_ERROR_STRING                                    \
  extern "C" const char* pipnet_cuda_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }

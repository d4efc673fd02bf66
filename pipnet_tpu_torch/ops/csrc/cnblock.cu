// K4: one ConvNeXt block branch, hand-written for Hopper (sm_90a).
//
// Replaces pipnet_tpu/ops/pallas_convnext.py::_cnblock_kernel (the Pallas
// TPU kernel behind make_fused_cnblock).  For every pixel of x (B, H, W, C):
//
//   h  = depthwise7x7(x) + dw_bias                      (f32, 49 taps)
//   z  = LayerNorm(h) * ln_scale + ln_bias              (f32, centred variance,
//                                                        eps 1e-6), cast to T
//   h1 = GELU(z W1 + b1)                                (f32 accumulation and
//                                                        GELU, cast to T)
//   out = ((h1 W2) + b2) * layer_scale                  (f32, cast to T once)
//
// which is the Pallas kernel's rounding order.  W1 and W2 arrive transposed,
// as nn.Linear keeps them: w1t (4C, C), w2t (C, 4C).
//
// What bounds it (B=128, stage 3: 26 x 26 x 768, bf16): the two products,
// 16 * 86528 * 768^2 = 817 GFLOP, 0.83 ms at the 989 TFLOP/s bf16 peak, plus
// the f32 depthwise taps (6.5 GFLOP, 0.10 ms at 67 TFLOP/s); input and output
// are 266 MB, 79 us at 3.35 TB/s: operations bound it.  In f32 the products
// run on the SIMT FMA units at 67 TFLOP/s (TF32 would miss the 1e-5 bar):
// 12.2 ms at B=128, 0.77 ms at B=8, stage 3.
//
// Three launches in both dtypes.  The products need large tiles to run near
// the card's rate, and a tile that keeps h1 on chip between them cannot
// hold a 64-row accumulator over all 768 output columns (384 registers a
// thread), so h1 makes one round trip through device memory (stage 3, bf16:
// 1.06 GB written and read at B=128, 0.32 ms at 3.35 TB/s; f32: 2.13 GB,
// 0.63 ms at B=128 and 0.04 ms at B=8, against products of 12.2 / 0.77 ms
// at the bound):
//   1. cnblock_dwln<T>: the depthwise taps and the LayerNorm of up to 32
//      neighbouring pixels of one image row a block (a thread takes a
//      channel and a strip of 8 pixels, loading each row of their 7 x 14
//      window once: dwconv_tile.cuh's taps; one warp a pixel for the
//      LayerNorm), z (B*H*W, C) written to device memory in T;
//   2. the product with epilogue GELU_BIAS: h1 = GELU(z W1 + b1), (B*H*W, 4C);
//   3. the product with epilogue BIAS_SCALE: out = (h1 W2 + b2) * layer_scale.
// The weights are read K-major from nn.Linear's layout (w1t (4C, C), w2t
// (C, 4C)), so neither is copied; column tiles are the fastest grid index,
// so neighbouring blocks share their A rows in L2, and every block reads its
// weight slab once for 128 rows (the weights, at most 9.4 MB in f32, stay in
// the 50 MB L2).
//
// bf16 products: cnblock_gemm, one output tile of 128 rows x BN columns (BN
// 256 where it divides N, else 128) a block: one producer thread keeps a
// ring of hopper::STAGES stages full by TMA (128-byte swizzle), two
// consumer warpgroups of 64 rows run wgmma m64nBNk16 into f32 registers, and
// the epilogue adds the bias and applies GELU or the layer scale on those
// registers, casts once and stores pairs of columns, masked by row and
// column.  TMA fills zeros past every edge of a tensor: a depth that is not
// a multiple of 64 (C = 96), a ragged last row tile, a column tile past N.
//
// f32 products: cnblock_gemm_f32, one 128 x 128 output tile a block on
// simt_tile.cuh's register-tiled SIMT product (8 x 8 outputs a thread, a
// 3-stage cp.async ring of 32-deep slices, two blocks an SM), the same
// epilogues on the accumulators, f32 stores of 16 neighbouring columns a
// half warp.  The design it replaces fused the whole branch into one launch
// of 32 pixels a block, so every block re-read all of W1 and W2 (18.9 MB at
// C = 768) through a 16-column hidden chunk with four barriers each, and
// ran at 8.6% of the bound.

#include "dwconv_tile.cuh"
#include "simt_tile.cuh"

namespace {

using namespace dwconv_tile;

constexpr int M = 32;          // pixels per tile of the depthwise + LayerNorm stage
constexpr int THREADS = 256;   // 8 warps
constexpr int SW = 8;          // pixels per strip of the depthwise stage
constexpr int MAX_C = 768;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float v, int fast) {
  if (fast) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

using simt::raise_smem;

// The LayerNorm over the channels of each of the first npix pixels of the
// f32 tile S (M x C, shared memory), one warp a pixel: store(m, c, z)
// receives every pixel's normalised, scaled and shifted value in f32 (0 for
// a pixel m >= npix).  Called after a barrier that completes S.
template <typename T, typename Store>
__device__ __forceinline__ void layer_norm(const float* S, int npix, int C,
                                           const T* __restrict__ lns,
                                           const T* __restrict__ lnb, Store&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < M; m += THREADS / 32) {
    if (m >= npix) {
      for (int c = lane; c < C; c += 32) store(m, c, 0.f);
      continue;
    }
    const float* s = S + m * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += s[c];
    const float mu = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) sq += (s[c] - mu) * (s[c] - mu);
    const float rstd = rsqrtf(warp_sum(sq) / C + 1e-6f);
    for (int c = lane; c < C; c += 32)
      store(m, c, (s[c] - mu) * rstd * to_f32(lns[c]) + to_f32(lnb[c]));
  }
}

// A tile of the depthwise + LayerNorm launch is M neighbouring pixels
// of one image row: tile t covers row t / chunks of the B*H rows, columns x0 =
// (t % chunks) * M on, chunks = ceil(W / M); the first npix of its M pixels
// exist, and they are consecutive in the flattened B*H*W axis from p0.
struct Tile {
  int img, y, x0, npix;
  long long p0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W) {
  const int chunks = (W + M - 1) / M, row = t / chunks, x0 = (t - row * chunks) * M;
  return {row / H, row % H, x0, min(M, W - x0), (long long)row * W + x0};
}

// The depthwise 7x7 + bias of tile `tl` of x (B, H, W, C), in f32 into S
// (M x C floats in shared memory).  A thread's item is one channel and a
// strip of SW neighbouring pixels: each input row of their 7 x (SW + 6)
// window is loaded once (dwconv_tile.cuh's taps: the 49 taps of each pixel
// in the Pallas order).
template <typename T>
__device__ __forceinline__ void dw_rows(const T* __restrict__ x, const T* __restrict__ dwk,
                                        const T* __restrict__ dwb, float* S, const Tile& tl,
                                        int H, int W, int C) {
  static_assert(M % SW == 0, "a tile is whole strips");
  for (int item = threadIdx.x; item < C * (M / SW); item += THREADS) {
    const int c = item % C, s0 = (item / C) * SW;
    if (s0 >= tl.npix) continue;
    float wr[TAPS];
    load_weights(dwk, C, c, false, wr);
    const float bias = to_f32(dwb[c]);
    const T* xc = x + (size_t)tl.img * H * W * C + c;
    float acc[SW];
#pragma unroll
    for (int j = 0; j < SW; ++j) acc[j] = 0.f;
    // every load reads a clamped address inside the image, so a window
    // row's loads issue together; taps outside the image are zeroed after
    taps<SW>([&](int dy, int i) {
      const int yy = tl.y + dy - 3, xx = tl.x0 + s0 + i - 3;
      const float v =
          to_f32(xc[((size_t)min(max(yy, 0), H - 1) * W + min(max(xx, 0), W - 1)) * C]);
      return yy >= 0 && yy < H && xx >= 0 && xx < W ? v : 0.f;
    }, wr, acc);
#pragma unroll
    for (int j = 0; j < SW; ++j)
      if (s0 + j < tl.npix) S[(s0 + j) * C + c] = acc[j] + bias;
  }
}

// ---- launch 1: depthwise + LayerNorm, z to device memory -----------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
cnblock_dwln(const T* __restrict__ x, const T* __restrict__ dwk, const T* __restrict__ dwb,
             const T* __restrict__ lns, const T* __restrict__ lnb, T* __restrict__ z, int H,
             int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const Tile tl = tile_of(blockIdx.x, H, W);
  T* zt = z + tl.p0 * C;
  dw_rows(x, dwk, dwb, S, tl, H, W, C);
  __syncthreads();
  layer_norm(S, tl.npix, C, lns, lnb, [&](int m, int c, float v) {
    if (m < tl.npix) zt[(size_t)m * C + c] = from_f32<T>(v);
  });
}

template <typename T>
cudaError_t launch_dwln(const void* x, const void* dwk, const void* dwb, const void* lns,
                        const void* lnb, void* z, int B, int H, int W, int C, cudaStream_t s) {
  const int tiles = B * H * ((W + M - 1) / M), bytes = M * C * 4;
  const cudaError_t err = raise_smem<cnblock_dwln<T>>(bytes);
  if (err != cudaSuccess) return err;
  cnblock_dwln<T><<<tiles, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dwk), static_cast<const T*>(dwb),
      static_cast<const T*>(lns), static_cast<const T*>(lnb), static_cast<T*>(z), H, W, C);
  return cudaGetLastError();
}

// ---- bf16 launches 2 and 3: TMA + wgmma product, fused epilogue -----------

enum Epilogue { GELU_BIAS = 0, BIAS_SCALE = 1 };

// Shared-memory layout of a 128 x BN tile: STAGES stages of the A tile (128
// rows x 64 depth) and the B tile (BN rows x 64 depth), then the ring's
// barriers; offsets from a 1024-byte aligned base.
template <int BN>
struct GemmSmem {
  static constexpr int STAGE = hopper::A_BYTES + BN * hopper::BK * 2;
  static constexpr int BARS = hopper::STAGES * STAGE;
  static constexpr int BYTES = BARS + 2 * hopper::STAGES * 8 + 1024;   // + alignment slack
  static_assert((BN == 128 || BN == 256) && BYTES <= 232448, "tile does not fit");
};

template <int BN>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (BN == 256) hopper::wgmma_m64n256k16_kmajor(d, da, db, accumulate);
  else hopper::wgmma_m64n128k16_kmajor(d, da, db, accumulate);
}

// out (Mrows, N) = epilogue(A (Mrows, K) B^T), B (N, K), all row-major
// bf16; block b computes the tile (b / grid_n, b % grid_n); KT = ceil(K / 64).
// bias (N); scale (N), read by BIAS_SCALE only.
template <int BN, int EPI>
__global__ void __launch_bounds__(hopper::THREADS, 1)
cnblock_gemm(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
             const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ scale,
             __nv_bfloat16* __restrict__ out, int Mrows, int N, int KT, int grid_n,
             int fast_gelu) {
  using namespace hopper;
  using P = GemmSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BARS);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = (blockIdx.x / grid_n) * BM, n0 = (blockIdx.x % grid_n) * BN;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {   // producer
    setmaxnreg_dec<24>();
    if (tid == 2 * 128) {
      Ring ring;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        uint8_t* st = sm + ring.stage * P::STAGE;
        mbar_expect_tx(&full[ring.stage], P::STAGE);
        tma_load_2d(st, &tmA, &full[ring.stage], kt * BK, m0);
        tma_load_2d(st + A_BYTES, &tmB, &full[ring.stage], kt * BK, n0);
        ring.advance();
      }
    }
  } else {         // consumers
    setmaxnreg_inc<240>();
    const int t = tid & 127, lane = t & 31;
    Ring ring;
    float acc[BN / 2];
    // both tiles are K-major, 128 bytes a row: the B tile's descriptor has
    // the A tile's form
    consume_tile(ring, full, empty, sm, P::STAGE, KT, lane, [&](uint32_t st, int kt) {
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_kmajor<BN>(acc, desc_a(st + wg * (A_BYTES / 2), k), desc_a(st + A_BYTES, k),
                         (kt | k) != 0);
    });
    fence_regs(acc);

    // the accumulator fragment (head_tile.cuh): rows r and r + 8, columns
    // 8 j + 2 (lane % 4) + e at acc[4 j + 2 h + e]; N is a multiple of 8, so
    // a pair of columns lies wholly inside or outside the tensor
    const int r = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= N) continue;
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
      float2 s = make_float2(1.f, 1.f);
      if (EPI == BIAS_SCALE)
        s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(scale + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= Mrows) continue;
        float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        if (EPI == GELU_BIAS) {
          v0 = gelu(v0, fast_gelu);
          v1 = gelu(v1, fast_gelu);
        } else {
          v0 *= s.x;
          v1 *= s.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8 * h) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BN, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, const void* bias, const void* scale,
                        void* out, int Mrows, int N, int K, int grid_m, int grid_n, int KT,
                        int fast_gelu, cudaStream_t s) {
  using P = GemmSmem<BN>;
  CUtensorMap tmA, tmB;
  cudaError_t err = hopper::bf16_map(&tmA, a, K, Mrows, hopper::BK, hopper::BM);
  if (err == cudaSuccess) err = hopper::bf16_map(&tmB, b, K, N, hopper::BK, BN);
  if (err == cudaSuccess) err = raise_smem<cnblock_gemm<BN, EPI>>(P::BYTES);
  if (err != cudaSuccess) return err;
  cnblock_gemm<BN, EPI><<<grid_m * grid_n, hopper::THREADS, P::BYTES, s>>>(
      tmA, tmB, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out), Mrows, N, KT,
      grid_n, fast_gelu);
  return cudaGetLastError();
}

// ---- f32 launches 2 and 3: SIMT product, fused epilogue --------------------

// out (Mrows, N) = epilogue(A (Mrows, K) B^T), B (N, K), all row-major f32;
// block b computes the tile (b / grid_n, b % grid_n) of simt::BM x simt::BN.
// bias (N); scale (N), read by BIAS_SCALE only.
template <int EPI>
__global__ void __launch_bounds__(simt::THREADS, simt::MIN_BLOCKS)
cnblock_gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ bias, const float* __restrict__ scale,
                 float* __restrict__ out, int Mrows, int N, int K, int grid_n, int fast_gelu) {
  using namespace simt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = (blockIdx.x / grid_n) * BM, n0 = (blockIdx.x % grid_n) * BN;
  float acc[TR][TC];
  product<B_KMAJOR>(reinterpret_cast<float*>(smem_raw), a + (size_t)m0 * K, K, Mrows - m0,
                    b + (size_t)n0 * K, K, N - n0, K, acc);
  // a half warp stores 16 neighbouring columns of a row: two whole sectors
  float bj[TC], sj[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int col = n0 + frag_col<B_KMAJOR>(j);
    bj[j] = col < N ? bias[col] : 0.f;
    sj[j] = EPI == BIAS_SCALE && col < N ? scale[col] : 1.f;
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = m0 + frag_row(i);
    if (r >= Mrows) continue;
    float* o = out + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = n0 + frag_col<B_KMAJOR>(j);
      if (col >= N) continue;
      const float v = acc[i][j] + bj[j];
      o[col] = EPI == GELU_BIAS ? gelu(v, fast_gelu) : v * sj[j];
    }
  }
}

template <int EPI>
cudaError_t launch_gemm_f32(const void* a, const void* b, const void* bias, const void* scale,
                            void* out, int Mrows, int N, int K, int grid_m, int grid_n,
                            int fast_gelu, cudaStream_t s) {
  constexpr int BYTES = simt::Ring<simt::B_KMAJOR>::BYTES;
  const cudaError_t err = raise_smem<cnblock_gemm_f32<EPI>>(BYTES);
  if (err != cudaSuccess) return err;
  cnblock_gemm_f32<EPI><<<grid_m * grid_n, simt::THREADS, BYTES, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<float*>(out), Mrows, N, K, grid_n, fast_gelu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// launch 1: z (B*H*W, C) from x (B, H, W, C), dw_kernel (7, 7, C) and the
// vectors dw_bias, ln_scale, ln_bias (C); all contiguous, dtype 0 = float32,
// 1 = bfloat16.  C a positive multiple of 8, at most 768.  Launches on
// `stream`; returns the CUDA error code so a refused launch is reported to
// the caller.
int pipnet_cnblock_dwln(const void* x, const void* dwk, const void* dwb, const void* lns,
                        const void* lnb, void* z, int B, int H, int W, int C, int dtype,
                        void* stream) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0
                              ? launch_dwln<float>(x, dwk, dwb, lns, lnb, z, B, H, W, C, s)
                              : launch_dwln<__nv_bfloat16>(x, dwk, dwb, lns, lnb, z, B, H, W,
                                                           C, s));
}

// f32 launches 2 and 3: out (Mrows, N) = epilogue(a (Mrows, K) b^T) with b
// (N, K), bias (N) and, for epilogue 1, scale (N), epilogues as below.  All
// contiguous float32, a and b 16-byte aligned, K and N multiples of 4
// (16-byte cp.async rows).  The plan (ops/cnblock.py::gemm_plan_f32):
// grid_m x grid_n tiles of 128 x 128 covering the output.
int pipnet_cnblock_gemm_f32(const void* a, const void* b, const void* bias, const void* scale,
                            void* out, int Mrows, int N, int K, int grid_m, int grid_n,
                            int epilogue, int fast_gelu, void* stream) {
  if (Mrows <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 4 != 0 ||
      (long long)grid_m * simt::BM < Mrows || (long long)grid_n * simt::BN < N ||
      (long long)grid_m * grid_n > 0x7FFFFFFF ||
      (epilogue != GELU_BIAS && epilogue != BIAS_SCALE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      epilogue == GELU_BIAS
          ? launch_gemm_f32<GELU_BIAS>(a, b, bias, scale, out, Mrows, N, K, grid_m, grid_n,
                                       fast_gelu, s)
          : launch_gemm_f32<BIAS_SCALE>(a, b, bias, scale, out, Mrows, N, K, grid_m, grid_n,
                                        fast_gelu, s));
}

// bf16 launches 2 and 3: out (Mrows, N) = epilogue(a (Mrows, K) b^T) with b
// (N, K), bias (N) and, for epilogue 1, scale (N); epilogue 0 is GELU(. +
// bias) (tanh if fast_gelu, else erf), 1 is (. + bias) * scale.  All
// contiguous bfloat16, 16-byte aligned, K and N multiples of 8 (TMA).  The
// plan (ops/cnblock.py::gemm_plan): tiles of 128 rows x bn (128 or 256)
// columns, grid_m x grid_n of them covering the output, k_steps depth
// stages of 64 covering K.
int pipnet_cnblock_gemm(const void* a, const void* b, const void* bias, const void* scale,
                        void* out, int Mrows, int N, int K, int bn, int grid_m, int grid_n,
                        int k_steps, int epilogue, int fast_gelu, void* stream) {
  if (Mrows <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      (long long)grid_m * hopper::BM < Mrows || (long long)grid_n * bn < N ||
      k_steps * hopper::BK < K || (long long)grid_m * grid_n > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bn != 128 && bn != 256) || (epilogue != GELU_BIAS && epilogue != BIAS_SCALE))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const void*, void*, int,
                                 int, int, int, int, int, int, cudaStream_t);
  static const Launch launch[2][2] = {
      {launch_gemm<128, GELU_BIAS>, launch_gemm<128, BIAS_SCALE>},
      {launch_gemm<256, GELU_BIAS>, launch_gemm<256, BIAS_SCALE>}};
  return static_cast<int>(launch[bn == 256][epilogue](a, b, bias, scale, out, Mrows, N, K, grid_m,
                                                      grid_n, k_steps, fast_gelu,
                                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

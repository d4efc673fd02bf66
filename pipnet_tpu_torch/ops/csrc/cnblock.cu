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
// are 266 MB, 79 us at 3.35 TB/s: operations bound it.
//
// bf16: three launches.  The products need large tiles to run at the
// tensor cores' rate, and a tile that keeps h1 on chip between them cannot
// hold a 64-row accumulator over all 768 output columns (384 registers a
// thread), so h1 makes one round trip through device memory (at stage 3
// 1.06 GB written and read, 0.32 ms at 3.35 TB/s):
//   1. cnblock_dwln: the depthwise taps and the LayerNorm of up to 32
//      neighbouring pixels of one image row a block (a thread takes a
//      channel and a strip of 8 pixels, loading each row of their 7 x 14
//      window once: dwconv_tile.cuh's taps; one warp a pixel for the
//      LayerNorm), z (B*H*W, C) written to device memory;
//   2. cnblock_gemm<GELU_BIAS>: h1 = GELU(z W1 + b1), (B*H*W, 4C);
//   3. cnblock_gemm<BIAS_SCALE>: out = (h1 W2 + b2) * layer_scale.
// cnblock_gemm is one output tile of 128 rows x BN columns (BN 256 where it
// divides N, else 128) a block: one producer thread keeps a ring of
// hopper::STAGES stages full by TMA (128-byte swizzle; the A tile from the
// row-major activations, the B tile from the weight's nn.Linear layout,
// which is K-major, so neither is copied), two consumer warpgroups of 64
// rows run wgmma m64nBNk16 into f32 registers, and the epilogue adds the
// bias and applies GELU or the layer scale on those registers, casts once
// and stores pairs of columns, masked by row and column.  Column tiles are
// the fastest grid index, so neighbouring blocks share their A rows in L2;
// the weights (at most 4.7 MB) stay in the 50 MB L2.  TMA fills zeros past
// every edge of a tensor: a depth that is not a multiple of 64 (C = 96), a
// ragged last row tile, a column tile past N.
//
// f32 keeps the earlier design's one fused launch (cnblock_f32): a block
// owns M = 32 pixels of the flattened B*H*W axis (tiles may cross image
// rows and images), takes their depthwise taps pixel by pixel
// (dwconv_tile.cuh's at_pixel) and the same LayerNorm into shared memory,
// then the hidden dimension in chunks of NH = 16 columns whose W1^T rows and
// W2^T columns are staged by cp.async, ping-ponging between the two SIMT FMA
// products (TF32 would miss 1e-5); neither z nor h1 reaches device memory.
// Every block re-reads all of W1 and W2 from L2, which bounds it well above
// the card's bound.

#include "dwconv_tile.cuh"

namespace {

using namespace dwconv_tile;

constexpr int M = 32;          // pixels per tile of the depthwise + LayerNorm stage
constexpr int THREADS = 256;   // 8 warps
constexpr int SW = 8;          // pixels per strip of the bf16 depthwise stage
constexpr int PG = 4;          // pixel groups of the f32 depthwise stage
constexpr int MAX_C = 768;
constexpr int NH = 16;         // hidden chunk of the f32 products
constexpr int PAD = 4;         // row padding of its shared-memory tiles

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float v, int fast) {
  if (fast) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// Raise KERNEL's dynamic shared-memory limit to `bytes`, on the first launch
// that needs more than the device's last raise only (the flags are the
// template's own, one set per kernel).
template <auto KERNEL>
cudaError_t raise_smem(int bytes) {
  static int raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised[dev] = bytes;
  return err;
}

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

// A tile of the bf16 depthwise + LayerNorm launch is M neighbouring pixels
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

// ---- bf16 launch 1: depthwise + LayerNorm, z to device memory -------------

__global__ void __launch_bounds__(THREADS, 2)
cnblock_dwln(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dwk,
             const __nv_bfloat16* __restrict__ dwb, const __nv_bfloat16* __restrict__ lns,
             const __nv_bfloat16* __restrict__ lnb, __nv_bfloat16* __restrict__ z, int H, int W,
             int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const Tile tl = tile_of(blockIdx.x, H, W);
  __nv_bfloat16* zt = z + tl.p0 * C;
  dw_rows(x, dwk, dwb, S, tl, H, W, C);
  __syncthreads();
  layer_norm(S, tl.npix, C, lns, lnb, [&](int m, int c, float v) {
    if (m < tl.npix) zt[(size_t)m * C + c] = __float2bfloat16(v);
  });
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

// ---- f32: one fused launch --------------------------------------------------

// Shared-memory plan for C channels: S (f32, M x C) is dead once z is
// formed, so the weight staging (Bs1: W1^T chunk, NH x b1ld; Bs2: W2^T
// chunk, C x b2ld) reuses it; Z (M x zld) and H1 (M x hld) follow.
struct Layout {
  int Cp, zld, b1ld, b2ld, hld;     // depth rounded up to 16; row strides in elements
  int bs2_off, z_off, h_off, total;  // byte offsets and size
};

__host__ __device__ Layout layout(int C) {
  Layout L;
  L.Cp = round_up(C, 16);
  L.zld = L.b1ld = L.Cp + PAD;
  L.b2ld = L.hld = NH + PAD;
  L.bs2_off = NH * L.b1ld * 4;
  const int stage = L.bs2_off + C * L.b2ld * 4, s_bytes = M * C * 4;
  L.z_off = round_up(stage > s_bytes ? stage : s_bytes, 16);
  L.h_off = L.z_off + round_up(M * L.zld * 4, 16);
  L.total = L.h_off + round_up(M * L.hld * 4, 16);
  return L;
}

// rows x cols of f32 from src (row stride src_ld) into dst (row stride
// dst_ld), 16 bytes a thread with cp.async, as one commit group; columns
// cols..cols_padded-1 become zeros (a source size of 0 fills zeros).  The
// data is there after cp_async_wait and a barrier.
__device__ __forceinline__ void stage_async(float* dst, int dst_ld, const float* __restrict__ src,
                                            size_t src_ld, int rows, int cols,
                                            int cols_padded) {
  const int per_row = cols_padded / 4;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row, k = (idx % per_row) * 4;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * dst_ld + k));
    const int bytes = k < cols ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src + r * src_ld + (k < cols ? k : 0)), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The hidden dimension in chunks of NH: gemm1(j0) reads the chunk's W1^T
// rows (Bs1) and writes h1; gemm2(j0) reads h1 and the chunk's W2^T columns
// (Bs2).  The next chunk's Bs1 loads during gemm2, its Bs2 during the next
// gemm1; an empty group keeps the count of groups in flight the same at the
// last chunk.  Called after a barrier that ends every read of the S tile.
template <typename Gemm1, typename Gemm2>
__device__ __forceinline__ void hidden_chunks(const Layout& L, float* Bs1, float* Bs2,
                                              const float* __restrict__ w1t,
                                              const float* __restrict__ w2t, int C,
                                              Gemm1&& gemm1, Gemm2&& gemm2) {
  const int hidden = 4 * C;
  auto load_w1 = [&](int j0) {
    stage_async(Bs1, L.b1ld, w1t + (size_t)j0 * C, C, NH, C, L.Cp);
  };
  auto load_w2 = [&](int j0) { stage_async(Bs2, L.b2ld, w2t + j0, hidden, C, NH, NH); };
  load_w1(0);
  load_w2(0);
  for (int j0 = 0; j0 < hidden; j0 += NH) {
    const bool more = j0 + NH < hidden;
    cp_async_wait<1>();            // this chunk's W1^T rows are in
    __syncthreads();
    gemm1(j0);
    __syncthreads();               // h1 is complete and Bs1 free
    if (more) load_w1(j0 + NH);
    else asm volatile("cp.async.commit_group;\n" ::);
    cp_async_wait<1>();            // this chunk's W2^T columns are in
    __syncthreads();
    gemm2(j0);
    __syncthreads();               // Bs2 and h1 free
    if (more) load_w2(j0 + NH);
  }
  cp_async_wait<0>();
}

// NT: the output's 8-column tiles per thread group, ceil(C / 64) rounded up
// to an instantiated count
template <int NT>
__global__ void __launch_bounds__(THREADS, NT <= 3 ? 2 : 1)
cnblock_f32(const float* __restrict__ x, const float* __restrict__ dwk,
            const float* __restrict__ dwb, const float* __restrict__ lns,
            const float* __restrict__ lnb, const float* __restrict__ w1t,
            const float* __restrict__ b1, const float* __restrict__ w2t,
            const float* __restrict__ b2, const float* __restrict__ ls, float* __restrict__ out,
            int npix_total, int H, int W, int C, int fast_gelu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pix_img[M], pix_y[M], pix_x[M];
  const Layout L = layout(C);
  float* S = reinterpret_cast<float*>(smem);
  float* Bs1 = reinterpret_cast<float*>(smem);
  float* Bs2 = reinterpret_cast<float*>(smem + L.bs2_off);
  float* Z = reinterpret_cast<float*>(smem + L.z_off);
  float* H1 = reinterpret_cast<float*>(smem + L.h_off);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * M, npix = min(M, npix_total - p0), HW = H * W;
  if (tid < M) {
    const int p = min(p0 + tid, npix_total - 1), r = p % HW;
    pix_img[tid] = p / HW;
    pix_y[tid] = r / W;
    pix_x[tid] = r % W;
  }
  __syncthreads();

  // 1. depthwise 7x7 + bias in f32 into S; each item's pixels unrolled so
  // their loads overlap
  for (int item = tid; item < C * PG; item += THREADS) {
    const int c = item % C;
    float wr[TAPS];
    load_weights(dwk, C, c, false, wr);
    const float bias = to_f32(dwb[c]);
#pragma unroll 4
    for (int i = 0; i < M / PG; ++i) {
      const int m = item / C + i * PG;
      S[m * C + c] = m < npix ? at_pixel(x + (size_t)pix_img[m] * HW * C, H, W, C, pix_y[m],
                                         pix_x[m], c, wr) + bias
                              : 0.f;
    }
  }
  __syncthreads();

  // 2. LayerNorm, z into shared memory
  layer_norm(S, npix, C, lns, lnb, [&](int m, int c, float v) { Z[m * L.zld + c] = v; });
  __syncthreads();   // S is dead from here: the weight staging overwrites it

  // 3. the two products, hidden dimension in chunks of NH
  constexpr int NJ = 8 * NT;              // output columns cl + 8 j of row `row`
  const int row = tid / 8, cl = tid % 8;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  // h1 chunk (M x NH = 32 x 16): row tid / 8, columns 2 cl and 2 cl + 1
  auto gemm1 = [&](int j0) {
    float h0 = 0.f, h1 = 0.f;
    const float* z = Z + row * L.zld;
    const float* w0 = Bs1 + (2 * cl) * L.b1ld;
    for (int k = 0; k < C; ++k) {
      h0 = fmaf(z[k], w0[k], h0);
      h1 = fmaf(z[k], w0[L.b1ld + k], h1);
    }
    H1[row * L.hld + 2 * cl] = gelu(h0 + b1[j0 + 2 * cl], fast_gelu);
    H1[row * L.hld + 2 * cl + 1] = gelu(h1 + b1[j0 + 2 * cl + 1], fast_gelu);
  };
  auto gemm2 = [&](int) {
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const float a = H1[row * L.hld + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cl + 8 * j;
        if (c < C) acc[j] = fmaf(a, Bs2[c * L.b2ld + k], acc[j]);
      }
    }
  };
  hidden_chunks(L, Bs1, Bs2, w1t, w2t, C, gemm1, gemm2);

  if (row < npix)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cl + 8 * j;
      if (c < C) out[(size_t)(p0 + row) * C + c] = (acc[j] + b2[c]) * ls[c];
    }
}

template <int NT>
int launch_f32(const float* const* p, float* out, int npix, int H, int W, int C, int fast_gelu,
               cudaStream_t s) {
  const int bytes = layout(C).total;
  const cudaError_t err = raise_smem<cnblock_f32<NT>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cnblock_f32<NT><<<(npix + M - 1) / M, THREADS, bytes, s>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], out, npix, H, W, C, fast_gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32, one launch.  params: 10 contiguous float32 device pointers: x (B, H,
// W, C), dw_kernel (7, 7, C), dw_bias, ln_scale, ln_bias (C), w1t (4C, C),
// b1 (4C), w2t (C, 4C), b2, layer_scale (C).  C a positive multiple of 8,
// at most 768.  Launches on `stream`; returns the CUDA error code so a
// refused launch is reported to the caller.
int pipnet_cnblock_f32(const void* const* params, void* out, int B, int H, int W, int C,
                       int fast_gelu, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* p = reinterpret_cast<const float* const*>(params);
  float* o = static_cast<float*>(out);
  const int npix = B * H * W, need = (C + 63) / 64;
  if (need <= 2) return launch_f32<2>(p, o, npix, H, W, C, fast_gelu, s);
  if (need <= 3) return launch_f32<3>(p, o, npix, H, W, C, fast_gelu, s);
  if (need <= 6) return launch_f32<6>(p, o, npix, H, W, C, fast_gelu, s);
  return launch_f32<12>(p, o, npix, H, W, C, fast_gelu, s);
}

// bf16 launch 1: z (B*H*W, C) from x (B, H, W, C), dw_kernel (7, 7, C) and
// the vectors dw_bias, ln_scale, ln_bias (C); all contiguous bfloat16.
int pipnet_cnblock_dwln(const void* x, const void* dwk, const void* dwb, const void* lns,
                        const void* lnb, void* z, int B, int H, int W, int C, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  using T = __nv_bfloat16;
  const int tiles = B * H * ((W + M - 1) / M), bytes = M * C * 4;
  const cudaError_t err = raise_smem<cnblock_dwln>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cnblock_dwln<<<tiles, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dwk), static_cast<const T*>(dwb),
      static_cast<const T*>(lns), static_cast<const T*>(lnb), static_cast<T*>(z), H, W, C);
  return static_cast<int>(cudaGetLastError());
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

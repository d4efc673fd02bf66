// K4: one ConvNeXt block branch, fused, hand-written for Hopper (sm_90a).
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
// Design (right and simple first).  The Pallas kernel holds a whole image in
// VMEM; on Hopper a block owns M = 32 pixels of the flattened B*H*W axis and
// all C channels (the LayerNorm reduces over channels), so tiles may cross
// image rows and images and only the last one is ragged.
//   1. Depthwise stage (dwconv_tile.cuh): one item per (channel, group of 8
//      pixels) reads its 7x7 neighbourhoods from device memory through L1,
//      zero outside each pixel's own image, into an f32 tile S (M x C).
//   2. LayerNorm: one warp per pixel; z goes to shared memory in T.
//   3. The two products, hidden dimension in chunks of NH columns (32 in
//      bf16, 16 in f32): the chunk's W1^T rows and W2^T columns are staged
//      in shared memory (over the dead S tile); h1 = z W1[:, chunk] with f32
//      accumulation, + b1 and GELU in f32, cast into shared memory; then
//      h1 W2[chunk, :] is added into the M x C f32 output accumulator held
//      in registers.  Neither z nor h1 reaches device memory.  The staging
//      is asynchronous (cp.async) and ping-pongs between the two products:
//      the next chunk's W1^T rows load while this chunk's second product
//      runs, its W2^T columns while its first product runs, so the loads'
//      latency hides behind the products without a second buffer.
//   bf16 products are mma.sync.m16n8k16 tensor-core tiles (head_tile.cuh's
//   fragment layout); f32 products are SIMT FMA (TF32 would miss 1e-5).
// Budget at C = 768: the output accumulator is 96 KB of f32, 96 registers a
// thread at 256 threads; shared memory is 163 KB in bf16 (z 49.7 KB, W1^T
// chunk 49.7 KB, W2^T chunk 61.4 KB, h1 2.5 KB) and 212 KB in f32, so one
// block per SM, set with cudaFuncSetAttribute.  At C <= 192 (stages 0-1)
// a block needs under 45 KB and few accumulator registers, so two blocks
// share an SM (launch bounds of 128 registers a thread).
//
// Bound at B=128, stage 3 (26 x 26 x 768, bf16): the products are
// 16 * 86528 * 768^2 = 817 GFLOP, 0.83 ms at the 989 TFLOP/s bf16 peak, plus
// the f32 depthwise taps (6.5 GFLOP, 0.10 ms at 67 TFLOP/s); input + output
// are 266 MB, 79 us at 3.35 TB/s: operations bound it.  What this design
// leaves on the table: every block re-reads all of W1 and W2 (9.4 MB at
// C = 768) from L2, 25 GB at that shape, which bounds this design well above
// the card's bound; wgmma/TMA multicast across a cluster, larger M and weight
// reuse across tiles are later work.

#include "dwconv_tile.cuh"

namespace {

using namespace dwconv_tile;
using head_tile::mma_bf16_16816;

constexpr int M = 32;          // pixels per block
constexpr int THREADS = 256;   // 8 warps
constexpr int PG = 4;          // pixel groups of the depthwise stage
constexpr int MAX_C = 768;

template <typename T> struct Plan;   // hidden chunk width and row padding
template <> struct Plan<__nv_bfloat16> { static constexpr int NH = 32, PAD = 8; };
template <> struct Plan<float> { static constexpr int NH = 16, PAD = 4; };

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory plan for C channels: S (f32, M x C) is dead once z is
// formed, so the weight staging (Bs1: W1^T chunk, NH x b1ld; Bs2: W2^T
// chunk, C x b2ld) reuses it; Z (M x zld) and H1 (M x hld) follow.
struct Layout {
  int Cp, zld, b1ld, b2ld, hld;     // depth rounded up to 16; row strides in elements
  int bs2_off, z_off, h_off, total;  // byte offsets and size
};

template <typename T>
__host__ __device__ Layout layout(int C) {
  constexpr int NH = Plan<T>::NH, PAD = Plan<T>::PAD, ES = sizeof(T);
  Layout L;
  L.Cp = round_up(C, 16);
  L.zld = L.b1ld = L.Cp + PAD;
  L.b2ld = L.hld = NH + PAD;
  L.bs2_off = NH * L.b1ld * ES;
  const int stage = L.bs2_off + C * L.b2ld * ES, s_bytes = M * C * 4;
  L.z_off = round_up(stage > s_bytes ? stage : s_bytes, 16);
  L.h_off = L.z_off + round_up(M * L.zld * ES, 16);
  L.total = L.h_off + round_up(M * L.hld * ES, 16);
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float v, int fast) {
  if (fast) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// rows x cols of T from src (row stride src_ld) into dst (row stride
// dst_ld), 16 bytes a thread with cp.async, as one commit group; columns
// cols..cols_padded-1 become zeros (a source size of 0 fills zeros).  The
// data is there after cp_async_wait and a barrier.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, int dst_ld, const T* __restrict__ src,
                                            size_t src_ld, int rows, int cols,
                                            int cols_padded) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols_padded / VEC;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row, k = (idx % per_row) * VEC;
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
template <typename T, typename Gemm1, typename Gemm2>
__device__ __forceinline__ void hidden_chunks(const Layout& L, T* Bs1, T* Bs2,
                                              const T* __restrict__ w1t,
                                              const T* __restrict__ w2t, int C,
                                              Gemm1&& gemm1, Gemm2&& gemm2) {
  constexpr int NH = Plan<T>::NH;
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

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 3 ? 2 : 1)
cnblock_kernel(const T* __restrict__ x, const T* __restrict__ dwk, const T* __restrict__ dwb,
               const T* __restrict__ lns, const T* __restrict__ lnb, const T* __restrict__ w1t,
               const T* __restrict__ b1, const T* __restrict__ w2t, const T* __restrict__ b2,
               const T* __restrict__ ls, T* __restrict__ out, int npix_total, int H, int W,
               int C, int fast_gelu) {
  constexpr int NH = Plan<T>::NH;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pix_img[M], pix_y[M], pix_x[M];
  const Layout L = layout<T>(C);
  float* S = reinterpret_cast<float*>(smem);
  T* Bs1 = reinterpret_cast<T*>(smem);
  T* Bs2 = reinterpret_cast<T*>(smem + L.bs2_off);
  T* Z = reinterpret_cast<T*>(smem + L.z_off);
  T* H1 = reinterpret_cast<T*>(smem + L.h_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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

  // 2. LayerNorm over the channels of each pixel, one warp per pixel
  for (int m = warp; m < M; m += THREADS / 32) {
    const float* s = S + m * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += s[c];
    const float mu = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) sq += (s[c] - mu) * (s[c] - mu);
    const float rstd = rsqrtf(warp_sum(sq) / C + 1e-6f);
    for (int c = lane; c < L.Cp; c += 32)
      Z[m * L.zld + c] = from_f32<T>(c < C && m < npix
                                         ? (s[c] - mu) * rstd * to_f32(lns[c]) + to_f32(lnb[c])
                                         : 0.f);
  }
  __syncthreads();   // S is dead from here: the weight staging overwrites it

  // 3. the two products, hidden dimension in chunks of NH
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int g = lane >> 2, t = lane & 3;
    const int ntiles = C / 8;
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

    // h1 chunk (M x NH): warp w owns rows 16 (w & 1), columns 8 (w >> 1)
    auto gemm1 = [&](int j0) {
      const int mi = warp & 1, ni = warp >> 1;
      float c2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      auto step = [&](int kb, float (&c)[4]) {
        const T* ab = Z + (16 * mi + g) * L.zld + kb + 2 * t;
        const T* bb = Bs1 + (8 * ni + g) * L.b1ld + kb + 2 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ab),
                               *reinterpret_cast<const uint32_t*>(ab + 8 * L.zld),
                               *reinterpret_cast<const uint32_t*>(ab + 8),
                               *reinterpret_cast<const uint32_t*>(ab + 8 * L.zld + 8)};
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(bb),
                               *reinterpret_cast<const uint32_t*>(bb + 8)};
        mma_bf16_16816(c, a, b);
      };
      for (int kb = 0; kb < L.Cp; kb += 32) {     // two chains, for latency
        step(kb, c2[0]);
        if (kb + 16 < L.Cp) step(kb + 16, c2[1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mi + g + (q >= 2 ? 8 : 0), col = 8 * ni + 2 * t + (q & 1);
        H1[r * L.hld + col] = from_f32<T>(gelu(c2[0][q] + c2[1][q] + to_f32(b1[j0 + col]),
                                               fast_gelu));
      }
    };
    auto gemm2 = [&](int) {
#pragma unroll
      for (int kb = 0; kb < NH; kb += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const T* ab = H1 + (16 * mi + g) * L.hld + kb + 2 * t;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(ab);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(ab + 8 * L.hld);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(ab + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(ab + 8 * L.hld + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int nt = warp + 8 * j;      // warp-uniform
          if (nt < ntiles) {
            const T* bb = Bs2 + (8 * nt + g) * L.b2ld + kb + 2 * t;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(bb),
                                   *reinterpret_cast<const uint32_t*>(bb + 8)};
            mma_bf16_16816(acc[0][j], a[0], b);
            mma_bf16_16816(acc[1][j], a[1], b);
          }
        }
      }
    };
    hidden_chunks(L, Bs1, Bs2, w1t, w2t, C, gemm1, gemm2);

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nt = warp + 8 * j, col = 8 * nt + 2 * t;
        if (nt >= ntiles) continue;
        const float bias0 = to_f32(b2[col]), bias1 = to_f32(b2[col + 1]);
        const float s0 = to_f32(ls[col]), s1 = to_f32(ls[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mi + g + 8 * half;
          if (r >= npix) continue;
          __nv_bfloat162 v;
          v.x = __float2bfloat16((acc[mi][j][2 * half] + bias0) * s0);
          v.y = __float2bfloat16((acc[mi][j][2 * half + 1] + bias1) * s1);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(p0 + r) * C + col) = v;
        }
      }
  } else {
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
}

template <typename T, int NT>
int launch(const void* const* p, void* out, int npix, int H, int W, int C, int fast_gelu,
           cudaStream_t s) {
  const int bytes = layout<T>(C).total;
  cudaError_t err = cudaFuncSetAttribute(cnblock_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* const* q = reinterpret_cast<const T* const*>(p);
  cnblock_kernel<T, NT><<<(npix + M - 1) / M, THREADS, bytes, s>>>(
      q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], static_cast<T*>(out), npix,
      H, W, C, fast_gelu);
  return static_cast<int>(cudaGetLastError());
}

// the output's n-tiles (8 columns) per warp: ceil(C / 64), rounded up to an
// instantiated count
template <typename T>
int dispatch(const void* const* p, void* out, int npix, int H, int W, int C, int fast_gelu,
             cudaStream_t s) {
  const int need = (C + 63) / 64;
  if (need <= 2) return launch<T, 2>(p, out, npix, H, W, C, fast_gelu, s);
  if (need <= 3) return launch<T, 3>(p, out, npix, H, W, C, fast_gelu, s);
  if (need <= 6) return launch<T, 6>(p, out, npix, H, W, C, fast_gelu, s);
  return launch<T, 12>(p, out, npix, H, W, C, fast_gelu, s);
}

}  // namespace

extern "C" {

// params: 10 device pointers of one dtype (0 = float32, 1 = bfloat16), all
// contiguous: x (B, H, W, C), dw_kernel (7, 7, C), dw_bias, ln_scale,
// ln_bias (C), w1t (4C, C), b1 (4C), w2t (C, 4C), b2, layer_scale (C).
// C must be a positive multiple of 8, at most 768.  Launches on `stream`;
// returns the CUDA error code so a refused launch is reported to the caller.
int pipnet_cnblock_forward(const void* const* params, void* out, int B, int H, int W, int C,
                           int fast_gelu, int dtype, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = B * H * W;
  if (dtype == 0) return dispatch<float>(params, out, npix, H, W, C, fast_gelu, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(params, out, npix, H, W, C, fast_gelu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

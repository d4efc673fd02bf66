// K3: depthwise 7x7 'SAME' convolution, hand-written for Hopper (sm_90a).
//
// Replaces pipnet_tpu/ops/pallas_dwconv.py::_dw_kernel (the Pallas TPU
// kernel behind make_dwconv7x7).  For x (B, H, W, C) and w (7, 7, C):
//
//   out[b, y, x, c] = sum_{dy, dx} x[b, y + dy - 3, x + dx - 3, c] * w[dy, dx, c]
//
// with zeros outside the image, f32 multiply-adds in the Pallas order (dy
// outer, dx inner, one fused multiply-add per tap), and the result cast to
// x's dtype.  `flip` reverses both spatial axes of w: the input gradient is
// this same kernel on the cotangent with the flipped weights.
//
// What bounds it on an H100, at B=128 and stage 3 (26 x 26 x 768) in bf16:
// 2 x 49 x 66.4 M = 6.5 GFLOP of f32 FMA, 97 us at the 67 TFLOP/s f32 peak,
// against 133 MB read + 133 MB written, 79 us at 3.35 TB/s: operations on
// the SIMT units.  So the design spends as few instructions as it can on
// anything but the 49 FMAs of an output, and computes no output it drops.
//
// Design: rows rolled down the image.  A thread owns one channel of one
// image and a strip of neighbouring output columns, and walks down the
// whole height.  Each input row is read once, with its 3-column halo, and
// feeds the 7 output rows around it, whose partial sums live in registers
// as a ring of 7 rows; output row y takes its input rows y - 3 .. y + 3 in
// ascending order, so its taps still run dy outer, dx inner.  When input
// row y + 3 is done, output row y is complete, stored and its ring slot
// cleared for row y + 7.  The 49 weights stay in registers.  Two ways to
// get the rows in:
// - the TMA row ring (dwconv7x7_ring, for rows of x that are 16-byte
//   aligned: every ConvNeXt stage): a producer warp keeps RING input rows
//   in flight in shared memory, each one 4-D TMA box whose halo TMA fills
//   with zeros, and 32 channels x strips of 4 columns consume them;
// - direct loads (dwconv7x7_rows, any C): each lane loads its own row into
//   registers one row ahead, the halo through L1, strips the widest of 4,
//   3, 2, 1 columns that divides W.
// On an H100 the ring keeps the card's FMA units about a third busy
// (PERF.md); the direct loads, with one row ahead in 128 registers, half that.
//
// What the previous design (8 x 8 tiles through shared memory) lost, from
// clock64() timers on an H100 (PERF.md): 77% of a block's time in the
// halo load before any tap could start.

#include "dwconv_tile.cuh"

namespace {

using namespace dwconv_tile;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// columns x0 - 3 .. x0 + SW + 2 of one input row (`at` is column x0), zero
// outside the image
template <typename T, int SW>
__device__ __forceinline__ void load_row(const T* __restrict__ at, int C,
                                         const bool (&inside)[SW + 6], float (&v)[SW + 6]) {
#pragma unroll
  for (int i = 0; i < SW + 6; ++i) v[i] = inside[i] ? to_f32(at[(long long)(i - 3) * C]) : 0.f;
}

// One warp: 32 neighbouring channels of one image and one strip of SW
// output columns; each lane walks down the image.
template <typename T, int SW>
__global__ void __launch_bounds__(THREADS, 2)
dwconv7x7_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int B,
               int H, int W, int C, int strips, int flip) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long per_image = (long long)((C + 31) / 32) * strips;
  if (item >= (long long)B * per_image) return;
  const int b = (int)(item / per_image);
  const int rem = (int)(item % per_image);
  const int c = (rem / strips) * 32 + lane, x0 = (rem % strips) * SW;
  if (c >= C) return;

  float wr[TAPS];
  load_weights(w, C, c, flip != 0, wr);
  bool inside[SW + 6];
#pragma unroll
  for (int i = 0; i < SW + 6; ++i) inside[i] = x0 - 3 + i >= 0 && x0 - 3 + i < W;
  // element (row 0, column x0) of this channel in x and out
  const T* xb = x + ((size_t)b * H * W + x0) * C + c;
  T* ob = out + ((size_t)b * H * W + x0) * C + c;
  const size_t row_step = (size_t)W * C;

  float acc[7][SW];   // slot y % 7 holds output row y
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int j = 0; j < SW; ++j) acc[s][j] = 0.f;
  float row[SW + 6], next[SW + 6];
  load_row<T, SW>(xb, C, inside, next);

  for (int y0 = 0; y0 < H + 3; y0 += 7) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {       // input row yi = y0 + k, y0 a multiple of 7
      const int yi = y0 + k;
      if (yi < H) {
#pragma unroll
        for (int i = 0; i < SW + 6; ++i) row[i] = next[i];
        if (yi + 1 < H) load_row<T, SW>(xb + (size_t)(yi + 1) * row_step, C, inside, next);
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
          const int y = yi + 3 - dy;      // the output row this input row feeds through dy
          if (y < 0 || y >= H) continue;
          float(&a)[SW] = acc[(k + 10 - dy) % 7];
#pragma unroll
          for (int dx = 0; dx < 7; ++dx)
#pragma unroll
            for (int j = 0; j < SW; ++j) a[j] = fmaf(row[j + dx], wr[dy * 7 + dx], a[j]);
        }
      }
      // output row yi - 3 has had its last tap
      float(&done)[SW] = acc[(k + 4) % 7];
      const int y = yi - 3;
      if (y >= 0 && y < H) {
#pragma unroll
        for (int j = 0; j < SW; ++j)
          if (x0 + j < W) ob[(size_t)y * row_step + (size_t)j * C] = from_f32<T>(done[j]);
      }
#pragma unroll
      for (int j = 0; j < SW; ++j) done[j] = 0.f;
    }
  }
}

template <typename T, int SW>
int launch_strips(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
                  cudaStream_t s) {
  const int strips = (W + SW - 1) / SW;
  const long long warps = (long long)B * ((C + 31) / 32) * strips;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dwconv7x7_rows<T, SW><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), B, H, W, C,
      strips, flip);
  return static_cast<int>(cudaGetLastError());
}

// ---- the TMA row ring ------------------------------------------------------
//
// For C * sizeof(T) a multiple of 16 (every ConvNeXt stage): a block owns
// CT = 32 channels of one image and up to MAXW strips of SW = 4 columns,
// one consumer warp each, and walks down the image.  A producer warp keeps
// a ring of RING input rows in shared memory full: each row is one 4-D TMA
// box (CT channels x the strips' columns and their 3-column halo) of x
// seen as (C, W, H, B), started at column x0 - 3, which TMA fills with zeros
// outside the image, so the consumers read the halo without a branch.  A
// consumer lane is one channel: per input row it reads SW + 6 values from
// shared memory (32 lanes, 32 neighbouring elements: no bank conflict) and
// runs the same rolled 7-row ring of partial sums in registers as above.
// Taps of output rows outside the image are computed and dropped (7% of
// them at H = 26) rather than branched around.

constexpr int CT = 32;            // channels per block: one per consumer lane
constexpr int TSW = 4;            // columns per strip
constexpr int MAXW = 7;           // consumer warps (strips) per block at most
constexpr int RING = 8;           // input rows in flight

template <typename T>
struct RowRing {
  static constexpr int BOX_W = MAXW * TSW + 6;
  static constexpr int STAGE = (CT * BOX_W * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int BYTES = RING * STAGE + 2 * RING * 8 + 128;   // + barriers, alignment
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__((MAXW + 1) * 32, 2)
dwconv7x7_ring(const __grid_constant__ CUtensorMap tmx, const T* __restrict__ w,
               T* __restrict__ out, int H, int W, int C, int warps, int flip) {
  using namespace hopper;
  using Ring = RowRing<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * Ring::STAGE);
  uint64_t* empty = full + RING;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CT, x_first = blockIdx.y * warps * TSW, b = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], warps);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {                  // producer
    if (lane == 0) {
      const int bytes = CT * (warps * TSW + 6) * (int)sizeof(T);   // one box, zeros included
      for (int yi = 0; yi < H; ++yi) {
        const int s = yi % RING;
        mbar_wait(&empty[s], ((yi / RING) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        tma_load_4d(ring + s * Ring::STAGE, &tmx, &full[s], c0, x_first - 3, yi, b);
      }
    }
    return;
  }

  // consumer: channel c, output columns x0 .. x0 + TSW - 1
  const int c = c0 + lane, x0 = x_first + warp * TSW;
  float wr[TAPS];
  load_weights(w, C, c, flip != 0, wr);
  const bool store_c = c < C;
  T* ob = out + ((size_t)b * H * W + x0) * C + c;
  const size_t row_step = (size_t)W * C;
  const T* mine = reinterpret_cast<const T*>(ring) + warp * TSW * CT + lane;

  float acc[7][TSW];
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int j = 0; j < TSW; ++j) acc[s][j] = 0.f;

  for (int y0 = 0; y0 < H + 3; y0 += 7) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int yi = y0 + k;
      if (yi < H) {
        const int s = yi % RING;
        mbar_wait(&full[s], (yi / RING) & 1);
        const T* src = mine + s * (Ring::STAGE / (int)sizeof(T));
        float row[TSW + 6];
#pragma unroll
        for (int i = 0; i < TSW + 6; ++i) row[i] = to_f32(src[i * CT]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
          float(&a)[TSW] = acc[(k + 10 - dy) % 7];
#pragma unroll
          for (int dx = 0; dx < 7; ++dx)
#pragma unroll
            for (int j = 0; j < TSW; ++j) a[j] = fmaf(row[j + dx], wr[dy * 7 + dx], a[j]);
        }
      }
      float(&done)[TSW] = acc[(k + 4) % 7];
      const int y = yi - 3;
      if (y >= 0 && y < H && store_c) {
#pragma unroll
        for (int j = 0; j < TSW; ++j)
          if (x0 + j < W) ob[(size_t)y * row_step + (size_t)j * C] = from_f32<T>(done[j]);
      }
#pragma unroll
      for (int j = 0; j < TSW; ++j) done[j] = 0.f;
    }
  }
}

// x seen as (C, W, H, B) with (CT, box_w, 1, 1) boxes, zeros outside; maps
// are cached by (pointer, shape), as hopper::bf16_map caches its own
template <typename T>
cudaError_t x_map(CUtensorMap* out, const void* ptr, int B, int H, int W, int C, int box_w) {
  struct Entry {
    const void* ptr;
    int B, H, W, C, box_w;
    CUtensorMap map;
  };
  static Entry cache[16];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.B == B && e.H == H && e.W == W && e.C == C && e.box_w == box_w) {
      *out = e.map;
      return cudaSuccess;
    }
  }
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * es, (cuuint64_t)W * C * es, (cuuint64_t)H * W * C * es};
  const cuuint32_t box[4] = {CT, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (encode(&map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  Entry& e = cache[next];
  e = {ptr, B, H, W, C, box_w, map};
  next = (next + 1) % 16;
  if (used < 16) ++used;
  *out = map;
  return cudaSuccess;
}

template <typename T>
int launch_ring(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
                cudaStream_t s) {
  // strips of TSW columns, cut into chunks of at most MAXW, one chunk a block
  const int strips = (W + TSW - 1) / TSW;
  const int chunks = (strips + MAXW - 1) / MAXW;
  const int warps = (strips + chunks - 1) / chunks;
  CUtensorMap map;
  cudaError_t err = x_map<T>(&map, x, B, H, W, C, warps * TSW + 6);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = dwconv7x7_ring<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RowRing<T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((C + CT - 1) / CT, chunks, B), (warps + 1) * 32, RowRing<T>::BYTES, s>>>(
      map, static_cast<const T*>(w), static_cast<T*>(out), H, W, C, warps, flip);
  return static_cast<int>(cudaGetLastError());
}

// the TMA ring where x's rows are 16-byte aligned; else the direct loads,
// with the widest strip that divides W
template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
           cudaStream_t s) {
  if ((C * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_ring<T>(x, w, out, B, H, W, C, flip, s);
  if (W % 4 == 0) return launch_strips<T, 4>(x, w, out, B, H, W, C, flip, s);
  if (W % 3 == 0) return launch_strips<T, 3>(x, w, out, B, H, W, C, flip, s);
  if (W % 2 == 0) return launch_strips<T, 2>(x, w, out, B, H, W, C, flip, s);
  return launch_strips<T, 1>(x, w, out, B, H, W, C, flip, s);
}

}  // namespace

extern "C" {

// x, out (B, H, W, C) and w (7, 7, C), contiguous, of one dtype: 0 = float32,
// 1 = bfloat16.  Launches on `stream`; returns cudaGetLastError() so a
// refused launch is reported to the caller.
int pipnet_dwconv7x7(const void* x, const void* w, void* out, int B, int H, int W, int C,
                     int flip, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (dtype == 0) return launch<float>(x, w, out, B, H, W, C, flip, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, B, H, W, C, flip, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

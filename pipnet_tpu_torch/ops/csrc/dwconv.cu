// K3: depthwise 7x7 'SAME' convolution, hand-written for Hopper (sm_90a).
//
// Replaces pipnet_tpu/ops/pallas_dwconv.py::_dw_kernel (the Pallas TPU
// kernel behind make_dwconv7x7).  For x (B, H, W, C) and w (7, 7, C):
//
//   out[b, y, x, c] = sum_{dy, dx} x[b, y + dy - 3, x + dx - 3, c] * w[dy, dx, c]
//
// with zeros outside the image, 49 f32 multiply-adds per output, and the
// result cast to x's dtype.  `flip` reverses both spatial axes of w: the
// input gradient is this same kernel on the cotangent with the flipped
// weights.
//
// Design (right and simple first).  A block owns an 8 x 8 spatial tile of
// one image and a slice of 32 channels.  The tile and its 3-pixel halo
// (14 x 14 x 32) are loaded once into shared memory as f32, with 16-byte
// channel-vector loads where the slice lies inside C (scalar loads at a
// ragged channel edge), zeros outside the image.  Each of the 256 threads
// owns one channel and one output row of 8 pixels: per tap row it reads 14
// values from shared memory (a warp reads 32 neighbouring channels, so no
// bank conflicts) and does 8 x 7 multiply-adds with its 49 weights held in
// registers.
//
// Bound at B=128, stage 3 (26 x 26 x 768) in bf16: 133 MB read + 133 MB
// written, 79 us at 3.35 TB/s; 2 x 49 x 66.4 M = 6.5 GFLOP of f32 FMA, 97 us
// at the 67 TFLOP/s f32 peak: operations on the SIMT units bound it, not
// the tensor cores.  The halo costs (14 x 14) / (8 x 8) = 3x reads of the
// tile from L2; edge tiles of 26 x 26 maps are a quarter empty.

#include "dwconv_tile.cuh"

namespace {

using namespace dwconv_tile;

constexpr int TH = 8, TW = 8;        // output tile (rows, columns)
constexpr int CT = 32;               // channels per block
constexpr int THREADS = CT * TH;     // one thread per (channel, output row)
constexpr int HALO_H = TH + 6, HALO_W = TW + 6;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dwconv7x7_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                 int H, int W, int C, int tiles_x, int flip) {
  __shared__ float tile[HALO_H * HALO_W][CT];
  constexpr int VEC = 16 / sizeof(T);          // channels per 16-byte load
  constexpr int VECS = CT / VEC;
  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int c0 = blockIdx.y * CT;
  const T* xb = x + (size_t)blockIdx.z * H * W * C;

  for (int idx = tid; idx < HALO_H * HALO_W * VECS; idx += THREADS) {
    const int pos = idx / VECS, cv = (idx % VECS) * VEC;
    const int yy = y0 + pos / HALO_W - 3, xx = x0 + pos % HALO_W - 3;
    float v[VEC];
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* src = xb + ((long long)yy * W + xx) * C + c0 + cv;   // read only if inside
    if (inside && C % VEC == 0 && c0 + cv + VEC <= C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = (inside && c0 + cv + i < C) ? to_f32(src[i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) tile[pos][cv + i] = v[i];
  }

  const int c = tid % CT, ty = tid / CT;
  float wr[TAPS];
  load_weights(w, C, c0 + c, flip != 0, wr);
  __syncthreads();

  float acc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) acc[j] = 0.f;
  taps<TW>([&](int dy, int i) { return tile[(ty + dy) * HALO_W + i][c]; }, wr, acc);

  const int y = y0 + ty;
  if (y >= H || c0 + c >= C) return;
  T* ob = out + ((size_t)blockIdx.z * H * W + (size_t)y * W) * C + c0 + c;
#pragma unroll
  for (int j = 0; j < TW; ++j)
    if (x0 + j < W) ob[(size_t)(x0 + j) * C] = from_f32<T>(acc[j]);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int C, int flip,
           cudaStream_t s) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (C + CT - 1) / CT, B);
  dwconv7x7_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(w), static_cast<T*>(out),
                                               H, W, C, tiles_x, flip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out (B, H, W, C) and w (7, 7, C), contiguous, of one dtype: 0 = float32,
// 1 = bfloat16.  Launches on `stream`; returns cudaGetLastError() so a
// refused launch is reported to the caller.
int pipnet_dwconv7x7(const void* x, const void* w, void* out, int B, int H, int W, int C,
                     int flip, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, B, H, W, C, flip, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, B, H, W, C, flip, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

PIPNET_EXPORT_ERROR_STRING

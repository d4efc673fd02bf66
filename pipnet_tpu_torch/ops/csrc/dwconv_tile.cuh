// Device code shared by the depthwise 7x7 kernels (K3 dwconv.cu and the
// first stage of K4 cnblock.cu): the 49 taps of a depthwise 7x7 'SAME'
// convolution, accumulated in f32 in the Pallas kernels' order (dy outer, dx
// inner, one fused multiply-add per tap).
#pragma once

#include "head_tile.cuh"

namespace dwconv_tile {

using head_tile::from_f32;
using head_tile::to_f32;

constexpr int TAPS = 49;

// One channel's 49 weights from a (7, 7, C) kernel, as f32 registers;
// `flip` reverses both spatial axes (the input gradient's kernel).  Channels
// at or beyond C get zero weights.
template <typename T>
__device__ __forceinline__ void load_weights(const T* __restrict__ w, int C, int c, bool flip,
                                             float (&wr)[TAPS]) {
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
    wr[t] = c < C ? to_f32(w[(size_t)(flip ? TAPS - 1 - t : t) * C + c]) : 0.f;
}

// acc[j] += sum over (dy, dx) of src(dy, j + dx) * w[7 dy + dx], for NPIX
// neighbouring outputs along x.  src(dy, i) is the f32 input at row offset
// dy and column offset i of the outputs' 7 x (NPIX + 6) window, zero outside
// the image.
template <int NPIX, typename Src>
__device__ __forceinline__ void taps(const Src& src, const float (&w)[TAPS],
                                     float (&acc)[NPIX]) {
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
    float row[NPIX + 6];
#pragma unroll
    for (int i = 0; i < NPIX + 6; ++i) row[i] = src(dy, i);
#pragma unroll
    for (int dx = 0; dx < 7; ++dx)
#pragma unroll
      for (int j = 0; j < NPIX; ++j) acc[j] = fmaf(row[j + dx], w[dy * 7 + dx], acc[j]);
  }
}

// The depthwise output at pixel (y, x), channel c of one image xb (H, W, C)
// in device memory, in f32: the input is read through L1, zero outside.
template <typename T>
__device__ __forceinline__ float at_pixel(const T* __restrict__ xb, int H, int W, int C,
                                          int y, int x, int c, const float (&w)[TAPS]) {
  float acc[1] = {0.f};
  taps<1>([&](int dy, int i) {
    const int yy = y + dy - 3, xx = x + i - 3;
    return (yy >= 0 && yy < H && xx >= 0 && xx < W) ? to_f32(xb[((size_t)yy * W + xx) * C + c])
                                                    : 0.f;
  }, w, acc);
  return acc[0];
}

}  // namespace dwconv_tile

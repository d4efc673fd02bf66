// Native host-side preprocessing for the data loader (the PyTorch port's
// copy of the JAX package's source).
//
// The per-image hot path -- uint8 HWC -> bilinear resize -> crop ->
// horizontal flip -> normalized float32 HWC -- is one C++ pass over the
// pixels, loaded via ctypes (pipnet_tpu_torch/native/__init__.py), writing
// straight into the caller's buffer.
//
// Build (done at first use by the wrapper, into build/native/):
//   g++ -O3 -ffp-contract=off -shared -fPIC preprocess.cc -o libpipnet_native-<hash>.so

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear-resize src (sh x sw x 3, uint8) to (dh x dw), then take the crop
// at (cy, cx) of size (ch x cw), optional horizontal flip, normalize with
// per-channel mean/std, and write float32 HWC into dst (ch x cw x 3).
void resize_crop_normalize(const uint8_t* src, int sh, int sw,
                           int dh, int dw,
                           int cy, int cx, int ch, int cw,
                           int hflip,
                           const float* mean, const float* std_,
                           float* dst) {
  // half-pixel sampling convention, matching PIL / torchvision bilinear
  // (align_corners=False): src_pos = (dst_pos + 0.5) * src/dst - 0.5.
  const float scale_y = (float)sh / (float)dh;
  const float scale_x = (float)sw / (float)dw;
  const float inv_std[3] = {1.f / std_[0], 1.f / std_[1], 1.f / std_[2]};
  const float k = 1.f / 255.f;

  for (int y = 0; y < ch; ++y) {
    const float fy = std::max(0.f, ((float)(cy + y) + 0.5f) * scale_y - 0.5f);
    const int y0 = std::min((int)fy, sh - 1);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - (float)y0;
    float* row = dst + (size_t)y * cw * 3;
    for (int x = 0; x < cw; ++x) {
      const int out_x = hflip ? (cw - 1 - x) : x;
      const float fx = std::max(0.f, ((float)(cx + x) + 0.5f) * scale_x - 0.5f);
      const int x0 = std::min((int)fx, sw - 1);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - (float)x0;
      const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * 3;
      const uint8_t* p01 = src + ((size_t)y0 * sw + x1) * 3;
      const uint8_t* p10 = src + ((size_t)y1 * sw + x0) * 3;
      const uint8_t* p11 = src + ((size_t)y1 * sw + x1) * 3;
      const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
      const float w10 = wy * (1.f - wx), w11 = wy * wx;
      float* out = row + (size_t)out_x * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        out[c] = (v * k - mean[c]) * inv_std[c];
      }
    }
  }
}

// Normalize an already-decoded uint8 HWC image into float32 (no resize).
void normalize_u8(const uint8_t* src, int h, int w,
                  const float* mean, const float* std_, float* dst) {
  const float inv_std[3] = {1.f / std_[0], 1.f / std_[1], 1.f / std_[2]};
  const float k = 1.f / 255.f;
  const size_t n = (size_t)h * w;
  for (size_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      dst[i * 3 + c] = ((float)src[i * 3 + c] * k - mean[c]) * inv_std[c];
    }
  }
}

}  // extern "C"

// Host image kernels of the data loader, behind a plain C ABI (ctypes,
// imvoxelnet_tpu_torch/native/__init__.py).
//
// normalize_pad_u8: one pass over a uint8 RGB image writes the normalized
// float32 image into its zero-padded canvas (mmcv imnormalize + Pad), with
// the same IEEE float32 operations as the numpy pair of data/pipeline.py
// ((f32(u8) - f32 mean) / f32 std), so the results are bit-identical.  A
// copy of imvoxelnet_tpu/native/image_ops.cc.
//
// png_unfilter: reverses the PNG row filters (None, Sub, Up, Average,
// Paeth; PNG spec section 9) of an inflated 8-bit image.  Average and
// Paeth are serial along a row, which is why this is native code; its
// plain version is data/image_io.py:png_unfilter_plain.
//
// resize_linear_u8: cv2.resize(INTER_LINEAR) of a uint8 image from the
// taps and 11-bit weights that data/image_io.py:_taps computes as OpenCV
// does; its plain version is data/image_io.py:resize_linear_u8_plain.
//
// All three run without the interpreter lock (ctypes releases it), so the
// loader's threads decode in parallel.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// src: (h, w, 3) RGB uint8, C-contiguous.
// dst: (ph, pw, 3) float32, fully written (right/bottom zero padding).
void normalize_pad_u8(const uint8_t* src, int64_t h, int64_t w,
                      const float* mean, const float* stdv,
                      float* dst, int64_t ph, int64_t pw) {
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float s0 = stdv[0], s1 = stdv[1], s2 = stdv[2];
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* sp = src + y * w * 3;
    float* dp = dst + y * pw * 3;
    for (int64_t x = 0; x < w; ++x) {
      dp[3 * x + 0] = (static_cast<float>(sp[3 * x + 0]) - m0) / s0;
      dp[3 * x + 1] = (static_cast<float>(sp[3 * x + 1]) - m1) / s1;
      dp[3 * x + 2] = (static_cast<float>(sp[3 * x + 2]) - m2) / s2;
    }
    if (pw > w) {
      memset(dp + 3 * w, 0, sizeof(float) * 3 * (pw - w));
    }
  }
  if (ph > h) {
    memset(dst + h * pw * 3, 0, sizeof(float) * 3 * (ph - h) * pw);
  }
}

// src: h rows of (1 + row_bytes) bytes, each a filter-type byte and the
// filtered row; bpp: bytes per pixel (1 gray, 2 gray + alpha, 3 RGB,
// 4 RGBA).  dst: (h, row_bytes) reconstructed bytes.
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4 (rows before it are written).
int64_t png_unfilter(const uint8_t* src, int64_t h, int64_t row_bytes,
                     int64_t bpp, uint8_t* dst) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * row_bytes;
    const uint8_t* up = y ? out - row_bytes : nullptr;
    switch (type) {
      case 0:
        memcpy(out, in, row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = in[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// src: (h, w, cn) uint8; dst: (oh, ow, cn) uint8.  Output column x reads
// source columns x0[x], x1[x] with weights a0[x], a1[x]; output row y
// blends source rows y0[y], y1[y] with weights b0[y], b1[y].  The
// horizontal pass is exact in int32; the vertical pass rounds as OpenCV's
// SIMD path does: ((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2 >> 2.
void resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t cn,
                      uint8_t* dst, int64_t oh, int64_t ow,
                      const int32_t* x0, const int32_t* x1,
                      const int32_t* a0, const int32_t* a1,
                      const int32_t* y0, const int32_t* y1,
                      const int32_t* b0, const int32_t* b1) {
  (void)h;
  const int64_t n = ow * cn;
  std::vector<int32_t> buf(2 * n);
  int64_t held[2] = {-1, -1};       // source row held by each slot
  auto row = [&](int64_t sy) -> const int32_t* {
    const int slot = static_cast<int>(sy & 1);
    int32_t* out = buf.data() + slot * n;
    if (held[slot] != sy) {
      const uint8_t* s = src + sy * w * cn;
      for (int64_t x = 0; x < ow; ++x) {
        const uint8_t* p0 = s + x0[x] * cn;
        const uint8_t* p1 = s + x1[x] * cn;
        for (int64_t c = 0; c < cn; ++c)
          out[x * cn + c] = (p0[c] * a0[x] + p1[c] * a1[x]) >> 4;
      }
      held[slot] = sy;
    }
    return out;
  };
  for (int64_t y = 0; y < oh; ++y) {
    const int32_t* r0 = row(y0[y]);
    const int32_t* r1 = row(y1[y]);
    const int32_t w0 = b0[y], w1 = b1[y];
    uint8_t* d = dst + y * n;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t v = (((r0[i] * w0) >> 16) + ((r1[i] * w1) >> 16) + 2) >> 2;
      d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // extern "C"

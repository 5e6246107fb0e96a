// Native data plane of the port's input pipeline (the port's own copy of
// the JAX package's C++ data plane; x2vlm_tpu_torch/data/native.py binds it
// with ctypes and builds it with g++ at first use, never at import).
//
// The reference's input path is pure Python (PIL decode + transform per
// sample; dataset/pretrain_dataset.py), and at 128+ images a step the
// Python decode is the host-side bottleneck feeding the device. This library
// moves the hot loop to C++: base64 -> JPEG/PNG decode (libjpeg/libpng) ->
// resize -> CLIP-normalized float32 NHWC for the eval decode, and the
// pretraining / region train paths to uint8 NHWC, batched over a
// std::thread pool.
//
// Exposed C ABI (ctypes-friendly):
//   dp_decode_batch_b64(...)  - batch of base64 strings -> (N, res, res, 3) f32
//   dp_decode_batch_raw(...)  - batch of raw encoded bytes -> same
//   dp_b64_decode(...)        - standalone base64 decoder
//   dp_pretrain_batch_{raw,b64}, dp_region_batch_raw, dp_image_dims,
//   dp_crop_resize_u8, dp_aug_apply, dp_sample_params - the train paths
// All functions return 0 on success; per-item failures zero-fill that item and
// set the corresponding status byte (broken-sample skip semantics).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <thread>
#include <vector>
#include <atomic>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------- base64 ----------------

int b64_value(unsigned char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

// Returns decoded length, or -1 on error.
int64_t b64_decode(const char* in, int64_t len, uint8_t* out) {
  int64_t o = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < len; ++i) {
    unsigned char c = (unsigned char)in[i];
    if (c == '=' || c == '\n' || c == '\r' || c == ' ') continue;
    int v = b64_value(c);
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (uint8_t)((acc >> bits) & 0xFF);
    }
  }
  return o;
}

// ---------------- JPEG ----------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = (JpegErrorMgr*)cinfo->err;
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG to RGB8. Returns true on success; fills w/h and pixel vector.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>& pixels,
                 int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  pixels.resize((size_t)w * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------- PNG ----------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* st = (PngReadState*)png_get_io_ptr(png);
  if (st->pos + n > st->len) {
    png_error(png, "eof");
    return;
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>& pixels,
                int& w, int& h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  pixels.resize((size_t)w * h * 3);
  std::vector<png_bytep> rows(h);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> rowbuf;
  if (rowbytes != (size_t)w * 3) {
    // unexpected layout; bail
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  for (int y = 0; y < h; ++y) rows[y] = pixels.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------- resize + normalize ----------------

// Separable triangle-filter resample (PIL BILINEAR semantics: the filter
// support scales with the downscale factor, i.e. proper antialiasing), then
// CLIP-normalize: RGB8 (h, w) → float32 (res, res, 3).
struct ResampleTaps {
  std::vector<int> lo;        // first source index per output pixel
  std::vector<int> count;     // taps per output pixel
  std::vector<float> weights; // max_taps per output pixel, row-major
  int max_taps;
};

// filter: 0 = triangle (PIL BILINEAR), 1 = Catmull-Rom-style cubic a=-0.5
// (PIL BICUBIC). Both antialias by scaling support with the downscale factor.
static double filter_weight(double x, int filter) {
  if (filter == 0) {
    if (x < 0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
  }
  const double a = -0.5;
  if (x < 0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

void build_taps(int src, int dst, ResampleTaps& t, int filter) {
  const double scale = (double)src / dst;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double fsupport = filter == 0 ? 1.0 : 2.0;
  const double support = fsupport * filterscale;
  t.max_taps = (int)ceil(support) * 2 + 1;
  t.lo.resize(dst);
  t.count.resize(dst);
  t.weights.assign((size_t)dst * t.max_taps, 0.0f);
  for (int i = 0; i < dst; ++i) {
    double center = (i + 0.5) * scale;
    int lo = (int)(center - support + 0.5);
    int hi = (int)(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > src) hi = src;
    double total = 0.0;
    float* wrow = &t.weights[(size_t)i * t.max_taps];
    for (int j = lo; j < hi; ++j) {
      double x = (j - center + 0.5) / filterscale;
      double wv = filter_weight(x, filter);
      wrow[j - lo] = (float)wv;
      total += wv;
    }
    if (total > 0) {
      for (int j = 0; j < hi - lo; ++j) wrow[j] = (float)(wrow[j] / total);
    }
    t.lo[i] = lo;
    t.count[i] = hi - lo;
  }
}

void resize_normalize(const std::vector<uint8_t>& pixels, int w, int h, int res,
                      const float* mean, const float* stdev, float* out,
                      int filter) {
  ResampleTaps tx, ty;
  build_taps(w, res, tx, filter);
  build_taps(h, res, ty, filter);

  // horizontal pass: (h, w, 3) u8 → (h, res, 3) f32
  std::vector<float> tmp((size_t)h * res * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = &pixels[(size_t)y * w * 3];
    float* dst = &tmp[(size_t)y * res * 3];
    for (int ox = 0; ox < res; ++ox) {
      const float* wrow = &tx.weights[(size_t)ox * tx.max_taps];
      int lo = tx.lo[ox];
      float r = 0, g = 0, b = 0;
      for (int j = 0; j < tx.count[ox]; ++j) {
        const uint8_t* p = src + (size_t)(lo + j) * 3;
        float wv = wrow[j];
        r += wv * p[0];
        g += wv * p[1];
        b += wv * p[2];
      }
      dst[ox * 3 + 0] = r;
      dst[ox * 3 + 1] = g;
      dst[ox * 3 + 2] = b;
    }
  }
  // vertical pass + normalize: (h, res, 3) → (res, res, 3)
  const float inv255 = 1.0f / 255.0f;
  for (int oy = 0; oy < res; ++oy) {
    const float* wrow = &ty.weights[(size_t)oy * ty.max_taps];
    int lo = ty.lo[oy];
    float* o = out + (size_t)oy * res * 3;
    for (int ox = 0; ox < res; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < ty.count[oy]; ++j) {
        const float* p = &tmp[((size_t)(lo + j) * res + ox) * 3];
        float wv = wrow[j];
        acc[0] += wv * p[0];
        acc[1] += wv * p[1];
        acc[2] += wv * p[2];
      }
      for (int c = 0; c < 3; ++c)
        o[ox * 3 + c] = (acc[c] * inv255 - mean[c]) / stdev[c];
    }
  }
}

bool decode_any(const uint8_t* data, size_t len, std::vector<uint8_t>& pixels,
                int& w, int& h) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, pixels, w, h);
  if (len >= 8 && !png_sig_cmp(data, 0, 8))
    return decode_png(data, len, pixels, w, h);
  // try jpeg anyway (some files lack clean magic handling)
  return decode_jpeg(data, len, pixels, w, h);
}

// ---------------- train path: crop-resize + RandAugment on uint8 ----------
//
// PIL-semantics re-implementations of the pretrain transform
// (data/transforms.py pretrain_transform: RandomResizedCrop(0.2-1.0)
// bicubic → hflip(0.5) → RandomAugment(2, 7) → uint8). Pixel math follows
// Pillow: two-pass resample with a uint8 intermediate (clamp+round per pass),
// nearest-neighbor affine at pixel centers with floor, ImageOps LUT ops, and
// ImageEnhance extrapolating blends with float truncation.

inline uint8_t clamp_round_u8(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return (uint8_t)(v + 0.5f);
}

inline uint8_t clamp_trunc_u8(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return (uint8_t)v;
}

// taps over the (possibly fractional) source window [lo0, lo0 + src_len),
// source pixel indices clipped to [clip_lo, clip_hi)
void build_taps_boxf(double lo0, double src_len, int clip_lo, int clip_hi,
                     int dst, ResampleTaps& t, int filter) {
  const double scale = src_len / dst;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double fsupport = filter == 0 ? 1.0 : 2.0;
  const double support = fsupport * filterscale;
  t.max_taps = (int)ceil(support) * 2 + 1;
  t.lo.resize(dst);
  t.count.resize(dst);
  t.weights.assign((size_t)dst * t.max_taps, 0.0f);
  for (int i = 0; i < dst; ++i) {
    double center = lo0 + (i + 0.5) * scale;
    int lo = (int)(center - support + 0.5);
    int hi = (int)(center + support + 0.5);
    if (lo < clip_lo) lo = clip_lo;
    if (hi > clip_hi) hi = clip_hi;
    if (hi < lo) hi = lo;
    double total = 0.0;
    float* wrow = &t.weights[(size_t)i * t.max_taps];
    for (int j = lo; j < hi; ++j) {
      double x = (j - center + 0.5) / filterscale;
      double wv = filter_weight(x, filter);
      wrow[j - lo] = (float)wv;
      total += wv;
    }
    if (total > 0)
      for (int j = 0; j < hi - lo; ++j) wrow[j] = (float)(wrow[j] / total);
    t.lo[i] = lo;
    t.count[i] = hi - lo;
  }
}

// crop box (fx0, fy0, fcw, fch) — fractional coords allowed (the ROI-decode
// path maps a full-res crop into DCT-scaled buffer coords) — of an RGB8
// (h, w) image, resampled to (res, res) uint8. Pillow order: horizontal pass
// (uint8 intermediate) then vertical pass; taps clipped to the crop edges
// (PIL crop-then-resize semantics: no bleed from outside the box).
void crop_resize_u8f(const uint8_t* pixels, int w, int h, double fx0,
                     double fy0, double fcw, double fch, int res, int filter,
                     uint8_t* out, std::vector<uint8_t>& tmp) {
  int cx_lo = (int)floor(fx0), cx_hi = (int)ceil(fx0 + fcw);
  int cy_lo = (int)floor(fy0), cy_hi = (int)ceil(fy0 + fch);
  if (cx_lo < 0) cx_lo = 0;
  if (cy_lo < 0) cy_lo = 0;
  if (cx_hi > w) cx_hi = w;
  if (cy_hi > h) cy_hi = h;
  ResampleTaps tx, ty;
  build_taps_boxf(fx0, fcw, cx_lo, cx_hi, res, tx, filter);
  build_taps_boxf(fy0, fch, cy_lo, cy_hi, res, ty, filter);
  // horizontal-pass only the rows the vertical taps touch
  int rmin = h, rmax = 0;
  for (int i = 0; i < res; ++i) {
    if (ty.lo[i] < rmin) rmin = ty.lo[i];
    if (ty.lo[i] + ty.count[i] > rmax) rmax = ty.lo[i] + ty.count[i];
  }
  if (rmin > rmax) rmin = rmax = 0;
  tmp.resize((size_t)(rmax - rmin) * res * 3);
  for (int y = rmin; y < rmax; ++y) {
    const uint8_t* src = pixels + (size_t)y * w * 3;
    uint8_t* dst = &tmp[(size_t)(y - rmin) * res * 3];
    for (int ox = 0; ox < res; ++ox) {
      const float* wrow = &tx.weights[(size_t)ox * tx.max_taps];
      int lo = tx.lo[ox];
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < tx.count[ox]; ++j) {
        const uint8_t* p = src + (size_t)(lo + j) * 3;
        float wv = wrow[j];
        acc[0] += wv * p[0];
        acc[1] += wv * p[1];
        acc[2] += wv * p[2];
      }
      for (int c = 0; c < 3; ++c) dst[ox * 3 + c] = clamp_round_u8(acc[c]);
    }
  }
  for (int oy = 0; oy < res; ++oy) {
    const float* wrow = &ty.weights[(size_t)oy * ty.max_taps];
    int lo = ty.lo[oy];
    uint8_t* o = out + (size_t)oy * res * 3;
    for (int ox = 0; ox < res; ++ox) {
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < ty.count[oy]; ++j) {
        const uint8_t* p = &tmp[((size_t)(lo + j - rmin) * res + ox) * 3];
        float wv = wrow[j];
        acc[0] += wv * p[0];
        acc[1] += wv * p[1];
        acc[2] += wv * p[2];
      }
      for (int c = 0; c < 3; ++c) o[ox * 3 + c] = clamp_round_u8(acc[c]);
    }
  }
}

void crop_resize_u8(const uint8_t* pixels, int w, int h, int x0, int y0,
                    int cw, int ch, int res, int filter, uint8_t* out,
                    std::vector<uint8_t>& tmp) {
  crop_resize_u8f(pixels, w, h, x0, y0, cw, ch, res, filter, out, tmp);
}

// ---------------- JPEG ROI decode (libjpeg-turbo fast path) ----------------

// Header-only parse for (width, height).
bool jpeg_dims(const uint8_t* data, size_t len, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  bool ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
  w = cinfo.image_width;
  h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return ok && w > 0 && h > 0;
}

// Decode only the full-res crop box [x0, y0, cw, ch) at the largest DCT
// downscale (M/8) that keeps the decoded crop >= res in both dims
// (standard fused decode+RandomResizedCrop: never reconstruct pixels the
// crop throws away). Returns the decoded subregion (pw, ph) and the crop
// box mapped into its coordinates (fractional).
bool decode_jpeg_roi(const uint8_t* data, size_t len, int x0, int y0, int cw,
                     int ch, int res, std::vector<uint8_t>& pixels, int& pw,
                     int& ph, double fbox[4]) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  int M = 8;
  while (M > 1 && (int64_t)cw * (M - 1) / 8 >= res &&
         (int64_t)ch * (M - 1) / 8 >= res)
    M--;
  cinfo.scale_num = M;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const double sx = (double)cinfo.output_width / cinfo.image_width;
  const double sy = (double)cinfo.output_height / cinfo.image_height;
  JDIMENSION xoff = (JDIMENSION)floor(x0 * sx);
  JDIMENSION xw = (JDIMENSION)ceil((x0 + cw) * sx) - xoff;
  if (xoff + xw > cinfo.output_width) xw = cinfo.output_width - xoff;
  if (xw < cinfo.output_width)
    jpeg_crop_scanline(&cinfo, &xoff, &xw);  // aligns to iMCU, updates both
  int y_lo = (int)floor(y0 * sy);
  int y_hi = (int)ceil((y0 + ch) * sy);
  if (y_hi > (int)cinfo.output_height) y_hi = cinfo.output_height;
  while ((int)cinfo.output_scanline < y_lo) {
    if (jpeg_skip_scanlines(&cinfo, y_lo - cinfo.output_scanline) == 0) break;
  }
  int y_start = cinfo.output_scanline;
  pw = cinfo.output_width;  // post-crop_scanline width
  ph = y_hi - y_start;
  if (ph <= 0 || pw <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels.resize((size_t)pw * ph * 3);
  while ((int)cinfo.output_scanline < y_hi) {
    uint8_t* row =
        pixels.data() + (size_t)(cinfo.output_scanline - y_start) * pw * 3;
    if (jpeg_read_scanlines(&cinfo, &row, 1) == 0) break;
  }
  jpeg_abort_decompress(&cinfo);  // skip the rows below the crop entirely
  jpeg_destroy_decompress(&cinfo);
  fbox[0] = x0 * sx - xoff;
  fbox[1] = y0 * sy - y_start;
  fbox[2] = cw * sx;
  fbox[3] = ch * sy;
  return true;
}

void hflip_u8(const uint8_t* in, int h, int w, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = in + (size_t)y * w * 3;
    uint8_t* dst = out + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = src + (size_t)(w - 1 - x) * 3;
      dst[x * 3 + 0] = p[0];
      dst[x * 3 + 1] = p[1];
      dst[x * 3 + 2] = p[2];
    }
  }
}

// out(x, y) = in(floor(m0*(x+.5) + m1*(y+.5) + m2), floor(m3.. m5)), fill 0
// (Pillow ImagingTransformAffine, NEAREST: pixel-center eval + floor COORD).
void affine_nearest_u8(const uint8_t* in, int h, int w, const double* m,
                       uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = out + (size_t)y * w * 3;
    double xs = m[0] * 0.5 + m[1] * (y + 0.5) + m[2];
    double ys = m[3] * 0.5 + m[4] * (y + 0.5) + m[5];
    for (int x = 0; x < w; ++x, xs += m[0], ys += m[3]) {
      int xi = (int)floor(xs);
      int yi = (int)floor(ys);
      uint8_t* o = dst + (size_t)x * 3;
      if (xi >= 0 && xi < w && yi >= 0 && yi < h) {
        const uint8_t* p = in + ((size_t)yi * w + xi) * 3;
        o[0] = p[0];
        o[1] = p[1];
        o[2] = p[2];
      } else {
        o[0] = o[1] = o[2] = 0;
      }
    }
  }
}

// ImageOps.autocontrast(cutoff=0): per-channel linear LUT stretch.
void autocontrast_u8(const uint8_t* in, int h, int w, uint8_t* out) {
  for (int c = 0; c < 3; ++c) {
    int64_t hist[256] = {0};
    const size_t n = (size_t)h * w;
    for (size_t i = 0; i < n; ++i) hist[in[i * 3 + c]]++;
    int lo = 0, hi = 255;
    while (lo < 256 && hist[lo] == 0) lo++;
    while (hi >= 0 && hist[hi] == 0) hi--;
    uint8_t lut[256];
    if (hi <= lo) {
      for (int i = 0; i < 256; ++i) lut[i] = (uint8_t)i;
    } else {
      double scale = 255.0 / (hi - lo);
      double offset = -lo * scale;
      for (int i = 0; i < 256; ++i) {
        int v = (int)(i * scale + offset);  // Pillow: int() truncation
        lut[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
    for (size_t i = 0; i < n; ++i) out[i * 3 + c] = lut[in[i * 3 + c]];
  }
}

// ImageOps.equalize: per-channel histogram equalization (Pillow algorithm).
void equalize_u8(const uint8_t* in, int h, int w, uint8_t* out) {
  for (int c = 0; c < 3; ++c) {
    int64_t hist[256] = {0};
    const size_t n = (size_t)h * w;
    for (size_t i = 0; i < n; ++i) hist[in[i * 3 + c]]++;
    int64_t total = 0, last_nonzero = 0;
    int nonzero = 0;
    for (int i = 0; i < 256; ++i)
      if (hist[i]) {
        total += hist[i];
        last_nonzero = hist[i];
        nonzero++;
      }
    uint8_t lut[256];
    int64_t step = nonzero > 1 ? (total - last_nonzero) / 255 : 0;
    if (step == 0) {
      for (int i = 0; i < 256; ++i) lut[i] = (uint8_t)i;
    } else {
      int64_t acc = step / 2;
      for (int i = 0; i < 256; ++i) {
        int64_t v = acc / step;
        lut[i] = (uint8_t)(v > 255 ? 255 : v);
        acc += hist[i];
      }
    }
    for (size_t i = 0; i < n; ++i) out[i * 3 + c] = lut[in[i * 3 + c]];
  }
}

// ImageEnhance.Brightness: blend(black, img, v) — float, truncation, clamped.
void brightness_u8(const uint8_t* in, int h, int w, float v, uint8_t* out) {
  const size_t n = (size_t)h * w * 3;
  for (size_t i = 0; i < n; ++i) out[i] = clamp_trunc_u8(v * in[i]);
}

// ImageEnhance.Sharpness: blend(SMOOTH-filtered, img, v). SMOOTH = 3x3 kernel
// (1 1 1 / 1 5 1 / 1 1 1)/13, border pixels copied from input.
void sharpness_u8(const uint8_t* in, int h, int w, float v, uint8_t* out) {
  static const float k[9] = {1, 1, 1, 1, 5, 1, 1, 1, 1};
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = in + ((size_t)y * w + x) * 3;
      uint8_t* o = out + ((size_t)y * w + x) * 3;
      if (y == 0 || y == h - 1 || x == 0 || x == w - 1) {
        o[0] = p[0];
        o[1] = p[1];
        o[2] = p[2];
        continue;
      }
      for (int c = 0; c < 3; ++c) {
        float s = 0;
        int ki = 0;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx, ++ki)
            s += k[ki] * in[((size_t)(y + dy) * w + (x + dx)) * 3 + c];
        float smooth = clamp_round_u8(s / 13.0f);  // uint8 degenerate image
        o[c] = clamp_trunc_u8(smooth + v * ((float)p[c] - smooth));
      }
    }
  }
}

// op ids (matches transforms.DEFAULT_AUGS order): 0 Identity, 1 AutoContrast,
// 2 Equalize, 3 Brightness, 4 Sharpness, 5 ShearX, 6 ShearY, 7 TranslateX,
// 8 TranslateY, 9 Rotate.
const float kAugLo[10] = {0, 0, 0, 0.1f, 0.1f, -0.3f, -0.3f, -0.3f, -0.3f, -30};
const float kAugHi[10] = {0, 0, 0, 1.9f, 1.9f, 0.3f, 0.3f, 0.3f, 0.3f, 30};

// Applies op to in → out. Returns false for Identity (caller keeps in).
bool apply_aug_op(const uint8_t* in, int h, int w, int op, float v,
                  uint8_t* out) {
  double m[6] = {1, 0, 0, 0, 1, 0};
  switch (op) {
    case 0:
      return false;
    case 1:
      autocontrast_u8(in, h, w, out);
      return true;
    case 2:
      equalize_u8(in, h, w, out);
      return true;
    case 3:
      brightness_u8(in, h, w, v, out);
      return true;
    case 4:
      sharpness_u8(in, h, w, v, out);
      return true;
    case 5:
      m[1] = v;
      break;
    case 6:
      m[3] = v;
      break;
    case 7:
      m[2] = v * w;
      break;
    case 8:
      m[5] = v * h;
      break;
    case 9: {
      // Pillow rotate(v): CCW degrees around the center; Pillow builds the
      // inverse map from the NEGATED radian angle
      double t = -v * 3.14159265358979323846 / 180.0;
      double cx = w / 2.0, cy = h / 2.0;
      m[0] = cos(t);
      m[1] = sin(t);
      m[2] = cx - cx * m[0] - cy * m[1];
      m[3] = -sin(t);
      m[4] = cos(t);
      m[5] = cy - cx * m[3] - cy * m[4];
      break;
    }
    default:
      return false;
  }
  affine_nearest_u8(in, h, w, m, out);
  return true;
}

// ---------------- splitmix64 param sampler ----------------

struct Sm64 {
  uint64_t s;
  uint64_t next() {
    s += 0x9E3779B97f4A7C15ULL;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int randint(int hi_inclusive) {  // uniform int in [0, hi]
    int v = (int)(uniform() * (hi_inclusive + 1));
    return v > hi_inclusive ? hi_inclusive : v;
  }
};

// RandomResizedCrop sampler (transforms.random_resized_crop algorithm: 10
// attempts of area/log-aspect sampling, center-crop fallback), then flip coin
// and aug-op choices. Writes crop[5] = {x0, y0, cw, ch, flip} and
// ops/vals[aug_n].
void sample_train_params(uint64_t seed, int w, int h, float scale_lo,
                         float scale_hi, float hflip_prob,
                         const int32_t* cand_ops, int n_cand, int aug_n,
                         float aug_m, int32_t* crop, int32_t* ops,
                         float* vals) {
  Sm64 rng{seed};
  const double area = (double)w * h;
  const double log_lo = log(3.0 / 4.0), log_hi = log(4.0 / 3.0);
  int x0 = -1, y0 = -1, cw = 0, ch = 0;
  for (int a = 0; a < 10; ++a) {
    double target = area * (scale_lo + rng.uniform() * (scale_hi - scale_lo));
    double aspect = exp(log_lo + rng.uniform() * (log_hi - log_lo));
    int tw = (int)llround(sqrt(target * aspect));
    int th = (int)llround(sqrt(target / aspect));
    if (tw > 0 && tw <= w && th > 0 && th <= h) {
      cw = tw;
      ch = th;
      x0 = rng.randint(w - cw);
      y0 = rng.randint(h - ch);
      break;
    }
  }
  if (x0 < 0) {  // center-crop fallback
    int s = w < h ? w : h;
    cw = ch = s;
    x0 = (w - s) / 2;
    y0 = (h - s) / 2;
  }
  crop[0] = x0;
  crop[1] = y0;
  crop[2] = cw;
  crop[3] = ch;
  crop[4] = rng.uniform() < hflip_prob ? 1 : 0;
  for (int i = 0; i < aug_n; ++i) {
    int idx = rng.randint(n_cand - 1);
    int op = cand_ops[idx];
    ops[i] = op;
    vals[i] = kAugLo[op] + (kAugHi[op] - kAugLo[op]) * (aug_m / 10.0f);
  }
}

}  // namespace

extern "C" {

int64_t dp_b64_decode(const char* in, int64_t len, uint8_t* out) {
  return b64_decode(in, len, out);
}

// inputs: concatenated raw bytes with offsets (n+1 entries).
// out: (n, res, res, 3) float32. status: n bytes, 1 = ok, 0 = broken.
int dp_decode_batch_raw(const uint8_t* blob, const int64_t* offsets, int n,
                        int res, const float* mean, const float* stdev,
                        float* out, uint8_t* status, int num_threads,
                        int filter) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* data = blob + offsets[i];
      size_t len = (size_t)(offsets[i + 1] - offsets[i]);
      int w = 0, h = 0;
      float* dst = out + (size_t)i * res * res * 3;
      if (decode_any(data, len, pixels, w, h) && w > 0 && h > 0) {
        resize_normalize(pixels, w, h, res, mean, stdev, dst, filter);
        status[i] = 1;
      } else {
        memset(dst, 0, sizeof(float) * (size_t)res * res * 3);
        status[i] = 0;
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// base64 inputs: concatenated chars with offsets (n+1 entries).
int dp_decode_batch_b64(const char* blob, const int64_t* offsets, int n,
                        int res, const float* mean, const float* stdev,
                        float* out, uint8_t* status, int num_threads,
                        int filter) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> raw;
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const char* in = blob + offsets[i];
      int64_t len = offsets[i + 1] - offsets[i];
      raw.resize((size_t)(len * 3 / 4 + 4));
      int64_t rlen = b64_decode(in, len, raw.data());
      float* dst = out + (size_t)i * res * res * 3;
      int w = 0, h = 0;
      if (rlen > 0 && decode_any(raw.data(), (size_t)rlen, pixels, w, h) &&
          w > 0 && h > 0) {
        resize_normalize(pixels, w, h, res, mean, stdev, dst, filter);
        status[i] = 1;
      } else {
        memset(dst, 0, sizeof(float) * (size_t)res * res * 3);
        status[i] = 0;
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// ---------------- train path entry points ----------------

// Full pretrain transform: decode → RandomResizedCrop(scale, bicubic) →
// hflip(prob) → aug_n RandAugment ops at magnitude aug_m → uint8 out.
// seeds: one uint64 per image (drives the per-image param sampler).
// cand_ops: candidate op ids (see apply_aug_op). out: (n, res, res, 3) u8.
int dp_pretrain_batch_raw(const uint8_t* blob, const int64_t* offsets, int n,
                          int res, const uint64_t* seeds, float scale_lo,
                          float scale_hi, float hflip_prob,
                          const int32_t* cand_ops, int n_cand, int aug_n,
                          float aug_m, uint8_t* out, uint8_t* status,
                          int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> pixels, tmp, buf_a, buf_b;
    std::vector<int32_t> ops(aug_n > 0 ? aug_n : 1);
    std::vector<float> vals(aug_n > 0 ? aug_n : 1);
    const size_t npix = (size_t)res * res * 3;
    buf_a.resize(npix);
    buf_b.resize(npix);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* data = blob + offsets[i];
      size_t len = (size_t)(offsets[i + 1] - offsets[i]);
      uint8_t* dst = out + (size_t)i * npix;
      uint8_t* cur = buf_a.data();
      uint8_t* alt = buf_b.data();
      int32_t crop[5];
      bool is_jpg = len >= 2 && data[0] == 0xFF && data[1] == 0xD8;
      int w = 0, h = 0;
      bool decoded = false;
      if (is_jpg && jpeg_dims(data, len, w, h)) {
        // fast path: sample the crop from the header dims, then ROI-decode
        // only the crop at the largest adequate DCT downscale
        sample_train_params(seeds[i], w, h, scale_lo, scale_hi, hflip_prob,
                            cand_ops, n_cand, aug_n, aug_m, crop, ops.data(),
                            vals.data());
        int pw = 0, ph = 0;
        double fbox[4];
        if (decode_jpeg_roi(data, len, crop[0], crop[1], crop[2], crop[3],
                            res, pixels, pw, ph, fbox)) {
          crop_resize_u8f(pixels.data(), pw, ph, fbox[0], fbox[1], fbox[2],
                          fbox[3], res, /*filter=*/1, cur, tmp);
          decoded = true;
        }
      }
      if (!decoded) {  // PNG / odd JPEGs: full decode, exact crop
        if (!decode_any(data, len, pixels, w, h) || w <= 0 || h <= 0) {
          memset(dst, 0, npix);
          status[i] = 0;
          continue;
        }
        sample_train_params(seeds[i], w, h, scale_lo, scale_hi, hflip_prob,
                            cand_ops, n_cand, aug_n, aug_m, crop, ops.data(),
                            vals.data());
        crop_resize_u8(pixels.data(), w, h, crop[0], crop[1], crop[2],
                       crop[3], res, /*filter=*/1, cur, tmp);
      }
      if (crop[4]) {
        hflip_u8(cur, res, res, alt);
        std::swap(cur, alt);
      }
      for (int a = 0; a < aug_n; ++a) {
        if (apply_aug_op(cur, res, res, ops[a], vals[a], alt))
          std::swap(cur, alt);
      }
      memcpy(dst, cur, npix);
      status[i] = 1;
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

int dp_pretrain_batch_b64(const char* blob, const int64_t* offsets, int n,
                          int res, const uint64_t* seeds, float scale_lo,
                          float scale_hi, float hflip_prob,
                          const int32_t* cand_ops, int n_cand, int aug_n,
                          float aug_m, uint8_t* out, uint8_t* status,
                          int num_threads) {
  // decode base64 up front (cheap vs jpeg), then share the raw path
  std::vector<uint8_t> raw;
  std::vector<int64_t> roffsets(n + 1, 0);
  raw.resize((size_t)(offsets[n] * 3 / 4 + 4 * (size_t)n));
  int64_t pos = 0;
  for (int i = 0; i < n; ++i) {
    int64_t rlen =
        b64_decode(blob + offsets[i], offsets[i + 1] - offsets[i], raw.data() + pos);
    if (rlen < 0) rlen = 0;  // decode_any will fail and zero-fill
    pos += rlen;
    roffsets[i + 1] = pos;
  }
  return dp_pretrain_batch_raw(raw.data(), roffsets.data(), n, res, seeds,
                               scale_lo, scale_hi, hflip_prob, cand_ops,
                               n_cand, aug_n, aug_m, out, status, num_threads);
}

// Region-text train path (reference RegionTextJsonDataset): the bbox-aware
// crop box, flip decision, and augment ops are sampled host-side (they need
// the annotation's bboxes); this runs the pixel work — ROI decode of the
// given crop, bicubic resample to res, optional hflip, explicit op list —
// in one pass per image. boxes: (n, 4) int32 x0/y0/cw/ch in full-res
// coords; ops/vals: (n, aug_n). out: (n, res, res, 3) uint8.
int dp_region_batch_raw(const uint8_t* blob, const int64_t* offsets, int n,
                        int res, const int32_t* boxes, const uint8_t* flips,
                        const int32_t* aug_ops, const float* aug_vals,
                        int aug_n, uint8_t* out, uint8_t* status,
                        int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> pixels, tmp, buf_a, buf_b;
    const size_t npix = (size_t)res * res * 3;
    buf_a.resize(npix);
    buf_b.resize(npix);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* data = blob + offsets[i];
      size_t len = (size_t)(offsets[i + 1] - offsets[i]);
      uint8_t* dst = out + (size_t)i * npix;
      const int32_t* box = boxes + (size_t)i * 4;
      uint8_t* cur = buf_a.data();
      uint8_t* alt = buf_b.data();
      bool is_jpg = len >= 2 && data[0] == 0xFF && data[1] == 0xD8;
      bool decoded = false;
      if (is_jpg) {
        int pw = 0, ph = 0;
        double fbox[4];
        if (decode_jpeg_roi(data, len, box[0], box[1], box[2], box[3], res,
                            pixels, pw, ph, fbox)) {
          crop_resize_u8f(pixels.data(), pw, ph, fbox[0], fbox[1], fbox[2],
                          fbox[3], res, /*filter=*/1, cur, tmp);
          decoded = true;
        }
      }
      if (!decoded) {
        int w = 0, h = 0;
        if (!decode_any(data, len, pixels, w, h) || w <= 0 || h <= 0) {
          memset(dst, 0, npix);
          status[i] = 0;
          continue;
        }
        crop_resize_u8(pixels.data(), w, h, box[0], box[1], box[2], box[3],
                       res, /*filter=*/1, cur, tmp);
      }
      if (flips[i]) {
        hflip_u8(cur, res, res, alt);
        std::swap(cur, alt);
      }
      for (int a = 0; a < aug_n; ++a) {
        if (apply_aug_op(cur, res, res, aug_ops[(size_t)i * aug_n + a],
                         aug_vals[(size_t)i * aug_n + a], alt))
          std::swap(cur, alt);
      }
      memcpy(dst, cur, npix);
      status[i] = 1;
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// Header-only image dims (JPEG or PNG). Returns 1 on success.
int dp_image_dims(const uint8_t* data, int64_t len, int32_t* wh) {
  int w = 0, h = 0;
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    if (!jpeg_dims(data, (size_t)len, w, h)) return 0;
  } else if (len >= 24 && !png_sig_cmp(data, 0, 8)) {
    // PNG IHDR is always first: width/height big-endian at offsets 16/20
    w = (data[16] << 24) | (data[17] << 16) | (data[18] << 8) | data[19];
    h = (data[20] << 24) | (data[21] << 16) | (data[22] << 8) | data[23];
  } else if (!jpeg_dims(data, (size_t)len, w, h)) {
    return 0;
  }
  if (w <= 0 || h <= 0) return 0;
  wh[0] = w;
  wh[1] = h;
  return 1;
}

// Test hooks (PIL-parity unit tests drive these directly).
int dp_crop_resize_u8(const uint8_t* rgb, int w, int h, int x0, int y0,
                      int cw, int ch, int res, int filter, uint8_t* out) {
  std::vector<uint8_t> tmp;
  crop_resize_u8(rgb, w, h, x0, y0, cw, ch, res, filter, out, tmp);
  return 0;
}

int dp_aug_apply(const uint8_t* in, int h, int w, int op, float v,
                 uint8_t* out) {
  if (!apply_aug_op(in, h, w, op, v, out))
    memcpy(out, in, (size_t)h * w * 3);
  return 0;
}

int dp_sample_params(uint64_t seed, int w, int h, float scale_lo,
                     float scale_hi, float hflip_prob,
                     const int32_t* cand_ops, int n_cand, int aug_n,
                     float aug_m, int32_t* crop, int32_t* ops, float* vals) {
  sample_train_params(seed, w, h, scale_lo, scale_hi, hflip_prob, cand_ops,
                      n_cand, aug_n, aug_m, crop, ops, vals);
  return 0;
}

}  // extern "C"

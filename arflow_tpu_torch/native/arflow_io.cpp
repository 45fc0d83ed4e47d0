// Native data-path kernels: image decode, resize, flow IO and the hue
// shift (the port's own copy of arflow_tpu/native/arflow_io.cpp).
//
// PNG (libpng) / PPM / PGM decode straight into float32 [0,1] HWC buffers,
// Middlebury .flo and KITTI flow PNG reading, torch-convention bilinear
// resize, and the ColorJitter hue rotation. Decode, flow IO and resize
// compute as the JAX package's library does, bit for bit; the hue shift
// computes as the numpy path does (see hue_shift_f32).
//
// Exposed as a plain C ABI consumed via ctypes. Built with -DARF_NO_PNG
// (on a host without libpng's headers) the PNG functions return 9 and
// arf_has_png() 0; the rest is the same.

#ifndef ARF_NO_PNG
#include <png.h>
#endif

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

#ifdef ARF_NO_PNG
int arf_has_png() { return 0; }
int arf_png_info(const char*, int*, int*, int*) { return 9; }
int png_decode_f32(const char*, float*, int) { return 9; }
int png_decode_kitti_flow(const char*, float*) { return 9; }
#else
int arf_has_png() { return 1; }

// Returns 0 on success; fills height/width/channels of the decoded image
// (after palette/gray expansion to 8-bit RGB or RGBA or G/GA).
int arf_png_info(const char* path, int* height, int* width, int* channels) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *height = static_cast<int>(png_get_image_height(png, info));
  *width = static_cast<int>(png_get_image_width(png, info));
  int color = png_get_color_type(png, info);
  switch (color) {
    case PNG_COLOR_TYPE_GRAY: *channels = 1; break;
    case PNG_COLOR_TYPE_GRAY_ALPHA: *channels = 2; break;
    case PNG_COLOR_TYPE_PALETTE:
    case PNG_COLOR_TYPE_RGB: *channels = 3; break;
    default: *channels = 4; break;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// Decode to float32 [0,1] HWC with `out_channels` channels (1 or 3): gray is
// broadcast to RGB, alpha dropped, 16-bit scaled. Caller allocates
// out[height*width*out_channels]. Returns 0 on success.
int png_decode_f32(const char* path, float* out, int out_channels) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  const int rowbytes = static_cast<int>(png_get_rowbytes(png, info));
  const int c = rowbytes / w;  // 3 after the transforms above

  std::vector<uint8_t> row(rowbytes);
  const float inv = 1.0f / 255.0f;
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + static_cast<size_t>(y) * w * out_channels;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = row.data() + x * c;
      if (out_channels == 1) {
        dst[x] = (0.2989f * px[0] + 0.5870f * px[1] + 0.1140f * px[2]) * inv;
      } else {
        dst[x * 3 + 0] = px[0] * inv;
        dst[x * 3 + 1] = px[1] * inv;
        dst[x * 3 + 2] = px[2] * inv;
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// KITTI 16-bit flow PNG -> (u, v, valid) float32 HWC
// ((value - 2^15) / 64 masked; utils/flow_utils.py:10-22 semantics).
int png_decode_kitti_flow(const char* path, float* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  if (png_get_bit_depth(png, info) != 16 ||
      png_get_color_type(png, info) != PNG_COLOR_TYPE_RGB) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 3;
  }
  png_set_swap(png);  // PNG is big-endian; host is little-endian
  png_read_update_info(png, info);
  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  std::vector<uint16_t> row(static_cast<size_t>(w) * 3);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, reinterpret_cast<png_bytep>(row.data()), nullptr);
    float* dst = out + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      // cv2.imread returns BGR: channel order in the file is RGB = (valid?,
      // ... ) — reference reads BGR then takes [2:0:-1] = (R, G) as (u, v)
      // and B as mask. In file order (R, G, B): u=R, v=G, mask=B.
      float mask = static_cast<float>(row[x * 3 + 2]);
      float u = (static_cast<float>(row[x * 3 + 0]) - 32768.0f) / 64.0f;
      float v = (static_cast<float>(row[x * 3 + 1]) - 32768.0f) / 64.0f;
      if (std::fabs(u) < 1e-10f) u = 1e-10f;
      if (std::fabs(v) < 1e-10f) v = 1e-10f;
      dst[x * 3 + 0] = u * mask;
      dst[x * 3 + 1] = v * mask;
      dst[x * 3 + 2] = mask;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

#endif  // ARF_NO_PNG

// ---------------------------------------------------------------------------
// PPM / PGM (binary P5/P6)
// ---------------------------------------------------------------------------

static int pnm_skip_ws(FILE* fp) {
  int ch;
  for (;;) {
    ch = fgetc(fp);
    if (ch == '#') {
      while (ch != '\n' && ch != EOF) ch = fgetc(fp);
    } else if (!isspace(ch)) {
      return ch;
    }
  }
}

static int pnm_read_int(FILE* fp) {
  int ch = pnm_skip_ws(fp);
  int val = 0;
  while (isdigit(ch)) {
    val = val * 10 + (ch - '0');
    ch = fgetc(fp);
  }
  return val;
}

int arf_ppm_info(const char* path, int* height, int* width, int* channels) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  int p = fgetc(fp), n = fgetc(fp);
  if (p != 'P' || (n != '5' && n != '6')) {
    fclose(fp);
    return 2;
  }
  *channels = (n == '6') ? 3 : 1;
  *width = pnm_read_int(fp);
  *height = pnm_read_int(fp);
  fclose(fp);
  return 0;
}

int ppm_decode_f32(const char* path, float* out, int out_channels) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  int p = fgetc(fp), n = fgetc(fp);
  if (p != 'P' || (n != '5' && n != '6')) {
    fclose(fp);
    return 2;
  }
  const int c = (n == '6') ? 3 : 1;
  const int w = pnm_read_int(fp);
  const int h = pnm_read_int(fp);
  const int maxval = pnm_read_int(fp);
  if (maxval <= 0 || maxval > 255) {
    fclose(fp);
    return 3;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(h) * w * c);
  if (fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    fclose(fp);
    return 4;
  }
  fclose(fp);
  const float inv = 1.0f / static_cast<float>(maxval);
  for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i) {
    const uint8_t* px = buf.data() + i * c;
    float r = px[0] * inv;
    float g = (c == 3 ? px[1] : px[0]) * inv;
    float b = (c == 3 ? px[2] : px[0]) * inv;
    if (out_channels == 1) {
      out[i] = 0.2989f * r + 0.5870f * g + 0.1140f * b;
    } else {
      out[i * 3 + 0] = r;
      out[i * 3 + 1] = g;
      out[i * 3 + 2] = b;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Middlebury .flo
// ---------------------------------------------------------------------------

int arf_flo_info(const char* path, int* height, int* width) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  float magic = 0;
  int32_t w = 0, h = 0;
  if (fread(&magic, 4, 1, fp) != 1 || magic != 202021.25f ||
      fread(&w, 4, 1, fp) != 1 || fread(&h, 4, 1, fp) != 1) {
    fclose(fp);
    return 2;
  }
  *width = w;
  *height = h;
  fclose(fp);
  return 0;
}

int flo_decode(const char* path, float* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  float magic = 0;
  int32_t w = 0, h = 0;
  if (fread(&magic, 4, 1, fp) != 1 || magic != 202021.25f ||
      fread(&w, 4, 1, fp) != 1 || fread(&h, 4, 1, fp) != 1) {
    fclose(fp);
    return 2;
  }
  const size_t n = static_cast<size_t>(w) * h * 2;
  const size_t got = fread(out, 4, n, fp);
  fclose(fp);
  return got == n ? 0 : 3;
}

// ---------------------------------------------------------------------------
// Bilinear resize, torch F.interpolate(align_corners=False) convention
// (half-pixel centers, source coord clamped at 0; matches
// arflow_tpu/ops/resize.py weights).
// ---------------------------------------------------------------------------

void resize_bilinear_f32(const float* src, int h, int w, int c, float* dst,
                         int oh, int ow) {
  std::vector<int> x0(ow), x1(ow);
  std::vector<float> wx(ow);
  for (int x = 0; x < ow; ++x) {
    float sx = (x + 0.5f) * w / ow - 0.5f;
    if (sx < 0) sx = 0;
    int xi = static_cast<int>(sx);
    if (xi > w - 1) xi = w - 1;
    x0[x] = xi;
    x1[x] = xi + 1 < w ? xi + 1 : w - 1;
    wx[x] = sx - xi;
  }
  for (int y = 0; y < oh; ++y) {
    float sy = (y + 0.5f) * h / oh - 0.5f;
    if (sy < 0) sy = 0;
    int yi = static_cast<int>(sy);
    if (yi > h - 1) yi = h - 1;
    const int y1 = yi + 1 < h ? yi + 1 : h - 1;
    const float wy = sy - yi;
    const float* r0 = src + static_cast<size_t>(yi) * w * c;
    const float* r1 = src + static_cast<size_t>(y1) * w * c;
    float* drow = dst + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float wx1 = wx[x];
      const float wx0 = 1.0f - wx1;
      const float* p00 = r0 + x0[x] * c;
      const float* p01 = r0 + x1[x] * c;
      const float* p10 = r1 + x0[x] * c;
      const float* p11 = r1 + x1[x] * c;
      for (int k = 0; k < c; ++k) {
        drow[x * c + k] = (1.0f - wy) * (wx0 * p00[k] + wx1 * p01[k]) +
                          wy * (wx0 * p10[k] + wx1 * p11[k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// HSV hue shift (the ColorJitter hue op). Computes what the numpy path of
// arflow_tpu_torch/data/transforms.py (_rgb_to_hsv -> +delta mod 1 ->
// _hsv_to_rgb) computes, bit for bit, so that the two are interchangeable:
// - the divisions are divisions (not products with a reciprocal);
// - q and t are computed in double and rounded once to float, as numpy
//   promotes them (f = h*6 - floor(h*6) is float32 minus int64 there);
// - sector 6 (h rounded up to 1.0 by the mod) is sector 0, as numpy's
//   i % 6 makes it;
// - no fused multiply-adds (fp-contract=off on this function alone: the
//   rest of the file is built as the JAX package builds it): a fused
//   multiply-add rounds once where numpy rounds twice.
// The JAX package's library computes the same function in float32 with a
// reciprocal and misses sector 6, so it can part from numpy by an ulp.
// ---------------------------------------------------------------------------

__attribute__((optimize("fp-contract=off")))
void hue_shift_f32(const float* src, float* dst, long long n_pixels,
                   float delta) {
  // Branchless (ternaries compile to SIMD blends), in four loops over a
  // stack tile that each vectorize: deinterleave, float32 HSV and sector,
  // the double-precision q and t, then select and interleave.
  constexpr long long TILE = 1024;
  float rbuf[TILE], gbuf[TILE], bbuf[TILE];
  float fbuf[TILE], ibuf[TILE], sbuf[TILE], vbuf[TILE], qbuf[TILE], tbuf[TILE];
  for (long long base = 0; base < n_pixels; base += TILE) {
    const long long n = std::min(TILE, n_pixels - base);
    const float* sp = src + 3 * base;
    for (long long i = 0; i < n; ++i) {
      rbuf[i] = sp[3 * i];
      gbuf[i] = sp[3 * i + 1];
      bbuf[i] = sp[3 * i + 2];
    }
    for (long long i = 0; i < n; ++i) {
      const float r = rbuf[i], g = gbuf[i], b = bbuf[i];
      const float maxc = std::max(r, std::max(g, b));
      const float minc = std::min(r, std::min(g, b));
      const float deltac = maxc - minc;
      const float dsafe = deltac == 0.0f ? 1.0f : deltac;
      const float rc = (maxc - r) / dsafe;
      const float gc = (maxc - g) / dsafe;
      const float bc = (maxc - b) / dsafe;
      float h = r == maxc ? (bc - gc)
                          : (g == maxc ? 2.0f + rc - bc : 4.0f + gc - rc);
      h = deltac == 0.0f ? 0.0f : h;
      h = h / 6.0f;
      h -= std::floor(h);
      h += delta;
      h -= std::floor(h);
      const float f6 = h * 6.0f;
      const float fi = std::floor(f6);  // in [0, 6]: h may round up to 1.0
      fbuf[i] = f6 - fi;  // exact
      ibuf[i] = fi == 6.0f ? 0.0f : fi;
      sbuf[i] = maxc > 0.0f ? deltac / std::max(maxc, 1e-12f) : 0.0f;
      vbuf[i] = maxc;
    }
    for (long long i = 0; i < n; ++i) {
      const double f = fbuf[i], s = sbuf[i], v = vbuf[i];
      qbuf[i] = static_cast<float>(v * (1.0 - s * f));
      tbuf[i] = static_cast<float>(v * (1.0 - s * (1.0 - f)));
    }
    for (long long i = 0; i < n; ++i) {
      const float fi = ibuf[i], s = sbuf[i], v = vbuf[i];
      const float p = v * (1.0f - s), q = qbuf[i], t = tbuf[i];
      // Sector table (matches _hsv_to_rgb):
      //   i: 0:(v,t,p) 1:(q,v,p) 2:(p,v,t) 3:(p,q,v) 4:(t,p,v) 5:(v,p,q)
      rbuf[i] = fi == 0.0f ? v
              : fi == 1.0f ? q
              : fi == 2.0f ? p
              : fi == 3.0f ? p
              : fi == 4.0f ? t : v;
      gbuf[i] = fi == 0.0f ? t
              : fi == 1.0f ? v
              : fi == 2.0f ? v
              : fi == 3.0f ? q : p;
      bbuf[i] = fi == 0.0f ? p
              : fi == 1.0f ? p
              : fi == 2.0f ? t
              : fi == 3.0f ? v
              : fi == 4.0f ? v : q;
    }
    float* dp = dst + 3 * base;
    for (long long i = 0; i < n; ++i) {
      dp[3 * i] = rbuf[i];
      dp[3 * i + 1] = gbuf[i];
      dp[3 * i + 2] = bbuf[i];
    }
  }
}

}  // extern "C"

// Image decoding and the dataset's resize + center crop, as a plain C ABI
// loaded with ctypes (data/_dataio.py builds it with g++ at first use).
//
// The port's own copy of the JAX package's native data runtime
// (sonicdiffusionbayeslab_tpu/runtime/dataio.cpp), split by the libraries
// it needs:
//   * sdbl_resize_center_crop: no library; the same filter bank and
//     rounding as the reference, so it gives the same bytes;
//   * sdbl_decode_png: zlib only (inflate, then the five PNG row filters),
//     8-bit RGB or RGBA, not interlaced; alpha is dropped, as libpng's
//     png_set_strip_alpha does;
//   * sdbl_decode_jpeg: libjpeg, compiled only where jpeglib.h is found
//     (SDBL_HAVE_JPEG); sdbl_has_jpeg() says whether it was.
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

#ifdef SDBL_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

extern "C" {

int sdbl_dataio_version() { return 1; }

int sdbl_has_jpeg() {
#ifdef SDBL_HAVE_JPEG
  return 1;
#else
  return 0;
#endif
}

// ------------------------------------------------------------------ JPEG
#ifdef SDBL_HAVE_JPEG
struct sdbl_error_mgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void sdbl_jpeg_error_exit(j_common_ptr cinfo) {
  sdbl_error_mgr* err = reinterpret_cast<sdbl_error_mgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
#endif

// Decode a JPEG in memory to RGB8 (libjpeg's defaults, as the reference).
// -10: built without libjpeg.
int sdbl_decode_jpeg(const uint8_t* data, int64_t size, uint8_t* out,
                     int64_t out_cap, int32_t* out_w, int32_t* out_h) {
#ifdef SDBL_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  sdbl_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = sdbl_jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if (static_cast<int64_t>(w) * h * 3 > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_w = w;
  *out_h = h;
  return 0;
#else
  (void)data; (void)size; (void)out; (void)out_cap; (void)out_w; (void)out_h;
  return -10;
#endif
}

// ------------------------------------------------------------------- PNG
static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

static int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Decode an 8-bit RGB or RGBA, non-interlaced PNG to RGB8.  -3: not a PNG;
// -2: corrupt (bad chunk, CRC or zlib stream); -4: out too small; -5: a
// PNG variant this decoder does not take (bit depth, colour type, interlace).
int sdbl_decode_png(const uint8_t* data, int64_t size, uint8_t* out,
                    int64_t out_cap, int32_t* out_w, int32_t* out_h) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(data, sig, 8) != 0) return -3;
  int64_t pos = 8;
  uint32_t w = 0, h = 0;
  int channels = 0;
  bool have_header = false, have_end = false;
  std::vector<uint8_t> idat;
  while (pos + 12 <= size) {
    const uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + static_cast<int64_t>(len) > size) return -2;
    const uint32_t crc = be32(body + len);
    if (static_cast<uint32_t>(crc32(0L, type, len + 4)) != crc) return -2;
    if (!memcmp(type, "IHDR", 4)) {
      if (len != 13) return -2;
      w = be32(body);
      h = be32(body + 4);
      const int depth = body[8], colour = body[9], interlace = body[12];
      if (depth != 8 || (colour != 2 && colour != 6) || interlace != 0 || body[10] || body[11])
        return -5;
      channels = colour == 6 ? 4 : 3;
      have_header = true;
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      have_end = true;
      break;
    }
    pos += 12 + static_cast<int64_t>(len);
  }
  if (!have_header || !have_end || w == 0 || h == 0) return -2;
  if (static_cast<int64_t>(w) * h * 3 > out_cap) return -4;

  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -2;
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  const int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || zs.avail_out != 0) return -2;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + y * (stride + 1);
    const int filter = line[0];
    const uint8_t* src = line + 1;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= static_cast<size_t>(channels) ? cur[i - channels] : 0;
      const int b = prev[i];
      const int c = i >= static_cast<size_t>(channels) ? prev[i - channels] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return -2;
      }
      cur[i] = static_cast<uint8_t>(src[i] + pred);
    }
    uint8_t* dst = out + static_cast<int64_t>(y) * w * 3;
    for (uint32_t x = 0; x < w; ++x) {
      dst[x * 3 + 0] = cur[x * channels + 0];
      dst[x * 3 + 1] = cur[x * channels + 1];
      dst[x * 3 + 2] = cur[x * channels + 2];
    }
    prev.swap(cur);
  }
  *out_w = static_cast<int32_t>(w);
  *out_h = static_cast<int32_t>(h);
  return 0;
}

// ----------------------------- resize (antialiased bilinear) + crop
// src: h*w*3 RGB8.  Resizes so the short side equals `size` (separable
// triangle filter with support scaled on downscale), then center crops to
// size x size.  dst must hold size*size*3 bytes.

namespace {

// For each of n_out output positions (offset by crop x0): the contributing
// source index range and normalized triangle weights.
struct FilterBank {
  std::vector<int> start;
  std::vector<int> count;
  std::vector<double> weights;  // flattened, max_taps per output
  int max_taps;
};

FilterBank make_filter(int n_src, int n_dst_full, int crop0, int n_out) {
  const double scale = static_cast<double>(n_dst_full) / n_src;  // dst/src
  const double inv = 1.0 / scale;
  const double support = scale < 1.0 ? inv : 1.0;  // triangle radius in src units
  FilterBank fb;
  fb.max_taps = static_cast<int>(2 * support + 2);
  fb.start.resize(n_out);
  fb.count.resize(n_out);
  fb.weights.assign(static_cast<size_t>(n_out) * fb.max_taps, 0.0);
  for (int o = 0; o < n_out; ++o) {
    const double center = (o + crop0 + 0.5) * inv - 0.5;
    int lo = static_cast<int>(center - support + 0.5 - 1);
    int hi = static_cast<int>(center + support + 0.5 + 1);
    if (lo < 0) lo = 0;
    if (hi > n_src - 1) hi = n_src - 1;
    double total = 0.0;
    int cnt = 0;
    for (int i = lo; i <= hi && cnt < fb.max_taps; ++i) {
      const double d = (i - center) * (scale < 1.0 ? scale : 1.0);
      const double wgt = d > -1.0 && d < 1.0 ? 1.0 - (d < 0 ? -d : d) : 0.0;
      if (wgt <= 0.0 && cnt == 0) {
        ++lo;
        continue;
      }
      fb.weights[static_cast<size_t>(o) * fb.max_taps + cnt] = wgt;
      total += wgt;
      ++cnt;
    }
    fb.start[o] = lo;
    fb.count[o] = cnt;
    if (total > 0) {
      for (int t = 0; t < cnt; ++t)
        fb.weights[static_cast<size_t>(o) * fb.max_taps + t] /= total;
    }
  }
  return fb;
}

}  // namespace

int sdbl_resize_center_crop(const uint8_t* src, int32_t w, int32_t h,
                            int32_t size, uint8_t* dst) {
  if (w <= 0 || h <= 0 || size <= 0) return -1;
  const double scale = static_cast<double>(size) / (w < h ? w : h);
  const int rw = static_cast<int>(w * scale + 0.5);
  const int rh = static_cast<int>(h * scale + 0.5);
  const int x0 = (rw - size) / 2;
  const int y0 = (rh - size) / 2;

  FilterBank fx = make_filter(w, rw, x0, size);
  FilterBank fy = make_filter(h, rh, y0, size);

  // Horizontal pass into a float intermediate (h x size x 3).
  std::vector<float> tmp(static_cast<size_t>(h) * size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * size * 3;
    for (int x = 0; x < size; ++x) {
      double acc[3] = {0, 0, 0};
      const int s = fx.start[x], c = fx.count[x];
      const double* wts = &fx.weights[static_cast<size_t>(x) * fx.max_taps];
      for (int t = 0; t < c; ++t) {
        const uint8_t* p = row + static_cast<int64_t>(s + t) * 3;
        acc[0] += wts[t] * p[0];
        acc[1] += wts[t] * p[1];
        acc[2] += wts[t] * p[2];
      }
      trow[x * 3 + 0] = static_cast<float>(acc[0]);
      trow[x * 3 + 1] = static_cast<float>(acc[1]);
      trow[x * 3 + 2] = static_cast<float>(acc[2]);
    }
  }
  // Vertical pass.
  for (int y = 0; y < size; ++y) {
    const int s = fy.start[y], c = fy.count[y];
    const double* wts = &fy.weights[static_cast<size_t>(y) * fy.max_taps];
    uint8_t* drow = dst + static_cast<int64_t>(y) * size * 3;
    for (int x = 0; x < size * 3; ++x) {
      double acc = 0;
      for (int t = 0; t < c; ++t) {
        acc += wts[t] * tmp[static_cast<size_t>(s + t) * size * 3 + x];
      }
      const double v = acc + 0.5;
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  return 0;
}

}  // extern "C"

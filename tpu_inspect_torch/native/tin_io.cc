// tin_io: native image decode for tpu_inspect_torch (a copy of the JAX
// package's tpu_inspect/native/tin_io.cc, so the port never imports it).
//
// The reference delegates image decode to Qt / OpenCV C++ through Python
// bindings (indexing_ui.py:145-194). This library is the port's own native
// decode path: PNG via libpng, TIFF via libtiff, returning raw pixel
// buffers (uint8/uint16; gray / BGR / BGRA channel order matching
// cv2.imread(IMREAD_UNCHANGED)) to the Python host layer, which applies the
// reference's normalization semantics (tpu_inspect_torch/imageio.py). A
// host without cv2 reads PNG and TIFF captures through it alone.
//
// Contract: tin_decode returns 0 on success. Any file the decoder cannot
// handle bit-exactly (unusual layouts, float TIFFs, gray+alpha PNGs)
// returns nonzero and the caller falls back to cv2 - parity first.
//
// Build (tpu_inspect_torch/native/__init__.py, at first use):
//   g++ -O2 -shared -fPIC -pthread tin_io.cc -o libtin_io_<hash>.so -lpng -ltiff

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <png.h>
#include <tiffio.h>

extern "C" {

void tin_free(uint8_t* p) { free(p); }

const char* tin_version() { return "tin_io 1.0 (libpng + libtiff)"; }

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

static int decode_png(FILE* fp, uint8_t** data, int32_t* w, int32_t* h,
                      int32_t* channels, int32_t* bitdepth) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 2;
  }
  uint8_t* buf = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    return 3;
  }
  png_init_io(png, fp);

  // expand palette -> RGB and sub-8-bit gray -> 8; keep 16-bit (swapped to
  // little-endian, matching cv2's IMREAD_UNCHANGED)
  int transforms = PNG_TRANSFORM_EXPAND | PNG_TRANSFORM_PACKING;
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  transforms |= PNG_TRANSFORM_SWAP_ENDIAN;
#endif
  png_read_png(png, info, transforms, nullptr);

  const png_uint_32 width = png_get_image_width(png, info);
  const png_uint_32 height = png_get_image_height(png, info);
  const int depth = png_get_bit_depth(png, info);
  const int nch = png_get_channels(png, info);
  if ((depth != 8 && depth != 16) || (nch != 1 && nch != 3 && nch != 4)) {
    // gray+alpha and exotic layouts: let cv2 handle them
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;
  }
  const size_t bytes_per_sample = depth / 8;
  const size_t row_bytes = (size_t)width * nch * bytes_per_sample;
  buf = (uint8_t*)malloc(row_bytes * height);
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 5;
  }
  png_bytepp rows = png_get_rows(png, info);
  for (png_uint_32 y = 0; y < height; y++) {
    memcpy(buf + (size_t)y * row_bytes, rows[y], row_bytes);
  }
  // RGB(A) -> BGR(A), the cv2 channel order the host layer expects
  if (nch >= 3) {
    if (depth == 8) {
      for (size_t i = 0; i < (size_t)width * height; i++) {
        uint8_t* px = buf + i * nch;
        uint8_t t = px[0];
        px[0] = px[2];
        px[2] = t;
      }
    } else {
      uint16_t* b16 = (uint16_t*)buf;
      for (size_t i = 0; i < (size_t)width * height; i++) {
        uint16_t* px = b16 + i * nch;
        uint16_t t = px[0];
        px[0] = px[2];
        px[2] = t;
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *data = buf;
  *w = (int32_t)width;
  *h = (int32_t)height;
  *channels = nch;
  *bitdepth = depth;
  return 0;
}

// ---------------------------------------------------------------------------
// TIFF
// ---------------------------------------------------------------------------

static void tiff_quiet(const char*, const char*, va_list) {}

static int decode_tiff(const char* path, uint8_t** data, int32_t* w,
                       int32_t* h, int32_t* channels, int32_t* bitdepth) {
  TIFFSetErrorHandler(tiff_quiet);
  TIFFSetWarningHandler(tiff_quiet);
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return 2;

  uint32_t width = 0, height = 0;
  uint16_t bits = 0, spp = 0, sfmt = SAMPLEFORMAT_UINT, planar = 0,
           photometric = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bits);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &sfmt);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photometric);

  // strictly handled: uint8/uint16, 1 or 3 or 4 contiguous samples,
  // scanline-readable, min-is-black gray or RGB. Everything else -> cv2.
  const bool ok_fmt =
      (bits == 8 || bits == 16) && (spp == 1 || spp == 3 || spp == 4) &&
      sfmt == SAMPLEFORMAT_UINT && planar == PLANARCONFIG_CONTIG &&
      (photometric == PHOTOMETRIC_MINISBLACK || photometric == PHOTOMETRIC_RGB) &&
      !TIFFIsTiled(tif) && width > 0 && height > 0;
  if (!ok_fmt) {
    TIFFClose(tif);
    return 4;
  }
  const size_t row_bytes = (size_t)width * spp * (bits / 8);
  const tmsize_t scan = TIFFScanlineSize(tif);
  if ((size_t)scan != row_bytes) {
    TIFFClose(tif);
    return 4;
  }
  uint8_t* buf = (uint8_t*)malloc(row_bytes * height);
  if (!buf) {
    TIFFClose(tif);
    return 5;
  }
  for (uint32_t y = 0; y < height; y++) {
    if (TIFFReadScanline(tif, buf + (size_t)y * row_bytes, y) < 0) {
      free(buf);
      TIFFClose(tif);
      return 3;
    }
  }
  TIFFClose(tif);
  if (spp >= 3) {  // RGB(A) -> BGR(A)
    if (bits == 8) {
      for (size_t i = 0; i < (size_t)width * height; i++) {
        uint8_t* px = buf + i * spp;
        uint8_t t = px[0];
        px[0] = px[2];
        px[2] = t;
      }
    } else {
      uint16_t* b16 = (uint16_t*)buf;
      for (size_t i = 0; i < (size_t)width * height; i++) {
        uint16_t* px = b16 + i * spp;
        uint16_t t = px[0];
        px[0] = px[2];
        px[2] = t;
      }
    }
  }
  *data = buf;
  *w = (int32_t)width;
  *h = (int32_t)height;
  *channels = spp;
  *bitdepth = bits;
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encode (8-bit grayscale: the masks_%04d.png export path,
// indexing_ui.py:2703-2730)
// ---------------------------------------------------------------------------

int tin_encode_png_gray8(const char* path, const uint8_t* data, int32_t w,
                         int32_t h) {
  if (w <= 0 || h <= 0 || !data) return 1;
  FILE* fp = fopen(path, "wb");
  if (!fp) return 1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return 2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_GRAY, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int32_t y = 0; y < h; y++) {
    png_write_row(png, (png_const_bytep)(data + (size_t)y * w));
  }
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// dispatch by magic bytes
// ---------------------------------------------------------------------------

int tin_decode(const char* path, uint8_t** data, int32_t* w, int32_t* h,
               int32_t* channels, int32_t* bitdepth) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  unsigned char magic[8] = {0};
  size_t n = fread(magic, 1, 8, fp);
  if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rewind(fp);
    int rc = decode_png(fp, data, w, h, channels, bitdepth);
    fclose(fp);
    return rc;
  }
  fclose(fp);
  const bool is_tiff =
      n >= 4 && ((magic[0] == 'I' && magic[1] == 'I' && magic[2] == 42 &&
                  magic[3] == 0) ||
                 (magic[0] == 'M' && magic[1] == 'M' && magic[2] == 0 &&
                  magic[3] == 42));
  if (is_tiff) return decode_tiff(path, data, w, h, channels, bitdepth);
  return 6;  // unknown container (JPEG/BMP/...): cv2 fallback
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded prefetch loader — the framework's native data-loader runtime.
//
// The reference decodes each image synchronously on the UI thread at switch
// time (indexing_ui.py:145-194, :1225). Production deployment is a stream of
// captures (streaming.py); this loader decodes ahead on a worker pool so the
// host never stalls the device pipeline on libpng/libtiff: workers claim
// frame indices, decode into malloc'd buffers, and a bounded in-order queue
// hands frames to the consumer (bounded => at most `capacity` decoded frames
// in flight, so memory stays flat on arbitrarily long streams).
// ---------------------------------------------------------------------------

#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  uint8_t* data = nullptr;
  int32_t w = 0, h = 0, channels = 0, bitdepth = 0;
  int rc = 0;
};

struct Loader {
  std::vector<std::string> paths;
  int32_t capacity = 1;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable ready_cv;  // consumer: frames[consumed] available
  std::condition_variable space_cv;  // workers: claim slot within capacity
  std::map<int32_t, Frame> frames;   // decoded, not yet consumed
  int32_t next_claim = 0;
  int32_t consumed = 0;
  bool stop = false;

  void work() {
    for (;;) {
      int32_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        space_cv.wait(lk, [&] {
          return stop || (next_claim < (int32_t)paths.size() &&
                          next_claim < consumed + capacity);
        });
        if (stop || next_claim >= (int32_t)paths.size()) return;
        idx = next_claim++;
      }
      Frame f;
      f.rc = tin_decode(paths[idx].c_str(), &f.data, &f.w, &f.h, &f.channels,
                        &f.bitdepth);
      if (f.rc != 0) f.data = nullptr;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stop) {
          free(f.data);
          return;
        }
        frames[idx] = f;
      }
      ready_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* tin_loader_create(const char** paths, int32_t n, int32_t capacity,
                        int32_t threads) {
  if (n < 0 || capacity < 1 || threads < 1) return nullptr;
  Loader* L = new Loader();
  L->paths.reserve(n);
  for (int32_t i = 0; i < n; i++) L->paths.emplace_back(paths[i]);
  L->capacity = capacity;
  int32_t t = threads;
  if (n > 0 && t > n) t = n;
  for (int32_t i = 0; i < t && n > 0; i++) {
    L->workers.emplace_back(&Loader::work, L);
  }
  return L;
}

// Delivers frames strictly in path order. Returns 0 on success (caller owns
// *data, frees with tin_free), -1 when the stream is exhausted (or the
// loader was stopped), and the per-frame tin_decode code (>0, *data null)
// when that frame's native decode declined — the caller decodes that one
// path itself and keeps streaming.
int tin_loader_next(void* handle, uint8_t** data, int32_t* w, int32_t* h,
                    int32_t* channels, int32_t* bitdepth) {
  Loader* L = (Loader*)handle;
  if (!L) return -1;
  Frame f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->consumed >= (int32_t)L->paths.size()) return -1;
    L->ready_cv.wait(
        lk, [&] { return L->frames.count(L->consumed) || L->stop; });
    if (L->stop) return -1;
    f = L->frames[L->consumed];
    L->frames.erase(L->consumed);
    L->consumed++;
  }
  L->space_cv.notify_all();
  *data = f.data;
  *w = f.w;
  *h = f.h;
  *channels = f.channels;
  *bitdepth = f.bitdepth;
  return f.rc;
}

void tin_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->space_cv.notify_all();
  L->ready_cv.notify_all();
  for (auto& t : L->workers) t.join();
  for (auto& kv : L->frames) free(kv.second.data);
  delete L;
}

}  // extern "C"

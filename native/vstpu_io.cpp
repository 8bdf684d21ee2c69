// vstpu_io — native IO runtime for visualslam.
//
// The reference is pure native C++ throughout (SURVEY.md §2.1 note); in this
// framework the device compute path is JAX/XLA, and the host-side runtime that
// feeds it is this library: grayscale image decode (PNG via libpng, JPEG via
// libjpeg, PGM native), a multithreaded lookahead prefetcher that decodes
// frames ahead of the SLAM loop (double buffering between disk and device),
// and the reference-compatible descriptor serialization
// (featureDescriptors.dat, Diff_of_Gauss.cpp:838-863).
//
// C ABI for ctypes binding (visualslam/io/native.py). Build: native/build.sh

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Decoding
// ---------------------------------------------------------------------------

// Returns 0 on success. Fills *h, *w. If out != nullptr it must hold h*w
// floats (grayscale in [0,1]); probe first with out == nullptr.
static int decode_png_gray(const char* path, float* out, int* h, int* w);
static int decode_jpeg_gray(const char* path, float* out, int* h, int* w);
static int decode_pgm_gray(const char* path, float* out, int* h, int* w);

int vstpu_decode_gray(const char* path, float* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  fclose(f);
  if (got < 2) return -2;
  if (magic[0] == 0x89 && magic[1] == 'P') return decode_png_gray(path, out, h, w);
  if (magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg_gray(path, out, h, w);
  if (magic[0] == 'P' && (magic[1] == '5' || magic[1] == '2'))
    return decode_pgm_gray(path, out, h, w);
  return -3;
}

static int decode_png_gray(const char* path, float* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return -4;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  *h = (int)height;
  *w = (int)width;
  if (!out) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 0;
  }
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);  // ITU-R BT.709-ish weights
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  const float inv = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < height; y++) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + (size_t)y * width;
    for (png_uint_32 x = 0; x < width; x++) dst[x] = row[x] * inv;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

static int decode_jpeg_gray(const char* path, float* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  *h = (int)cinfo.output_height;
  *w = (int)cinfo.output_width;
  if (!out) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  std::vector<unsigned char> row(cinfo.output_width);
  const float inv = 1.0f / 255.0f;
  unsigned char* rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = (int)cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out + (size_t)y * cinfo.output_width;
    for (unsigned x = 0; x < cinfo.output_width; x++) dst[x] = row[x] * inv;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

static int decode_pgm_gray(const char* path, float* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0};
  int width, height, maxval;
  if (fscanf(f, "%2s %d %d %d", magic, &width, &height, &maxval) != 4) {
    fclose(f);
    return -5;
  }
  fgetc(f);  // single whitespace after header
  *h = height;
  *w = width;
  if (!out) {
    fclose(f);
    return 0;
  }
  const float inv = 1.0f / (float)maxval;
  size_t n = (size_t)width * height;
  if (strcmp(magic, "P5") == 0) {
    std::vector<unsigned char> buf(n);
    if (fread(buf.data(), 1, n, f) != n) {
      fclose(f);
      return -6;
    }
    for (size_t i = 0; i < n; i++) out[i] = buf[i] * inv;
  } else {  // P2 ascii
    for (size_t i = 0; i < n; i++) {
      int v;
      if (fscanf(f, "%d", &v) != 1) {
        fclose(f);
        return -6;
      }
      out[i] = v * inv;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetcher: worker threads decode frames ahead, consumer pops in order
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> data;
  int h = 0, w = 0, status = 0;  // status: 0 empty, 1 ready, <0 error
  int64_t frame = -1;
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int64_t> next_job{0};
  int64_t next_out = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  explicit Prefetcher(std::vector<std::string> p, int capacity, int n_threads)
      : paths(std::move(p)), slots(capacity) {
    for (int t = 0; t < n_threads; t++)
      workers.emplace_back([this] { work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& th : workers) th.join();
  }

  void work() {
    for (;;) {
      int64_t job = next_job.fetch_add(1);
      if (job >= (int64_t)paths.size()) return;
      int h = 0, w = 0;
      // decode outside the lock
      int rc = vstpu_decode_gray(paths[job].c_str(), nullptr, &h, &w);
      std::vector<float> buf;
      if (rc == 0) {
        buf.resize((size_t)h * w);
        rc = vstpu_decode_gray(paths[job].c_str(), buf.data(), &h, &w);
      }
      std::unique_lock<std::mutex> lk(mu);
      Slot& s = slots[job % slots.size()];
      // wait until the slot is free AND it is this job's turn for it —
      // without the window check two jobs that map to the same slot can
      // write out of order and deadlock the in-order consumer
      cv_free.wait(lk, [&] {
        return stop || (s.status == 0 &&
                        job < next_out + (int64_t)slots.size());
      });
      if (stop) return;
      s.data = std::move(buf);
      s.h = h;
      s.w = w;
      s.status = rc == 0 ? 1 : rc;
      s.frame = job;
      cv_ready.notify_all();
    }
  }

  // returns 0 ok / <0 error / 1 end-of-sequence
  int pop(float* out, int* h, int* w, int64_t max_elems) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_out >= (int64_t)paths.size()) return 1;
    Slot& s = slots[next_out % slots.size()];
    cv_ready.wait(lk, [&] { return stop || (s.status != 0 && s.frame == next_out); });
    if (stop) return -9;
    int rc = s.status > 0 ? 0 : s.status;
    *h = s.h;
    *w = s.w;
    if (rc == 0) {
      int64_t n = (int64_t)s.h * s.w;
      if (n > max_elems) rc = -7;
      else memcpy(out, s.data.data(), (size_t)n * sizeof(float));
    }
    s.status = 0;
    s.frame = -1;
    next_out++;
    cv_free.notify_all();
    return rc;
  }
};

void* vstpu_prefetcher_create(const char** paths, int n_paths, int capacity,
                              int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  if (capacity < 2) capacity = 2;
  if (n_threads < 1) n_threads = 1;
  return new Prefetcher(std::move(p), capacity, n_threads);
}

int vstpu_prefetcher_next(void* handle, float* out, int* h, int* w,
                          int64_t max_elems) {
  return static_cast<Prefetcher*>(handle)->pop(out, h, w, max_elems);
}

void vstpu_prefetcher_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

// ---------------------------------------------------------------------------
// Reference-format descriptor serialization (Diff_of_Gauss.cpp:838-863)
// ---------------------------------------------------------------------------

int vstpu_write_descriptors(const char* path, const float* data, int n, int d) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int front = 4;  // element size (the reference wrote sizeof(std::vector)=24)
  int ok = fwrite(&n, 4, 1, f) == 1 && fwrite(&d, 4, 1, f) == 1 &&
           fwrite(&front, 4, 1, f) == 1 &&
           fwrite(data, sizeof(float), (size_t)n * d, f) == (size_t)n * d;
  fclose(f);
  return ok ? 0 : -2;
}

// probe: n/d only (data == nullptr), else fill data (must hold n*d floats)
int vstpu_read_descriptors(const char* path, float* data, int* n, int* d) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int front = 0;
  if (fread(n, 4, 1, f) != 1 || fread(d, 4, 1, f) != 1 ||
      fread(&front, 4, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  if (front != 4 && front != 24) {  // 24 = reference quirk
    fclose(f);
    return -3;
  }
  int rc = 0;
  if (data) {
    size_t cnt = (size_t)(*n) * (*d);
    if (fread(data, sizeof(float), cnt, f) != cnt) rc = -4;
  }
  fclose(f);
  return rc;
}

}  // extern "C"

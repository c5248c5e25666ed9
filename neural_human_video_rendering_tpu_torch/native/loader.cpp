// Native data-loader runtime: threaded JPEG/PNG decode -> bilinear resize ->
// normalize, delivering ready float32 tensors to the Python input pipeline.
//
// The PyTorch port's copy of the JAX package's native/loader.cpp: the same
// C ABI, the same decode rules and the same arithmetic, expression for
// expression, so both packages read the same pixels from a file. A C++
// worker pool decodes and resizes frames while the device computes, and
// Python (ctypes, data/native_loader.py) only moves ready buffers. No
// per-frame Python, no GIL on the decode path.
//
// C ABI (all functions exported with nhvr_ prefix):
//   nhvr_decode_image(path, out, size, mode) -> 0 ok / <0 error
//       mode 0: RGB float32 [-1,1], out has size*size*3 floats
//       mode 1: grayscale float32 [0,1], out has size*size floats
//       mode 2: RGB uint8 nearest-resize (IUV labels), out size*size*3 bytes
//   nhvr_batch_create(paths, n_paths, size, mode, n_threads) -> handle
//   nhvr_batch_submit(handle, indices, count)   enqueue decode jobs
//   nhvr_batch_wait(handle, out)                blocks; writes count items
//   nhvr_batch_destroy(handle)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off loader.cpp
//   -o libnhvr_loader.so -ljpeg -lpng -lpthread
// (data/native_loader.py builds it into build/native/ on first use).
// -ffp-contract=off keeps a*b+c unfused on every host, so the float
// expressions round as written (aarch64 g++ contracts them by default).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved, c channels
};

// ---------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG
bool decode_png(FILE* f, Image* out) {
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return false;
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray->8bit, tRNS->alpha
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->c = png_get_channels(png, info);
  if (out->c != 1 && out->c != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  out->data.resize(size_t(out->w) * out->h * out->c);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * out->c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int c0 = fgetc(f);
  int c1 = fgetc(f);
  rewind(f);
  bool ok = false;
  if (c0 == 0xFF && c1 == 0xD8) ok = decode_jpeg(f, out);
  else if (c0 == 0x89 && c1 == 'P') ok = decode_png(f, out);
  fclose(f);
  return ok;
}

// -------------------------------------------------------------- resize
inline uint8_t sample_u8(const Image& im, int x, int y, int ch) {
  return im.data[(size_t(y) * im.w + x) * im.c + ch];
}

// bilinear resize one channel plane into a float buffer (no normalization)
void resize_bilinear(const Image& im, int size, int ch, float* out) {
  const float sx = float(im.w) / size, sy = float(im.h) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= im.h ? im.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= im.h ? im.h - 1 : y0 + 1);
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= im.w ? im.w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= im.w ? im.w - 1 : x0 + 1);
      float v00 = sample_u8(im, x0c, y0c, ch), v01 = sample_u8(im, x1c, y0c, ch);
      float v10 = sample_u8(im, x0c, y1c, ch), v11 = sample_u8(im, x1c, y1c, ch);
      out[size_t(oy) * size + ox] =
          (v00 * (1 - wx) + v01 * wx) * (1 - wy) +
          (v10 * (1 - wx) + v11 * wx) * wy;
    }
  }
}

void resize_nearest_u8(const Image& im, int size, uint8_t* out) {
  const float sx = float(im.w) / size, sy = float(im.h) / size;
  for (int oy = 0; oy < size; ++oy) {
    int y = (int)((oy + 0.5f) * sy);
    if (y >= im.h) y = im.h - 1;
    for (int ox = 0; ox < size; ++ox) {
      int x = (int)((ox + 0.5f) * sx);
      if (x >= im.w) x = im.w - 1;
      for (int ch = 0; ch < 3; ++ch)
        out[(size_t(oy) * size + ox) * 3 + ch] =
            im.c == 3 ? sample_u8(im, x, y, ch) : sample_u8(im, x, y, 0);
    }
  }
}

int decode_to(const char* path, void* out, int size, int mode) {
  Image im;
  if (!decode_file(path, &im)) return -1;
  if (mode == 0) {  // RGB float [-1, 1], HWC
    float* o = reinterpret_cast<float*>(out);
    std::vector<float> plane(size_t(size) * size);
    for (int ch = 0; ch < 3; ++ch) {
      int src_ch = im.c == 3 ? ch : 0;
      resize_bilinear(im, size, src_ch, plane.data());
      for (int i = 0; i < size * size; ++i)
        o[size_t(i) * 3 + ch] = plane[i] * (2.0f / 255.0f) - 1.0f;
    }
  } else if (mode == 1) {  // gray float [0, 1]
    float* o = reinterpret_cast<float*>(out);
    std::vector<float> plane(size_t(size) * size);
    if (im.c == 3) {
      // BT.601 luminance — matches the cv2.IMREAD_GRAYSCALE fallback path
      std::vector<float> g(size_t(size) * size);
      static const float lw[3] = {0.299f, 0.587f, 0.114f};
      std::fill(plane.begin(), plane.end(), 0.0f);
      for (int ch = 0; ch < 3; ++ch) {
        resize_bilinear(im, size, ch, g.data());
        for (int i = 0; i < size * size; ++i) plane[i] += lw[ch] * g[i];
      }
    } else {
      resize_bilinear(im, size, 0, plane.data());
    }
    for (int i = 0; i < size * size; ++i) o[i] = plane[i] / 255.0f;
  } else if (mode == 2) {  // label RGB uint8, nearest
    resize_nearest_u8(im, size, reinterpret_cast<uint8_t*>(out));
  } else {
    return -2;
  }
  return 0;
}

// --------------------------------------------------------- worker pool
struct Batcher {
  std::vector<std::string> paths;
  int size = 0, mode = 0;
  size_t item_floats = 0;  // floats (or bytes for mode 2) per item

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::queue<std::pair<int, int>> jobs;  // (slot, path index)
  uint8_t* out = nullptr;                // current output buffer
  int pending = 0;
  std::atomic<int> errors{0};
  bool stop = false;

  void worker() {
    for (;;) {
      std::pair<int, int> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = jobs.front();
        jobs.pop();
      }
      size_t bytes = mode == 2 ? item_floats : item_floats * 4;
      int rc = decode_to(paths[job.second].c_str(), out + bytes * job.first,
                         size, mode);
      if (rc != 0) errors.fetch_add(1);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (--pending == 0) cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

int nhvr_decode_image(const char* path, void* out, int size, int mode) {
  return decode_to(path, out, size, mode);
}

void* nhvr_batch_create(const char** paths, int n_paths, int size, int mode,
                        int n_threads) {
  auto* b = new Batcher();
  b->paths.assign(paths, paths + n_paths);
  b->size = size;
  b->mode = mode;
  b->item_floats = mode == 1 ? size_t(size) * size : size_t(size) * size * 3;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    b->workers.emplace_back([b] { b->worker(); });
  return b;
}

int nhvr_batch_submit(void* handle, const int* indices, int count, void* out) {
  auto* b = static_cast<Batcher*>(handle);
  std::lock_guard<std::mutex> lk(b->mu);
  if (b->pending != 0) return -1;  // previous batch not drained
  // validate BEFORE mutating any state: rejecting mid-enqueue would leave
  // pending > queued jobs and a later wait() would block forever
  for (int i = 0; i < count; ++i)
    if (indices[i] < 0 || indices[i] >= (int)b->paths.size()) return -2;
  b->out = reinterpret_cast<uint8_t*>(out);
  b->errors.store(0);
  b->pending = count;
  for (int i = 0; i < count; ++i) b->jobs.emplace(i, indices[i]);
  b->cv_job.notify_all();
  return 0;
}

int nhvr_batch_wait(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  std::unique_lock<std::mutex> lk(b->mu);
  b->cv_done.wait(lk, [&] { return b->pending == 0; });
  return -b->errors.load();
}

void nhvr_batch_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->stop = true;
  }
  b->cv_job.notify_all();
  for (auto& t : b->workers) t.join();
  delete b;
}

}  // extern "C"

// JPEG decode through the system libjpeg, for hosts without OpenCV: the
// JPEG part of the JAX package's native/loader.cpp, decoding to 8-bit
// interleaved RGB or gray at the file's own size (no resize here).
//
// C ABI:
//   nhvr_jpeg_decode(path, out, w, h, gray) -> 0 ok, <0 error
//     out == NULL: read the header only and set *w, *h;
//     else decode into out (*h * *w * (gray ? 1 : 3) bytes), checking the
//     size matches *w, *h.
//
// Build: g++ -O2 -shared -fPIC jpeg_decode.cpp -o libnhvr_jpeg.so -ljpeg
// (utils/image.py builds it into build/native/ at first use).

#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

}  // namespace

extern "C" int nhvr_jpeg_decode(const char* path, unsigned char* out, int* w,
                                int* h, int gray) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (!out) {
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int c = gray ? 1 : 3;
  if (static_cast<int>(cinfo.output_width) != *w ||
      static_cast<int>(cinfo.output_height) != *h ||
      static_cast<int>(cinfo.output_components) != c) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -3;
  }
  const size_t stride = static_cast<size_t>(*w) * c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

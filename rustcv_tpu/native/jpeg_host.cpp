// Fast full-host JPEG decode via libjpeg-turbo (SIMD), straight into a
// caller-provided PITCHED buffer — the device-host analog of the reference's
// turbojpeg path, which decompresses directly into the Mat with
// pitch = mat.step (rustcv-camera/src/decode.rs:92-123). No intermediate
// image object, no post-hoc channel swap: the decoder emits BGR (or RGB)
// scanlines directly via libjpeg-turbo's extended colorspaces.
//
// Compiled only when the toolchain finds <jpeglib.h> (the builder retries
// without -DRCV_HAVE_LIBJPEG; rcv_jpeg_host_available() then returns 0 and
// Python falls back to PIL).

#include <cstdint>
#include <cstring>

#ifdef RCV_HAVE_LIBJPEG

#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void on_emit(j_common_ptr, int) {}  // swallow warnings (corrupt-but-decodable)

}  // namespace

extern "C" {

int rcv_jpeg_host_available() { return 1; }

// Decode a JPEG into out[rows_cap][pitch], one scanline per row, 3 bytes per
// pixel in BGR (want_bgr=1) or RGB order. Returns 0 and fills *width/*height
// on success; negative on malformed input or capacity overflow.
int rcv_jpeg_decode_pitched(const uint8_t* data, long len, uint8_t* out,
                            long pitch, long rows_cap, int want_bgr,
                            int* width, int* height) {
  if (len <= 0) return -1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = on_emit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;  // libjpeg fatal error (malformed stream)
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = want_bgr ? JCS_EXT_BGR : JCS_EXT_RGB;
  // JDCT_ISLOW matches PIL's default decode bit-for-bit (same library).
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const long w = cinfo.output_width, h = cinfo.output_height;
  if (h > rows_cap || w * 3 > pitch || cinfo.output_components != 3) {
    // Geometry exceeds the staging row (or grayscale source — caller
    // renegotiates); stop cleanly without reading scanlines.
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *width = (int)w;
    *height = (int)h;
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (long)cinfo.output_scanline * pitch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *width = (int)w;
  *height = (int)h;
  return 0;
}

}  // extern "C"

#else  // !RCV_HAVE_LIBJPEG

extern "C" {
int rcv_jpeg_host_available() { return 0; }
int rcv_jpeg_decode_pitched(const uint8_t*, long, uint8_t*, long, long, int,
                            int*, int*) {
  return -100;
}
}

#endif

// Native batch image loader: JPEG decode + bilinear resize -> uint8 NHWC.
//
// The port's own copy of the JAX package's host loader (native/
// dataloader.cpp beside dml_tpu): the same source, so the two packages
// decode a JPEG batch to the same bytes. libjpeg(-turbo) decodes with
// DCT scaling (a large JPEG decodes straight to the smallest 1/2^k
// scale that still covers the target size, skipping most of the IDCT
// work), a C++ bilinear resize brings it to the model's input size, and
// a thread pool sized to the host's cores fills one contiguous NHWC
// uint8 block: the batch the engine copies to the card.
//
// Exposed as a small C ABI consumed via ctypes
// (dml_tpu_torch/native/loader.py, which builds it with g++ at first
// use); no Python C-API dependency, so one .so serves every interpreter.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize (align-corners=false, the PIL/TF convention of
// sampling at pixel centers), RGB interleaved uint8.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float top = row0[x0 * 3 + c] * (1 - wx) + row0[x1 * 3 + c] * wx;
        const float bot = row1[x0 * 3 + c] * (1 - wx) + row1[x1 * 3 + c] * wx;
        const float v = top * (1 - wy) + bot * wy;
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

bool decode_one(const char* path, int out_h, int out_w, uint8_t* out,
                std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    *err = std::string(path) + ": " + jerr.message;
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT scaling: decode at the smallest 1/2^k >= target resolution
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  while (static_cast<int>(cinfo.scale_denom) < 8 &&
         static_cast<int>(cinfo.image_height / (cinfo.scale_denom * 2)) >= out_h &&
         static_cast<int>(cinfo.image_width / (cinfo.scale_denom * 2)) >= out_w) {
    cinfo.scale_denom *= 2;
  }
  jpeg_start_decompress(&cinfo);
  const int sh = cinfo.output_height;
  const int sw = cinfo.output_width;
  std::vector<uint8_t> buf(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  resize_bilinear(buf.data(), sh, sw, out, out_h, out_w);
  return true;
}

}  // namespace

extern "C" {

// Decode n JPEG files into out (n * out_h * out_w * 3, NHWC uint8).
// Returns 0 on success; on failure returns 1 and writes the first
// error into errbuf.
int dml_decode_batch(const char** paths, int n, int out_h, int out_w,
                     uint8_t* out, int n_threads, char* errbuf,
                     int errbuf_len) {
  if (n <= 0) return 0;
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  int workers = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
  workers = std::min(workers, n);
  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  std::vector<std::string> errors(workers);
  std::vector<std::thread> pool;
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&, w]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        if (failed.load(std::memory_order_relaxed)) return;
        std::string err;
        if (!decode_one(paths[i], out_h, out_w, out + stride * i, &err)) {
          errors[w] = err;
          failed.store(true);
          return;
        }
      }
    });
  }
  for (auto& t : pool) t.join();
  if (failed.load()) {
    for (const auto& e : errors) {
      if (!e.empty()) {
        std::snprintf(errbuf, errbuf_len, "%s", e.c_str());
        break;
      }
    }
    return 1;
  }
  return 0;
}

int dml_loader_version() { return 1; }

}  // extern "C"

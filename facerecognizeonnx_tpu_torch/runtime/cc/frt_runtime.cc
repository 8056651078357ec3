// Native host runtime of facerecognizeonnx_tpu_torch (the port's own copy
// of the JAX package's runtime/cc/frt_runtime.cc; same functions, same
// arithmetic). The device path is PyTorch on the card; this library is
// the host side:
//
//   frt_letterbox   — uint8 bilinear letterbox (the reference's
//                     preprocess geometry, src/face_detector.cpp:92-137):
//                     float32 scale and resized size, (uint8)(v + 0.5f)
//   frt_nms         — greedy NMS with the reference's semantics,
//                     including the integer-rect IoU variant
//                     (src/face_detector.cpp:340-384): the bit-parity
//                     oracle of the device NMS
//   frt_ring_*      — a pthread ring buffer of frames: a producer
//                     thread letterboxes while the consumer feeds the
//                     card, overlapping host work with device compute
//   frt_image_info / frt_decode / frt_decode_letterbox
//                   — JPEG (libjpeg) + PNG (libpng) decode to BGR uint8
//                     (cv::imread channel order). Decode releases the
//                     Python GIL (ctypes). Compiled only when the codec
//                     headers exist (-DFRT_WITH_CODECS).
//   frt_loader_*    — a multi-threaded file loader: worker threads
//                     read + decode + letterbox a path list into a
//                     bounded queue.
//
// Built at first use by runtime/native.py with g++ (-O3 -std=c++17 -fPIC
// -ffp-contract=off, so the letterbox's rounding does not depend on
// whether the host contracts to FMA).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef FRT_WITH_CODECS
#include <csetjmp>
#include <jpeglib.h>
#include <png.h>
#endif

// ------------------------------------------------------------ codec helpers

namespace {

#ifdef FRT_WITH_CODECS

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool is_jpeg(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

bool is_png(const uint8_t* d, size_t n) {
  return n >= 8 && d[0] == 0x89 && d[1] == 'P' && d[2] == 'N' && d[3] == 'G';
}

// Header-only dimension probe. Returns false if the payload is neither
// a decodable JPEG nor PNG.
bool image_dims(const uint8_t* data, size_t len, int* h, int* w) {
  if (is_jpeg(data, len)) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return *w > 0 && *h > 0;
  }
  if (is_png(data, len)) {
    png_image image;
    std::memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, len)) return false;
    *w = (int)image.width;
    *h = (int)image.height;
    png_image_free(&image);
    return *w > 0 && *h > 0;
  }
  return false;
}

// Full decode to interleaved BGR uint8 (cv::imread channel order).
// Grayscale/paletted inputs are converted by the codec libraries.
bool decode_bgr(const uint8_t* data, size_t len, std::vector<uint8_t>& bgr,
                int* h, int* w) {
  if (is_jpeg(data, len)) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;  // codec converts gray→RGB too
    jpeg_start_decompress(&cinfo);
    int ww = (int)cinfo.output_width, hh = (int)cinfo.output_height;
    if (ww <= 0 || hh <= 0 || cinfo.output_components != 3) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    bgr.resize((size_t)hh * ww * 3);
    std::vector<uint8_t> row((size_t)ww * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      int y = (int)cinfo.output_scanline;
      uint8_t* rp = row.data();
      jpeg_read_scanlines(&cinfo, &rp, 1);
      uint8_t* out = bgr.data() + (size_t)y * ww * 3;
      for (int j = 0; j < ww; ++j) {  // RGB → BGR
        out[j * 3 + 0] = row[j * 3 + 2];
        out[j * 3 + 1] = row[j * 3 + 1];
        out[j * 3 + 2] = row[j * 3 + 0];
      }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *h = hh;
    *w = ww;
    return true;
  }
  if (is_png(data, len)) {
    png_image image;
    std::memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, len)) return false;
    image.format = PNG_FORMAT_BGR;  // libpng composites alpha/palette
    bgr.resize(PNG_IMAGE_SIZE(image));
    if (!png_image_finish_read(&image, nullptr, bgr.data(), 0, nullptr)) {
      png_image_free(&image);
      return false;
    }
    *h = (int)image.height;
    *w = (int)image.width;
    return true;
  }
  return false;
}

#endif  // FRT_WITH_CODECS

}  // namespace

extern "C" {

// ---------------------------------------------------------------- letterbox

// Bilinear resize (half-pixel centers, edge clamp — cv2.INTER_LINEAR
// geometry) of src (sh x sw x 3, BGR uint8) by `scale`, written into the
// top-left of dst (dsize x dsize x 3); the rest of dst is zeroed.
// Returns the scale actually used (min(dsize/w, dsize/h)).
float frt_letterbox(const uint8_t* src, int sh, int sw, uint8_t* dst,
                    int dsize) {
  float scale = std::min((float)dsize / sw, (float)dsize / sh);
  int nw = (int)(sw * scale);
  int nh = (int)(sh * scale);
  std::memset(dst, 0, (size_t)dsize * dsize * 3);
  if (nw <= 0 || nh <= 0) return 1.0f;

  // Precompute x-axis sample positions/weights once per row sweep.
  std::vector<int> x0(nw), x1(nw);
  std::vector<float> wx(nw);
  for (int j = 0; j < nw; ++j) {
    float sx = (j + 0.5f) * (float)sw / nw - 0.5f;
    float fx = std::floor(sx);
    wx[j] = sx - fx;
    int xi = (int)fx;
    x0[j] = std::min(std::max(xi, 0), sw - 1);
    x1[j] = std::min(std::max(xi + 1, 0), sw - 1);
  }
  for (int i = 0; i < nh; ++i) {
    float sy = (i + 0.5f) * (float)sh / nh - 0.5f;
    float fy = std::floor(sy);
    float wy = sy - fy;
    int yi = (int)fy;
    int y0 = std::min(std::max(yi, 0), sh - 1);
    int y1 = std::min(std::max(yi + 1, 0), sh - 1);
    const uint8_t* r0 = src + (size_t)y0 * sw * 3;
    const uint8_t* r1 = src + (size_t)y1 * sw * 3;
    uint8_t* out = dst + (size_t)i * dsize * 3;
    for (int j = 0; j < nw; ++j) {
      const uint8_t* p00 = r0 + x0[j] * 3;
      const uint8_t* p01 = r0 + x1[j] * 3;
      const uint8_t* p10 = r1 + x0[j] * 3;
      const uint8_t* p11 = r1 + x1[j] * 3;
      float w00 = (1 - wy) * (1 - wx[j]), w01 = (1 - wy) * wx[j];
      float w10 = wy * (1 - wx[j]), w11 = wy * wx[j];
      for (int c = 0; c < 3; ++c) {
        float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        out[j * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
  return scale;
}

// ---------------------------------------------------------------------- NMS

// Greedy NMS over (x1,y1,x2,y2) float boxes sorted internally by
// descending score. keep_out[i] = 1 if box i (ORIGINAL index) survives.
// int_rects=1 reproduces the reference's integer-truncated rect IoU
// (cv::Rect of ints, src/face_detector.cpp:260-265,340-354); 0 = float.
// Returns the number of surviving boxes.
int frt_nms(const float* boxes, const float* scores, int n, float iou_thr,
            int int_rects, int32_t* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });

  struct R {
    float x1, y1, x2, y2;
  };
  std::vector<R> r(n);
  for (int k = 0; k < n; ++k) {
    const float* b = boxes + (size_t)order[k] * 4;
    if (int_rects) {
      // reference: x=int(x1), y=int(y1), w=int(x2-x1), h=int(y2-y1)
      int x = (int)b[0], y = (int)b[1];
      int w = (int)(b[2] - b[0]), h = (int)(b[3] - b[1]);
      r[k] = {(float)x, (float)y, (float)(x + w), (float)(y + h)};
    } else {
      r[k] = {b[0], b[1], b[2], b[3]};
    }
  }

  std::vector<char> suppressed(n, 0);
  for (int i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      float ix1 = std::max(r[i].x1, r[j].x1);
      float iy1 = std::max(r[i].y1, r[j].y1);
      float ix2 = std::min(r[i].x2, r[j].x2);
      float iy2 = std::min(r[i].y2, r[j].y2);
      float iw = std::max(0.0f, ix2 - ix1);
      float ih = std::max(0.0f, iy2 - iy1);
      float inter = iw * ih;
      float a1 = (r[i].x2 - r[i].x1) * (r[i].y2 - r[i].y1);
      float a2 = (r[j].x2 - r[j].x1) * (r[j].y2 - r[j].y1);
      float denom = a1 + a2 - inter;
      float iou = denom > 0 ? inter / denom : 0.0f;
      if (iou > iou_thr) suppressed[j] = 1;
    }
  }
  int kept = 0;
  std::memset(keep_out, 0, sizeof(int32_t) * n);
  for (int k = 0; k < n; ++k) {
    if (!suppressed[k]) {
      keep_out[order[k]] = 1;
      ++kept;
    }
  }
  return kept;
}

// -------------------------------------------------------------- frame ring

struct FrtRing {
  std::vector<uint8_t> data;
  std::vector<float> scales;
  size_t frame_bytes;
  int capacity;
  int head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
};

void* frt_ring_create(int capacity, size_t frame_bytes) {
  auto* ring = new FrtRing();
  ring->capacity = capacity;
  ring->frame_bytes = frame_bytes;
  ring->data.resize((size_t)capacity * frame_bytes);
  ring->scales.resize(capacity);
  return ring;
}

void frt_ring_destroy(void* h) { delete (FrtRing*)h; }

void frt_ring_close(void* h) {
  auto* ring = (FrtRing*)h;
  {
    std::lock_guard<std::mutex> lk(ring->mu);
    ring->closed = true;
  }
  ring->cv_push.notify_all();
  ring->cv_pop.notify_all();
}

// Push one frame (blocks up to timeout_ms while full). Returns 0 on
// success, -1 on timeout, -2 if the ring is closed.
int frt_ring_push(void* h, const uint8_t* frame, float scale, int timeout_ms) {
  auto* ring = (FrtRing*)h;
  std::unique_lock<std::mutex> lk(ring->mu);
  bool ok = ring->cv_push.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return ring->count < ring->capacity || ring->closed; });
  if (ring->closed) return -2;
  if (!ok) return -1;
  std::memcpy(&ring->data[(size_t)ring->head * ring->frame_bytes], frame,
              ring->frame_bytes);
  ring->scales[ring->head] = scale;
  ring->head = (ring->head + 1) % ring->capacity;
  ring->count++;
  lk.unlock();
  ring->cv_pop.notify_one();
  return 0;
}

// Pop one frame (blocks up to timeout_ms while empty). Returns 0 on
// success, -1 on timeout, -2 if closed AND drained.
int frt_ring_pop(void* h, uint8_t* out, float* scale_out, int timeout_ms) {
  auto* ring = (FrtRing*)h;
  std::unique_lock<std::mutex> lk(ring->mu);
  bool ok = ring->cv_pop.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return ring->count > 0 || ring->closed; });
  if (ring->count == 0) return ring->closed ? -2 : -1;
  if (!ok) return -1;
  std::memcpy(out, &ring->data[(size_t)ring->tail * ring->frame_bytes],
              ring->frame_bytes);
  if (scale_out) *scale_out = ring->scales[ring->tail];
  ring->tail = (ring->tail + 1) % ring->capacity;
  ring->count--;
  lk.unlock();
  ring->cv_push.notify_one();
  return 0;
}

int frt_ring_size(void* h) {
  auto* ring = (FrtRing*)h;
  std::lock_guard<std::mutex> lk(ring->mu);
  return ring->count;
}

// ------------------------------------------------------------------- codecs

// 1 if this build links libjpeg/libpng, else 0 (callers fall back to
// cv2/PIL decode in Python).
int frt_codecs_available() {
#ifdef FRT_WITH_CODECS
  return 1;
#else
  return 0;
#endif
}

// Header-only probe of encoded JPEG/PNG bytes. 0 on success (h/w set),
// -1 on unrecognized/corrupt payload or codec-less build.
int frt_image_info(const uint8_t* data, size_t len, int* h, int* w) {
#ifdef FRT_WITH_CODECS
  return image_dims(data, len, h, w) ? 0 : -1;
#else
  (void)data, (void)len, (void)h, (void)w;
  return -1;
#endif
}

// Decode JPEG/PNG bytes into caller-allocated out (h*w*3 BGR uint8,
// dims from frt_image_info). 0 on success; -1 decode failure; -2 if the
// decoded dims do not match (h, w).
int frt_decode(const uint8_t* data, size_t len, uint8_t* out, int h, int w) {
#ifdef FRT_WITH_CODECS
  std::vector<uint8_t> bgr;
  int dh = 0, dw = 0;
  if (!decode_bgr(data, len, bgr, &dh, &dw)) return -1;
  if (dh != h || dw != w) return -2;
  std::memcpy(out, bgr.data(), bgr.size());
  return 0;
#else
  (void)data, (void)len, (void)out, (void)h, (void)w;
  return -1;
#endif
}

// Decode + letterbox in ONE native call (the serve/enroll hot path:
// encoded bytes → detector-ready (dsize,dsize,3) BGR uint8). Returns
// the letterbox scale, or <= 0 on decode failure.
float frt_decode_letterbox(const uint8_t* data, size_t len, uint8_t* dst,
                           int dsize) {
#ifdef FRT_WITH_CODECS
  std::vector<uint8_t> bgr;
  int h = 0, w = 0;
  if (!decode_bgr(data, len, bgr, &h, &w)) return -1.0f;
  return frt_letterbox(bgr.data(), h, w, dst, dsize);
#else
  (void)data, (void)len, (void)dst, (void)dsize;
  return -1.0f;
#endif
}

// ------------------------------------------------------------- file loader

// Multi-threaded path-list loader: workers read + decode + letterbox
// into a bounded queue; the consumer pops detector-ready frames in
// completion order (per-item index reported). The native analog of a
// framework input pipeline — the reference loads images one blocking
// cv::imread at a time (src/main.cpp:71-72).

struct FrtLoader {
  struct Item {
    std::vector<uint8_t> frame;
    float scale;
    int index;
    int ok;
  };
  std::vector<std::string> paths;
  int target;
  size_t capacity;
  std::atomic<int> next{0};
  std::deque<Item> q;
  int active_workers;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
};

static void frt_loader_worker(FrtLoader* L) {
  const size_t frame_bytes = (size_t)L->target * L->target * 3;
  for (;;) {
    int idx = L->next.fetch_add(1);
    if (idx >= (int)L->paths.size()) break;
    FrtLoader::Item item;
    item.index = idx;
    item.ok = 0;
    item.scale = 0.0f;
    item.frame.assign(frame_bytes, 0);
#ifdef FRT_WITH_CODECS
    std::ifstream f(L->paths[idx], std::ios::binary);
    if (f) {
      std::vector<uint8_t> bytes((std::istreambuf_iterator<char>(f)),
                                 std::istreambuf_iterator<char>());
      float scale =
          frt_decode_letterbox(bytes.data(), bytes.size(),
                               item.frame.data(), L->target);
      if (scale > 0) {
        item.ok = 1;
        item.scale = scale;
      }
    }
#endif
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [&] { return L->q.size() < L->capacity || L->closed; });
    if (L->closed) break;
    L->q.push_back(std::move(item));
    lk.unlock();
    L->cv_pop.notify_one();
  }
  std::lock_guard<std::mutex> lk(L->mu);
  if (--L->active_workers == 0) L->cv_pop.notify_all();
}

// Create a loader over n paths. nthreads decode workers, bounded queue
// of `capacity` frames. NULL if this build has no codecs.
void* frt_loader_create(const char* const* paths, int n, int target,
                        int nthreads, int capacity) {
#ifndef FRT_WITH_CODECS
  (void)paths, (void)n, (void)target, (void)nthreads, (void)capacity;
  return nullptr;
#else
  auto* L = new FrtLoader();
  L->paths.reserve(n);
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->target = target;
  L->capacity = capacity > 0 ? (size_t)capacity : 8;
  nthreads = std::max(1, nthreads);
  L->active_workers = nthreads;
  for (int t = 0; t < nthreads; ++t)
    L->workers.emplace_back(frt_loader_worker, L);
  return L;
#endif
}

// Pop the next decoded frame (completion order). out must hold
// target*target*3 bytes. Returns 0 on success, -1 timeout, -2 all
// items delivered, -3 this item failed to read/decode (index still
// reported; frame zeroed).
int frt_loader_next(void* h, uint8_t* out, float* scale_out, int* index_out,
                    int timeout_ms) {
  auto* L = (FrtLoader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return !L->q.empty() || L->active_workers == 0; });
  if (L->q.empty()) return L->active_workers == 0 ? -2 : -1;
  FrtLoader::Item item = std::move(L->q.front());
  L->q.pop_front();
  lk.unlock();
  L->cv_push.notify_one();
  std::memcpy(out, item.frame.data(), item.frame.size());
  if (scale_out) *scale_out = item.scale;
  if (index_out) *index_out = item.index;
  return item.ok ? 0 : -3;
}

// Stop workers (even mid-list) and free the loader.
void frt_loader_destroy(void* h) {
  auto* L = (FrtLoader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closed = true;
    L->next.store((int)L->paths.size());
  }
  L->cv_push.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"

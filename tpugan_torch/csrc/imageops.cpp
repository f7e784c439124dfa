// Host ops of the input pipeline: batch assembly from the decoded uint8
// dataset (gather rows by index, optional horizontal flip) in one pass over
// several threads, in place of numpy fancy indexing (one thread, an extra
// copy), and uint8 -> float32 normalization to [-1, 1].  Batches cross to
// the device as uint8 and are normalized there; the host normalization is
// for consumers that want it on the host.
//
// Plain C interface, loaded with ctypes; built with g++ at first use by
// tpugan_torch/ops/_build.py (load_host).  tpugan_torch/data/native.py
// wraps it and keeps its numpy twins.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_range(const uint8_t* src, const int64_t* idx,
                  const uint8_t* flip, uint8_t* dst, int64_t img_bytes,
                  int64_t h, int64_t w, int64_t c, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t* s = src + idx[i] * img_bytes;
    uint8_t* d = dst + i * img_bytes;
    if (flip != nullptr && flip[i]) {
      // horizontal flip: reverse pixel order within each row
      const int64_t row_bytes = w * c;
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* srow = s + y * row_bytes;
        uint8_t* drow = d + y * row_bytes;
        for (int64_t x = 0; x < w; ++x) {
          std::memcpy(drow + x * c, srow + (w - 1 - x) * c, c);
        }
      }
    } else {
      std::memcpy(d, s, img_bytes);
    }
  }
}

}  // namespace

extern "C" {

// Gather n images by index from src (N,h,w,c) uint8 into dst (n,h,w,c),
// flipping horizontally where flip[i] != 0 (flip may be null).
// Returns 0 on success.
int tpugan_batch_gather_u8(const uint8_t* src, const int64_t* idx,
                           const uint8_t* flip, uint8_t* dst, int64_t n,
                           int64_t h, int64_t w, int64_t c,
                           int64_t n_threads) {
  if (n <= 0) return 0;
  const int64_t img_bytes = h * w * c;
  if (n_threads <= 1 || n < 64) {
    gather_range(src, idx, flip, dst, img_bytes, h, w, c, 0, n);
    return 0;
  }
  const int64_t nt = n_threads < n ? n_threads : n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(gather_range, src, idx, flip, dst, img_bytes, h, w,
                         c, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// uint8 -> float32 in [-1, 1] (x/127.5 - 1), threaded. For consumers that
// want host-side normalization (the on-device path is preferred).
int tpugan_normalize_u8_f32(const uint8_t* src, float* dst, int64_t n,
                            int64_t n_threads) {
  if (n <= 0) return 0;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      // IEEE division for bit-parity with the numpy/device normalization
      dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
    }
  };
  if (n_threads <= 1 || n < (1 << 16)) {
    work(0, n);
    return 0;
  }
  const int64_t nt = n_threads;
  std::vector<std::thread> threads;
  const int64_t chunk = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

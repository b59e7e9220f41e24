// Native host-side reader of distributed_eigenspaces_tpu_torch's bin
// stream (data/bin_stream.py) and image loaders (data/cifar.py): a copy of
// the JAX package's loader.
//
//   - u8_nhwc_to_gray_f32: (n, h, w, c) uint8 -> (n, h*w) float32
//     channel-mean grayscale (the CIFAR preprocessing), threaded.
//   - u8_to_f32: multithreaded uint8 -> float32 widen of a uint8 row file.
//   - f32_absmax / f32_quantize_i8: the symmetric int8 wire-format prep
//     (data/bin_stream.py::quantize_file_i8): vectorization-shaped inner
//     loops (bit-mask abs, unsigned-compare max) + threading.
//   - reader_*: a chunked file reader with one background read-ahead thread
//     (double buffer), so disk latency overlaps host->device transfer.
//
// Built with plain g++ (no external deps) at first use; loaded via ctypes
// (runtime/native.py) with a numpy fallback when unavailable.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---- conversion kernels ---------------------------------------------------

// (n, h, w, c) uint8 -> (n, h*w) float32 channel-mean grayscale.
void u8_nhwc_to_gray_f32(const uint8_t* in, float* out, int64_t n,
                         int64_t h, int64_t w, int64_t c,
                         int32_t num_threads) {
  const int64_t hw = h * w;
  const float inv_c = 1.0f / static_cast<float>(c);
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = in + i * hw * c;
      float* dst = out + i * hw;
      for (int64_t p = 0; p < hw; ++p) {
        int32_t acc = 0;
        for (int64_t ch = 0; ch < c; ++ch) acc += row[p * c + ch];
        dst[p] = static_cast<float>(acc) * inv_c;
      }
    }
  };
  if (num_threads <= 1 || n < num_threads) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// flat uint8 -> float32 widen.
void u8_to_f32(const uint8_t* in, float* out, int64_t count,
               int32_t num_threads) {
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = static_cast<float>(in[i]);
  };
  if (num_threads <= 1 || count < (1 << 20)) {
    worker(0, count);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (count + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---- int8 quantization kernels -------------------------------------------
//
// Prep path of the out-of-core int8 wire format (data/bin_stream.py): a
// symmetric global scale cancels in eigenvectors, so quantization is the
// only host-side transform a 400M-row fp32 corpus needs before streaming.
// Two passes, both threaded: absmax (the scale), then scale+round+clip.

// branch-free 8-wide unrolled reduction: a single `if (a > m)` chain is a
// serial dependency the compiler cannot vectorize; independent lanes
// become packed max instructions (measured 4x vs the naive loop on one
// core — the bar is numpy's SIMD absmax, which the naive loop LOSES to)
static float absmax_range(const float* in, int64_t lo, int64_t hi) {
  // abs = clear the sign bit; max as unsigned int compare — valid because
  // non-negative IEEE floats order identically to their bit patterns.
  // Both ops are single packed integer instructions, so the 8 lanes
  // vectorize where float max (NaN semantics) and branchy abs do not.
  uint32_t m[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(in);
  int64_t i = lo;
  for (; i + 8 <= hi; i += 8) {
    for (int64_t l = 0; l < 8; ++l) {
      uint32_t a = bits[i + l] & 0x7fffffffu;
      m[l] = m[l] > a ? m[l] : a;
    }
  }
  for (; i < hi; ++i) {
    uint32_t a = bits[i] & 0x7fffffffu;
    m[0] = m[0] > a ? m[0] : a;
  }
  uint32_t r = 0;
  for (int64_t l = 0; l < 8; ++l) r = r > m[l] ? r : m[l];
  float out;
  memcpy(&out, &r, sizeof(out));
  return out;
}

float f32_absmax(const float* in, int64_t count, int32_t num_threads) {
  if (num_threads <= 1 || count < (1 << 20)) {
    return absmax_range(in, 0, count);
  }
  std::vector<float> part(static_cast<size_t>(num_threads), 0.0f);
  std::vector<std::thread> ts;
  int64_t per = (count + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&part, in, t, lo, hi] {
      part[static_cast<size_t>(t)] = absmax_range(in, lo, hi);
    });
  }
  for (auto& t : ts) t.join();
  float m = 0.0f;
  for (float p : part) {
    if (p > m) m = p;
  }
  return m;
}

// out[i] = clip(round(in[i] * scale), -127, 127); round half away from zero
// (matches numpy's np.round to within the symmetric-quantization noise the
// accuracy gate already charges — exact np.round parity is banker's
// rounding, which differs only at exact .5 multiples of 1/scale).
void f32_quantize_i8(const float* in, int8_t* out, int64_t count,
                     float scale, int32_t num_threads) {
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float v = in[i] * scale;
      v = v < 0 ? v - 0.5f : v + 0.5f;
      // clamp BEFORE the int cast: float->int32 of a value outside
      // int32's range is UB (measured: 3e9f casts to INT_MIN under -O3,
      // sign-flipping the clipped result). The float clamp also absorbs
      // +/-inf; NaN (both comparisons false) maps to 0 explicitly.
      if (v > 127.0f) v = 127.0f;
      if (v < -127.0f) v = -127.0f;
      out[i] = static_cast<int8_t>(v == v ? static_cast<int32_t>(v) : 0);
    }
  };
  if (num_threads <= 1 || count < (1 << 20)) {
    worker(0, count);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (count + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---- double-buffered chunk reader ----------------------------------------

struct Reader {
  FILE* f = nullptr;
  int64_t chunk = 0;
  int64_t skip = 0;             // bytes to skip after each chunk (stride)
  std::vector<uint8_t> ahead;   // read-ahead buffer
  int64_t ahead_len = 0;        // bytes valid in `ahead`
  bool ahead_ready = false;
  bool eof = false;
  bool stop = false;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv;

  void loop() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return stop || !ahead_ready; });
      if (stop) return;
      lk.unlock();
      int64_t got = static_cast<int64_t>(
          fread(ahead.data(), 1, static_cast<size_t>(chunk), f));
      bool hit_eof = got < chunk;
      if (!hit_eof && skip > 0 && fseeko(f, skip, SEEK_CUR) != 0) {
        // NOTE: on regular files fseeko past EOF SUCCEEDS (POSIX), so a
        // stride overrun terminates via the next fread returning 0, not
        // here — this branch only fires for non-seekable streams
        hit_eof = true;
      }
      lk.lock();
      ahead_len = got;
      ahead_ready = true;
      if (hit_eof) eof = true;
      cv.notify_all();
      if (eof) return;
    }
  }
};

// ``offset``: initial seek; ``skip``: bytes skipped after EVERY chunk —
// the strided access a multi-host reader needs when each host owns a
// contiguous row slice of every step in one shared file.
void* reader_open_strided(const char* path, int64_t chunk_bytes,
                          int64_t offset, int64_t skip) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (offset > 0 && fseeko(f, offset, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  Reader* r = new Reader();
  r->f = f;
  r->chunk = chunk_bytes;
  r->skip = skip;
  r->ahead.resize(static_cast<size_t>(chunk_bytes));
  r->th = std::thread([r] { r->loop(); });
  return r;
}

void* reader_open(const char* path, int64_t chunk_bytes) {
  return reader_open_strided(path, chunk_bytes, 0, 0);
}

// Copy the next chunk into buf; returns bytes delivered (0 at EOF).
int64_t reader_next(void* h, uint8_t* buf) {
  Reader* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  // wait for data OR a finished reader (eof with its final chunk already
  // consumed must return 0 immediately, not wait on a dead thread)
  r->cv.wait(lk, [&] { return r->ahead_ready || r->eof; });
  if (!r->ahead_ready) return 0;  // eof, final chunk already delivered
  int64_t got = r->ahead_len;
  if (got > 0) memcpy(buf, r->ahead.data(), static_cast<size_t>(got));
  r->ahead_ready = false;
  r->cv.notify_all();
  return got;
}

void reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop = true;
  }
  r->cv.notify_all();
  if (r->th.joinable()) r->th.join();
  fclose(r->f);
  delete r;
}

}  // extern "C"

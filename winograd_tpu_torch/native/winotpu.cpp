// winotpu: the host library of winograd_tpu_torch, built by g++ and loaded
// with ctypes (winograd_tpu_torch/utils/native.py).
//
// The port's own copy of winograd_tpu/native/winotpu.cpp, which rebuilds the
// reference's C host utilities (util.c): raw float32 blob IO (get_parameter,
// util.c:28-44), the host transpose (util.c:15-26), a microsecond wall clock
// (util.c:5-13) and the shift-aware output checker (util.c:46-63). As in the
// JAX package's copy, IO returns counts and never exits the process, and the
// checker returns its violation count and max error. A C ABI: no pybind11.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <ctime>
#include <thread>
#include <vector>

extern "C" {

// Microsecond wall clock (CLOCK_REALTIME, util.c:5-13).
uint64_t wt_time_us() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000ull + (uint64_t)ts.tv_nsec / 1000ull;
}

// Read up to n float32 values from a raw little-endian blob. Returns the
// number read, or -1 when the file cannot be opened.
long long wt_read_f32(const char* path, float* out, long long n) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long long got = (long long)std::fread(out, sizeof(float), (size_t)n, f);
  std::fclose(f);
  return got;
}

// Write n float32 values as a raw blob. Returns the number written, or -1.
long long wt_write_f32(const char* path, const float* data, long long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  long long put = (long long)std::fwrite(data, sizeof(float), (size_t)n, f);
  std::fclose(f);
  return put;
}

// out[j * h + i] = in[i * w + j] (util.c:15-26, into a caller's buffer).
void wt_transpose_f32(const float* in, float* out, long long h, long long w) {
  for (long long i = 0; i < h; ++i)
    for (long long j = 0; j < w; ++j)
      out[j * h + i] = in[i * w + j];
}

// Shift-aware elementwise check (util.c:46-63). a is (side_a, side_a,
// channels) with its valid region at +shift in both spatial dims; b is
// dense (len, len, channels). Counts the elements whose difference is not
// within tol and writes the max abs difference. A NaN difference counts as
// a violation and makes max_error NaN. Returns the violation count.
long long wt_output_checker(const float* a, const float* b, long long len,
                            long long channels, long long shift,
                            long long side_a, double tol, double* max_error) {
  long long count = 0;
  double max_err = 0.0;
  bool saw_nan = false;
  for (long long x = 0; x < len; ++x) {
    for (long long y = 0; y < len; ++y) {
      for (long long c = 0; c < channels; ++c) {
        double va = a[((x + shift) * side_a + (y + shift)) * channels + c];
        double vb = b[(x * len + y) * channels + c];
        double diff = std::fabs(va - vb);
        if (std::isnan(diff)) { saw_nan = true; ++count; continue; }
        if (diff > max_err) max_err = diff;
        if (!(diff <= tol)) ++count;
      }
    }
  }
  if (max_error) *max_error = saw_nan ? std::nan("") : max_err;
  return count;
}

// Read n blobs on up to `threads` threads: outs[i] holds counts[i] floats.
// Returns the number of files read whole.
long long wt_read_many_f32(const char** paths, float** outs,
                           const long long* counts, long long n,
                           long long threads) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::atomic<long long> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      long long i = next.fetch_add(1);
      if (i >= n) return;
      if (wt_read_f32(paths[i], outs[i], counts[i]) == counts[i]) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve((size_t)threads);
  for (long long t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // extern "C"

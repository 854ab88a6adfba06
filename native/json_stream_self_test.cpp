// Sanitizer self-test of the streaming JSON writer (fmcw_json_stream.cpp).
//
// Built by tests/test_native_json_stream_sanitize.py with small chunks
// (-DFMCW_JSON_STREAM_CHUNK=...) so that a few thousand values span many
// blocks, under AddressSanitizer + UBSan and under ThreadSanitizer, and
// run as a standalone binary. It streams float32 and float64 arrays that
// hold NaN, +-Inf, -0.0, subnormals and values printed in exponent form,
// 1-D and 2-D, pretty and compact, on 1 to 7 threads, into a temporary
// file and through a pipe read by another thread, and holds every output
// to fmcw_json_f64_array's text of the same values widened to double. A
// pipe whose reader is gone must give -1 on every thread count.
//
// Exit code 0 = all checks passed.

#include "fmcw_json_stream.cpp"

#include <csignal>
#include <cstdio>
#include <limits>
#include <string>
#include <thread>
#include <vector>

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);     \
      return 1;                                                           \
    }                                                                     \
  } while (0)

namespace {

std::vector<double> values(int64_t n) {
  const double specials[] = {
      std::numeric_limits<double>::quiet_NaN(),
      std::numeric_limits<double>::infinity(),
      -std::numeric_limits<double>::infinity(),
      -0.0, 0.0, 5e-324, 1.0e-45, 1e-05, 1e+20, 206.0, -1.5e-7, 123456789.0,
      0.1, 1e16, 9999999999999998.0, -3.4028234663852886e+38};
  std::vector<double> v(static_cast<size_t>(n));
  uint64_t x = 88172645463325252ull;
  for (int64_t i = 0; i < n; ++i) {
    x ^= x << 13; x ^= x >> 7; x ^= x << 17;
    v[size_t(i)] = i % 5 == 0 ? specials[(i / 5) % 16]
                              : (double(x % 2000001) - 1e6) / 977.0;
  }
  return v;
}

// fmcw_json_f64_array's text of the values widened to double.
template <typename T>
std::string reference(const std::vector<T>& a, int64_t rows, int64_t cols,
                      int pretty) {
  std::vector<double> d(a.begin(), a.end());
  std::vector<char> buf(d.size() * 64 + 4096);
  int64_t n = fmcw_json_f64_array(d.data(), rows, cols, pretty, 1, buf.data(),
                                  int64_t(buf.size()));
  return n < 0 ? std::string("overflow") : std::string(buf.data(), size_t(n));
}

template <typename T>
std::string via_file(const std::vector<T>& a, int64_t rows, int64_t cols,
                     int pretty, int threads, int64_t* ret) {
  FILE* f = tmpfile();
  if (!f) return "no tmpfile";
  *ret = fmcw_json_stream(a.data(), int(sizeof(T)), rows, cols, pretty, 1,
                          fileno(f), threads);
  std::string out;
  rewind(f);
  char buf[4096];
  size_t k;
  while ((k = fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, k);
  fclose(f);
  return out;
}

template <typename T>
std::string via_pipe(const std::vector<T>& a, int64_t rows, int64_t cols,
                     int pretty, int threads, int64_t* ret) {
  int p[2];
  if (pipe(p) != 0) return "no pipe";
  std::string out;
  std::thread reader([&] {
    char buf[1000];
    ssize_t k;
    while ((k = read(p[0], buf, sizeof(buf))) > 0) out.append(buf, size_t(k));
  });
  *ret = fmcw_json_stream(a.data(), int(sizeof(T)), rows, cols, pretty, 1,
                          p[1], threads);
  close(p[1]);
  reader.join();
  close(p[0]);
  return out;
}

template <typename T>
int check_shape(int64_t rows, int64_t cols) {
  const int64_t n = cols == 0 ? rows : rows * cols;
  std::vector<double> d = values(n);
  std::vector<T> a(d.begin(), d.end());
  for (int pretty = 0; pretty < 2; ++pretty) {
    const std::string want = reference(a, rows, cols, pretty);
    CHECK(want != "overflow");
    for (int threads : {1, 2, 3, 7}) {
      int64_t ret = 0;
      CHECK(via_file(a, rows, cols, pretty, threads, &ret) == want);
      CHECK(ret == int64_t(want.size()));
      CHECK(via_pipe(a, rows, cols, pretty, threads, &ret) == want);
      CHECK(ret == int64_t(want.size()));
    }
  }
  return 0;
}

int check_broken_pipe() {
  std::vector<float> a(4000, 1.25f);
  for (int threads : {1, 2, 5}) {
    int p[2];
    CHECK(pipe(p) == 0);
    close(p[0]);  // no reader: write(2) fails with EPIPE
    CHECK(fmcw_json_stream(a.data(), 4, 40, 100, 1, 1, p[1], threads) == -1);
    close(p[1]);
  }
  return 0;
}

int check_arguments() {
  double a[4] = {1, 2, 3, 4};
  CHECK(fmcw_json_stream(a, 2, 4, 0, 1, 1, 1, 1) == -1);   // itemsize
  CHECK(fmcw_json_stream(a, 8, -1, 0, 1, 1, 1, 1) == -1);  // rows
  CHECK(fmcw_json_stream(a, 8, 2, -2, 1, 1, 1, 1) == -1);  // cols
  CHECK(fmcw_json_stream(a, 8, 4, 0, 1, -1, 1, 1) == -1);  // level
  return 0;
}

}  // namespace

int main() {
  signal(SIGPIPE, SIG_IGN);
  const int64_t shapes[][2] = {{0, 0}, {1, 0},  {7, 0},   {2500, 0},
                               {0, 5}, {1, 1},  {1, 900}, {900, 1},
                               {3, 7}, {37, 61}, {61, 37}};
  for (const auto& s : shapes) {
    if (check_shape<float>(s[0], s[1]) || check_shape<double>(s[0], s[1])) {
      fprintf(stderr, "shape %lld x %lld\n", (long long)s[0], (long long)s[1]);
      return 1;
    }
  }
  if (check_broken_pipe() || check_arguments()) return 1;
  printf("all checks passed\n");
  return 0;
}

// Streaming JSON writer for large float arrays: the text of
// fmcw_json_f64_array (fmcw_json.cpp, included below and used unchanged),
// written to a file descriptor in bounded chunks instead of one buffer the
// size of the output.
//
//   * float32 or float64 input, each value widened to double as it is read
//     (no float64 copy of the array);
//   * the array's text is cut into blocks of whole values; each block is
//     formatted into a chunk buffer of a fixed size (FMCW_JSON_STREAM_CHUNK
//     bytes, however large the array) and written with write(2);
//   * with more than one thread, workers format blocks into a ring of
//     workers + 2 chunk buffers and the calling thread writes them to the
//     descriptor in block order, so the bytes do not depend on the thread
//     count.
//
// C ABI for ctypes, like fmcw_json.cpp.

#include "fmcw_json.cpp"

#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#ifndef FMCW_JSON_STREAM_CHUNK
#define FMCW_JSON_STREAM_CHUNK (4 << 20)
#endif

namespace {

// Values [begin, end) of the flat array, each with what precedes it (the
// separator, the newline and indent, a row's '['), a row's ']' after its
// last value, and the outer brackets at the array's first and last value:
// fmcw_json_f64_array's layout, cut anywhere between two values.
template <typename T>
void format_block(Writer& w, const T* a, int64_t n, int64_t cols, int pretty,
                  int level, int64_t begin, int64_t end) {
  if (begin == 0) w.putc_('[');
  if (cols == 0) {
    for (int64_t i = begin; i < end; ++i) {
      if (i) w.putc_(',');
      if (pretty) { w.putc_('\n'); w.indent(level + 1); }
      else if (i) w.putc_(' ');
      w.value(double(a[i]));
    }
  } else {
    int64_t r = begin / cols, c = begin % cols;
    for (int64_t i = begin; i < end; ++i) {
      if (c == 0) {
        if (r) w.putc_(',');
        if (pretty) { w.putc_('\n'); w.indent(level + 1); }
        else if (r) w.putc_(' ');
        w.putc_('[');
      } else {
        w.putc_(',');
      }
      if (pretty) { w.putc_('\n'); w.indent(level + 2); }
      else if (c) w.putc_(' ');
      w.value(double(a[i]));
      if (++c == cols) {
        if (pretty) { w.putc_('\n'); w.indent(level + 1); }
        w.putc_(']');
        c = 0;
        ++r;
      }
    }
  }
  if (end == n) {
    if (pretty) { w.putc_('\n'); w.indent(level); }
    w.putc_(']');
  }
}

bool write_all(int fd, const char* p, int64_t len) {
  while (len > 0) {
    ssize_t k = ::write(fd, p, size_t(std::min<int64_t>(len, 1 << 30)));
    if (k < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += k;
    len -= k;
  }
  return true;
}

template <typename T>
struct Stream {
  const T* a;
  int64_t n, cols;
  int pretty, level;
  int64_t block;     // values a block
  int64_t nblocks;
  int64_t cap;       // bytes a chunk buffer: the most a block can take

  // Block b into buf; its length, or -1 where it did not fit.
  int64_t format(int64_t b, char* buf) const {
    Writer w{buf, cap};
    int64_t begin = b * block;
    format_block(w, a, n, cols, pretty, level, begin,
                 std::min(n, begin + block));
    return w.overflow ? -1 : w.pos;
  }

  int64_t run_serial(int fd) const {
    std::vector<char> buf(static_cast<size_t>(cap));
    int64_t total = 0;
    for (int64_t b = 0; b < nblocks; ++b) {
      int64_t len = format(b, buf.data());
      if (len < 0 || !write_all(fd, buf.data(), len)) return -1;
      total += len;
    }
    return total;
  }

  int64_t run_threaded(int fd, int workers) const {
    const int64_t nslots = int64_t(workers) + 2;
    const size_t ns = static_cast<size_t>(nslots);
    std::vector<std::vector<char>> slots(
        ns, std::vector<char>(static_cast<size_t>(cap)));
    std::vector<int64_t> ready(ns, -1);  // the block a slot holds, or -1
    std::vector<int64_t> length(ns, 0);
    std::mutex m;
    std::condition_variable filled, freed;
    int64_t next = 0;     // next block to claim
    int64_t written = 0;  // blocks written to fd, in order
    bool failed = false;

    auto fail = [&] {
      { std::lock_guard<std::mutex> lk(m); failed = true; }
      filled.notify_all();
      freed.notify_all();
    };
    // Blocks are claimed in order; block b waits for its slot (b % nslots)
    // until block b - nslots is written, so the block the writer waits
    // for is always claimed and has its slot.
    auto work = [&] {
      for (;;) {
        int64_t b;
        {
          std::unique_lock<std::mutex> lk(m);
          if (failed || next >= nblocks) return;
          b = next++;
          freed.wait(lk, [&] { return failed || b < written + nslots; });
          if (failed) return;
        }
        size_t s = size_t(b % nslots);
        int64_t len = format(b, slots[s].data());
        if (len < 0) { fail(); return; }
        {
          std::lock_guard<std::mutex> lk(m);
          ready[s] = b;
          length[s] = len;
        }
        filled.notify_all();
      }
    };

    std::vector<std::thread> pool;
    try {
      pool.reserve(static_cast<size_t>(workers));
      for (int i = 0; i < workers; ++i) pool.emplace_back(work);
    } catch (...) {
      fail();
    }
    int64_t total = 0;
    for (int64_t b = 0; b < nblocks; ++b) {
      size_t s = size_t(b % nslots);
      int64_t len;
      {
        std::unique_lock<std::mutex> lk(m);
        filled.wait(lk, [&] { return failed || ready[s] == b; });
        if (failed) break;
        len = length[s];
      }
      if (!write_all(fd, slots[s].data(), len)) { fail(); break; }
      total += len;
      {
        std::lock_guard<std::mutex> lk(m);
        ready[s] = -1;
        written = b + 1;
      }
      freed.notify_all();
    }
    for (auto& t : pool) t.join();
    return failed ? -1 : total;
  }
};

template <typename T>
int64_t stream_array(const T* a, int64_t rows, int64_t cols, int pretty,
                     int level, int fd, int threads) {
  const int64_t n = cols == 0 ? rows : rows * cols;
  if (n == 0) return write_all(fd, "[]", 2) ? 2 : -1;
  // The most one value can take: its separator, newline and indent, the
  // value (at most 24 characters), and a row's opening and closing.
  const int64_t pad = pretty ? 2 * (int64_t(level) + 2) + 3 : 3;
  const int64_t per = 3 * pad + 32;
  const int64_t block = std::max<int64_t>(1, FMCW_JSON_STREAM_CHUNK / per);
  Stream<T> s{a, n, cols, pretty, level, block, (n + block - 1) / block,
              block * per + 2 * int64_t(level) + 16};
  const int workers = int(std::min<int64_t>(threads, s.nblocks));
  return workers <= 1 ? s.run_serial(fd) : s.run_threaded(fd, workers);
}

}  // namespace

extern "C" {

// Write a float32 (itemsize 4) or float64 (itemsize 8) C-contiguous array
// to fd as fmcw_json_f64_array renders it.
//   rows, cols, pretty, level : as fmcw_json_f64_array (cols 0 => 1-D)
//   threads : formatting workers at most (<= 1: the calling thread alone)
// Returns the bytes written, or -1 (bad arguments, a failed write or
// allocation); after -1 the descriptor may hold part of the text.
int64_t fmcw_json_stream(const void* a, int itemsize, int64_t rows,
                         int64_t cols, int pretty, int level, int fd,
                         int threads) {
  if (rows < 0 || cols < 0 || level < 0 || level > 1024 ||
      (itemsize != 4 && itemsize != 8))
    return -1;
  try {
    return itemsize == 4
        ? stream_array(static_cast<const float*>(a), rows, cols, pretty,
                       level, fd, threads)
        : stream_array(static_cast<const double*>(a), rows, cols, pretty,
                       level, fd, threads);
  } catch (...) {  // std::bad_alloc, std::system_error
    return -1;
  }
}

}  // extern "C"

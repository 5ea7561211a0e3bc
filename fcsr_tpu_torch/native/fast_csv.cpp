// Fast float32 CSV parser for vectorized-connectome tables.
//
// The port's own copy of fcsr_tpu/native/fast_csv.cpp. It parses the
// numeric body of a CSV directly into a caller-provided float32 buffer,
// multi-threaded over rows, with NaN/empty -> 0 (the dataset's NaN rule).
//
// Plain C ABI for ctypes:
//   fcsr_csv_dims(path, skip_first_col, *rows, *cols) -> 0 on success
//   fcsr_csv_read(path, skip_first_col, out, rows, cols) -> 0 on success
//
// Built by native/csv_reader.py at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread fast_csv.cpp -o libfcsr_csv.so

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read the whole file into memory.
bool slurp(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f)
                    : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

// Count commas outside of quotes in [begin, end).
int count_fields(const char* begin, const char* end) {
  int n = 1;
  for (const char* p = begin; p < end; ++p) {
    if (*p == ',') ++n;
  }
  return n;
}

// Parse one line of floats into out[0..cols); returns parsed count.
// Empty/NaN/non-numeric fields become 0.0f.
int parse_line(const char* begin, const char* end, bool skip_first,
               float* out, int cols) {
  const char* p = begin;
  int field = 0;
  int written = 0;
  while (p <= end && written < cols) {
    const char* q = p;
    while (q < end && *q != ',') ++q;
    if (!(skip_first && field == 0)) {
      // Parse the field BOUNDED to [p, q): strtod on the raw pointer
      // would skip '\n' as whitespace and, for a trailing empty field,
      // silently pull the NEXT row's first value into this row.
      double v = 0.0;
      size_t len = static_cast<size_t>(q - p);
      if (len > 0) {
        char tmp[64];
        if (len >= sizeof(tmp)) len = sizeof(tmp) - 1;
        std::memcpy(tmp, p, len);
        tmp[len] = '\0';
        char* endp = nullptr;
        v = std::strtod(tmp, &endp);
        if (endp == tmp || std::isnan(v)) v = 0.0;
      }
      out[written++] = static_cast<float>(v);
    }
    ++field;
    p = q + 1;
    if (q == end) break;
  }
  while (written < cols) out[written++] = 0.0f;
  return written;
}

struct LineIndex {
  std::vector<const char*> starts;
  std::vector<const char*> ends;
};

LineIndex index_lines(const std::string& buf) {
  LineIndex idx;
  const char* p = buf.data();
  const char* eof = buf.data() + buf.size();
  while (p < eof) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(eof - p)));
    const char* end = nl ? nl : eof;
    const char* trimmed = end;
    if (trimmed > p && trimmed[-1] == '\r') --trimmed;
    if (trimmed > p) {  // skip blank lines
      idx.starts.push_back(p);
      idx.ends.push_back(trimmed);
    }
    p = nl ? nl + 1 : eof;
  }
  return idx;
}

}  // namespace

extern "C" {

int fcsr_csv_dims(const char* path, int skip_first_col, int64_t* rows,
                  int64_t* cols) {
  std::string buf;
  if (!slurp(path, &buf)) return 1;
  LineIndex idx = index_lines(buf);
  if (idx.starts.size() < 2) return 2;  // header + at least one row
  int fields = count_fields(idx.starts[1], idx.ends[1]);
  *rows = static_cast<int64_t>(idx.starts.size()) - 1;  // minus header
  *cols = fields - (skip_first_col ? 1 : 0);
  return 0;
}

int fcsr_csv_read(const char* path, int skip_first_col, float* out,
                  int64_t rows, int64_t cols) {
  std::string buf;
  if (!slurp(path, &buf)) return 1;
  LineIndex idx = index_lines(buf);
  if (static_cast<int64_t>(idx.starts.size()) - 1 < rows) return 2;

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (static_cast<int64_t>(n_threads) > rows) {
    n_threads = static_cast<unsigned>(rows);
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  for (unsigned t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      for (;;) {
        int64_t r = next.fetch_add(1);
        if (r >= rows) break;
        parse_line(idx.starts[r + 1], idx.ends[r + 1],
                   skip_first_col != 0, out + r * cols,
                   static_cast<int>(cols));
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

}  // extern "C"

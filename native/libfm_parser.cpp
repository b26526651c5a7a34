// Fast libFM-format parser: the host-side data-loading hot path.
//
// The reference's only native code is transitively linked BLAS (SURVEY §2:
// breeze-natives); its ingestion is JVM string splitting per line
// (FMUtils.scala:24-37). Feeding an accelerator demands host-side parse rates
// far beyond a Python (or JVM-string) loop, so this parser:
//
//   * reads the whole file once, splits it into per-thread chunks at line
//     boundaries, and parses each chunk with hand-rolled int/float scanning
//     (no locale, no allocations in the inner loop);
//   * is two-phase: `lf_scan` sizes the output (rows, max nnz, max index),
//     then `lf_fill` writes labels/ids/vals straight into caller-provided
//     padded-CSR numpy buffers — zero copies on the Python side.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Semantics match sparkfm_tpu/data/libfm.py::_parse_lines_python: skip
// blank lines and '#' comments; 0-based indices; "label i:v i:v ...".

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

struct ChunkStat {
  int64_t rows = 0;
  int64_t max_nnz = 0;
  int64_t max_idx = -1;
};

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse a non-negative integer; returns -1 if no digits. Advances p.
inline int64_t parse_uint(const char*& p, const char* end) {
  int64_t v = -1;
  while (p < end && *p >= '0' && *p <= '9') {
    v = (v < 0 ? 0 : v) * 10 + (*p - '0');
    ++p;
  }
  return v;
}

// Fast float parse: [-+]?digits[.digits][eE[-+]digits]. Falls back to
// strtof semantics closely enough for data files. Advances p.
inline float parse_float(const char*& p, const char* end) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  double v = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p - '0'); ++p; any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale; scale *= 0.1; ++p; any = true;
    }
  }
  if (!any) { p = start; return 0.0f; }
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* ep = p + 1;
    bool eneg = false;
    if (ep < end && (*ep == '-' || *ep == '+')) { eneg = (*ep == '-'); ++ep; }
    int64_t ex = parse_uint(ep, end);
    if (ex >= 0) {
      p = ep;
      double f = 1.0;
      for (int64_t i = 0; i < ex; ++i) f *= 10.0;
      v = eneg ? v / f : v * f;
    }
  }
  return static_cast<float>(neg ? -v : v);
}

// Advance past the current line (to one past '\n' or to end).
inline const char* next_line(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
  return nl ? nl + 1 : end;
}

// True if the line is blank or a '#' comment.
inline bool skip_line(const char* p, const char* end) {
  while (p < end && is_space(*p)) ++p;
  return p >= end || *p == '\n' || *p == '#';
}

// Chunk boundaries aligned to line starts.
std::vector<const char*> chunk_starts(const char* buf, int64_t len,
                                      int nthreads) {
  std::vector<const char*> starts(nthreads + 1);
  const char* end = buf + len;
  starts[0] = buf;
  starts[nthreads] = end;
  for (int t = 1; t < nthreads; ++t) {
    const char* p = buf + (len * t) / nthreads;
    if (p >= end) { starts[t] = end; continue; }
    starts[t] = next_line(p, end);
  }
  // enforce monotonicity
  for (int t = 1; t <= nthreads; ++t)
    if (starts[t] < starts[t - 1]) starts[t] = starts[t - 1];
  return starts;
}

void scan_chunk(const char* p, const char* end, ChunkStat* st) {
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    if (!skip_line(p, line_end)) {
      st->rows++;
      // count ':' tokens for nnz, find max index
      const char* q = p;
      while (q < line_end && is_space(*q)) ++q;
      // skip the label token
      while (q < line_end && !is_space(*q)) ++q;
      int64_t nnz = 0;
      while (q < line_end) {
        while (q < line_end && is_space(*q)) ++q;
        if (q >= line_end) break;
        int64_t idx = parse_uint(q, line_end);
        if (q < line_end && *q == ':') {
          ++q;
          parse_float(q, line_end);
          if (idx >= 0) {
            nnz++;
            st->max_idx = std::max(st->max_idx, idx);
          }
        } else {
          while (q < line_end && !is_space(*q)) ++q;  // malformed token
        }
      }
      st->max_nnz = std::max(st->max_nnz, nnz);
    }
    p = line_end < end ? line_end + 1 : end;
  }
}

void fill_chunk(const char* p, const char* end, int64_t row0,
                int64_t max_nnz, float* y, int32_t* ids, float* vals) {
  int64_t r = row0;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    if (!skip_line(p, line_end)) {
      const char* q = p;
      while (q < line_end && is_space(*q)) ++q;
      y[r] = parse_float(q, line_end);
      int64_t k = 0;
      int32_t* row_ids = ids + r * max_nnz;
      float* row_vals = vals + r * max_nnz;
      while (q < line_end) {
        while (q < line_end && is_space(*q)) ++q;
        if (q >= line_end) break;
        int64_t idx = parse_uint(q, line_end);
        if (q < line_end && *q == ':') {
          ++q;
          float v = parse_float(q, line_end);
          if (idx >= 0 && k < max_nnz) {
            row_ids[k] = static_cast<int32_t>(idx);
            row_vals[k] = v;
            ++k;
          }
        } else {
          while (q < line_end && !is_space(*q)) ++q;
        }
      }
      ++r;
    }
    p = line_end < end ? line_end + 1 : end;
  }
}

int pick_threads(int64_t len) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int by_size = static_cast<int>(len / (1 << 20)) + 1;  // >=1MB per thread
  return std::max(1, std::min({hw, 16, by_size}));
}

}  // namespace

extern "C" {

// Phase 1: sizes. Returns 0 on success.
int lf_scan(const char* buf, int64_t len, int64_t* out_rows,
            int64_t* out_max_nnz, int64_t* out_max_idx) {
  int nt = pick_threads(len);
  auto starts = chunk_starts(buf, len, nt);
  std::vector<ChunkStat> stats(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(scan_chunk, starts[t], starts[t + 1], &stats[t]);
  for (auto& th : threads) th.join();
  int64_t rows = 0, mnnz = 0, midx = -1;
  for (auto& s : stats) {
    rows += s.rows;
    mnnz = std::max(mnnz, s.max_nnz);
    midx = std::max(midx, s.max_idx);
  }
  *out_rows = rows;
  *out_max_nnz = mnnz;
  *out_max_idx = midx;
  return 0;
}

// Phase 2: fill caller-allocated arrays. y: (rows,), ids/vals:
// (rows, max_nnz), all zero-initialized by the caller. Returns rows filled.
int64_t lf_fill(const char* buf, int64_t len, int64_t max_nnz, float* y,
                int32_t* ids, float* vals) {
  int nt = pick_threads(len);
  auto starts = chunk_starts(buf, len, nt);
  // per-chunk row offsets from a quick serial count
  std::vector<int64_t> row0(nt + 1, 0);
  {
    std::vector<ChunkStat> stats(nt);
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back(scan_chunk, starts[t], starts[t + 1], &stats[t]);
    for (auto& th : threads) th.join();
    for (int t = 0; t < nt; ++t) row0[t + 1] = row0[t] + stats[t].rows;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(fill_chunk, starts[t], starts[t + 1], row0[t],
                         max_nnz, y, ids, vals);
  for (auto& th : threads) th.join();
  return row0[nt];
}

}  // extern "C"

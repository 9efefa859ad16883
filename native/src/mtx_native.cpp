// Native MTX coordinate-body parser for linkpred_tpu.
//
// Equivalent of the reference's blocked strtoull/strtod body parse
// (/root/reference/inc/mtx.hxx:152-193): the reference streams 131072-line blocks
// through an OpenMP loop; here one tight single pass over an mmapped buffer feeds
// preallocated int64/double columns handed in by NumPy via ctypes (the downstream
// CSR build is vectorized NumPy — parsing text is the only genuinely serial work).
//
// C ABI only — loaded with ctypes, no pybind11 dependency.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

// Separator between fields of ONE record: spaces/tabs only.  A newline here
// means the record is truncated — the caller must stop rather than silently
// consuming the next line's first field (which would shift every subsequent
// edge by one field).
inline const char *skip_field_sep(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
    ++p;
  return p;
}

inline const char *skip_line(const char *p, const char *end) {
  while (p < end && *p != '\n')
    ++p;
  return p < end ? p + 1 : end;
}

inline const char *parse_i64(const char *p, const char *end, int64_t *out) {
  int64_t v = 0;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = neg ? -v : v;
  return p;
}

} // namespace

extern "C" {

// Number of whitespace-separated fields on the first non-comment, non-empty line.
int lp_mtx_detect_cols(const char *buf, int64_t len) {
  const char *p = buf;
  const char *end = buf + len;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end)
      return 0;
    if (*p == '%') {
      p = skip_line(p, end);
      continue;
    }
    int cols = 0;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
        ++p;
      if (p >= end || *p == '\n')
        break;
      ++cols;
      while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
        ++p;
    }
    return cols;
  }
  return 0;
}

// Parse up to max_rows coordinate lines of ncols fields into src/dst(/wts).
// Comment lines (%) are skipped; short/garbage tail lines stop the parse.
// Returns the number of rows written.
int64_t lp_mtx_parse(const char *buf, int64_t len, int64_t max_rows, int ncols,
                     int64_t *src, int64_t *dst, double *wts) {
  const char *p = buf;
  const char *end = buf + len;
  int64_t rows = 0;
  while (rows < max_rows) {
    p = skip_ws(p, end);
    if (p >= end)
      break;
    if (*p == '%') {
      p = skip_line(p, end);
      continue;
    }
    int64_t a, b;
    const char *q = parse_i64(p, end, &a);
    if (q == p)
      break;
    p = skip_field_sep(q, end);
    q = parse_i64(p, end, &b);
    if (q == p)
      break;  // truncated record (newline or garbage before the 2nd field)
    p = q;
    src[rows] = a;
    dst[rows] = b;
    if (ncols >= 3) {
      p = skip_field_sep(p, end);
      // strtod needs NUL termination; the mmapped buffer has none, so copy the
      // bounded token instead of trusting bytes past `len`.
      char tok[64];
      int64_t tl = 0;
      const char *t = p;
      while (t < end && *t != ' ' && *t != '\t' && *t != '\r' && *t != '\n' &&
             tl < 63)
        tok[tl++] = *t++;
      tok[tl] = '\0';
      char *after = nullptr;
      double w = strtod(tok, &after);
      if (after == tok)
        break;  // truncated record (no weight field)
      if (wts)
        wts[rows] = w;
      p += (after - tok);
      // ignore any 4th+ columns on the line
      while (p < end && *p != '\n')
        ++p;
    }
    ++rows;
  }
  return rows;
}

} // extern "C"

// Fast MatrixMarket parser (native counterpart of cgx_torch/io/mmio.py;
// the port's own copy of cgx/_native/mmio.cc, built into build/cgx_torch/).
//
// The reference vendors NIST's ANSI-C mmio library (mmio.c/mmio.h) and
// parses triplets with per-line fscanf (matrix_coo.cc:44-55).
// This implementation reads the whole file once and scans it with
// strtol/strtod; the Python wrapper in
// cgx_torch/io/native.py exposes it via ctypes with a NumPy fallback.
//
// C ABI:
//   cgx_mm_read(path, &out) -> 0 on success, negative error code
//   cgx_mm_free(&out)       -> release malloc'd buffers
//
// Supported (parity with the Python reader): object=matrix,
// format=coordinate|array, field=real|integer|pattern,
// symmetry=general|symmetric|skew-symmetric. Indices are converted
// 1-based -> 0-based (matrix_coo.cc:48-50 parity). For symmetric files
// only the stored triangle is returned (mirroring is the container's
// job, matrix.cc:12-21).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

typedef struct {
  int32_t m;
  int32_t n;
  int64_t nnz;        // stored entries (coordinate) or m*n (array)
  int32_t* rows;      // coordinate only (0-based)
  int32_t* cols;      // coordinate only (0-based)
  double* values;     // entry values (coordinate) or column-major (array)
  int32_t is_sparse;  // 1 = coordinate, 0 = array
  int32_t is_symmetric;
  int32_t is_skew;
  int32_t is_pattern;
  char error[256];
} CgxMMData;

enum {
  CGX_MM_OK = 0,
  CGX_MM_EIO = -1,
  CGX_MM_EBANNER = -2,
  CGX_MM_EFORMAT = -3,
  CGX_MM_ESIZE = -4,
  CGX_MM_EENTRY = -5,
  CGX_MM_EBOUNDS = -6,
};

void cgx_mm_free(CgxMMData* out);

static int fail(CgxMMData* out, int code, const char* msg) {
  std::snprintf(out->error, sizeof(out->error), "%s", msg);
  return code;
}

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

static const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

int cgx_mm_read(const char* path, CgxMMData* out) {
  std::memset(out, 0, sizeof(*out));

  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(out, CGX_MM_EIO, "cannot open file");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 0) {
    std::fclose(f);
    return fail(out, CGX_MM_EIO, "cannot stat file");
  }
  std::vector<char> buf(static_cast<size_t>(fsize) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(fsize), f);
  std::fclose(f);
  buf[got] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + got;

  // ---- banner (mm_read_banner parity: 5 tokens, exact prefix) ----
  char object[64], format[64], field[64], symmetry[64], prefix[64];
  {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string banner(p, line_end);
    if (std::sscanf(banner.c_str(), "%63s %63s %63s %63s %63s", prefix, object,
                    format, field, symmetry) != 5 ||
        std::strcmp(prefix, "%%MatrixMarket") != 0)
      return fail(out, CGX_MM_EBANNER, "not a MatrixMarket banner");
    for (char* s : {object, format, field, symmetry})
      for (char* c = s; *c; ++c) *c = (char)std::tolower((unsigned char)*c);
    p = line_end < end ? line_end + 1 : end;
  }
  if (std::strcmp(object, "matrix") != 0)
    return fail(out, CGX_MM_EFORMAT, "unsupported object");
  bool sparse;
  if (std::strcmp(format, "coordinate") == 0)
    sparse = true;
  else if (std::strcmp(format, "array") == 0)
    sparse = false;
  else
    return fail(out, CGX_MM_EFORMAT, "unsupported format");
  bool pattern = false, integer = false;
  if (std::strcmp(field, "pattern") == 0)
    pattern = true;
  else if (std::strcmp(field, "integer") == 0)
    integer = true;
  else if (std::strcmp(field, "real") != 0)
    return fail(out, CGX_MM_EFORMAT, "unsupported field");
  (void)integer;  // integers parse through strtod identically
  bool symmetric = false, skew = false;
  if (std::strcmp(symmetry, "symmetric") == 0)
    symmetric = true;
  else if (std::strcmp(symmetry, "skew-symmetric") == 0)
    skew = true;
  else if (std::strcmp(symmetry, "general") != 0)
    return fail(out, CGX_MM_EFORMAT, "unsupported symmetry");

  // ---- comments then size line ----
  p = skip_ws(p, end);
  while (p < end && *p == '%') p = skip_ws(next_line(p, end), end);
  char* q = nullptr;
  long m = std::strtol(p, &q, 10);
  if (q == p) return fail(out, CGX_MM_ESIZE, "missing size line");
  p = q;
  long n = std::strtol(p, &q, 10);
  if (q == p) return fail(out, CGX_MM_ESIZE, "bad size line");
  p = q;
  int64_t nnz;
  if (sparse) {
    long long z = std::strtoll(p, &q, 10);
    if (q == p) return fail(out, CGX_MM_ESIZE, "bad coordinate size line");
    p = q;
    nnz = (int64_t)z;
  } else {
    nnz = (int64_t)m * (int64_t)n;
  }
  if (m <= 0 || n <= 0 || nnz < 0)
    return fail(out, CGX_MM_ESIZE, "non-positive dimensions");

  out->m = (int32_t)m;
  out->n = (int32_t)n;
  out->nnz = nnz;
  out->is_sparse = sparse ? 1 : 0;
  out->is_symmetric = symmetric ? 1 : 0;
  out->is_skew = skew ? 1 : 0;
  out->is_pattern = pattern ? 1 : 0;

  if (sparse) {
    out->rows = (int32_t*)std::malloc(sizeof(int32_t) * (size_t)nnz);
    out->cols = (int32_t*)std::malloc(sizeof(int32_t) * (size_t)nnz);
    out->values = (double*)std::malloc(sizeof(double) * (size_t)nnz);
    if (!out->rows || !out->cols || !out->values) {
      cgx_mm_free(out);
      return fail(out, CGX_MM_EIO, "out of memory");
    }
    for (int64_t k = 0; k < nnz; ++k) {
      long i = std::strtol(p, &q, 10);
      if (q == p) {
        cgx_mm_free(out);
        return fail(out, CGX_MM_EENTRY, "truncated/invalid entry (row)");
      }
      p = q;
      long j = std::strtol(p, &q, 10);
      if (q == p) {
        cgx_mm_free(out);
        return fail(out, CGX_MM_EENTRY, "truncated/invalid entry (col)");
      }
      p = q;
      double v = 1.0;
      if (!pattern) {
        v = std::strtod(p, &q);
        if (q == p) {
          cgx_mm_free(out);
          return fail(out, CGX_MM_EENTRY, "truncated/invalid entry (value)");
        }
        p = q;
      }
      if (i < 1 || i > m || j < 1 || j > n) {
        cgx_mm_free(out);
        return fail(out, CGX_MM_EBOUNDS, "index out of bounds");
      }
      out->rows[k] = (int32_t)(i - 1);
      out->cols[k] = (int32_t)(j - 1);
      out->values[k] = v;
    }
    p = skip_ws(p, end);
    if (p < end && *p != '%') {
      cgx_mm_free(out);
      return fail(out, CGX_MM_EENTRY, "trailing data after declared entries");
    }
  } else {
    if (symmetric || skew) {
      return fail(out, CGX_MM_EFORMAT,
                  "symmetric dense array files are not supported");
    }
    out->values = (double*)std::malloc(sizeof(double) * (size_t)nnz);
    if (!out->values) return fail(out, CGX_MM_EIO, "out of memory");
    for (int64_t k = 0; k < nnz; ++k) {
      double v = std::strtod(p, &q);
      if (q == p) {
        cgx_mm_free(out);
        return fail(out, CGX_MM_EENTRY, "truncated/invalid array entry");
      }
      p = q;
      out->values[k] = v;  // column-major on disk, kept as-is
    }
  }
  return CGX_MM_OK;
}

void cgx_mm_free(CgxMMData* out) {
  std::free(out->rows);
  std::free(out->cols);
  std::free(out->values);
  out->rows = nullptr;
  out->cols = nullptr;
  out->values = nullptr;
}

// Fast writer: coordinate real, 1-based indices, %.17g values.
int cgx_mm_write(const char* path, int32_t m, int32_t n, int64_t nnz,
                 const int32_t* rows, const int32_t* cols,
                 const double* values, int32_t symmetric,
                 const char* comment) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return CGX_MM_EIO;
  std::vector<char> iobuf(1 << 20);
  std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
  std::fprintf(f, "%%%%MatrixMarket matrix coordinate real %s\n",
               symmetric ? "symmetric" : "general");
  if (comment && comment[0]) std::fprintf(f, "%%%s\n", comment);
  std::fprintf(f, "%d %d %lld\n", m, n, (long long)nnz);
  for (int64_t k = 0; k < nnz; ++k) {
    std::fprintf(f, "%d %d %.17g\n", rows[k] + 1, cols[k] + 1, values[k]);
  }
  std::fclose(f);
  return CGX_MM_OK;
}

}  // extern "C"

// Native host-side helpers for sblas.
//
// The reference implements its host-side analysis passes in C++ (SURVEY.md
// C1/C7: mmio parsing, level-set construction). These are the equivalents
// here: sequential O(nnz) passes that are pathological for numpy but
// trivial in C++ (level schedules, .mtx parsing, the golden triangular
// solve, IC(0)/ILU(0)). Built as a plain shared library, loaded via ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsblas_native.so sblas_native.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>

extern "C" {

// Level-set schedule for a lower-triangular CSR matrix (SURVEY.md C7).
// level[i] = 1 + max(level[j]) over off-diagonal dependencies j < i.
// Rows are topologically ordered by index for a lower-triangular matrix, so
// one forward sweep suffices. Returns the number of levels.
int32_t sblas_level_schedule_lower(const int32_t* indptr,
                                   const int32_t* indices,
                                   int64_t n,
                                   int32_t* levels) {
  int32_t nlevels = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t lvl = 0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j < i) {
        int32_t cand = levels[j] + 1;
        if (cand > lvl) lvl = cand;
      }
    }
    levels[i] = lvl;
    if (lvl + 1 > nlevels) nlevels = lvl + 1;
  }
  return nlevels;
}

// Upper-triangular variant: backward sweep, deps are j > i.
int32_t sblas_level_schedule_upper(const int32_t* indptr,
                                   const int32_t* indices,
                                   int64_t n,
                                   int32_t* levels) {
  int32_t nlevels = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    int32_t lvl = 0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j > i) {
        int32_t cand = levels[j] + 1;
        if (cand > lvl) lvl = cand;
      }
    }
    levels[i] = lvl;
    if (lvl + 1 > nlevels) nlevels = lvl + 1;
  }
  return nlevels;
}

// Fast MatrixMarket coordinate-body parser (SURVEY.md C1).
// Parses up to nnz lines of "row col [value]" from buf. Returns number of
// entries parsed, or -1 on malformed input. 1-based indices are converted to
// 0-based. If has_value == 0 values are set to 1.0.
int64_t sblas_parse_mtx_body(const char* buf, int64_t len, int64_t nnz,
                             int has_value, int32_t* rows, int32_t* cols,
                             double* vals) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t count = 0;
  while (count < nnz && p < end) {
    // skip whitespace/newlines
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '%') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    char* next;
    long r = strtol(p, &next, 10);
    if (next == p) return -1;
    p = next;
    long c = strtol(p, &next, 10);
    if (next == p) return -1;
    p = next;
    double v = 1.0;
    if (has_value) {
      v = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    rows[count] = (int32_t)(r - 1);
    cols[count] = (int32_t)(c - 1);
    vals[count] = v;
    ++count;
  }
  return count;
}

// CSR forward substitution golden (serial, for validation parity with the
// reference's CPU goldens — SURVEY.md C12). x and b may alias.
void sblas_sptrsv_lower_f64(const int32_t* indptr, const int32_t* indices,
                            const double* data, int64_t n, const double* b,
                            double* x, int unit_diagonal) {
  for (int64_t i = 0; i < n; ++i) {
    double acc = b[i];
    double diag = 1.0;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j < i) {
        acc -= data[k] * x[j];
      } else if (j == i) {
        diag = data[k];
      }
    }
    x[i] = unit_diagonal ? acc : acc / diag;
  }
}

}  // extern "C"

// IC(0): incomplete Cholesky on the pattern of tril(A), in place.
// Input: CSR of tril(A) (columns ascending, diagonal present as the last
// entry of each row), values overwritten with L such that L L^T ~= A.
// Returns 0, or (i+1) if the pivot of row i was non-positive (breakdown —
// caller may shift the diagonal and retry).
extern "C" int64_t sblas_ic0_f64(const int32_t* indptr,
                                 const int32_t* indices,
                                 double* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p0 = indptr[i], p1 = indptr[i + 1];
    // columns ascending; diagonal last
    for (int32_t p = p0; p < p1 - 1; ++p) {
      const int32_t k = indices[p];
      // dot of row i prefix [p0, p) with row k's sub-diagonal part,
      // two-pointer merge over sorted columns
      double dot = 0.0;
      const int32_t k0 = indptr[k], k1 = indptr[k + 1] - 1;  // excl diag
      int32_t a = p0, b = k0;
      while (a < p && b < k1) {
        const int32_t ca = indices[a], cb = indices[b];
        if (ca == cb) { dot += data[a] * data[b]; ++a; ++b; }
        else if (ca < cb) ++a;
        else ++b;
      }
      const double lkk = data[indptr[k + 1] - 1];
      data[p] = (data[p] - dot) / lkk;
    }
    double diag = data[p1 - 1];
    for (int32_t p = p0; p < p1 - 1; ++p) diag -= data[p] * data[p];
    if (!(diag > 0.0)) return i + 1;
    data[p1 - 1] = sqrt(diag);
  }
  return 0;
}

// ILU(0): incomplete LU on the pattern of A (square CSR, columns ascending,
// full diagonal), in place — IKJ sweep with a column-position work array.
// On return data holds L (strictly lower, unit diagonal implicit) and U
// (diagonal + strictly upper). Returns 0, or (i+1) if row i hit a zero
// pivot / missing diagonal (caller may shift the diagonal and retry).
extern "C" int64_t sblas_ilu0_f64(const int32_t* indptr,
                                  const int32_t* indices,
                                  double* data, int64_t n) {
  std::vector<int32_t> diag(n, -1);
  std::vector<int32_t> pos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t p0 = indptr[i], p1 = indptr[i + 1];
    for (int32_t p = p0; p < p1; ++p) pos[indices[p]] = p;
    int64_t bad = 0;
    for (int32_t p = p0; p < p1 && indices[p] < i; ++p) {
      const int32_t k = indices[p];
      const double ukk = data[diag[k]];
      if (ukk == 0.0) { bad = (int64_t)k + 1; break; }
      const double lik = data[p] / ukk;
      data[p] = lik;
      for (int32_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
        const int32_t pj = pos[indices[q]];
        if (pj >= 0) data[pj] -= lik * data[q];
      }
    }
    if (!bad) {
      const int32_t pd = pos[i];
      if (pd < 0 || data[pd] == 0.0) bad = i + 1;
      else diag[i] = pd;
    }
    for (int32_t p = p0; p < p1; ++p) pos[indices[p]] = -1;
    if (bad) return bad;
  }
  return 0;
}

// genmmrec_native: the port's C++ host runtime for the data path.
//
// Counterpart of genmmrec_tpu/native/genmmrec_native.cpp, with the same
// results on tab-separated input:
//   - tsv_count_rows / tsv_parse_inter: the `.inter` reader. A row keeps its
//     timestamp here, so the times always come from the rows that are kept
//     (a row with a negative or empty user or item id is dropped, and so is
//     its time). A blank line is no row.
//   - build_csr / build_padded_history / max_row_count: a row-sorted padded
//     history matrix (a user's train items).
//   - cooccur_topk: each left node's k co-occurring left nodes with the most
//     shared right nodes (a user-user or item-item graph).
//
// A plain C interface for ctypes; every buffer is a caller-allocated numpy
// array. genmmrec_tpu_torch/native/__init__.py builds it with g++ at first
// use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Lines of a file after its header (an unterminated last line counts).
// Returns -1 when the file cannot be opened.
int64_t tsv_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t lines = 0;
  std::vector<char> buf(1 << 20);
  size_t got;
  char last = '\n';
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; ++i)
      if (buf[i] == '\n') ++lines;
    last = buf[got - 1];
  }
  fclose(f);
  if (last != '\n') ++lines;
  return lines > 0 ? lines - 1 : 0;
}

static int32_t parse_id(const char* s) {
  char* end;
  long v = strtol(s, &end, 10);
  return end == s ? -1 : (int32_t)v;  // an empty field is no id
}

static double parse_real(const char* s) {
  char* end;
  double v = strtod(s, &end);
  return end == s ? NAN : v;  // an empty field is missing
}

// The user, item and label columns (and, when their index is >= 0, the
// rating and time columns) of the rows of a tab-separated file after its
// header, by 0-based column index, into buffers of `cap` rows. A row with a
// negative or empty user or item id is dropped whole. Returns the number of
// rows kept, or -1 when the file cannot be opened.
int64_t tsv_parse_inter(const char* path, int user_col, int item_col,
                        int label_col, int rating_col, int time_col,
                        int32_t* users, int32_t* items, int32_t* labels,
                        float* ratings, double* times, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t size = 0;
  ssize_t len;
  int64_t n = 0;
  bool header = true;
  while ((len = getline(&line, &size, f)) != -1) {
    if (header) { header = false; continue; }
    if (len == 0 || line[0] == '\n' || (line[0] == '\r' && line[1] == '\n')) continue;
    if (n >= cap) break;
    int col = 0;
    char* field = line;
    int32_t u = -1, it = -1, lab = 0;
    float r = NAN;
    double t = NAN;
    for (char* p = line;; ++p) {
      char c = *p;
      if (c == '\t' || c == '\n' || c == '\r' || c == '\0') {
        *p = '\0';
        if (col == user_col) u = parse_id(field);
        else if (col == item_col) it = parse_id(field);
        else if (col == label_col) lab = (int32_t)strtol(field, nullptr, 10);
        if (col == rating_col) r = (float)parse_real(field);
        if (col == time_col) t = parse_real(field);
        ++col;
        field = p + 1;
        if (c != '\t') break;
      }
    }
    if (u < 0 || it < 0) continue;
    users[n] = u;
    items[n] = it;
    labels[n] = lab;
    if (ratings) ratings[n] = r;
    if (times) times[n] = t;
    ++n;
  }
  free(line);
  fclose(f);
  return n;
}

// CSR of (ids, vals) pairs: row_ptr (n_rows + 1) and the values grouped by
// id, in their order within a row, into out_vals (n).
void build_csr(const int32_t* ids, const int32_t* vals, int64_t n,
               int32_t n_rows, int64_t* row_ptr, int32_t* out_vals) {
  std::memset(row_ptr, 0, sizeof(int64_t) * (n_rows + 1));
  for (int64_t i = 0; i < n; ++i) row_ptr[ids[i] + 1]++;
  for (int32_t r = 0; r < n_rows; ++r) row_ptr[r + 1] += row_ptr[r];
  std::vector<int64_t> cursor(row_ptr, row_ptr + n_rows);
  for (int64_t i = 0; i < n; ++i) out_vals[cursor[ids[i]]++] = vals[i];
}

// The (n_rows, max_len) matrix of each row's values sorted ascending, the
// rest of the row `pad_value`, and each row's length. Returns max_len.
int64_t build_padded_history(const int32_t* ids, const int32_t* vals,
                             int64_t n, int32_t n_rows, int32_t pad_value,
                             int32_t* out, int32_t* lens, int64_t max_len) {
  std::vector<int64_t> row_ptr(n_rows + 1, 0);
  std::vector<int32_t> grouped(n);
  build_csr(ids, vals, n, n_rows, row_ptr.data(), grouped.data());
  for (int32_t r = 0; r < n_rows; ++r) {
    int64_t s = row_ptr[r], e = row_ptr[r + 1];
    std::sort(grouped.begin() + s, grouped.begin() + e);
    int64_t len = e - s;
    lens[r] = (int32_t)len;
    int32_t* dst = out + (int64_t)r * max_len;
    for (int64_t i = 0; i < len && i < max_len; ++i) dst[i] = grouped[s + i];
    for (int64_t i = len; i < max_len; ++i) dst[i] = pad_value;
  }
  return max_len;
}

int64_t max_row_count(const int32_t* ids, int64_t n, int32_t n_rows) {
  std::vector<int64_t> cnt(n_rows, 0);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t c = ++cnt[ids[i]];
    if (c > m) m = c;
  }
  return m;
}

// For each left node u, the k other left nodes that share the most right
// nodes with it, over the two-hop neighbourhood of both CSRs
// (O(sum_u sum_{i in u} deg(i))). A pair (u, i) listed twice counts twice on
// u's side. Rows with fewer than k neighbours repeat them cyclically (all 0
// when there are none); equal counts come in partial_sort's order.
void cooccur_topk(const int32_t* left, const int32_t* right, int64_t n,
                  int32_t n_left, int32_t n_right, int32_t k,
                  int32_t* nbrs, float* wts) {
  std::vector<int64_t> l_ptr(n_left + 1, 0);
  std::vector<int32_t> l_adj(n);
  build_csr(left, right, n, n_left, l_ptr.data(), l_adj.data());
  std::vector<int64_t> r_ptr(n_right + 1, 0);
  std::vector<int32_t> r_adj(n);
  build_csr(right, left, n, n_right, r_ptr.data(), r_adj.data());

  std::vector<int32_t> count(n_left, 0);
  std::vector<int32_t> touched;
  touched.reserve(4096);

  for (int32_t u = 0; u < n_left; ++u) {
    touched.clear();
    for (int64_t e = l_ptr[u]; e < l_ptr[u + 1]; ++e) {
      int32_t item = l_adj[e];
      for (int64_t e2 = r_ptr[item]; e2 < r_ptr[item + 1]; ++e2) {
        int32_t v = r_adj[e2];
        if (v == u) continue;
        if (count[v] == 0) touched.push_back(v);
        count[v]++;
      }
    }
    int32_t kk = (int32_t)std::min<size_t>(k, touched.size());
    std::partial_sort(touched.begin(), touched.begin() + kk, touched.end(),
                      [&](int32_t a, int32_t b) { return count[a] > count[b]; });
    int32_t* nrow = nbrs + (int64_t)u * k;
    float* wrow = wts + (int64_t)u * k;
    for (int32_t i = 0; i < kk; ++i) {
      nrow[i] = touched[i];
      wrow[i] = (float)count[touched[i]];
    }
    for (int32_t i = kk; i < k; ++i) {
      nrow[i] = kk > 0 ? nrow[i % kk] : 0;
      wrow[i] = kk > 0 ? wrow[i % kk] : 0.f;
    }
    for (int32_t v : touched) count[v] = 0;
  }
}

}  // extern "C"

// Streaming edge-list parser of graphmine_tpu_torch (host C++).
//
// The port's own copy of the chunked parse API of the JAX package's native
// builder (native/graph_builder.cpp): one interner lives across calls while
// the caller feeds buffers of complete lines, so peak host memory is
// O(chunk + vocabulary + edges). Endpoint tokens are interned to dense
// int32 ids line by line (source, then destination) in first-appearance
// order; an optional token holds a float edge weight. The port builds its
// message CSR on the device, so the CSR builder is not copied.
//
// Bound with ctypes by graphmine_tpu_torch/io/native.py, which compiles
// this file with the host C++ compiler at first use:
//   c++ -O3 -std=c++17 -fPIC -shared

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Interner {
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> names;
  // Column count of the first data line of a parse session; later lines
  // must match (np.loadtxt's rectangularity rule, which the NumPy paths
  // enforce as "number of columns changed").
  int32_t ncols = -1;

  int32_t intern(std::string_view s) {
    auto it = map.find(std::string(s));
    if (it != map.end()) return it->second;
    int32_t id = static_cast<int32_t>(names.size());
    names.emplace_back(s);
    map.emplace(names.back(), id);
    return id;
  }
};

}  // namespace

extern "C" {

void* gb_interner_new() { return new (std::nothrow) Interner(); }

void gb_interner_free(void* it) { delete static_cast<Interner*>(it); }

int64_t gb_interner_size(void* it) {
  return static_cast<int64_t>(static_cast<Interner*>(it)->names.size());
}

// Snapshot of the interner's names (malloc'd; free with gb_free_names).
// On allocation failure everything already allocated is freed and
// *names_out is nulled.
int64_t gb_interner_names(void* it, char*** names_out) {
  Interner* interner = static_cast<Interner*>(it);
  int64_t nv = static_cast<int64_t>(interner->names.size());
  *names_out = static_cast<char**>(malloc(sizeof(char*) * (nv ? nv : 1)));
  if (!*names_out) return -1;
  for (int64_t i = 0; i < nv; ++i) {
    const std::string& s = interner->names[static_cast<size_t>(i)];
    char* c = static_cast<char*>(malloc(s.size() + 1));
    if (!c) {
      for (int64_t j = 0; j < i; ++j) free((*names_out)[j]);
      free(*names_out);
      *names_out = nullptr;
      return -1;
    }
    memcpy(c, s.data(), s.size() + 1);
    (*names_out)[i] = c;
  }
  return nv;
}

// Parse a buffer of complete lines ("src dst [cols...]"), interning through
// the shared interner. A line is cut at the comment char wherever it
// stands (np.loadtxt's rule). weight_col: -1 = unweighted, else the 0-based
// token index of a float weight (>= 2). Returns the edge count and malloc'd
// arrays (w_out only when weighted), -1 on allocation failure, -2 when a
// data line lacks the weight token or it does not parse as a float, -3
// when a data line has fewer than 2 tokens, -4 when the column count
// changes between data lines (across chunks too, through the interner).
int64_t gb_parse_edge_chunk(void* it, const char* buf, int64_t len,
                            char comment, int32_t weight_col,
                            int32_t** src_out, int32_t** dst_out,
                            float** w_out) {
  Interner* interner = static_cast<Interner*>(it);
  std::vector<int32_t> src, dst;
  std::vector<float> w;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* cpos =
        static_cast<const char*>(memchr(p, comment, line_end - p));
    const char* data_end = cpos ? cpos : line_end;
    const char* q = p;
    while (q < data_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q < data_end) {
      const char* t[2] = {nullptr, nullptr};
      const char* te[2] = {nullptr, nullptr};
      const char* wt = nullptr;
      const char* wte = nullptr;
      int32_t tok = 0;
      while (q < data_end) {
        const char* s0 = q;
        while (q < data_end && *q != ' ' && *q != '\t' && *q != '\r') ++q;
        if (q > s0) {
          if (tok < 2) {
            t[tok] = s0;
            te[tok] = q;
          } else if (tok == weight_col) {
            wt = s0;
            wte = q;
          }
          ++tok;
        }
        while (q < data_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      }
      if (!te[1]) return -3;
      if (interner->ncols < 0) {
        interner->ncols = tok;
      } else if (tok != interner->ncols) {
        return -4;
      }
      if (weight_col >= 0) {
        if (!wt) return -2;
        char tmp[64];
        size_t n = static_cast<size_t>(wte - wt);
        if (n >= sizeof(tmp)) return -2;
        memcpy(tmp, wt, n);
        tmp[n] = '\0';
        char* parse_end = nullptr;
        float val = strtof(tmp, &parse_end);
        if (parse_end != tmp + n) return -2;
        w.push_back(val);
      }
      src.push_back(interner->intern({t[0], size_t(te[0] - t[0])}));
      dst.push_back(interner->intern({t[1], size_t(te[1] - t[1])}));
    }
    p = line_end + 1;
  }

  int64_t ne = static_cast<int64_t>(src.size());
  *src_out = static_cast<int32_t*>(malloc(sizeof(int32_t) * (ne ? ne : 1)));
  *dst_out = static_cast<int32_t*>(malloc(sizeof(int32_t) * (ne ? ne : 1)));
  if (!*src_out || !*dst_out) {
    free(*src_out);
    free(*dst_out);
    *src_out = nullptr;
    *dst_out = nullptr;
    return -1;
  }
  if (ne) {
    memcpy(*src_out, src.data(), sizeof(int32_t) * ne);
    memcpy(*dst_out, dst.data(), sizeof(int32_t) * ne);
  }
  if (weight_col >= 0 && w_out) {
    *w_out = static_cast<float*>(malloc(sizeof(float) * (ne ? ne : 1)));
    if (!*w_out) {
      free(*src_out);
      free(*dst_out);
      *src_out = nullptr;
      *dst_out = nullptr;
      return -1;
    }
    if (ne) memcpy(*w_out, w.data(), sizeof(float) * ne);
  }
  return ne;
}

void gb_free(void* p) { free(p); }

void gb_free_names(char** names, int64_t n) {
  if (!names) return;
  for (int64_t i = 0; i < n; ++i) free(names[i]);
  free(names);
}

}  // extern "C"

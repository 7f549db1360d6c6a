// goicp_tpu_torch native runtime: BnB frontier store + selection + fast TXT IO.
//
// TPU-native counterpart of the reference's host-side runtime pieces:
//  - std::priority_queue<RotNode>/<TransNode> (src/common.h:88-95,123-130)
//    -> handle-based SoA frontier with BATCH pops (the device consumes
//       hundreds of cubes per step; a one-at-a-time binary heap is the wrong
//       shape), introselect-partitioned (std::nth_element) by (lb, ub);
//  - intro_select partial sort (src/goicp/jly_sorting.hpp:229)
//    -> gn_select_kth / gn_trimmed_sum for host-side trimming oracles;
//  - load_cloud_txt (src/common.cpp:148-204)
//    -> gn_read_txt: single-pass std::from_chars parser (~10x the Python
//       tokenizer on the 150k-line artec3d exports).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Frontier {
  int dim;                        // payload floats per node
  std::vector<float> payload;     // [size * dim]
  std::vector<float> lb, ub;      // bound keys

  explicit Frontier(int d) : dim(d) {}

  size_t size() const { return lb.size(); }

  void push(int64_t n, const float* pay, const float* lbs, const float* ubs) {
    size_t old = size();
    payload.resize((old + n) * dim);
    lb.resize(old + n);
    ub.resize(old + n);
    std::memcpy(payload.data() + old * dim, pay, n * dim * sizeof(float));
    std::memcpy(lb.data() + old, lbs, n * sizeof(float));
    std::memcpy(ub.data() + old, ubs, n * sizeof(float));
  }

  // Remove and return the k best nodes by (lb, ub) lexicographic.
  // std::nth_element is introselect: O(size) expected, no full sort --
  // the same algorithmic idea as jly_sorting.hpp's intro_select.
  int64_t pop_best(int64_t k, float* out_pay, float* out_lbs, float* out_ubs) {
    int64_t n = static_cast<int64_t>(size());
    if (k > n) k = n;
    if (k <= 0) return 0;
    std::vector<uint32_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = static_cast<uint32_t>(i);
    auto better = [this](uint32_t a, uint32_t b) {
      if (lb[a] != lb[b]) return lb[a] < lb[b];
      return ub[a] < ub[b];
    };
    if (k < n) std::nth_element(idx.begin(), idx.begin() + k, idx.end(), better);
    for (int64_t i = 0; i < k; ++i) {
      uint32_t j = idx[i];
      std::memcpy(out_pay + i * dim, payload.data() + j * dim,
                  dim * sizeof(float));
      out_lbs[i] = lb[j];
      out_ubs[i] = ub[j];
    }
    std::vector<char> taken(n, 0);
    for (int64_t i = 0; i < k; ++i) taken[idx[i]] = 1;
    size_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (!taken[i]) {
        std::memmove(payload.data() + w * dim, payload.data() + i * dim,
                     dim * sizeof(float));
        lb[w] = lb[i];
        ub[w] = ub[i];
        ++w;
      }
    }
    payload.resize(w * dim);
    lb.resize(w);
    ub.resize(w);
    return k;
  }

  // Drop nodes with lb >= threshold (incumbent re-filter,
  // jly_goicp.cpp:533-543).  Returns #dropped.
  int64_t prune(float threshold) {
    size_t n = size(), w = 0;
    for (size_t i = 0; i < n; ++i) {
      if (lb[i] < threshold) {
        std::memmove(payload.data() + w * dim, payload.data() + i * dim,
                     dim * sizeof(float));
        lb[w] = lb[i];
        ub[w] = ub[i];
        ++w;
      }
    }
    int64_t dropped = static_cast<int64_t>(n - w);
    payload.resize(w * dim);
    lb.resize(w);
    ub.resize(w);
    return dropped;
  }

  float min_lb() const {
    float m = std::numeric_limits<float>::infinity();
    for (float v : lb) m = std::min(m, v);
    return m;
  }
};

std::mutex g_mu;
std::unordered_map<int64_t, Frontier*> g_frontiers;
std::atomic<int64_t> g_next{1};

Frontier* get(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_frontiers.find(h);
  return it == g_frontiers.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t gn_frontier_new(int64_t dim) {
  int64_t h = g_next.fetch_add(1);
  std::lock_guard<std::mutex> lock(g_mu);
  g_frontiers[h] = new Frontier(static_cast<int>(dim));
  return h;
}

void gn_frontier_free(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_frontiers.find(h);
  if (it != g_frontiers.end()) {
    delete it->second;
    g_frontiers.erase(it);
  }
}

int64_t gn_frontier_size(int64_t h) {
  Frontier* f = get(h);
  return f ? static_cast<int64_t>(f->size()) : -1;
}

void gn_frontier_push(int64_t h, int64_t n, const float* payload,
                      const float* lbs, const float* ubs) {
  Frontier* f = get(h);
  if (f) f->push(n, payload, lbs, ubs);
}

int64_t gn_frontier_pop_best(int64_t h, int64_t k, float* out_payload,
                             float* out_lbs, float* out_ubs) {
  Frontier* f = get(h);
  return f ? f->pop_best(k, out_payload, out_lbs, out_ubs) : -1;
}

// Copy the whole store out (checkpointing).  Buffers must hold size() nodes.
int64_t gn_frontier_dump(int64_t h, float* out_payload, float* out_lbs,
                         float* out_ubs) {
  Frontier* f = get(h);
  if (!f) return -1;
  int64_t n = static_cast<int64_t>(f->size());
  std::memcpy(out_payload, f->payload.data(), n * f->dim * sizeof(float));
  std::memcpy(out_lbs, f->lb.data(), n * sizeof(float));
  std::memcpy(out_ubs, f->ub.data(), n * sizeof(float));
  return n;
}

int64_t gn_frontier_prune(int64_t h, float threshold) {
  Frontier* f = get(h);
  return f ? f->prune(threshold) : -1;
}

float gn_frontier_min_lb(int64_t h) {
  Frontier* f = get(h);
  return f ? f->min_lb() : std::numeric_limits<float>::quiet_NaN();
}

// k-th smallest of values[0..n) (0-indexed): introselect, O(n) expected.
// (= the trimming threshold select of jly_sorting.hpp:229 / jly_goicp.cpp:298)
float gn_select_kth(const float* values, int64_t n, int64_t k) {
  if (n <= 0) return std::numeric_limits<float>::quiet_NaN();
  if (k < 0) k = 0;
  if (k >= n) k = n - 1;
  std::vector<float> v(values, values + n);
  std::nth_element(v.begin(), v.begin() + k, v.end());
  return v[k];
}

// Sum of the h smallest values (trimmed SSE accumulation,
// jly_goicp.cpp:296-302).
double gn_trimmed_sum(const float* values, int64_t n, int64_t h) {
  if (n <= 0 || h <= 0) return 0.0;
  if (h >= n) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += values[i];
    return s;
  }
  std::vector<float> v(values, values + n);
  std::nth_element(v.begin(), v.begin() + h, v.end());
  double s = 0.0;
  for (int64_t i = 0; i < h; ++i) s += v[i];
  return s;
}

// Parse the reference TXT cloud format: "count\n x y z\n ..."
// (src/common.cpp:148-204).  Returns #points parsed into out (capacity
// max_points*3 floats), or -1 on IO/parse error.
int64_t gn_read_txt(const char* path, float* out, int64_t max_points) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long len = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(len) + 1);
  size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(len), fp);
  std::fclose(fp);
  buf[rd] = '\0';
  const char* p = buf.data();
  const char* end = p + rd;

  auto skip_ws = [&]() {
    while (p < end && (std::isspace(static_cast<unsigned char>(*p)))) ++p;
  };
  auto parse_f = [&](float* v) -> bool {
    skip_ws();
    if (p >= end) return false;
    auto res = std::from_chars(p, end, *v);
    if (res.ec != std::errc()) return false;
    p = res.ptr;
    return true;
  };

  float count_f;
  if (!parse_f(&count_f)) return -1;  // header line: point count
  int64_t declared = static_cast<int64_t>(count_f);
  int64_t n = 0;
  while (n < max_points && (declared <= 0 || n < declared)) {
    float x, y, z;
    if (!parse_f(&x) || !parse_f(&y) || !parse_f(&z)) break;
    out[3 * n + 0] = x;
    out[3 * n + 1] = y;
    out[3 * n + 2] = z;
    ++n;
  }
  return n;
}

}  // extern "C"

// labelmatch: interned label-selector matching engine.
//
// The host-side hot loop of the tensorizer (kubernetes_tpu_torch/models/snapshot.py)
// is selector-vs-labelmap matching: G pod signatures x N nodes for static
// masks, and G signatures x existing-pods for spread counts — at the 5k-node
// / 150k-pod design scale that is tens of millions of string-map probes per
// batch.  The reference keeps equivalents of these loops in compiled Go
// (labels.Selector.Matches over labels.Set); this engine is the C++
// counterpart exposed through a C ABI for ctypes.
//
// Model:
//   - all strings are interned to int32 ids (one global table per engine);
//   - a labelmap is a sorted (key,value) id vector (binary-searched);
//   - a selector is a list of requirements {key, op, value-set};
//   - match_matrix evaluates |selectors| x |labelmaps| into a uint8 matrix
//     in one call (row-major), no Python in the loop.
//
// Operators mirror kubernetes_tpu_torch/api/selectors.py exactly (including
// "missing key satisfies NotIn" and integer Gt/Lt semantics).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

enum Op : int32_t {
  OP_IN = 0,
  OP_NOT_IN = 1,
  OP_EXISTS = 2,
  OP_DOES_NOT_EXIST = 3,
  OP_GT = 4,
  OP_LT = 5,
  OP_EQ = 6,  // simple key=value (matchLabels / nodeSelector entries)
};

struct Requirement {
  int32_t key;
  int32_t op;
  std::vector<int32_t> values;       // interned value ids (IN/NOT_IN/EQ)
  long long num_value = 0;           // parsed numeric value (GT/LT)
  bool num_valid = false;
};

struct Selector {
  std::vector<Requirement> reqs;  // ANDed
};

struct LabelMap {
  // sorted by key id for binary search
  std::vector<std::pair<int32_t, int32_t>> kv;

  const int32_t* find(int32_t key) const {
    auto it = std::lower_bound(
        kv.begin(), kv.end(), key,
        [](const std::pair<int32_t, int32_t>& p, int32_t k) { return p.first < k; });
    if (it != kv.end() && it->first == key) return &it->second;
    return nullptr;
  }
};

struct Engine {
  std::unordered_map<std::string, int32_t> intern;
  std::vector<std::string> strings;
  std::vector<LabelMap> labelmaps;
  std::vector<Selector> selectors;

  int32_t intern_str(const char* s) {
    auto it = intern.find(s);
    if (it != intern.end()) return it->second;
    int32_t id = (int32_t)strings.size();
    strings.emplace_back(s);
    intern.emplace(strings.back(), id);
    return id;
  }
};

bool parse_ll(const std::string& s, long long* out) {
  if (s.empty()) return false;
  size_t i = (s[0] == '-' || s[0] == '+') ? 1 : 0;
  if (i >= s.size()) return false;
  long long v = 0;
  for (; i < s.size(); i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = (s[0] == '-') ? -v : v;
  return true;
}

bool req_matches(const Engine& e, const Requirement& r, const LabelMap& m) {
  const int32_t* val = m.find(r.key);
  switch (r.op) {
    case OP_EQ:
      return val != nullptr && !r.values.empty() && *val == r.values[0];
    case OP_IN: {
      if (val == nullptr) return false;
      for (int32_t v : r.values)
        if (v == *val) return true;
      return false;
    }
    case OP_NOT_IN: {
      if (val == nullptr) return true;  // missing key satisfies NotIn
      for (int32_t v : r.values)
        if (v == *val) return false;
      return true;
    }
    case OP_EXISTS:
      return val != nullptr;
    case OP_DOES_NOT_EXIST:
      return val == nullptr;
    case OP_GT:
    case OP_LT: {
      if (val == nullptr || !r.num_valid) return false;
      long long lhs;
      if (!parse_ll(e.strings[*val], &lhs)) return false;
      return r.op == OP_GT ? lhs > r.num_value : lhs < r.num_value;
    }
  }
  return false;
}

bool sel_matches(const Engine& e, const Selector& s, const LabelMap& m) {
  for (const auto& r : s.reqs)
    if (!req_matches(e, r, m)) return false;
  return true;
}

}  // namespace

extern "C" {

void* lm_new() { return new Engine(); }
void lm_free(void* h) { delete static_cast<Engine*>(h); }

// labelmap from parallel key/value C-string arrays; returns its id
int32_t lm_add_labelmap(void* h, const char** keys, const char** vals, int32_t n) {
  Engine* e = static_cast<Engine*>(h);
  LabelMap m;
  m.kv.reserve(n);
  for (int32_t i = 0; i < n; i++)
    m.kv.emplace_back(e->intern_str(keys[i]), e->intern_str(vals[i]));
  std::sort(m.kv.begin(), m.kv.end());
  e->labelmaps.push_back(std::move(m));
  return (int32_t)e->labelmaps.size() - 1;
}

int32_t lm_new_selector(void* h) {
  Engine* e = static_cast<Engine*>(h);
  e->selectors.emplace_back();
  return (int32_t)e->selectors.size() - 1;
}

// add one requirement to a selector
void lm_sel_add_req(void* h, int32_t sel, const char* key, int32_t op,
                    const char** values, int32_t nvalues) {
  Engine* e = static_cast<Engine*>(h);
  Requirement r;
  r.key = e->intern_str(key);
  r.op = op;
  r.values.reserve(nvalues);
  for (int32_t i = 0; i < nvalues; i++) r.values.push_back(e->intern_str(values[i]));
  if ((op == OP_GT || op == OP_LT) && nvalues == 1)
    r.num_valid = parse_ll(e->strings[r.values[0]], &r.num_value);
  e->selectors[sel].reqs.push_back(std::move(r));
}

// out[i*nl + j] = selector selector_ids[i] matches labelmap labelmap_ids[j]
void lm_match_matrix(void* h, const int32_t* selector_ids, int32_t ns,
                     const int32_t* labelmap_ids, int32_t nl, uint8_t* out) {
  Engine* e = static_cast<Engine*>(h);
  for (int32_t i = 0; i < ns; i++) {
    const Selector& s = e->selectors[selector_ids[i]];
    uint8_t* row = out + (size_t)i * nl;
    for (int32_t j = 0; j < nl; j++)
      row[j] = sel_matches(*e, s, e->labelmaps[labelmap_ids[j]]) ? 1 : 0;
  }
}

// out[j] = 1 if ANY of the selectors matches labelmap j (the spread-count
// "matches any grouping selector" probe), fused to avoid |sels| passes
void lm_match_any(void* h, const int32_t* selector_ids, int32_t ns,
                  const int32_t* labelmap_ids, int32_t nl, uint8_t* out) {
  Engine* e = static_cast<Engine*>(h);
  for (int32_t j = 0; j < nl; j++) {
    const LabelMap& m = e->labelmaps[labelmap_ids[j]];
    uint8_t hit = 0;
    for (int32_t i = 0; i < ns && !hit; i++)
      hit = sel_matches(*e, e->selectors[selector_ids[i]], m) ? 1 : 0;
    out[j] = hit;
  }
}

}  // extern "C"

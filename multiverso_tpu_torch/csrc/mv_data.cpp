// mv_data: host-side data pipeline of multiverso_tpu_torch (a copy of the
// parts of multiverso_tpu/native/mv_data.cpp that the port uses; plain C++,
// no CUDA).
//
// One-pass corpus loading (tokenize, count, prune to min_count, encode),
// frequent-word subsampling and skip-gram pair generation with the dynamic
// window shrink, on a splitmix64 stream: the same seed gives the same ids
// and pairs as the JAX package's library. Also the LR reader's libsvm line
// parser. Exposed as a C ABI for ctypes.
//
// Built by multiverso_tpu_torch/native/__init__.py with g++ at first use
// into build/torch_native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: small deterministic RNG (seed-stable across platforms).
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed + 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // bounded draw for the window shrink and the shuffle (modulo, as the
  // JAX package's library draws it)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

struct Corpus {
  std::vector<std::string> words;  // id -> word, count-desc order
  std::vector<int64_t> counts;     // id -> corpus count
  std::vector<int32_t> ids;        // encoded corpus stream
  int64_t total_tokens = 0;        // pre-pruning token count
};

bool is_space(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\v' ||
         c == '\f';
}

}  // namespace

extern "C" {

// Load + tokenize + count + prune(min_count) + encode. Returns an opaque
// handle, or nullptr on IO failure.
void* mv_corpus_load(const char* path, int64_t min_count, int64_t max_vocab) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  // pass 1: count tokens, keeping only (offset, len) spans
  std::unordered_map<std::string, int64_t> counter;
  std::vector<std::pair<uint32_t, uint32_t>> spans;
  spans.reserve(static_cast<size_t>(size / 6 + 16));
  size_t i = 0, n = buf.size();
  auto corpus = new Corpus();
  std::string scratch;
  while (i < n) {
    while (i < n && is_space(buf[i])) ++i;
    size_t start = i;
    while (i < n && !is_space(buf[i])) ++i;
    if (i > start) {
      spans.emplace_back(static_cast<uint32_t>(start),
                         static_cast<uint32_t>(i - start));
      scratch.assign(buf.data() + start, i - start);
      ++counter[scratch];
    }
  }
  corpus->total_tokens = static_cast<int64_t>(spans.size());

  // vocab: count-desc, then lexicographic (Dictionary.build's order)
  std::vector<std::pair<std::string, int64_t>> vocab;
  vocab.reserve(counter.size());
  for (auto& kv : counter) {
    if (kv.second >= min_count) vocab.emplace_back(kv.first, kv.second);
  }
  std::sort(vocab.begin(), vocab.end(), [](const auto& a, const auto& b) {
    return a.second != b.second ? a.second > b.second : a.first < b.first;
  });
  if (max_vocab > 0 && static_cast<int64_t>(vocab.size()) > max_vocab) {
    vocab.resize(static_cast<size_t>(max_vocab));
  }
  std::unordered_map<std::string, int32_t> word2id;
  word2id.reserve(vocab.size() * 2);
  for (size_t w = 0; w < vocab.size(); ++w) {
    corpus->words.push_back(vocab[w].first);
    corpus->counts.push_back(vocab[w].second);
    word2id.emplace(vocab[w].first, static_cast<int32_t>(w));
  }

  // pass 2: encode spans, dropping OOV
  corpus->ids.reserve(spans.size());
  for (auto& sp : spans) {
    scratch.assign(buf.data() + sp.first, sp.second);
    auto it = word2id.find(scratch);
    if (it != word2id.end()) corpus->ids.push_back(it->second);
  }
  return corpus;
}

void mv_corpus_free(void* handle) { delete static_cast<Corpus*>(handle); }

int64_t mv_corpus_vocab_size(void* handle) {
  return static_cast<int64_t>(static_cast<Corpus*>(handle)->words.size());
}

int64_t mv_corpus_size(void* handle) {
  return static_cast<int64_t>(static_cast<Corpus*>(handle)->ids.size());
}

int64_t mv_corpus_total_tokens(void* handle) {
  return static_cast<Corpus*>(handle)->total_tokens;
}

void mv_corpus_counts(void* handle, int64_t* out) {
  auto* c = static_cast<Corpus*>(handle);
  std::memcpy(out, c->counts.data(), c->counts.size() * sizeof(int64_t));
}

void mv_corpus_ids(void* handle, int32_t* out) {
  auto* c = static_cast<Corpus*>(handle);
  std::memcpy(out, c->ids.data(), c->ids.size() * sizeof(int32_t));
}

const char* mv_corpus_word(void* handle, int64_t id) {
  auto* c = static_cast<Corpus*>(handle);
  if (id < 0 || id >= static_cast<int64_t>(c->words.size())) return "";
  return c->words[static_cast<size_t>(id)].c_str();
}

// Frequent-word subsampling (ref reader.cpp sample_value): keep word w with
// prob min(1, (sqrt(f/t)+1) * t/f). Writes surviving ids to out; returns the
// new length. counts/vocab describe the id space; total = sum(counts).
int64_t mv_subsample(const int32_t* ids, int64_t n, const int64_t* counts,
                     int64_t vocab, double t, uint64_t seed, int32_t* out) {
  double total = 0;
  for (int64_t w = 0; w < vocab; ++w) total += static_cast<double>(counts[w]);
  std::vector<double> keep(static_cast<size_t>(vocab), 1.0);
  for (int64_t w = 0; w < vocab; ++w) {
    double f = counts[w] / (total > 0 ? total : 1.0);
    if (f > 1e-12) {
      double p = (std::sqrt(f / t) + 1.0) * t / f;
      keep[static_cast<size_t>(w)] = p < 1.0 ? p : 1.0;
    }
  }
  Rng rng(seed);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t w = ids[i];
    if (w >= 0 && w < vocab && rng.uniform() < keep[static_cast<size_t>(w)]) {
      out[m++] = w;
    }
  }
  return m;
}

// Sliding-window skip-gram pair generation with dynamic window shrink
// (word2vec 'b = rand % window'), then a Fisher-Yates shuffle so
// minibatches mix offsets. The caller allocates out_centers/out_contexts
// with capacity 2*window*n. Returns the pair count.
int64_t mv_generate_pairs(const int32_t* ids, int64_t n, int32_t window,
                          uint64_t seed, int32_t dynamic,
                          int32_t* out_centers, int32_t* out_contexts) {
  Rng rng(seed);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = dynamic ? 1 + static_cast<int64_t>(
                                  rng.below(static_cast<uint64_t>(window)))
                        : window;
    int64_t lo = i - w > 0 ? i - w : 0;
    int64_t hi = i + w + 1 < n ? i + w + 1 : n;
    for (int64_t j = lo; j < hi; ++j) {
      if (j == i) continue;
      out_centers[m] = ids[i];
      out_contexts[m] = ids[j];
      ++m;
    }
  }
  for (int64_t i = m - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(rng.below(static_cast<uint64_t>(i + 1)));
    std::swap(out_centers[i], out_centers[j]);
    std::swap(out_contexts[i], out_contexts[j]);
  }
  return m;
}

// libsvm line parsing: "label idx:val ..." -> dense row (ref LR reader.cpp
// text parser). Fills x (pre-zeroed by caller) of width dim; returns label,
// or INT32_MIN on an empty or comment line. Parsing stops at the first
// token that is not idx:val; indices outside [0, dim) are skipped.
int32_t mv_parse_libsvm_line(const char* line, int64_t len, float* x,
                             int64_t dim) {
  int64_t i = 0;
  while (i < len && is_space(line[i])) ++i;
  if (i >= len || line[i] == '#') return INT32_MIN;
  char* end = nullptr;
  long label = std::strtol(line + i, &end, 10);
  i = end - line;
  while (i < len) {
    while (i < len && is_space(line[i])) ++i;
    if (i >= len) break;
    char* colon = nullptr;
    long idx = std::strtol(line + i, &colon, 10);
    if (!colon || *colon != ':') break;
    char* vend = nullptr;
    double val = std::strtod(colon + 1, &vend);
    if (idx >= 0 && idx < dim) x[idx] = static_cast<float>(val);
    i = vend - line;
  }
  return static_cast<int32_t>(label);
}

}  // extern "C"

// Sanitizer smoke test of the port's native data pipeline (mv_data.cpp):
// every exported mv_* entry point, with its values checked, so the
// pipeline can run under AddressSanitizer and UndefinedBehaviorSanitizer
// (it is single-threaded: ThreadSanitizer has nothing to see).
//
//   g++ -O1 -g -std=c++17 -Wall -fsanitize=address,undefined
//       -fno-omit-frame-pointer -o mv_data_smoke mv_data.cpp mv_data_smoke.cpp
//   ./mv_data_smoke [corpus path]   (default: $TMPDIR or /tmp)
//
// tests/test_torch_native_data_smoke.py builds and runs it that way.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* mv_corpus_load(const char* path, int64_t min_count, int64_t max_vocab);
void mv_corpus_free(void* handle);
int64_t mv_corpus_vocab_size(void* handle);
int64_t mv_corpus_size(void* handle);
int64_t mv_corpus_total_tokens(void* handle);
void mv_corpus_counts(void* handle, int64_t* out);
void mv_corpus_ids(void* handle, int32_t* out);
const char* mv_corpus_word(void* handle, int64_t id);
int64_t mv_subsample(const int32_t* ids, int64_t n, const int64_t* counts,
                     int64_t vocab, double t, uint64_t seed, int32_t* out);
int64_t mv_generate_pairs(const int32_t* ids, int64_t n, int32_t window,
                          uint64_t seed, int32_t dynamic, int32_t* centers,
                          int32_t* contexts);
int32_t mv_parse_libsvm_line(const char* line, int64_t len, float* x,
                             int64_t input_size);
}

// checked in every build (assert() vanishes under NDEBUG)
#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::fprintf(stderr, "mv_data smoke: %s:%d: %s\n", __FILE__,    \
                   __LINE__, #cond);                                  \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

static int32_t parse(const std::string& line, std::vector<float>& x) {
  std::fill(x.begin(), x.end(), 0.f);
  return mv_parse_libsvm_line(line.c_str(), (int64_t)line.size(), x.data(),
                              (int64_t)x.size());
}

int main(int argc, char** argv) {
  std::string path;
  if (argc > 1) {
    path = argv[1];
  } else {
    const char* tmp = std::getenv("TMPDIR");
    path = std::string(tmp && *tmp ? tmp : "/tmp") + "/mv_data_smoke.txt";
  }
  FILE* f = std::fopen(path.c_str(), "w");
  CHECK(f);
  // 500 times ten tokens: "the" twice, seven other words once and one
  // of w0..w22 (each 21 or 22 times in all)
  for (int i = 0; i < 500; ++i)
    std::fprintf(f, "the quick brown fox jumps over the lazy dog w%d ",
                 i % 23);
  std::fclose(f);

  void* c = mv_corpus_load(path.c_str(), 2, 1 << 20);
  CHECK(c);
  const int64_t v = mv_corpus_vocab_size(c);
  const int64_t n = mv_corpus_size(c);
  CHECK(v == 8 + 23);               // "the" once, 7 other words, w0..w22
  CHECK(n == 500 * 10);
  CHECK(mv_corpus_total_tokens(c) == n);
  std::vector<int64_t> counts(v);
  mv_corpus_counts(c, counts.data());
  int64_t sum = 0;
  for (int64_t k = 0; k < v; ++k) sum += counts[k];
  CHECK(sum == n);
  CHECK(std::strcmp(mv_corpus_word(c, 0), "the") == 0);
  CHECK(counts[0] == 1000);         // the most frequent word comes first
  std::vector<int32_t> ids(n);
  mv_corpus_ids(c, ids.data());
  for (int64_t i = 0; i < n; ++i) CHECK(ids[i] >= 0 && ids[i] < v);
  CHECK(ids[0] == 0 && ids[6] == 0);

  std::vector<int32_t> sub(n);
  const int64_t m = mv_subsample(ids.data(), n, counts.data(), v, 1e-3, 7,
                                 sub.data());
  CHECK(m > 0 && m <= n);
  for (int64_t i = 0; i < m; ++i) CHECK(sub[i] >= 0 && sub[i] < v);
  std::vector<int32_t> sub2(n);
  CHECK(mv_subsample(ids.data(), n, counts.data(), v, 1e-3, 7,
                     sub2.data()) == m);   // seeded: the same draw
  CHECK(std::memcmp(sub.data(), sub2.data(), m * sizeof(int32_t)) == 0);

  const int64_t span = std::min<int64_t>(n, 2000);
  std::vector<int32_t> centers(span * 10), contexts(span * 10);
  const int64_t pairs = mv_generate_pairs(ids.data(), span, 5, 11, 1,
                                          centers.data(), contexts.data());
  CHECK(pairs > 0 && pairs <= span * 10);
  for (int64_t i = 0; i < pairs; ++i)
    CHECK(centers[i] >= 0 && centers[i] < v && contexts[i] >= 0 &&
          contexts[i] < v);
  const int64_t fixed = mv_generate_pairs(ids.data(), span, 5, 11, 0,
                                          centers.data(), contexts.data());
  CHECK(fixed == 2 * 5 * span - 2 * (1 + 2 + 3 + 4 + 5));

  std::vector<float> x(8);
  CHECK(parse("1 0:0.5 3:-1.25 7:2.0", x) == 1);
  CHECK(x[0] == 0.5f && x[3] == -1.25f && x[7] == 2.0f && x[1] == 0.f);
  CHECK(parse("  -1 2:3 9:4 -2:5", x) == -1);   // out of range: ignored
  CHECK(x[2] == 3.f && x[1] == 0.f);
  CHECK(parse("# a comment", x) == INT32_MIN);
  CHECK(parse("   ", x) == INT32_MIN);
  CHECK(parse("", x) == INT32_MIN);
  CHECK(parse("0 1:2 junk 4:5", x) == 0);        // stops at the junk
  CHECK(x[1] == 2.f && x[4] == 0.f);

  mv_corpus_free(c);
  std::remove(path.c_str());
  std::puts("mv_data smoke: OK");
  return 0;
}

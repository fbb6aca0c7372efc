// Host generators of the language-modeling corpora, built with the host's
// C++ compiler at first use (categoricalnf_tpu_torch/data/corpus.py) and
// loaded with ctypes.
//
// The port's own copy of markov_rollout and chunk_corpus of the JAX
// package's data runtime (categoricalnf_tpu/data/native/datagen.cpp): the
// same SplitMix64 streams, so that the same seed gives the same corpus and
// the same crops, element for element.  Deterministic given the seed and
// thread-free.

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint64_t splitmix64(uint64_t &s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// cdf: [V, V] float64 row-wise CDF of the transition matrix.
// out: [len] int32 chain states.
void markov_rollout(uint64_t seed, const double *cdf, int32_t V,
                    int64_t len, int32_t start, int32_t *out) {
  uint64_t s = seed * 0xA24BAED4963EE407ull + 5;
  int32_t state = start;
  for (int64_t t = 0; t < len; ++t) {
    double u = (double)(splitmix64(s) >> 11) * 0x1.0p-53;
    const double *row = cdf + (int64_t)state * V;
    // binary search for the first cdf >= u
    int32_t lo = 0, hi = V - 1;
    while (lo < hi) {
      int32_t mid = (lo + hi) / 2;
      if (row[mid] < u) lo = mid + 1; else hi = mid;
    }
    state = lo;
    out[t] = state;
  }
}

// stream: [len] int32; out: [n, T] int32 random crops.
void chunk_corpus(uint64_t seed, const int32_t *stream, int64_t len,
                  int64_t n, int32_t T, int32_t *out) {
  uint64_t s = seed * 0xF1357AEA2E62A9C5ull + 3;
  uint64_t span = (uint64_t)(len - T - 1);
  for (int64_t r = 0; r < n; ++r) {
    uint64_t start = splitmix64(s) % span;
    std::memcpy(out + r * T, stream + start, sizeof(int32_t) * T);
  }
}

}  // extern "C"

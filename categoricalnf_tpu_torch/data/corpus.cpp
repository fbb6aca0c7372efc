// Host data generators, built with the host's C++ compiler at first use
// (categoricalnf_tpu_torch/data/corpus.py) and loaded with ctypes: the set
// tasks' permutations and sum-constrained sequences, the language-modeling
// corpora and their crops.
//
// The port's own copy of the JAX package's data runtime
// (categoricalnf_tpu/data/native/datagen.cpp): the same SplitMix64 streams,
// the same bounded draws and the same seed mixing, so that the same seed
// gives the same batches, corpus and crops, element for element.
// Deterministic given the seed and thread-free.

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint64_t splitmix64(uint64_t &s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// An unbiased integer in [0, n) by Lemire's method.
static inline uint32_t bounded(uint64_t &s, uint32_t n) {
  uint64_t x = splitmix64(s) & 0xFFFFFFFFull;
  uint64_t m = x * (uint64_t)n;
  uint32_t l = (uint32_t)m;
  if (l < n) {
    uint32_t t = (uint32_t)(-(int32_t)n) % n;
    while (l < t) {
      x = splitmix64(s) & 0xFFFFFFFFull;
      m = x * (uint64_t)n;
      l = (uint32_t)m;
    }
  }
  return (uint32_t)(m >> 32);
}

// out: [n, S] int32, n random permutations of 0..S-1 (Fisher-Yates).
void gen_permutations(uint64_t seed, int64_t n, int32_t S, int32_t *out) {
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + 1;
  for (int64_t r = 0; r < n; ++r) {
    int32_t *row = out + r * S;
    for (int32_t i = 0; i < S; ++i) row[i] = i;
    for (int32_t i = S - 1; i > 0; --i) {
      uint32_t j = bounded(s, (uint32_t)(i + 1));
      int32_t t = row[i]; row[i] = row[j]; row[j] = t;
    }
  }
}

// out: [n, S] int32 in 0..K-1 whose values shifted to 1..K sum to target,
// by rejection sampling; S <= 512.  Returns the number of attempts.
int64_t gen_sum_sequences(uint64_t seed, int64_t n, int32_t S, int32_t K,
                          int32_t target, int32_t *out) {
  uint64_t s = seed * 0xD1342543DE82EF95ull + 11;
  int64_t attempts = 0;
  int32_t buf[512];
  for (int64_t r = 0; r < n;) {
    ++attempts;
    int32_t sum = 0;
    for (int32_t i = 0; i < S; ++i) {
      buf[i] = (int32_t)bounded(s, (uint32_t)K) + 1;
      sum += buf[i];
    }
    if (sum == target) {
      int32_t *row = out + r * S;
      for (int32_t i = 0; i < S; ++i) row[i] = buf[i] - 1;
      ++r;
    }
  }
  return attempts;
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

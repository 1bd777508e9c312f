// Native batched episode-table generator (host data-loader path).
//
// Parity mode needs one NumPy-legacy MT19937 stream per environment with
// bit-exact randint / normal / poisson draws (the reference precomputes
// whole-episode demand and lead-time tables from np.random.RandomState at
// every reset; reference supplychain_env.py:641-672, demands_generator.py).
// Generating thousands of independent streams from Python is GIL-bound; this
// module owns the per-env generator states and fills whole table batches in
// one call, multithreaded across environments.
//
// The generator and distribution algorithms implement the public, frozen
// NumPy *legacy* RandomState semantics:
//  - MT19937 init_genrand / init_by_array (Matsumoto & Nishimura reference
//    implementation, as used by NumPy).
//  - doubles via the 53-bit (a>>5, b>>6) construction.
//  - gauss: polar (Marsaglia) method with the one-value cache.
//  - randint: masked-rejection bounded 64-bit integers.
//  - poisson: multiplication method for lam < 10, PTRS otherwise.
// Bit-exactness against numpy is asserted by tests/test_torch_host_rng.py.
//
// Built by native/__init__.py: g++ -O3 -shared -fPIC -std=c++17 -pthread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfUL;
constexpr uint32_t UPPER_MASK = 0x80000000UL;
constexpr uint32_t LOWER_MASK = 0x7fffffffUL;

struct MT {
  uint32_t mt[N];
  int mti = N + 1;
  bool has_gauss = false;
  double gauss = 0.0;

  void init_genrand(uint32_t s) {
    mt[0] = s;
    for (mti = 1; mti < N; mti++) {
      mt[mti] = (1812433253UL * (mt[mti - 1] ^ (mt[mti - 1] >> 30)) + mti);
    }
    has_gauss = false;
    gauss = 0.0;
  }

  void init_by_array(const uint32_t* init_key, int key_length) {
    init_genrand(19650218UL);
    int i = 1, j = 0;
    int k = (N > key_length ? N : key_length);
    for (; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525UL)) +
              init_key[j] + j;
      i++; j++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
      if (j >= key_length) j = 0;
    }
    for (k = N - 1; k; k--) {
      mt[i] = (mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941UL)) - i;
      i++;
      if (i >= N) { mt[0] = mt[N - 1]; i = 1; }
    }
    mt[0] = 0x80000000UL;
  }

  uint32_t next32() {
    uint32_t y;
    if (mti >= N) {
      static const uint32_t mag01[2] = {0x0UL, MATRIX_A};
      int kk;
      if (mti == N + 1) init_genrand(5489UL);
      for (kk = 0; kk < N - M; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + M] ^ (y >> 1) ^ mag01[y & 0x1UL];
      }
      for (; kk < N - 1; kk++) {
        y = (mt[kk] & UPPER_MASK) | (mt[kk + 1] & LOWER_MASK);
        mt[kk] = mt[kk + (M - N)] ^ (y >> 1) ^ mag01[y & 0x1UL];
      }
      y = (mt[N - 1] & UPPER_MASK) | (mt[0] & LOWER_MASK);
      mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ mag01[y & 0x1UL];
      mti = 0;
    }
    y = mt[mti++];
    y ^= (y >> 11);
    y ^= (y << 7) & 0x9d2c5680UL;
    y ^= (y << 15) & 0xefc60000UL;
    y ^= (y >> 18);
    return y;
  }

  uint64_t next64() {
    uint64_t hi = next32();
    uint64_t lo = next32();
    return (hi << 32) | lo;
  }

  double next_double() {
    uint32_t a = next32() >> 5, b = next32() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }

  double next_gauss() {
    if (has_gauss) {
      has_gauss = false;
      return gauss;
    }
    double f, x1, x2, r2;
    do {
      x1 = 2.0 * next_double() - 1.0;
      x2 = 2.0 * next_double() - 1.0;
      r2 = x1 * x1 + x2 * x2;
    } while (r2 >= 1.0 || r2 == 0.0);
    f = std::sqrt(-2.0 * std::log(r2) / r2);
    gauss = f * x1;
    has_gauss = true;
    return f * x2;
  }

  // legacy bounded integers: masked rejection; ranges that fit in 32 bits
  // consume one 32-bit word per attempt (verified against NumPy's stream),
  // wider ranges consume 64-bit (hi<<32|lo) words.
  int64_t randint(int64_t low, int64_t high_excl) {
    uint64_t rng = (uint64_t)(high_excl - 1 - low);  // inclusive range width
    if (rng == 0) return low;
    uint64_t mask = rng;
    mask |= mask >> 1;  mask |= mask >> 2;  mask |= mask >> 4;
    mask |= mask >> 8;  mask |= mask >> 16; mask |= mask >> 32;
    uint64_t v;
    if (rng <= 0xffffffffULL) {
      do {
        v = next32() & (uint32_t)mask;
      } while (v > rng);
    } else {
      do {
        v = next64() & mask;
      } while (v > rng);
    }
    return low + (int64_t)v;
  }

  int64_t poisson_mult(double lam) {
    double enlam = std::exp(-lam);
    int64_t X = 0;
    double prod = 1.0;
    while (true) {
      prod *= next_double();
      if (prod > enlam) X += 1;
      else return X;
    }
  }

  double loggam(double x) {
    static const double a[10] = {
        8.333333333333333e-02, -2.777777777777778e-03, 7.936507936507937e-04,
        -5.952380952380952e-04, 8.417508417508418e-04, -1.917526917526918e-03,
        6.410256410256410e-03, -2.955065359477124e-02, 1.796443723688307e-01,
        -1.39243221690590e+00};
    double x0 = x;
    long n = 0;
    if ((x == 1.0) || (x == 2.0)) return 0.0;
    if (x <= 7.0) {
      n = (long)(7 - x);
      x0 = x + n;
    }
    double x2 = 1.0 / (x0 * x0);
    double xp = 2 * M_PI;
    double gl0 = a[9];
    for (long k = 8; k >= 0; k--) gl0 = gl0 * x2 + a[k];
    double gl = gl0 / x0 + 0.5 * std::log(xp) + (x0 - 0.5) * std::log(x0) - x0;
    if (x <= 7.0)
      for (long k = 1; k <= n; k++) {
        gl -= std::log(x0 - 1.0);
        x0 -= 1.0;
      }
    return gl;
  }

  int64_t poisson_ptrs(double lam) {
    double slam = std::sqrt(lam);
    double loglam = std::log(lam);
    double b = 0.931 + 2.53 * slam;
    double a = -0.059 + 0.02483 * b;
    double invalpha = 1.1239 + 1.1328 / (b - 3.4);
    double vr = 0.9277 - 3.6224 / (b - 2);
    while (true) {
      double U = next_double() - 0.5;
      double V = next_double();
      double us = 0.5 - std::fabs(U);
      long k = (long)std::floor((2 * a / us + b) * U + lam + 0.43);
      if ((us >= 0.07) && (V <= vr)) return k;
      if ((k < 0) || ((us < 0.013) && (V > us))) continue;
      if ((std::log(V) + std::log(invalpha) - std::log(a / (us * us) + b)) <=
          (-lam + k * loglam - loggam(k + 1)))
        return k;
    }
  }

  int64_t poisson(double lam) {
    if (lam >= 10) return poisson_ptrs(lam);
    if (lam == 0) return 0;
    return poisson_mult(lam);
  }
};

struct Batch {
  std::vector<MT> streams;
};

void parallel_for(size_t n, const std::function<void(size_t, size_t)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? (hw < n ? hw : n) : 1;
  if (nthreads <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (size_t t = 0; t < nthreads; t++) {
    size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

void* batch_create(const uint64_t* seeds, const uint8_t* has_seed, size_t B) {
  auto* b = new Batch();
  b->streams.resize(B);
  for (size_t i = 0; i < B; i++) {
    if (has_seed[i]) {
      uint64_t s = seeds[i];
      if (s <= 0xffffffffULL) {
        b->streams[i].init_genrand((uint32_t)s);
      } else {
        uint32_t key[2] = {(uint32_t)(s & 0xffffffffULL), (uint32_t)(s >> 32)};
        b->streams[i].init_by_array(key, key[1] ? 2 : 1);
      }
    } else {
      std::random_device rd;
      b->streams[i].init_genrand(rd());
    }
  }
  return b;
}

void batch_destroy(void* h) { delete static_cast<Batch*>(h); }

// Fill per-env uniform-integer tables: out[B, n] = randint(low, high_excl).
void batch_randint(void* h, long low, long high_excl, long* out, size_t n) {
  auto* b = static_cast<Batch*>(h);
  parallel_for(b->streams.size(), [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
      MT& mt = b->streams[i];
      long* row = out + i * n;
      for (size_t j = 0; j < n; j++) row[j] = mt.randint(low, high_excl);
    }
  });
}

// out[B, n] = loc + scale * gauss
void batch_normal(void* h, double loc, double scale, double* out, size_t n) {
  auto* b = static_cast<Batch*>(h);
  parallel_for(b->streams.size(), [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
      MT& mt = b->streams[i];
      double* row = out + i * n;
      for (size_t j = 0; j < n; j++) row[j] = loc + scale * mt.next_gauss();
    }
  });
}

// out[B, n] = poisson(lam)
void batch_poisson(void* h, double lam, long* out, size_t n) {
  auto* b = static_cast<Batch*>(h);
  parallel_for(b->streams.size(), [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
      MT& mt = b->streams[i];
      long* row = out + i * n;
      for (size_t j = 0; j < n; j++) row[j] = mt.poisson(lam);
    }
  });
}

}  // extern "C"

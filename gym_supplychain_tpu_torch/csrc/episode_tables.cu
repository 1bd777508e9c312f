// The evaluator's episode tables in one launch: what
// rng/device.py::episode_tables_plain computes on tensors (Philox4x32-10
// rows, then the lead-time and demand processes), bit for bit, for
// ops/episode_tables.py.
//
// Replaces no TPU kernel: the JAX package draws its tables with jax.random
// under XLA, no pallas_call.  The port's plain version runs Philox on int64
// tensors of shape [T+1, blocks, 4, B], a few hundred small launches an
// episode; the tables themselves are small.  Bound on the card: the bytes
// written, demands [T+1,R,P,B] and lead-times [T,K,B] (ntom at 4096 envs:
// 94.4 MB, 28 us at 3.35 TB/s); the integer work, ceil((K + R*P) / 4)
// Philox blocks an (env, period), is tens of microseconds on 132 SMs.  So a
// thread takes one (lane b, period s), lanes innermost, and writes its
// entries of every table row straight to memory: a warp stores whole
// 128-byte rows, nothing is staged.  The blocks lie on one flat grid
// axis, (period, lane block), so no grid limit bounds the horizon.
//
// Word i of lane b at period s is word i % 4 of Philox at counter
// (lane0 + b, s, i / 4, 0) under the episode key (philox_words).  Words
// 0..K-1 are the lead-time uniforms (period s >= 1 writes lead-time row
// s - 1: 1 + #{j : u >= cdf[j]}), words K..K+R*P-1 the demand uniforms of
// row s (entry (r, p) at K + r*P + p).  The demand processes follow
// demand_from_uniform in rng/device.py op for op, in float32: uniform
// integers floor(u * n) + lo; a normal by the inverse CDF (et_ndtri, in
// double, then rounded to float) times std plus the mean; a seasonal
// process adds its period's base, which the host computed in double and
// rounded to float; then a clamp that keeps a NaN, as torch.clamp does,
// and rounding half to even.  The store casts to the table's dtype
// (float32, or float64 for the vec env's float64 tables).
#include <cuda_runtime.h>

#include "philox.cuh"
#include "supplychain_step.cuh"

#define ET_THREADS 256
#define ET_PROD_WORDS 8   // kind, n, lo, std, mid, minv, maxv, unused

// torch.special.ndtri as it runs on the card in double: the Cephes
// algorithm of the jiterator's ndtri_string (ATen/native/cuda/Math.cuh).
// NVRTC builds that string with FMA contraction on, so each product that
// feeds a sum there is the fma written out here (this file builds with
// --fmad=false, which contracts nothing by itself).
__constant__ double ET_P0[5] = {
    -5.99633501014107895267E1, 9.80010754185999661536E1,
    -5.66762857469070293439E1, 1.39312609387279679503E1,
    -1.23916583867381258016E0};
__constant__ double ET_Q0[9] = {
    1.00000000000000000000E0,  1.95448858338141759834E0,
    4.67627912898881538453E0,  8.63602421390890590575E1,
    -2.25462687854119370527E2, 2.00260212380060660359E2,
    -8.20372256168333339912E1, 1.59056225126211695515E1,
    -1.18331621121330003142E0};
__constant__ double ET_P1[9] = {
    4.05544892305962419923E0,   3.15251094599893866154E1,
    5.71628192246421288162E1,   4.40805073893200834700E1,
    1.46849561928858024014E1,   2.18663306850790267539E0,
    -1.40256079171354495875E-1, -3.50424626827848203418E-2,
    -8.57456785154685413611E-4};
__constant__ double ET_Q1[9] = {
    1.00000000000000000000E0,   1.57799883256466749731E1,
    4.53907635128879210584E1,   4.13172038254672030440E1,
    1.50425385692907503408E1,   2.50464946208309415979E0,
    -1.42182922854787788574E-1, -3.80806407691578277194E-2,
    -9.33259480895457427372E-4};
__constant__ double ET_P2[9] = {
    3.23774891776946035970E0,  6.91522889068984211695E0,
    3.93881025292474443415E0,  1.33303460815807542389E0,
    2.01485389549179081538E-1, 1.23716634817820021358E-2,
    3.01581553508235416007E-4, 2.65806974686737550832E-6,
    6.23974539184983293730E-9};
__constant__ double ET_Q2[9] = {
    1.00000000000000000000E0,  6.02427039364742014255E0,
    3.67983563856160859403E0,  1.37702099489081330271E0,
    2.16236993594496635890E-1, 1.34204006088543189037E-2,
    3.28014464682127739104E-4, 2.89247864745380683936E-6,
    6.79019408009981274425E-9};

__device__ __forceinline__ double et_polevl(double x, const double* A,
                                            int len) {
  double r = 0.0;
#pragma unroll
  for (int i = 0; i < len; ++i) r = fma(r, x, A[i]);
  return r;
}

__device__ double et_ndtri(double y0) {
  if (y0 == 0.0) return -INFINITY;
  if (y0 == 1.0) return INFINITY;
  if (y0 < 0.0 || y0 > 1.0) return NAN;
  bool code = true;
  double y = y0;
  if (y > 1.0 - 0.13533528323661269189) {  // exp(-2)
    y = 1.0 - y;
    code = false;
  }
  if (y > 0.13533528323661269189) {
    y = y - 0.5;
    const double y2 = y * y;
    const double x =
        fma(y, y2 * et_polevl(y2, ET_P0, 5) / et_polevl(y2, ET_Q0, 9), y);
    return x * 2.50662827463100050242E0;  // sqrt(2 pi)
  }
  double x = sqrt(-2.0 * log(y));
  const double x0 = x - (log(x) / x);
  const double z = 1.0 / x;
  const double x1 = x < 8.0
                        ? z * et_polevl(z, ET_P1, 9) / et_polevl(z, ET_Q1, 9)
                        : z * et_polevl(z, ET_P2, 9) / et_polevl(z, ET_Q2, 9);
  x = x0 - x1;
  return code ? -x : x;
}

// one demand entry from its uniform: c the product's constants
// (rng/device.py demand_constants), base its seasonal base this period
__device__ __forceinline__ float et_demand(const int* c, float base,
                                           float u) {
  const int kind = c[0];
  const float n = __int_as_float(c[1]), lo = __int_as_float(c[2]);
  float x;
  if (kind == DEM_UNIFORM || kind == DEM_SEASONAL_UNIFORM) {
    x = floorf(u * n) + lo;
    if (kind == DEM_UNIFORM) return x;
  } else {
    x = (float)et_ndtri((double)u) * __int_as_float(c[3]);
  }
  x = kind == DEM_NORMAL ? x + __int_as_float(c[4]) : base + x;
  if (!isnan(x))
    x = fminf(fmaxf(x, __int_as_float(c[5])), __int_as_float(c[6]));
  return rintf(x);
}

// desc: cdf[n_cdf] | P x ET_PROD_WORDS product constants | base[P][T+1].
// Block g of the flat grid takes period g / lane_blocks and the lanes of
// block g % lane_blocks, striding by the grid, so any horizon fits.
template <typename D>
__global__ void __launch_bounds__(ET_THREADS)
    episode_tables_kernel(const int* __restrict__ desc, int T, int B, int R,
                          int P, int K, int n_cdf, unsigned int lane0,
                          unsigned int k0, unsigned int k1,
                          D* __restrict__ dem, int* __restrict__ lt) {
  const float* cdf = reinterpret_cast<const float*>(desc);
  const int* prod = desc + n_cdf;
  const float* bases =
      reinterpret_cast<const float*>(prod + ET_PROD_WORDS * P);
  const int RP = R * P, W = K + RP;
  const int lane_blocks = (B + ET_THREADS - 1) / ET_THREADS;
  const long long n_blocks = (long long)(T + 1) * lane_blocks;
  for (long long g = blockIdx.x; g < n_blocks; g += gridDim.x) {
    const int s = (int)(g / lane_blocks);
    const int b = (int)(g % lane_blocks) * ET_THREADS + threadIdx.x;
    if (b >= B) continue;
    const float* base = bases + s;
    for (int blk = 0; 4 * blk < W; ++blk) {
      const uint4 w = philox4x32_10(
          make_uint4(lane0 + (unsigned int)b, (unsigned int)s,
                     (unsigned int)blk, 0u),
          k0, k1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * blk + q;
        if (i >= W) break;
        const float u = uniform01(philox_word(w, q));
        if (i < K) {
          if (s == 0) continue;
          int v = 1;
          for (int j = 0; j < n_cdf; ++j) v += u >= cdf[j];
          lt[((size_t)(s - 1) * K + i) * B + b] = v;
        } else {
          const int e = i - K, p = e % P;
          dem[((size_t)s * RP + e) * B + b] = (D)et_demand(
              prod + ET_PROD_WORDS * p, base[(size_t)p * (T + 1)], u);
        }
      }
    }
  }
}

// desc_words: the descriptor's length, whose first n_cdf = desc_words -
// P * (ET_PROD_WORDS + T + 1) words are the lead-time thresholds.
// -8: a shape out of the kernel's range, a descriptor too short for its
// shapes, or lead-time columns without a lead-time table (or a table
// without columns)
extern "C" int episode_tables_launch(const int* desc, int desc_words, int T,
                                     int B, int R, int P, int K,
                                     unsigned int lane0, unsigned int k0,
                                     unsigned int k1, int f64, void* dem,
                                     int* lt, void* stream) {
  const long long n_cdf =
      desc_words - (long long)P * ((long long)T + 1 + ET_PROD_WORDS);
  if (T < 1 || T == 0x7FFFFFFF || B < 1 || R < 1 || P < 1 || K < 0 ||
      n_cdf < 0 || (K > 0) != (lt != nullptr))
    return -8;
  const long long n_blocks =
      (long long)(T + 1) * ((B + ET_THREADS - 1) / ET_THREADS);
  const unsigned int grid =
      (unsigned int)(n_blocks < (1LL << 30) ? n_blocks : (1LL << 30));
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    episode_tables_kernel<double><<<grid, ET_THREADS, 0, st>>>(
        desc, T, B, R, P, K, (int)n_cdf, lane0, k0, k1, (double*)dem, lt);
  else
    episode_tables_kernel<float><<<grid, ET_THREADS, 0, st>>>(
        desc, T, B, R, P, K, (int)n_cdf, lane0, k0, k1, (float*)dem, lt);
  return (int)cudaGetLastError();
}

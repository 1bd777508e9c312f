// Supply-chain trajectory collection, one thread per environment.
//
// Replaces the TPU collect kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py in all its modes.  Each
// env runs through S = episodes * T steps with auto-reset at every episode
// boundary, writing the pre-action observation and the reward of every
// step.  The per-env state (stock [N*P], pipeline ring [RING*N*P]) lives in
// per-thread arrays; the topology tables are one ScChain descriptor, copied
// to shared memory per block and read with loops over nodes, products and
// destinations at run time.  Stores of [.., B] rows are coalesced across a
// warp.
//
// * sc_collect_kernel (modes `random`, `actions`): 128 envs a block, one
//   thread each.
// * sc_policy_kernel (modes `policy`, `policy_eps`): the sampled
//   tanh-Gaussian actor-critic in the loop.  A block of 4 warps holds 32
//   envs: warp 0 steps them (one thread per env), then all 4 warps run the
//   MLP together on the block's obs tile [O, 32] in shared memory, each
//   thread computing 8 output rows of one env's column.  The packed weights
//   (ops/_mlp.py; 173 KB for ntom at hidden (128, 128)) are copied into
//   dynamic shared memory once per launch, so at B = 4096 the 128 blocks
//   spread over 128 of the 132 SMs, one block each.  It writes obs, the
//   pre-tanh action, its log-prob, the critic's value and the reward.
//
// Bounds on the card: the step is branchy scalar float work with indices
// known only at run time, so the state sits in local memory (L1) and the
// step is latency-bound; the only large traffic is the obs stream
// (S * O * B * 4 bytes).  The MLP reads weights as shared-memory broadcasts
// and activations without bank conflicts; it is issue-bound (a rounded
// product and an add per weight per env).
//
// Floating-point rules (the plain versions, core/step.py and
// ops/supplychain_collect.py, follow the same):
// * built with --fmad=false: every product is rounded before it is added,
//   as PyTorch eager and XLA:CPU do; one ulp in a shipped amount flips the
//   capacity gates downstream.  Divisions are IEEE (x / inf = 0, 0 / 0 =
//   nan as the reference emits).
// * pipeline adds keep (pipe + supply) + (e1 + e2 + ...): supply goes into
//   the ring directly, ship pushes are summed per (lead-time, dst, product)
//   in edge order, then added once.
// * the material leaving a node sums its destinations in index order.
// * the sorted cut is stable by destination index; its cut is
//   (v - pred) * avail, then a sequential clamp over sorted positions.
// * costs are summed per (category, product) and then over both, which is
//   not the plain version's order: rewards agree to ~1e-7 relative, the
//   dynamics bit for bit.
// * MLP layers accumulate w[j][k] * x[k] over k in order, starting from the
//   k = 0 product, then add the bias; the log-prob sums its A terms in
//   order; tanhf, expf, log1pf, cosf and sqrtf are the functions PyTorch's
//   CUDA kernels call, so policy actions match the plain version bit for
//   bit as well.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

#define SC_MAX_N 32
#define SC_MAX_P 8
#define SC_MAX_NP 32
#define SC_MAX_D 8
#define SC_MAX_ND 256
#define SC_MAX_NPD 256
#define SC_MAX_RING 8
#define SC_MAX_K 64
#define SC_MAX_A 64
#define SC_MAX_RP 16
#define SC_MAX_CDF 8

// cost categories (core/step.py COST_KEYS)
#define C_STOCK 0
#define C_STOCK_PEN 1
#define C_SUPPLY 2
#define C_PROCESS 3
#define C_PROCESS_PEN 4
#define C_SHIP 5
#define C_SHIP_PEN 6
#define C_UNMET 7

#define MODE_RANDOM 0
#define MODE_ACTIONS 1
#define MODE_POLICY 2
#define MODE_POLICY_EPS 3

// policy kernel: 4 warps, 32 envs a block; MLP layout of ops/_mlp.py
#define PK_THREADS 128
#define PK_WARPS 4
#define PK_ENVS 32
#define MLP_MAX_L 4
#define MLP_HEADER 10
#define MLP_PER_LAYER 7
#define MLP_LAYOUT_INTS (MLP_HEADER + 2 * (MLP_MAX_L + 1) * MLP_PER_LAYER)

#define LOG_STD_MIN -5.0f
#define LOG_STD_MAX 2.0f
#define LOG_2PI_F 1.8378770664093453f   // log(2 pi), rounded as float
#define LN2_F 0.6931471805599453f        // log(2)
#define TWO_PI_F 6.283185307179586f      // 2 pi

// Layout mirrored field for field by ops/supplychain_collect.py
// (_DESC_FIELDS); every field is 4 bytes, so there is no padding.
// Indexing: np = n*P + p, nd = n*dmax + d, npd = np*dmax + d,
// pipe row h at h*N*P + np.
struct ScChain {
  int N, P, R, A, K, T, Lavg, Lmax, H, ring, dmax, obs_dim;
  int stochastic, n_cdf, any_factory, pad0;
  float c_unmet, c_stock_pen, c_proc_pen, c_ship_pen;
  float init_stock[SC_MAX_NP];
  float stock_cap[SC_MAX_NP];
  float stock_cost[SC_MAX_NP];
  float supply_cap[SC_MAX_NP];
  float supply_cost[SC_MAX_NP];
  float proc_cost[SC_MAX_NP];
  float proc_ratio[SC_MAX_NP];
  float ms[SC_MAX_NP];       // obs normalizer max_ship (1 where it is 0)
  float ms_tail[SC_MAX_NP];  // ms * (Lmax - (Lavg - 1)), in float32
  int has_supply[SC_MAX_NP];
  int has_ship[SC_MAX_NP];
  int sup_act_idx[SC_MAX_NP];
  int ms_ok[SC_MAX_NP];
  int cap_finite[SC_MAX_NP];
  float proc_cap[SC_MAX_N];
  int is_factory[SC_MAX_N];
  int lt_base[SC_MAX_N];
  int node_ships[SC_MAX_N];
  int edge_dst[SC_MAX_ND];
  int edge_mask[SC_MAX_ND];
  float ship_cap_edge[SC_MAX_ND];
  float ship_cost[SC_MAX_NPD];
  int ship_act_idx[SC_MAX_NPD];
  float init_pipe[SC_MAX_RING * SC_MAX_NP];
  int retailer_idx[SC_MAX_RP];
  float dem_min[SC_MAX_P];
  float dem_range[SC_MAX_P];
  float dem_n[SC_MAX_P];   // uniform demand: floor(u * n) + lo
  float dem_lo[SC_MAX_P];
  float cdf[SC_MAX_CDF];   // lead-time thresholds: 1 + sum(u >= cdf[j])
};

__device__ __forceinline__ float clip_pm1(float x) {
  // 2x - 1 clipped to [-1, 1]; comparisons keep a nan, as jnp.clip does
  float y = 2.0f * x - 1.0f;
  y = y < -1.0f ? -1.0f : y;
  return y > 1.0f ? 1.0f : y;
}

__device__ __forceinline__ void copy_chain(const ScChain* gch, ScChain* ch) {
  const int* src = reinterpret_cast<const int*>(gch);
  int* dst = reinterpret_cast<int*>(ch);
  for (int i = threadIdx.x; i < (int)(sizeof(ScChain) / 4); i += blockDim.x)
    dst[i] = src[i];
}

// ---- episode init: initial stock, seeded pipeline -------------------------
__device__ __forceinline__ void sc_episode_init(const ScChain& ch, float* stock,
                                                float* ring) {
  const int NP = ch.N * ch.P;
  for (int i = 0; i < NP; ++i) stock[i] = ch.init_stock[i];
  for (int r = 0; r < ch.ring; ++r)
    for (int i = 0; i < NP; ++i)
      ring[r * NP + i] =
          (r >= 1 && r <= ch.H) ? ch.init_pipe[(r - 1) * NP + i] : 0.0f;
}

// ---- one step's random inputs from Philox at counter (lane, step, blk, 0):
// n_noise uniforms, then K lead-times (stochastic chains), then R*P demands
__device__ __forceinline__ void sc_draw_inputs(const ScChain& ch, int b, int s,
                                               uint32_t k0, uint32_t k1,
                                               int n_noise, float* noise,
                                               int* lt_row, float* dem) {
  const int Kr = ch.stochastic ? ch.K : 0, P = ch.P;
  const int U = n_noise + Kr + ch.R * P;
  for (int blk = 0; blk * 4 < U; ++blk) {
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)b, (uint32_t)s, (uint32_t)blk, 0u), k0, k1);
    for (int q = 0; q < 4; ++q) {
      const int i = blk * 4 + q;
      if (i >= U) break;
      const float u = uniform01(philox_word(w, q));
      if (i < n_noise) {
        noise[i] = u;
      } else if (i < n_noise + Kr) {
        int lt = 1;
        for (int j = 0; j < ch.n_cdf; ++j) lt += (u >= ch.cdf[j]);
        lt_row[i - n_noise] = lt;
      } else {
        const int j = i - n_noise - Kr, p = j % P;
        dem[j] = floorf(u * ch.dem_n[p]) + ch.dem_lo[p];
      }
    }
  }
}

// ---- one step's table rows: demands [S,R,P,B], lead-times [S,K,B] --------
__device__ __forceinline__ void sc_read_inputs(const ScChain& ch, int s, int b,
                                               size_t Bz,
                                               const float* __restrict__ dem_tab,
                                               const int* __restrict__ lt_tab,
                                               int* lt_row, float* dem) {
  const int RP = ch.R * ch.P;
  if (ch.stochastic)
    for (int k = 0; k < ch.K; ++k)
      lt_row[k] = lt_tab[((size_t)s * ch.K + k) * Bz + b];
  for (int j = 0; j < RP; ++j) dem[j] = dem_tab[((size_t)s * RP + j) * Bz + b];
}

// where an obs value goes: a global column (stride between features) and,
// for the policy kernel, the block's obs tile in shared memory
struct ObsSink {
  float* g;
  size_t stride;
  float* tile;  // [O][PK_ENVS] at this env's column, or nullptr
  __device__ __forceinline__ void operator()(int o, float v) const {
    g[(size_t)o * stride] = v;
    if (tile != nullptr) tile[o * PK_ENVS] = v;
  }
};

// ---- pre-action observation (core/step.py obs_fn) -------------------------
__device__ __forceinline__ void sc_obs(const ScChain& ch, const float* stock,
                                       const float* ring, const float* dem,
                                       int te, const ObsSink& out) {
  const int N = ch.N, P = ch.P, NP = N * P, RING = ch.ring, RP = ch.R * P;
  const int Lavg = ch.Lavg, H = ch.H, T = ch.T, t = te + 1;
  int o = 0;
  for (int j = 0; j < RP; ++j) {
    const int p = j % P;
    out(o++, clip_pm1((dem[j] - ch.dem_min[p]) / ch.dem_range[p]));
  }
  for (int n = 0; n < N; ++n) {
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      out(o++, clip_pm1(stock[i] / ch.stock_cap[i]));
    }
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      const bool ok = ch.ms_ok[i] != 0;
      // pipe[j] (arriving at te + 1 + j) sits in ring slot (t + j) % RING
      for (int j = 0; j < Lavg - 1; ++j) {
        const float x = ring[((t + j) % RING) * NP + i];
        out(o++, clip_pm1(ok ? x / ch.ms[i] : 0.0f));
      }
      float tail = ring[((t + Lavg - 1) % RING) * NP + i];
      for (int j = Lavg; j < H; ++j) tail = tail + ring[((t + j) % RING) * NP + i];
      out(o++, clip_pm1(ok ? tail / ch.ms_tail[i] : 0.0f));
    }
  }
  out(o, clip_pm1((float)(T - te) / (float)T));
}

// ---- phases 1-6 of one step; a[] holds the actions scaled to [0, 1] -------
__device__ __forceinline__ float sc_step(const ScChain& ch, float* stock,
                                         float* ring, const float* a,
                                         const int* lt_row, const float* dem,
                                         int t) {
  const int N = ch.N, P = ch.P, NP = N * P, D = ch.dmax, RING = ch.ring;
  const int K = ch.K, Lavg = ch.Lavg, Lmax = ch.Lmax;
  const bool stoch = ch.stochastic != 0;
  float upd[SC_MAX_RING * SC_MAX_NP], cost[8 * SC_MAX_P];
  int nfired[SC_MAX_N];

  for (int i = 0; i < 8 * P; ++i) cost[i] = 0.0f;

  // ---- phases 1+2: arrivals, stock-capacity penalty ---------------------
  const int slot0 = t % RING;
  for (int i = 0; i < NP; ++i) {
    const int p = i % P;
    float sv = stock[i] + ring[slot0 * NP + i];
    const float cap = ch.stock_cap[i];
    if (ch.cap_finite[i]) {
      const float ex = sv - cap;
      cost[C_STOCK_PEN * P + p] += ex > 0.0f ? ex : 0.0f;
    }
    stock[i] = fminf(sv, cap);
    ring[slot0 * NP + i] = 0.0f;
  }

  // ---- phase 3: supply --------------------------------------------------
  for (int n = 0; n < N; ++n) {
    int nf = 0;
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      if (!ch.has_supply[i]) continue;
      const float amt = a[ch.sup_act_idx[i]] * ch.supply_cap[i];
      cost[C_SUPPLY * P + p] += amt * ch.supply_cost[i];
      const bool fired = amt > 0.0f;
      int L = Lavg;
      if (stoch) {  // column = base + #earlier fired supplies at the node
        L = lt_row[min(ch.lt_base[n] + nf, K - 1)];
        nf += fired;
      }
      if (fired && L >= 1 && (!stoch || L <= Lmax))
        ring[((t + L) % RING) * NP + i] += amt;
    }
    nfired[n] = nf;
  }

  // ---- phase 4: ship -----------------------------------------------------
  const int Lhi = stoch ? Lmax : Lavg;
  for (int i = 0; i < (Lhi + 1) * NP; ++i) upd[i] = 0.0f;
  for (int n = 0; n < N; ++n) {
    if (!ch.node_ships[n]) continue;
    const bool fac = ch.is_factory[n] != 0;
    float avail_proc = ch.proc_cap[n];
    float avail_ship[SC_MAX_D];
    int Ld[SC_MAX_D];
    for (int d = 0; d < D; ++d) {
      avail_ship[d] = ch.ship_cap_edge[n * D + d];
      // transport columns follow the fired supplies, shared by products
      Ld[d] = stoch ? lt_row[min(ch.lt_base[n] + nfired[n] + d, K - 1)]
                    : Lavg;
    }
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      float v[SC_MAX_D], cut[SC_MAX_D], amounts[SC_MAX_D], to_ship[SC_MAX_D];
      int rank[SC_MAX_D];
      for (int d = 0; d < D; ++d)
        v[d] = (ch.has_ship[i] && ch.edge_mask[n * D + d])
                   ? a[ch.ship_act_idx[i * D + d]]
                   : 0.0f;
      const float s_g = stock[i];
      // sorted cut: predecessor and rank in the stable ascending sort
      for (int d = 0; d < D; ++d) {
        float w = -INFINITY;
        int r = 0;
        for (int j = 0; j < D; ++j) {
          const bool before = (v[j] < v[d]) || (v[j] == v[d] && j < d);
          if (before) {
            w = fmaxf(w, v[j]);
            ++r;
          }
        }
        if (r == 0) w = 0.0f;
        cut[d] = (v[d] - w) * s_g;
        rank[d] = r;
        amounts[d] = 0.0f;
      }
      float availr = s_g;
      for (int k = 0; k < D; ++k) {
        float cut_k = 0.0f;
        for (int d = 0; d < D; ++d) cut_k += (rank[d] == k) ? cut[d] : 0.0f;
        const float amt_k = fminf(cut_k, availr);
        availr = availr - amt_k;
        for (int d = 0; d < D; ++d) amounts[d] += (rank[d] == k) ? amt_k : 0.0f;
      }
      for (int d = 0; d < D; ++d)
        if (!ch.edge_mask[n * D + d]) amounts[d] = 0.0f;

      // processing-capacity clip, sequential over destinations
      float exc_proc = 0.0f;
      if (ch.any_factory) {
        for (int d = 0; d < D; ++d) {
          const float ai = amounts[d];
          const bool gate = fac && ai > 0.0f;
          const bool over = gate && ai > avail_proc;
          exc_proc = exc_proc + (over ? ai - avail_proc : 0.0f);
          const float ai2 = over ? avail_proc : ai;
          avail_proc = avail_proc - (gate ? ai2 : 0.0f);
          amounts[d] = ai2;
        }
      }
      for (int d = 0; d < D; ++d)
        to_ship[d] = (ch.any_factory && fac) ? amounts[d] / ch.proc_ratio[i]
                                             : amounts[d];

      // ship-capacity clip, bug-compatible shared-capacity bookkeeping
      float exc_ship = 0.0f, leaving = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float a2 = to_ship[d], capd = avail_ship[d];
        const bool g2 = a2 > 0.0f && a2 > capd;
        exc_ship += g2 ? a2 - capd : 0.0f;
        const float a2c = g2 ? capd : a2;
        const float raw = g2 ? (fac ? a2c * ch.proc_ratio[i] : a2c) : amounts[d];
        avail_ship[d] = capd - (g2 ? raw : 0.0f);
        leaving = d == 0 ? raw : leaving + raw;
        cost[C_SHIP * P + p] += a2c * ch.ship_cost[i * D + d];
        if (ch.edge_mask[n * D + d]) {
          const int L = Ld[d];
          if (L >= 1 && L <= Lhi && (stoch || L == Lavg)) {
            const int dst = ch.edge_dst[n * D + d];
            upd[L * NP + dst * P + p] += a2c > 0.0f ? a2c : 0.0f;
          }
        }
      }
      stock[i] = s_g - leaving;
      if (fac) cost[C_PROCESS * P + p] += leaving * ch.proc_cost[i];
      cost[C_PROCESS_PEN * P + p] += exc_proc;
      cost[C_SHIP_PEN * P + p] += exc_ship;
    }
  }
  // one pipeline add per (lead-time, dst, product)
  for (int L = stoch ? 1 : Lavg; L <= Lhi; ++L)
    for (int i = 0; i < NP; ++i)
      ring[((t + L) % RING) * NP + i] += upd[L * NP + i];

  // ---- phase 5: retailer demand ------------------------------------------
  for (int ri = 0; ri < ch.R; ++ri) {
    const int n = ch.retailer_idx[ri];
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      const float d = dem[ri * P + p];
      const float ful = fminf(stock[i], d);
      stock[i] = stock[i] - ful;
      cost[C_UNMET * P + p] += d - ful;
    }
  }

  // ---- phase 6: holding costs, reward ------------------------------------
  for (int i = 0; i < NP; ++i) cost[C_STOCK * P + i % P] += stock[i] * ch.stock_cost[i];
  float total = 0.0f;
  for (int p = 0; p < P; ++p) {
    cost[C_STOCK_PEN * P + p] = ch.c_stock_pen * cost[C_STOCK_PEN * P + p];
    cost[C_PROCESS_PEN * P + p] = ch.c_proc_pen * cost[C_PROCESS_PEN * P + p];
    cost[C_SHIP_PEN * P + p] = ch.c_ship_pen * cost[C_SHIP_PEN * P + p];
    cost[C_UNMET * P + p] = ch.c_unmet * cost[C_UNMET * P + p];
  }
  for (int k = 0; k < 8 * P; ++k) total += cost[k];
  return -total;
}

__global__ void __launch_bounds__(128)
sc_collect_kernel(const ScChain* __restrict__ gch, int mode, int S, int B,
                  const float* __restrict__ dem_tab,
                  const int* __restrict__ lt_tab,
                  const float* __restrict__ act_tab, uint32_t k0, uint32_t k1,
                  float* __restrict__ obs, float* __restrict__ rew,
                  float* __restrict__ stock_out) {
  __shared__ ScChain ch;
  copy_chain(gch, &ch);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const int NP = ch.N * ch.P, T = ch.T, A = ch.A, O = ch.obs_dim;
  const size_t Bz = (size_t)B;

  float stock[SC_MAX_NP], ring[SC_MAX_RING * SC_MAX_NP];
  float a[SC_MAX_A], dem[SC_MAX_RP];
  int lt_row[SC_MAX_K];

  for (int s = 0; s < S; ++s) {
    const int te = s % T;
    if (te == 0) sc_episode_init(ch, stock, ring);

    // ---- this step's inputs: actions, lead-time row, demand row --------
    if (mode == MODE_RANDOM) {
      sc_draw_inputs(ch, b, s, k0, k1, A, a, lt_row, dem);
      for (int i = 0; i < A; ++i) a[i] = 2.0f * a[i] - 1.0f;
    } else {
      for (int i = 0; i < A; ++i) a[i] = act_tab[((size_t)s * A + i) * Bz + b];
      sc_read_inputs(ch, s, b, Bz, dem_tab, lt_tab, lt_row, dem);
    }
    for (int i = 0; i < A; ++i) a[i] = (a[i] + 1.0f) * 0.5f;

    sc_obs(ch, stock, ring, dem, te,
           ObsSink{obs + (size_t)s * O * Bz + b, Bz, nullptr});
    rew[(size_t)s * Bz + b] = sc_step(ch, stock, ring, a, lt_row, dem, te + 1);
  }
  if (stock_out != nullptr)
    for (int i = 0; i < NP; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
}

// ---- the policy kernel's MLP ----------------------------------------------
struct MlpLayer {
  int K, J, Jp, w_off, b_off;
};

__device__ __forceinline__ MlpLayer mlp_layer(const int* lay, int net, int l) {
  const int* r = lay + MLP_HEADER + (net * (MLP_MAX_L + 1) + l) * MLP_PER_LAYER;
  return MlpLayer{r[0], r[1], r[2], r[3], r[4]};
}

// y[j][e] = act(sum_k w[j][k] * x[k][e] + b[j]) for the block's 32 envs e;
// Wt is w transposed, [K][Jp]; x and y are [rows][PK_ENVS].  Warp w takes
// rows 8w..8w+7, then 8w+32.., one env column a lane.  The sum over k runs
// in order from the k = 0 product (--fmad=false keeps each product rounded).
__device__ __forceinline__ void mlp_forward(const float* Wt, const float* bias,
                                            const MlpLayer& L, const float* x,
                                            float* y, bool tanh_act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = warp * 8; j0 < L.J; j0 += PK_WARPS * 8) {
    float acc[8];
    {
      const float xv = x[lane];
      const float4 w0 = *reinterpret_cast<const float4*>(Wt + j0);
      const float4 w1 = *reinterpret_cast<const float4*>(Wt + j0 + 4);
      acc[0] = w0.x * xv; acc[1] = w0.y * xv; acc[2] = w0.z * xv;
      acc[3] = w0.w * xv; acc[4] = w1.x * xv; acc[5] = w1.y * xv;
      acc[6] = w1.z * xv; acc[7] = w1.w * xv;
    }
    for (int k = 1; k < L.K; ++k) {
      const float xv = x[k * PK_ENVS + lane];
      const float* wr = Wt + (size_t)k * L.Jp + j0;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
      acc[0] = acc[0] + w0.x * xv; acc[1] = acc[1] + w0.y * xv;
      acc[2] = acc[2] + w0.z * xv; acc[3] = acc[3] + w0.w * xv;
      acc[4] = acc[4] + w1.x * xv; acc[5] = acc[5] + w1.y * xv;
      acc[6] = acc[6] + w1.z * xv; acc[7] = acc[7] + w1.w * xv;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (j0 + r < L.J) {
        const float h = acc[r] + bias[j0 + r];
        y[(j0 + r) * PK_ENVS + lane] = tanh_act ? tanhf(h) : h;
      }
    }
  }
}

// one network (0 actor, 1 critic) on the obs tile; its head lands in `head`
__device__ __forceinline__ void mlp_net(const int* lay, const float* wsec,
                                        int net, const float* xs, float* hA,
                                        float* hB, float* head) {
  const int nL = lay[0];
  const float* x = xs;
  for (int l = 0; l <= nL; ++l) {
    const MlpLayer L = mlp_layer(lay, net, l);
    float* y = l == nL ? head : (l % 2 == 0 ? hA : hB);
    mlp_forward(wsec + L.w_off, wsec + L.b_off, L, x, y, l < nL);
    __syncthreads();
    x = y;
  }
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(PK_THREADS)
sc_policy_kernel(const ScChain* __restrict__ gch, const int* __restrict__ glay,
                 const float* __restrict__ gw, int mode, int S, int B,
                 const float* __restrict__ dem_tab,
                 const int* __restrict__ lt_tab,
                 const float* __restrict__ eps_tab, uint32_t k0, uint32_t k1,
                 int sample_major, float* __restrict__ obs,
                 float* __restrict__ act_pre, float* __restrict__ logp_out,
                 float* __restrict__ value_out, float* __restrict__ rew,
                 float* __restrict__ stock_out) {
  __shared__ ScChain ch;
  __shared__ int lay[MLP_LAYOUT_INTS];
  extern __shared__ float4 dyn[];
  copy_chain(gch, &ch);
  for (int i = threadIdx.x; i < MLP_LAYOUT_INTS; i += blockDim.x) lay[i] = glay[i];
  __syncthreads();
  const int O = lay[1], A = lay[2], Hmax = lay[9];
  const int nw = lay[3] + lay[4];  // both sections, a multiple of 8 floats
  const int hrow_a = mlp_layer(lay, 0, lay[0]).Jp;
  float* W = reinterpret_cast<float*>(dyn);
  {
    const float4* src = reinterpret_cast<const float4*>(gw);
    for (int i = threadIdx.x; i < nw / 4; i += blockDim.x) dyn[i] = src[i];
  }
  float* xs = W + nw;                   // obs tile [O][32]
  float* hA = xs + O * PK_ENVS;         // hidden activations [Hmax][32]
  float* hB = hA + Hmax * PK_ENVS;
  float* mu_s = hB + Hmax * PK_ENVS;    // actor head [Jp][32]
  float* v_s = mu_s + hrow_a * PK_ENVS; // critic head [8][32]
  const float* W_actor = W;
  const float* W_critic = W + lay[3];
  const float* log_std = W + lay[5];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * PK_ENVS + lane;
  const bool env = warp == 0 && b < B;
  const int T = ch.T;
  const size_t Bz = (size_t)B, SB = (size_t)S * B;

  float stock[SC_MAX_NP], ring[SC_MAX_RING * SC_MAX_NP];
  float a[SC_MAX_A], eps[SC_MAX_A], dem[SC_MAX_RP];
  float noise[2 * SC_MAX_A];
  int lt_row[SC_MAX_K];

  for (int s = 0; s < S; ++s) {
    const int te = s % T;
    if (env) {
      if (te == 0) sc_episode_init(ch, stock, ring);
      if (mode == MODE_POLICY) {
        // 2A noise uniforms, then lead-times, then demands
        sc_draw_inputs(ch, b, s, k0, k1, 2 * A, noise, lt_row, dem);
        for (int i = 0; i < A; ++i) {
          const float r = sqrtf(-2.0f * log1pf(-noise[i]));
          eps[i] = r * cosf(TWO_PI_F * noise[A + i]);
        }
      } else {
        for (int i = 0; i < A; ++i) eps[i] = eps_tab[((size_t)s * A + i) * Bz + b];
        sc_read_inputs(ch, s, b, Bz, dem_tab, lt_tab, lt_row, dem);
      }
      const ObsSink sink =
          sample_major ? ObsSink{obs + (size_t)s * Bz + b, SB, xs + lane}
                       : ObsSink{obs + (size_t)s * O * Bz + b, Bz, xs + lane};
      sc_obs(ch, stock, ring, dem, te, sink);
    } else if (warp == 0) {
      for (int o = 0; o < O; ++o) xs[o * PK_ENVS + lane] = 0.0f;
    }
    __syncthreads();
    mlp_net(lay, W_actor, 0, xs, hA, hB, mu_s);
    mlp_net(lay, W_critic, 1, xs, hA, hB, v_s);
    if (env) {
      // sampled tanh-Gaussian action and its log-density
      float lp = 0.0f;
      for (int i = 0; i < A; ++i) {
        const float ls = fminf(fmaxf(log_std[i], LOG_STD_MIN), LOG_STD_MAX);
        const float sd = expf(ls);
        const float mu = mu_s[i * PK_ENVS + lane];
        const float pre = mu + sd * eps[i];
        const float z = (pre - mu) / sd;
        const float g = -0.5f * (z * z + 2.0f * ls + LOG_2PI_F);
        const float corr = 2.0f * (LN2_F - pre - softplus_f(-2.0f * pre));
        const float term = g - corr;
        lp = i == 0 ? term : lp + term;
        const size_t at = sample_major ? (size_t)i * SB + (size_t)s * Bz + b
                                       : ((size_t)s * A + i) * Bz + b;
        act_pre[at] = pre;
        a[i] = (tanhf(pre) + 1.0f) * 0.5f;
      }
      logp_out[(size_t)s * Bz + b] = lp;
      value_out[(size_t)s * Bz + b] = v_s[lane];
      rew[(size_t)s * Bz + b] = sc_step(ch, stock, ring, a, lt_row, dem, te + 1);
    }
    // the next step's obs tile is written after every warp read this one
    __syncthreads();
  }
  if (env && stock_out != nullptr)
    for (int i = 0; i < ch.N * ch.P; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
}

extern "C" int sc_collect_launch(const void* chain, int chain_bytes, int mode,
                                 int S, int B, const float* dem_tab,
                                 const int* lt_tab, const float* act_tab,
                                 unsigned int k0, unsigned int k1, float* obs,
                                 float* rew, float* stock_out, void* stream) {
  if (chain_bytes != (int)sizeof(ScChain)) return -1;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sc_collect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const ScChain*)chain, mode, S, B, dem_tab, lt_tab, act_tab, k0, k1, obs,
      rew, stock_out);
  return (int)cudaGetLastError();
}

extern "C" int sc_policy_launch(const void* chain, int chain_bytes,
                                const int* layout, const float* weights,
                                int smem_bytes, int mode, int S, int B,
                                const float* dem_tab, const int* lt_tab,
                                const float* eps_tab, unsigned int k0,
                                unsigned int k1, int sample_major, float* obs,
                                float* act_pre, float* logp, float* value,
                                float* rew, float* stock_out, void* stream) {
  if (chain_bytes != (int)sizeof(ScChain)) return -1;
  if (mode != MODE_POLICY && mode != MODE_POLICY_EPS) return -3;
  cudaError_t e = cudaFuncSetAttribute(
      sc_policy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + PK_ENVS - 1) / PK_ENVS;
  sc_policy_kernel<<<blocks, PK_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const ScChain*)chain, layout, weights, mode, S, B, dem_tab, lt_tab,
      eps_tab, k0, k1, sample_major, obs, act_pre, logp, value, rew,
      stock_out);
  return (int)cudaGetLastError();
}

extern "C" int sc_chain_bytes() { return (int)sizeof(ScChain); }
extern "C" int mlp_layout_ints() { return MLP_LAYOUT_INTS; }

extern "C" const char* gst_error_string(int code) {
  if (code == -1) return "chain descriptor size differs from ScChain";
  if (code == -2) return "beer game levels or ring exceed the kernel limits";
  if (code == -3) return "unknown collect mode";
  if (code == -4) return "MLP layout differs from the kernel's";
  return cudaGetErrorString((cudaError_t)code);
}

// The supply-chain environment step, shared by the collect kernels of
// supplychain_collect.cu (K1, K4/K6a) and the dense collect kernel of
// supplychain_dense.cu (K5): the chain descriptor, the episode init, the
// pre-action observation and the six phases of one step, written once.
//
// Each function is a template over where an environment's state lives and
// where its inputs come from:
// * state (stock [N*P], pipeline ring [RING*N*P], delivery sums): a
//   per-thread array (a plain pointer) in K1, or an env's column of a
//   shared-memory tile [rows][E] in K5 (`Strided`);
// * inputs (the step's actions scaled to [0, 1], lead-time row, demand
//   row): per-thread arrays in K1 (`LocalIn`), table rows or Philox words
//   read at their use in K5.
// The chain descriptor is `ChainT` at the kernel's size limits (`ScChain`
// for K1, `DnChain` for K5).
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
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
#define MODE_SEEDED 4

// Layout mirrored field for field by ops/supplychain_collect.py
// (_desc_fields); every field is 4 bytes, so there is no padding.
// Indexing: np = n*P + p, nd = n*dmax + d, npd = np*dmax + d,
// pipe row h at h*N*P + np.
template <int MN, int MP, int MNP, int MD, int MND, int MNPD, int MRING,
          int MRP, int MCDF>
struct ChainT {
  static constexpr int MAX_N = MN, MAX_P = MP, MAX_D = MD;
  int N, P, R, A, K, T, Lavg, Lmax, H, ring, dmax, obs_dim;
  int stochastic, n_cdf, any_factory, pad0;
  float c_unmet, c_stock_pen, c_proc_pen, c_ship_pen;
  float init_stock[MNP];
  float stock_cap[MNP];
  float stock_cost[MNP];
  float supply_cap[MNP];
  float supply_cost[MNP];
  float proc_cost[MNP];
  float proc_ratio[MNP];
  float ms[MNP];       // obs normalizer max_ship (1 where it is 0)
  float ms_tail[MNP];  // ms * (Lmax - (Lavg - 1)), in float32
  int has_supply[MNP];
  int has_ship[MNP];
  int sup_act_idx[MNP];
  int ms_ok[MNP];
  int cap_finite[MNP];
  float proc_cap[MN];
  int is_factory[MN];
  int lt_base[MN];
  int node_ships[MN];
  int node_deg[MN];    // edge slots in use (a prefix of the dmax slots)
  int edge_dst[MND];
  int edge_mask[MND];
  float ship_cap_edge[MND];
  float ship_cost[MNPD];
  int ship_act_idx[MNPD];
  float init_pipe[MRING * MNP];
  int retailer_idx[MRP];
  float dem_min[MP];
  float dem_range[MP];
  float dem_n[MP];   // uniform demand: floor(u * n) + lo
  float dem_lo[MP];
  float cdf[MCDF];   // lead-time thresholds: 1 + sum(u >= cdf[j])
};

// an env's array as one column of a shared-memory tile [rows][stride]
struct Strided {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[i * stride];
  }
};

// a step's inputs in per-thread arrays, the actions already in [0, 1]
struct LocalIn {
  const float* a;
  const int* lt_row;
  const float* d;
  __device__ __forceinline__ float act(int i) { return a[i]; }
  __device__ __forceinline__ int lt(int k) { return lt_row[k]; }
  __device__ __forceinline__ float dem(int j) { return d[j]; }
};

__device__ __forceinline__ float clip_pm1(float x) {
  // 2x - 1 clipped to [-1, 1]; comparisons keep a nan, as jnp.clip does
  float y = 2.0f * x - 1.0f;
  y = y < -1.0f ? -1.0f : y;
  return y > 1.0f ? 1.0f : y;
}

// ---- episode init: initial stock, seeded pipeline -------------------------
template <class Ch, class V>
__device__ __forceinline__ void sc_episode_init(const Ch& ch, V stock, V ring) {
  const int NP = ch.N * ch.P;
  for (int i = 0; i < NP; ++i) stock[i] = ch.init_stock[i];
  for (int r = 0; r < ch.ring; ++r)
    for (int i = 0; i < NP; ++i)
      ring[r * NP + i] =
          (r >= 1 && r <= ch.H) ? ch.init_pipe[(r - 1) * NP + i] : 0.0f;
}

// ---- pre-action observation (core/step.py obs_fn) -------------------------
template <class Ch, class V, class DV, class Sink>
__device__ __forceinline__ void sc_obs(const Ch& ch, V stock, V ring, DV dem,
                                       int te, const Sink& out) {
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

// ---- phases 1-6 of one step -------------------------------------------------
// `upd` holds the step's delivery sums, rows 0..RING-1 of N*P.
template <class Ch, class V, class In>
__device__ __forceinline__ float sc_step(const Ch& ch, V stock, V ring, V upd,
                                         In& in, int t) {
  const int N = ch.N, P = ch.P, NP = N * P, D = ch.dmax, RING = ch.ring;
  const int K = ch.K, Lavg = ch.Lavg, Lmax = ch.Lmax;
  const bool stoch = ch.stochastic != 0;
  float cost[8 * Ch::MAX_P];
  int nfired[Ch::MAX_N];

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
      const float amt = in.act(ch.sup_act_idx[i]) * ch.supply_cap[i];
      cost[C_SUPPLY * P + p] += amt * ch.supply_cost[i];
      const bool fired = amt > 0.0f;
      int L = Lavg;
      if (stoch) {  // column = base + #earlier fired supplies at the node
        L = in.lt(min(ch.lt_base[n] + nf, K - 1));
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
    const int deg = ch.node_deg[n];
    float avail_proc = ch.proc_cap[n];
    float avail_ship[Ch::MAX_D];
    int Ld[Ch::MAX_D];
    for (int d = 0; d < D; ++d) {
      avail_ship[d] = ch.ship_cap_edge[n * D + d];
      // transport columns follow the fired supplies, shared by products
      Ld[d] = stoch ? in.lt(min(ch.lt_base[n] + nfired[n] + d, K - 1)) : Lavg;
    }
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      float v[Ch::MAX_D], cut[Ch::MAX_D], amounts[Ch::MAX_D],
          to_ship[Ch::MAX_D];
      int rank[Ch::MAX_D];
      for (int d = 0; d < D; ++d)
        v[d] = (ch.has_ship[i] && ch.edge_mask[n * D + d])
                   ? in.act(ch.ship_act_idx[i * D + d])
                   : 0.0f;
      const float s_g = stock[i];
      // The slots past the node's degree hold v = 0.  While the stock and
      // every value are >= 0 they take zero cuts and leave the clamp's
      // remainder as it is, so the loops stop at the degree (the degree
      // groups of the TPU kernel); otherwise they run over all dmax slots
      // as the plain version does.
      int Dn = D;
      if (deg < D && s_g >= 0.0f) {
        bool nonneg = true;
        for (int d = 0; d < deg; ++d) nonneg = nonneg && v[d] >= 0.0f;
        if (nonneg) Dn = deg;
      }
      // sorted cut: predecessor and rank in the stable ascending sort
      for (int d = 0; d < Dn; ++d) {
        float w = -INFINITY;
        int r = 0;
        for (int j = 0; j < Dn; ++j) {
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
      for (int k = 0; k < Dn; ++k) {
        float cut_k = 0.0f;
        for (int d = 0; d < Dn; ++d) cut_k += (rank[d] == k) ? cut[d] : 0.0f;
        const float amt_k = fminf(cut_k, availr);
        availr = availr - amt_k;
        for (int d = 0; d < Dn; ++d) amounts[d] += (rank[d] == k) ? amt_k : 0.0f;
      }
      for (int d = 0; d < Dn; ++d)
        if (!ch.edge_mask[n * D + d]) amounts[d] = 0.0f;

      // processing-capacity clip, sequential over destinations
      float exc_proc = 0.0f;
      if (ch.any_factory) {
        for (int d = 0; d < Dn; ++d) {
          const float ai = amounts[d];
          const bool gate = fac && ai > 0.0f;
          const bool over = gate && ai > avail_proc;
          exc_proc = exc_proc + (over ? ai - avail_proc : 0.0f);
          const float ai2 = over ? avail_proc : ai;
          avail_proc = avail_proc - (gate ? ai2 : 0.0f);
          amounts[d] = ai2;
        }
      }
      for (int d = 0; d < Dn; ++d)
        to_ship[d] = (ch.any_factory && fac) ? amounts[d] / ch.proc_ratio[i]
                                             : amounts[d];

      // ship-capacity clip, bug-compatible shared-capacity bookkeeping
      float exc_ship = 0.0f, leaving = 0.0f;
      for (int d = 0; d < Dn; ++d) {
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
      const float d = in.dem(ri * P + p);
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

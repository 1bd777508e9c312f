// Supply-chain trajectory collection, one thread per environment.
//
// Replaces the TPU collect kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py (modes `random` and
// `actions`).  Each thread runs its env through S = episodes * T steps with
// auto-reset at every episode boundary, writing the pre-action observation
// obs[s, :, b] and the reward rew[s, b] of every step.  The per-env state
// (stock [N*P], pipeline ring [RING*N*P]) lives in per-thread arrays; the
// topology tables are one ScChain descriptor, copied to shared memory per
// block and read with loops over nodes, products and destinations at run
// time.  Stores of [.., B] rows are coalesced across a warp.
//
// Bounds on the card: the step is branchy scalar float work with indices
// known only at run time, so the state sits in local memory (L1) and the
// kernel is latency-bound; the only large traffic is the obs stream
// (S * O * B * 4 bytes).  At B = 4096 and 128 threads a block, 32 blocks
// occupy 32 of the H100's 132 SMs.
//
// Floating-point rules (the plain version, core/step.py, follows the same):
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

__global__ void __launch_bounds__(128)
sc_collect_kernel(const ScChain* __restrict__ gch, int mode, int S, int B,
                  const float* __restrict__ dem_tab,
                  const int* __restrict__ lt_tab,
                  const float* __restrict__ act_tab, uint32_t k0, uint32_t k1,
                  float* __restrict__ obs, float* __restrict__ rew,
                  float* __restrict__ stock_out) {
  __shared__ ScChain ch;
  {
    const int* src = reinterpret_cast<const int*>(gch);
    int* dst = reinterpret_cast<int*>(&ch);
    for (int i = threadIdx.x; i < (int)(sizeof(ScChain) / 4); i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const int N = ch.N, P = ch.P, NP = N * P, D = ch.dmax, RING = ch.ring;
  const int T = ch.T, A = ch.A, K = ch.K, RP = ch.R * P, O = ch.obs_dim;
  const int Lavg = ch.Lavg, Lmax = ch.Lmax, H = ch.H;
  const bool stoch = ch.stochastic != 0;
  const int Kr = stoch ? K : 0;
  const size_t Bz = (size_t)B;

  float stock[SC_MAX_NP], ring[SC_MAX_RING * SC_MAX_NP];
  float upd[SC_MAX_RING * SC_MAX_NP];
  float a[SC_MAX_A], dem[SC_MAX_RP], cost[8 * SC_MAX_P];
  int lt_row[SC_MAX_K], nfired[SC_MAX_N];

  for (int s = 0; s < S; ++s) {
    const int te = s % T, t = te + 1;
    if (te == 0) {  // episode init: initial stock, seeded pipeline
      for (int i = 0; i < NP; ++i) stock[i] = ch.init_stock[i];
      for (int r = 0; r < RING; ++r)
        for (int i = 0; i < NP; ++i)
          ring[r * NP + i] =
              (r >= 1 && r <= H) ? ch.init_pipe[(r - 1) * NP + i] : 0.0f;
    }

    // ---- this step's inputs: actions, lead-time row, demand row --------
    if (mode == MODE_RANDOM) {
      const int U = A + Kr + RP;
      for (int blk = 0; blk * 4 < U; ++blk) {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)s, (uint32_t)blk, 0u), k0, k1);
        for (int q = 0; q < 4; ++q) {
          const int i = blk * 4 + q;
          if (i >= U) break;
          const float u = uniform01(philox_word(w, q));
          if (i < A) {
            a[i] = 2.0f * u - 1.0f;
          } else if (i < A + Kr) {
            int lt = 1;
            for (int j = 0; j < ch.n_cdf; ++j) lt += (u >= ch.cdf[j]);
            lt_row[i - A] = lt;
          } else {
            const int j = i - A - Kr, p = j % P;
            dem[j] = floorf(u * ch.dem_n[p]) + ch.dem_lo[p];
          }
        }
      }
    } else {
      for (int i = 0; i < A; ++i) a[i] = act_tab[((size_t)s * A + i) * Bz + b];
      for (int k = 0; k < Kr; ++k)
        lt_row[k] = lt_tab[((size_t)s * K + k) * Bz + b];
      for (int j = 0; j < RP; ++j)
        dem[j] = dem_tab[((size_t)s * RP + j) * Bz + b];
    }
    for (int i = 0; i < A; ++i) a[i] = (a[i] + 1.0f) * 0.5f;

    // ---- pre-action observation (core/step.py obs_fn) ------------------
    {
      float* orow = obs + (size_t)s * O * Bz + b;
      int o = 0;
      for (int j = 0; j < RP; ++j) {
        const int p = j % P;
        orow[(size_t)(o++) * Bz] =
            clip_pm1((dem[j] - ch.dem_min[p]) / ch.dem_range[p]);
      }
      for (int n = 0; n < N; ++n) {
        for (int p = 0; p < P; ++p) {
          const int i = n * P + p;
          orow[(size_t)(o++) * Bz] = clip_pm1(stock[i] / ch.stock_cap[i]);
        }
        for (int p = 0; p < P; ++p) {
          const int i = n * P + p;
          const bool ok = ch.ms_ok[i] != 0;
          // pipe[j] (arriving at te + 1 + j) sits in ring slot (t + j) % RING
          for (int j = 0; j < Lavg - 1; ++j) {
            const float x = ring[((t + j) % RING) * NP + i];
            orow[(size_t)(o++) * Bz] = clip_pm1(ok ? x / ch.ms[i] : 0.0f);
          }
          float tail = ring[((t + Lavg - 1) % RING) * NP + i];
          for (int j = Lavg; j < H; ++j) tail = tail + ring[((t + j) % RING) * NP + i];
          orow[(size_t)(o++) * Bz] = clip_pm1(ok ? tail / ch.ms_tail[i] : 0.0f);
        }
      }
      orow[(size_t)o * Bz] = clip_pm1((float)(T - te) / (float)T);
    }

    for (int i = 0; i < 8 * P; ++i) cost[i] = 0.0f;

    // ---- phases 1+2: arrivals, stock-capacity penalty -------------------
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

    // ---- phase 3: supply ------------------------------------------------
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

    // ---- phase 4: ship ---------------------------------------------------
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

    // ---- phase 5: retailer demand ----------------------------------------
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

    // ---- phase 6: holding costs, reward ----------------------------------
    for (int i = 0; i < NP; ++i) cost[C_STOCK * P + i % P] += stock[i] * ch.stock_cost[i];
    float total = 0.0f;
    for (int p = 0; p < P; ++p) {
      cost[C_STOCK_PEN * P + p] = ch.c_stock_pen * cost[C_STOCK_PEN * P + p];
      cost[C_PROCESS_PEN * P + p] = ch.c_proc_pen * cost[C_PROCESS_PEN * P + p];
      cost[C_SHIP_PEN * P + p] = ch.c_ship_pen * cost[C_SHIP_PEN * P + p];
      cost[C_UNMET * P + p] = ch.c_unmet * cost[C_UNMET * P + p];
    }
    for (int k = 0; k < 8 * P; ++k) total += cost[k];
    rew[(size_t)s * Bz + b] = -total;
  }
  if (stock_out != nullptr)
    for (int i = 0; i < NP; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
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

extern "C" int sc_chain_bytes() { return (int)sizeof(ScChain); }

extern "C" const char* gst_error_string(int code) {
  if (code == -1) return "chain descriptor size differs from ScChain";
  if (code == -2) return "beer game levels or ring exceed the kernel limits";
  return cudaGetErrorString((cudaError_t)code);
}

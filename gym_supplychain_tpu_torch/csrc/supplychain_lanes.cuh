// The lane-group supply-chain env step and the kernel built on it: each
// environment on a group of G lanes (part of a warp), E envs a block, the
// env's state in shared memory.
//
// One kernel template, sc_lane_kernel<G, E, DT, OBS>, serves three kernels
// on one chain descriptor (DnChain then DnEdges below), and the step serves
// a fourth kernel template, sc_policy_lane_kernel (supplychain_policy.cu:
// K1's policy modes and K4, the actor in the loop):
// * K5, the dense collect kernel (supplychain_dense.cu): G = 16, E = 8,
//   modes `random` and `actions`, obs every step;
// * K1 in its modes `random` and `actions` (supplychain_lanes.cu): the same
//   collection on the small chains, G and E from the planner;
// * K6a in its modes `seeded` and `actions` (supplychain_episode.cu): one
//   episode, rewards and final stock only (OBS = 0).
// G and E come from the host-side planner (lane_block in
// ops/supplychain_dense.py): K5 keeps 16 lanes and 8 envs (16 beat 8 and 32
// on the large-topology chains); the small chains take the least of
// 4, 8 and 16 lanes that holds max(N*P, shipping nodes).  Registers are
// capped at 128 a thread (__launch_bounds__), so K5's 4 blocks an SM hold all
// of B = 4096 envs at once; a small chain's kernel needs far fewer.
//
// Replaces, with its wrappers, the TPU kernels `_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas_dense.py (K5),
// `_collect_kernel` (K1) and `_kernel` (K6a) of
// gym_supplychain_tpu/ops/supplychain_pallas.py.  Each env runs through S
// steps with auto-reset every T steps (K6a: S = T); the dynamics match the
// plain version (core/step.py) bit for bit: the step below follows
// core/step.py operation for operation (the float rules of
// supplychain_step.cuh: --fmad=false, IEEE division, every product
// rounded), spread over lanes.
//
// An env's state is a contiguous stretch of dynamic shared memory: stock
// [N*P], pipeline ring [RING*N*P], the demand row [R*P], the step's shipped
// amount per (edge, product) and lead-time per edge, the fired-supply count
// per node and, with OBS, its observation [O].  The chain descriptor
// (DnChain, 42 KB at the limits below, and DnEdges) stays in device memory
// behind the read-only cache: a copy per block would cost each block what
// an env's state costs several times over (a copy per block left room for 2
// blocks of K5 an SM, and ran slower on the H100).
//
// A step, phase by phase (each phase's items over the group's lanes, a
// warp sync where a phase reads what another lane wrote):
// * arrivals, stock penalty, holding cost: lanes over (node, product) rows;
// * supply: lanes over nodes, products inner, so the per-node fired count
//   and the lead-time columns it selects stay in one lane;
// * ship: one shipping node a lane, products inner (the processing and
//   per-destination ship capacities carry across products); the degree
//   elision (slots past a node's degree skipped while every value is >= 0)
//   is per (node, product).  Each edge's shipped amount goes to its own
//   slot;
// * pipeline adds: the lane of each (destination, product) adds its
//   incoming edges' amounts, per lead-time, in (source node, slot) order,
//   then onto pipe + supply: core/step.py's order, so the ring stays
//   bit-exact;
// * retailer demand: lanes over (retailer, product).
// Costs are per-lane partials per category, summed over the group by a
// fixed shuffle tree; rewards differ from plain in that order only (~1e-7
// relative).  With OBS the observation is computed by lanes into the env's
// stretch and written out by the whole block, o-major, in runs of E
// consecutive envs (E >= 8: one 32-byte sector a run or more).
//
// Inputs are read where the step uses them, by the lane that uses them:
// * `actions`: action a[i] of step s at act_tab[(s * A + i) * B + b], lead-
//   time column k at lt_tab[(s * K + k) * B + b], the demand row from
//   [S, R, P, B] (K6a: [T+1, R, P, B]); a block's envs read neighbouring
//   words, which L2 serves from one sector.
// * `random` (OBS): the same rows from Philox4x32-10 at counter (b, s,
//   block, 0): A action uniforms, then K lead-time uniforms (stochastic
//   chains), then R*P demand uniforms.  A lane caches one Philox block for
//   the actions and one for the lead-times (a node's columns are
//   consecutive); the demand row's blocks go one a lane.  So `random` is
//   `actions` fed the tables ops/supplychain_collect.py's philox_tables
//   makes.
// * `seeded` (no OBS): the actions from Philox, the first A words at
//   counter (b, s, block, 0) as `random` draws them; lead-times and demand
//   from the tables.  So `seeded` is `actions` fed the table
//   ops/supplychain_episode.py's seeded_actions makes.
//
// Bounds on the card: the work that must reach memory is the obs stream
// (S * O * B * 4 bytes) or, without it, the tables read and the rewards
// written.  The step is branchy scalar float work over N*P*Dmax^2 sorted-cut
// pairs at run-time indices: latency-bound, which the lane groups (more
// threads, shorter serial chains a thread) and the warps an SM address.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "supplychain_step.cuh"

#define DN_MAX_N 64
#define DN_MAX_P 16
#define DN_MAX_NP 128
#define DN_MAX_D 16
#define DN_MAX_ND 1024
#define DN_MAX_NPD 2048
#define DN_MAX_RING 8
#define DN_MAX_RP 128
#define DN_MAX_CDF 8

using DnChain = ChainT<DN_MAX_N, DN_MAX_P, DN_MAX_NP, DN_MAX_D, DN_MAX_ND,
                       DN_MAX_NPD, DN_MAX_RING, DN_MAX_RP, DN_MAX_CDF>;

// The edges as the lanes walk them, right after DnChain in the descriptor
// (ops/supplychain_dense.py dense_edges).  Edges are the (node, slot) pairs
// of shipping nodes with edge_mask set, numbered in (node, slot) order.
struct DnEdges {
  int n_edges, n_ship, pad0, pad1;
  int ship_list[DN_MAX_N];   // the shipping nodes, in index order
  int edge_id[DN_MAX_ND];    // n * dmax + d -> edge number, -1 for none
  int in_ptr[DN_MAX_N + 1];  // node m's incoming edges: in_edge[in_ptr[m]..]
  int in_edge[DN_MAX_ND];    // edge numbers, in (source node, slot) order
};

// an env's stretch of shared memory
struct LnEnv {
  float *stock, *ring, *dem, *eval, *obs;
  int *eL, *nfired;
};

// words of an env's stretch before its observation (obs_off), and with it
__device__ __forceinline__ int ln_env_words(const DnChain& ch, int n_edges,
                                            int& obs_off) {
  const int NP = ch.N * ch.P;
  obs_off = NP * (1 + ch.ring) + ch.R * ch.P + n_edges * (ch.P + 1) + ch.N;
  return obs_off + ch.obs_dim;
}

// `actions`: this step's rows of the tables at env b
struct LnTabIn {
  const float* a_row;  // act_tab + s * A * B + b
  const int* lt_row;   // lt_tab + s * K * B + b (stochastic chains)
  size_t B;
  __device__ __forceinline__ float act(int i) {
    return (__ldg(a_row + (size_t)i * B) + 1.0f) * 0.5f;
  }
  __device__ __forceinline__ int lt(int k) {
    return __ldg(lt_row + (size_t)k * B);
  }
};

// `random`: word `pos` of this step's Philox row, drawn at its use
struct LnPhiloxIn {
  const DnChain* ch;
  uint32_t b, s, k0, k1;
  int A;
  int blk_a, blk_l;  // the Philox block cached for actions / lead-times
  uint4 w_a, w_l;
  __device__ __forceinline__ float u_at(int pos, int& blk, uint4& w) {
    const int q = pos >> 2;
    if (q != blk) {
      w = philox4x32_10(make_uint4(b, s, (uint32_t)q, 0u), k0, k1);
      blk = q;
    }
    return uniform01(philox_word(w, pos & 3));
  }
  __device__ __forceinline__ float act(int i) {
    const float x = 2.0f * u_at(i, blk_a, w_a) - 1.0f;
    return (x + 1.0f) * 0.5f;
  }
  __device__ __forceinline__ int lt(int k) {
    const float u = u_at(A + k, blk_l, w_l);
    int v = 1;
    for (int j = 0; j < ch->n_cdf; ++j) v += (u >= ch->cdf[j]);
    return v;
  }
};

// `seeded`: the actions from Philox, the lead-times from the table
struct LnSeededIn {
  LnPhiloxIn ph;
  LnTabIn tab;
  __device__ __forceinline__ float act(int i) { return ph.act(i); }
  __device__ __forceinline__ int lt(int k) { return tab.lt(k); }
};

// ---- episode init: initial stock, seeded pipeline -------------------------
template <int G>
__device__ __forceinline__ void ln_init(const DnChain& ch, const LnEnv& env,
                                        int g) {
  const int NP = ch.N * ch.P;
  for (int i = g; i < NP; i += G) {
    env.stock[i] = ch.init_stock[i];
    for (int r = 0; r < ch.ring; ++r)
      env.ring[r * NP + i] =
          (r >= 1 && r <= ch.H) ? ch.init_pipe[(r - 1) * NP + i] : 0.0f;
  }
}

// ---- pre-action observation (core/step.py obs_fn): the demand entries
// over the lanes, then a (node, product) row a lane with its stock and
// pipeline entries
template <int G>
__device__ __forceinline__ void ln_obs(const DnChain& ch, const LnEnv& env,
                                       int te, int g) {
  const int N = ch.N, P = ch.P, NP = N * P, RING = ch.ring, RP = ch.R * P;
  const int Lavg = ch.Lavg, H = ch.H, T = ch.T, t = te + 1;
  const int PL = P * (1 + Lavg);
  for (int j = g; j < RP; j += G) {
    const int p = j % P;
    env.obs[j] = clip_pm1((env.dem[j] - ch.dem_min[p]) / ch.dem_range[p]);
  }
  for (int i = g; i < NP; i += G) {
    const int n = i / P, p = i - n * P;
    float* o = env.obs + RP + n * PL;
    o[p] = clip_pm1(env.stock[i] / ch.stock_cap[i]);
    o += P + p * Lavg;
    const bool ok = ch.ms_ok[i] != 0;
    // pipe[j] (arriving at te + 1 + j) sits in ring slot (t + j) % RING
    for (int j = 0; j < Lavg - 1; ++j) {
      const float x = env.ring[((t + j) % RING) * NP + i];
      o[j] = clip_pm1(ok ? x / ch.ms[i] : 0.0f);
    }
    float tail = env.ring[((t + Lavg - 1) % RING) * NP + i];
    for (int j = Lavg; j < H; ++j) tail = tail + env.ring[((t + j) % RING) * NP + i];
    o[Lavg - 1] = clip_pm1(ok ? tail / ch.ms_tail[i] : 0.0f);
  }
  if (g == 0) env.obs[RP + N * PL] = clip_pm1((float)(T - te) / (float)T);
}

// ---- phase 4 at one shipping node n, its products in order.  DT >= dmax
// is the kernel's compile-time degree: every loop over slots unrolls, so
// the slot arrays live in registers; the sorted cut and the clips stop at
// the run-time Dn as core/step.py's do.
template <int DT, class In>
__device__ __forceinline__ void ln_ship_node(const DnChain& ch,
                                             const DnEdges& ed,
                                             const LnEnv& env, In& in, int n,
                                             float (&cst)[8]) {
  const int P = ch.P, D = ch.dmax, K = ch.K, Lavg = ch.Lavg;
  const bool stoch = ch.stochastic != 0;
  const int Lhi = stoch ? ch.Lmax : Lavg;
  const bool fac = ch.is_factory[n] != 0;
  const int deg = ch.node_deg[n];
  float avail_proc = ch.proc_cap[n];
  float avail_ship[DT];
  const int nfn = env.nfired[n];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (d >= D) break;
    avail_ship[d] = ch.ship_cap_edge[n * D + d];
    // transport columns follow the fired supplies, shared by products
    const int L = stoch ? in.lt(min(ch.lt_base[n] + nfn + d, K - 1)) : Lavg;
    const int e = ed.edge_id[n * D + d];
    if (e >= 0)  // the lead-time the edge's amounts arrive at, 0 for none
      env.eL[e] = (L >= 1 && L <= Lhi && (stoch || L == Lavg)) ? L : 0;
  }
  for (int p = 0; p < P; ++p) {
    const int i = n * P + p;
    float v[DT], w[DT], amounts[DT];
    int rank[DT];
    const bool hs = ch.has_ship[i] != 0;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      v[d] = (d < D && hs && ch.edge_mask[n * D + d])
                 ? in.act(ch.ship_act_idx[i * D + d])
                 : 0.0f;
    const float s_g = env.stock[i];
    // The slots past the node's degree hold v = 0.  While the stock and
    // every value are >= 0 they take zero cuts and leave the clamp's
    // remainder as it is, so the loops stop at the degree; otherwise they
    // run over all dmax slots as the plain version does.
    int Dn = D;
    if (deg < D && s_g >= 0.0f) {
      bool nonneg = true;
#pragma unroll
      for (int d = 0; d < DT; ++d) nonneg = nonneg && (d >= deg || v[d] >= 0.0f);
      if (nonneg) Dn = deg;
    }
    // sorted cut: predecessor and rank in the stable ascending sort
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float wd = -INFINITY;
      int r = 0;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bool before =
            j < Dn && ((v[j] < v[d]) || (v[j] == v[d] && j < d));
        if (before) {
          wd = fmaxf(wd, v[j]);
          ++r;
        }
      }
      w[d] = r == 0 ? 0.0f : wd;
      rank[d] = d < Dn ? r : -1;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      v[d] = (v[d] - w[d]) * s_g;  // the cut
      amounts[d] = 0.0f;
    }
    float availr = s_g;
    for (int k = 0; k < Dn; ++k) {
      float cut_k = 0.0f;
#pragma unroll
      for (int d = 0; d < DT; ++d) cut_k += (rank[d] == k) ? v[d] : 0.0f;
      const float amt_k = fminf(cut_k, availr);
      availr = availr - amt_k;
#pragma unroll
      for (int d = 0; d < DT; ++d) amounts[d] += (rank[d] == k) ? amt_k : 0.0f;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (d < Dn && !ch.edge_mask[n * D + d]) amounts[d] = 0.0f;

    // processing-capacity clip, sequential over destinations
    float exc_proc = 0.0f;
    if (ch.any_factory) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d >= Dn) break;
        const float ai = amounts[d];
        const bool gate = fac && ai > 0.0f;
        const bool over = gate && ai > avail_proc;
        exc_proc = exc_proc + (over ? ai - avail_proc : 0.0f);
        const float ai2 = over ? avail_proc : ai;
        avail_proc = avail_proc - (gate ? ai2 : 0.0f);
        amounts[d] = ai2;
      }
    }

    // ship-capacity clip, bug-compatible shared-capacity bookkeeping
    float exc_ship = 0.0f, leaving = 0.0f;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d >= Dn) break;
      const float a2 = (ch.any_factory && fac) ? amounts[d] / ch.proc_ratio[i]
                                               : amounts[d];
      const float capd = avail_ship[d];
      const bool g2 = a2 > 0.0f && a2 > capd;
      exc_ship += g2 ? a2 - capd : 0.0f;
      const float a2c = g2 ? capd : a2;
      const float raw = g2 ? (fac ? a2c * ch.proc_ratio[i] : a2c) : amounts[d];
      avail_ship[d] = capd - (g2 ? raw : 0.0f);
      leaving = d == 0 ? raw : leaving + raw;
      cst[C_SHIP] += a2c * ch.ship_cost[i * D + d];
      const int e = ed.edge_id[n * D + d];
      if (e >= 0) env.eval[e * P + p] = a2c > 0.0f ? a2c : 0.0f;
    }
    env.stock[i] = s_g - leaving;
    if (fac) cst[C_PROCESS] += leaving * ch.proc_cost[i];
    cst[C_PROCESS_PEN] += exc_proc;
    cst[C_SHIP_PEN] += exc_ship;
  }
}

// ---- phases 1-6 of one step (core/step.py), over the group's G lanes -----
template <int G, int DT, class In>
__device__ __forceinline__ float ln_step(const DnChain& ch, const DnEdges& ed,
                                         const LnEnv& env, In& in, int t,
                                         int g) {
  const int N = ch.N, P = ch.P, NP = N * P, RING = ch.ring;
  const int K = ch.K, Lavg = ch.Lavg, Lmax = ch.Lmax;
  const bool stoch = ch.stochastic != 0;
  const int Lhi = stoch ? Lmax : Lavg;
  float cst[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) cst[c] = 0.0f;

  // ---- phases 1+2: arrivals, stock-capacity penalty ---------------------
  const int slot0 = t % RING;
  for (int i = g; i < NP; i += G) {
    float sv = env.stock[i] + env.ring[slot0 * NP + i];
    const float cap = ch.stock_cap[i];
    if (ch.cap_finite[i]) {
      const float ex = sv - cap;
      cst[C_STOCK_PEN] += ex > 0.0f ? ex : 0.0f;
    }
    env.stock[i] = fminf(sv, cap);
    env.ring[slot0 * NP + i] = 0.0f;
  }

  // ---- phase 3: supply, a node a lane ----------------------------------
  for (int n = g; n < N; n += G) {
    int nf = 0;
    for (int p = 0; p < P; ++p) {
      const int i = n * P + p;
      if (!ch.has_supply[i]) continue;
      const float amt = in.act(ch.sup_act_idx[i]) * ch.supply_cap[i];
      cst[C_SUPPLY] += amt * ch.supply_cost[i];
      const bool fired = amt > 0.0f;
      int L = Lavg;
      if (stoch) {  // column = base + #earlier fired supplies at the node
        L = in.lt(min(ch.lt_base[n] + nf, K - 1));
        nf += fired;
      }
      if (fired && L >= 1 && (!stoch || L <= Lmax))
        env.ring[((t + L) % RING) * NP + i] += amt;
    }
    env.nfired[n] = nf;
  }
  __syncwarp();

  // ---- phase 4: ship, a shipping node a lane ----------------------------
  for (int sl = g; sl < ed.n_ship; sl += G)
    ln_ship_node<DT>(ch, ed, env, in, ed.ship_list[sl], cst);
  __syncwarp();

  // ---- pipeline adds: per (lead-time, destination, product), incoming
  // edges in (source node, slot) order, then one add onto pipe + supply
  for (int i = g; i < NP; i += G) {
    const int m = i / P, p = i - m * P;
    const int k0 = ed.in_ptr[m], k1 = ed.in_ptr[m + 1];
    for (int L = stoch ? 1 : Lavg; L <= Lhi; ++L) {
      float s = 0.0f;
      for (int k = k0; k < k1; ++k) {
        const int e = ed.in_edge[k];
        if (env.eL[e] == L) s += env.eval[e * P + p];
      }
      env.ring[((t + L) % RING) * NP + i] += s;
    }
  }

  // ---- phase 5: retailer demand, lanes over (retailer, product) -----------
  for (int j = g; j < ch.R * P; j += G) {
    const int ri = j / P, p = j - ri * P;
    const int i = ch.retailer_idx[ri] * P + p;
    const float d = env.dem[j];
    const float ful = fminf(env.stock[i], d);
    env.stock[i] = env.stock[i] - ful;
    cst[C_UNMET] += d - ful;
  }
  __syncwarp();

  // ---- phase 6: holding costs, reward ------------------------------------
  for (int i = g; i < NP; i += G) cst[C_STOCK] += env.stock[i] * ch.stock_cost[i];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      cst[c] += __shfl_xor_sync(0xffffffffu, cst[c], off, G);
  const float total = cst[C_STOCK] + ch.c_stock_pen * cst[C_STOCK_PEN] +
                      cst[C_SUPPLY] + cst[C_PROCESS] +
                      ch.c_proc_pen * cst[C_PROCESS_PEN] + cst[C_SHIP] +
                      ch.c_ship_pen * cst[C_SHIP_PEN] + ch.c_unmet * cst[C_UNMET];
  return -total;
}

// ---- the kernel: E envs a block, G lanes an env ----------------------------
// OBS = 1: modes `random` / `actions`, S steps with auto-reset, obs [S,O,B]
// written; OBS = 0: modes `seeded` / `actions`, one episode (S = T), no obs.
// Every lane of the block runs every step (an env past B steps a real env's
// rows and writes nothing), so the warp syncs and shuffles see full warps.
// Internal linkage: each source that launches an instance builds its own.
template <int G, int E, int DT, int OBS>
static __global__ void __launch_bounds__(G * E, 512 / (G * E))
sc_lane_kernel(const DnChain* __restrict__ gch, int mode, int S, int B,
               int stride, const float* __restrict__ dem_tab,
               const int* __restrict__ lt_tab,
               const float* __restrict__ act_tab, uint32_t k0, uint32_t k1,
               float* __restrict__ obs, float* __restrict__ rew,
               float* __restrict__ stock_out) {
  static_assert((G * E) % 32 == 0 && 32 % G == 0, "whole warps of groups");
  extern __shared__ float sm[];
  const DnChain& ch = *gch;
  const DnEdges& ed = *reinterpret_cast<const DnEdges*>(gch + 1);
  const int tid = threadIdx.x, e = tid / G, g = tid % G;
  const int b = blockIdx.x * E + e;
  const bool active = b < B;
  const int bb = active ? b : B - 1;  // inactive lanes read a real env's rows

  const int NP = ch.N * ch.P, RP = ch.R * ch.P, T = ch.T, A = ch.A;
  const int O = ch.obs_dim, NE = ed.n_edges;
  const int Kr = ch.stochastic ? ch.K : 0;
  const size_t Bz = (size_t)B;
  int obs_off;
  const int words = ln_env_words(ch, NE, obs_off);
  if ((OBS ? words : obs_off) > stride || ch.dmax > DT) __trap();
  float* base = sm + (size_t)e * stride;
  LnEnv env;
  env.stock = base;
  env.ring = base + NP;
  env.dem = env.ring + ch.ring * NP;
  env.eval = env.dem + RP;
  env.eL = reinterpret_cast<int*>(env.eval + NE * ch.P);
  env.nfired = env.eL + NE;
  env.obs = base + obs_off;
  for (int k = g; k < NE; k += G) env.eL[k] = 0;

  for (int s = 0; s < S; ++s) {
    const int te = s % T;
    if (te == 0) ln_init<G>(ch, env, g);
    // the step's demand row
    if (OBS && mode == MODE_RANDOM) {
      const int w0 = A + Kr, q0 = w0 >> 2, q1 = (w0 + RP - 1) >> 2;
      for (int q = q0 + g; q <= q1; q += G) {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)s, (uint32_t)q, 0u), k0, k1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * q + c - w0;
          if (j >= 0 && j < RP) {
            const int p = j % ch.P;
            const float u = uniform01(philox_word(w, c));
            env.dem[j] = floorf(u * ch.dem_n[p]) + ch.dem_lo[p];
          }
        }
      }
    } else {
      for (int j = g; j < RP; j += G)
        env.dem[j] = __ldg(dem_tab + ((size_t)s * RP + j) * Bz + bb);
    }
    __syncwarp();
    if (OBS) {
      ln_obs<G>(ch, env, te, g);
      __syncthreads();
      // the block's observations, o-major, E consecutive envs a run
      float* obs_s = obs + (size_t)s * O * Bz;
      for (int idx = tid; idx < O * E; idx += E * G) {
        const int o = idx / E, ee = idx % E;
        const int bo = blockIdx.x * E + ee;
        if (bo < B) obs_s[(size_t)o * Bz + bo] = sm[(size_t)ee * stride + obs_off + o];
      }
    }
    float r;
    if (OBS && mode == MODE_RANDOM) {
      LnPhiloxIn in{gch, (uint32_t)b, (uint32_t)s, k0, k1, A, -1, -1,
                    make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      r = ln_step<G, DT>(ch, ed, env, in, te + 1, g);
    } else {
      LnTabIn in{act_tab + (size_t)s * A * Bz + bb,
                 ch.stochastic ? lt_tab + (size_t)s * ch.K * Bz + bb : nullptr,
                 Bz};
      if (!OBS && mode == MODE_SEEDED) {
        LnSeededIn sd{{gch, (uint32_t)b, (uint32_t)s, k0, k1, A, -1, -1,
                        make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)},
                       in};
        r = ln_step<G, DT>(ch, ed, env, sd, te + 1, g);
      } else {
        r = ln_step<G, DT>(ch, ed, env, in, te + 1, g);
      }
    }
    if (active && g == 0) rew[(size_t)s * Bz + b] = r;
    // the next step's observation is staged after the block wrote this one
    if (OBS) __syncthreads();
  }
  if (stock_out != nullptr && active)
    for (int i = g; i < NP; i += G) stock_out[(size_t)i * Bz + b] = env.stock[i];
}

// the checks of a launch entry: descriptor size, mode, shared memory
__host__ inline int ln_check(int desc_bytes, int mode, int obs, int E,
                             int stride, int smem_bytes) {
  if (desc_bytes != (int)(sizeof(DnChain) + sizeof(DnEdges))) return -1;
  if (mode != MODE_ACTIONS && mode != (obs ? MODE_RANDOM : MODE_SEEDED))
    return -3;
  if ((size_t)E * stride * 4 > (size_t)smem_bytes) return -5;
  return 0;
}

template <int G, int E, int DT, int OBS>
static int ln_launch(const void* chain, int mode, int S, int B, int stride,
                     int smem_bytes, const float* dem_tab, const int* lt_tab,
                     const float* act_tab, unsigned int k0, unsigned int k1,
                     float* obs, float* rew, float* stock_out,
                     cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sc_lane_kernel<G, E, DT, OBS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + E - 1) / E;
  sc_lane_kernel<G, E, DT, OBS><<<blocks, G * E, smem_bytes, stream>>>(
      (const DnChain*)chain, mode, S, B, stride, dem_tab, lt_tab, act_tab, k0,
      k1, obs, rew, stock_out);
  return (int)cudaGetLastError();
}

// A launch entry's case for the instance (g, e, dt, o) of the kernel; the
// entry (sc_dense_launch, sc_lane_launch, sc_episode_launch) has every name
// used here.
#define LN_CASE(g, e, dt, o)                                                 \
  if (G == g && E == e && DT == dt && OBS == o)                              \
    return ln_launch<g, e, dt, o>(chain, mode, S, B, stride, smem_bytes,     \
                                  dem_tab, lt_tab, act_tab, k0, k1, obs, rew, \
                                  stock_out, (cudaStream_t)stream);

// The arguments of the launch entries
#define LN_ENTRY_ARGS                                                        \
  const void *chain, int desc_bytes, int mode, int S, int B, int G, int E,   \
      int DT, int OBS, int stride, int smem_bytes, const float *dem_tab,     \
      const int *lt_tab, const float *act_tab, unsigned int k0,              \
      unsigned int k1, float *obs, float *rew, float *stock_out, void *stream

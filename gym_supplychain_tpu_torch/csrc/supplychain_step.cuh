// The supply-chain chain descriptor, cost categories, collect modes and
// float rules shared by the lane-group step (supplychain_lanes.cuh) and the
// kernels built on it: K1, K4, K5, K6a.  The step itself follows the plain
// version (core/step.py) operation for operation.
//
// The chain descriptor is `ChainT` at a kernel's size limits: `DnChain`
// (supplychain_lanes.cuh) for every kernel; `ScChain` (supplychain_collect.cu)
// mirrors ops/supplychain_collect.py's `chain_descriptor` at the collect
// kernel's smaller limits `_MAX`.
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
#define MODE_GREEDY 5

// demand processes (rng/device.py DEMAND_KINDS)
#define DEM_UNIFORM 0
#define DEM_NORMAL 1
#define DEM_SEASONAL_NORMAL 2
#define DEM_SEASONAL_UNIFORM 3

// Layout mirrored field for field by ops/supplychain_collect.py
// (_desc_fields); every field is 4 bytes, so there is no padding.
// Indexing: np = n*P + p, nd = n*dmax + d, npd = np*dmax + d,
// pipe row h at h*N*P + np.
template <int MN, int MP, int MNP, int MD, int MND, int MNPD, int MRING,
          int MRP, int MCDF>
struct ChainT {
  static constexpr int MAX_N = MN, MAX_P = MP, MAX_D = MD;
  int N, P, R, A, K, T, Lavg, Lmax, H, ring, dmax, obs_dim;
  int stochastic, n_cdf, any_factory, any_normal;
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
  // product p's demand process (rng/device.py demand_constants), its
  // float32 constants folded on the host
  float dem_n[MP];   // uniform draw floor(u * n) + lo: the demand, or a
  float dem_lo[MP];  // seasonal process's uniform perturbation
  int dem_kind[MP];  // DEM_*
  float dem_std[MP];
  float dem_mid[MP];  // the normal's mean, (maxv + minv) / 2
  float dem_minv[MP];
  float dem_maxv[MP];
  float dem_minavg[MP];
  float dem_half[MP];   // (maxavg - minavg) / 2
  float dem_peaks[MP];  // sen_peaks * 2 pi
  float cdf[MCDF];   // lead-time thresholds: 1 + sum(u >= cdf[j])
};

__device__ __forceinline__ float clip_pm1(float x) {
  // 2x - 1 clipped to [-1, 1]; comparisons keep a nan, as jnp.clip does
  float y = 2.0f * x - 1.0f;
  y = y < -1.0f ? -1.0f : y;
  return y > 1.0f ? 1.0f : y;
}

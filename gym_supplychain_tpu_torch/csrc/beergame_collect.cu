// Beer-game trajectory collection (v0 and v2) and the rewards-only episode
// sweep, a lane per level.
//
// Replaces the TPU collect kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/beergame_pallas.py (K3) and its episode kernel
// `_episode_kernel` (beergame_episode_pallas, K6b).  The collect kernel
// plays S = episodes * weeks weeks with auto-reset at every episode
// boundary and writes the post-week observation obs[s, l, b] and reward
// rew[s, b].  Delays are a constant or a per-lane table; actions come from
// a table (`actions`) or from Philox (`random`: the low bits of word l % 4
// at counter (lane, step, l / 4, 0), masked to the power-of-two max_order).
// The episode sweep is the same kernel with EPISODE = 1: one v0 episode
// from a per-lane initial inventory inv0[l, b], actions from a table, a
// constant delay, and no obs stream; it writes only the weekly rewards.
// All arithmetic is int32 (wrapping), so both are bit-exact against their
// plain versions (core/beergame.py) in any order of the reward's sum.
//
// Layout: G lanes an env (the power of two at or above L, at least 4; lane
// l is level l, the others idle), E envs a block, as
// ops/beergame_collect.py's beergame_block plans them.  A lane's state is
// its level's inventory, backlog, last order and shipment pipeline, all in
// registers: the pipeline is a shift register of CAP slots (a template
// parameter, the ring rounded up to 4, 8 or 16), slot k the amount
// arriving k weeks from now, so receiving reads slot 0 and a delay d
// (1..max_delay) lands in slot d by an unrolled masked add.  The
// downstream level's last order and the upstream level's delivery come by
// warp shuffles; the reward is a shuffle sum over the env's lanes.  In
// `random`, the 4 lanes of a level group draw 4 weeks' Philox calls at
// once and pass each week's words by shuffles.  Weeks run in unrolled
// runs of 4 (the sweep 8) without a branch (counters and selects, no
// division), each week's demand, delay and action rows loaded a run ahead
// of use.
//
// Bounds on the card: a few integer ops a level and week; the collect
// kernel's bound is its obs and reward stores, the sweep's its demand and
// action reads, both far below what a dependent chain of a few hundred
// weeks takes with one warp a scheduler (B = 4096 envs of 4 lanes are 512
// warps for 528 schedulers): the kernels are latency-bound, so the design
// keeps the chain short, gives the scheduler independent work from the
// neighbouring weeks in one basic block, and spreads the envs over every
// SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define BG_MAX_L 16
#define BG_MAX_RING 16
#define BG_MAX_THREADS 256

// a [rows(, B)] int32 table read in place: week s reads row s % rows
struct BgTable {
  const int* p;
  int rows, row_stride, lane_stride;
};

struct BgArgs {
  int mode;  // 0 random, 1 actions
  int S, B, weeks, L, gshift, E;
  int per_lane, delay, max_delay, init_delay;
  int init_ship, init_orders, init_inv, inv_cost, backlog_cost;
  int max_order, v2, max_stock, penalty;
  uint32_t k0, k1;
  BgTable demand, delays;
};

// walks a table's rows week by week, wrapping at its last row (selects,
// no branch)
struct BgRows {
  const int* base;
  int r, rows, stride;

  __device__ __forceinline__ BgRows(const BgTable& t, int b) {
    base = t.p + (size_t)b * t.lane_stride;
    rows = t.rows;
    stride = t.row_stride;
    r = 0;
  }
  __device__ __forceinline__ int next() {
    const int v = __ldg(base + (size_t)r * stride);
    r = r + 1 == rows ? 0 : r + 1;
    return v;
  }
};

// G lanes an env (4, 8 or 16), a pipeline of CAP >= ring slots (4, 8 or
// 16: extra slots stay 0), EPISODE the sweep.  The week loop runs in
// unrolled runs of AHEAD weeks without a branch: S is padded to whole
// runs, stores past S are predicated off and loads past S read the last
// rows again; the episode reset is a select.
template <int G, int CAP, int EPISODE>
__global__ void __launch_bounds__(BG_MAX_THREADS)
bg_collect_kernel(BgArgs g, const int* __restrict__ actions,
                  const int* __restrict__ inv0, int* __restrict__ obs,
                  int* __restrict__ rew) {
  constexpr unsigned FULL = 0xffffffffu;
  // weeks of input rows in flight, and of a run: the sweep's action rows
  // come from memory, the collect kernel's mostly from L1, where a shorter
  // run keeps its code small (a multiple of 4: the Philox runs)
  constexpr int AHEAD = EPISODE ? 8 : 4;
  const int L = g.L, S = g.S;
  const int l = threadIdx.x % G;
  const int env = blockIdx.x * g.E + threadIdx.x / G;
  // a lane past B replays the last env and writes nothing: every lane of
  // the warp takes part in the shuffles
  const bool live = env < g.B;
  const int b = live ? env : g.B - 1;
  const bool level = l < L;
  const int lc = level ? l : L - 1;
  const size_t Bz = (size_t)g.B, step = (size_t)L * Bz;
  const bool tab = EPISODE || g.mode == 1;
  const bool per_lane = !EPISODE && g.per_lane;
  const bool v2 = !EPISODE && g.v2;

  // input rows of week `next_s`, loaded AHEAD weeks ahead of use
  BgRows dem_rows(g.demand, b);
  BgRows dl_rows(per_lane ? g.delays : g.demand, b);
  const int* act_row = tab ? actions + (size_t)lc * Bz + b : actions;
  int next_s = 0;
  int q_dem[AHEAD], q_dl[AHEAD], q_act[AHEAD];
  auto load = [&](int u) {
    q_dem[u] = dem_rows.next();
    q_dl[u] = per_lane ? dl_rows.next() : g.delay;
    q_act[u] = tab ? __ldg(act_row) : 0;
    act_row = tab && next_s + 1 < S ? act_row + step : act_row;
    ++next_s;
  };
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) load(u);

  const int inv_start = EPISODE ? inv0[(size_t)lc * Bz + b] : g.init_inv;
  int pipe0[CAP], pipe[CAP];  // pipe[k]: arriving k weeks from now
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    pipe0[k] = k < g.init_delay ? g.init_ship : 0;
    pipe[k] = 0;
  }
  int* obs_row = obs + (size_t)lc * Bz + b;
  int* rew_row = rew + b;
  int inv = 0, back = 0, orders = 0, te = 0;
  // `random`: lane p of each group of 4 draws the Philox call of week
  // s + p of a run of 4 weeks (counter (b, s + p, l / 4, 0)); week s + j
  // takes its word l % 4 of lane j's call by shuffles
  const int quad = l & ~3, word = l & 3;
  uint4 wq = make_uint4(0u, 0u, 0u, 0u);

  for (int s0 = 0; s0 < S; s0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int s = s0 + u;
      const int dem = q_dem[u], dl = q_dl[u], act_in = q_act[u];
      // episode start
      const bool fresh = te == 0;
      inv = fresh ? inv_start : inv;
      back = fresh ? 0 : back;
      orders = fresh ? g.init_orders : orders;
#pragma unroll
      for (int k = 0; k < CAP; ++k) pipe[k] = fresh ? pipe0[k] : pipe[k];
      te = te + 1 == g.weeks ? 0 : te + 1;

      // 1. receive this week's shipment
      inv += pipe[0];
      // 2. fill orders: customer demand, then the downstream level's last
      //    order
      const int up = __shfl_up_sync(FULL, orders, 1, G);
      const int incoming = l == 0 ? dem : up;
      const int otf = incoming + back;
      const int td = min(inv, otf);
      // 3. deliveries downstream and the factory's self-supply: straight
      //    into inventory at delay 0, into slot d at 1..max_delay, else
      //    dropped
      const int from_up = __shfl_down_sync(FULL, td, 1, G);
      const int down = l == L - 1 ? orders : from_up;
      const int slot = (dl >= 1 && dl <= g.max_delay) ? dl : 0;
#pragma unroll
      for (int k = 0; k + 1 < CAP; ++k)
        pipe[k] = pipe[k + 1] + (slot == k + 1 ? down : 0);
      pipe[CAP - 1] = 0;
      // 4. record inventory / backlog
      inv = inv - td + (dl == 0 ? down : 0);
      back = otf - td;
      // 5. place orders
      int act = act_in;
      if (!EPISODE) {
        if (u % 4 == 0)
          wq = philox4x32_10(make_uint4((uint32_t)b, (uint32_t)(s + word),
                                        (uint32_t)(l >> 2), 0u),
                             g.k0, g.k1);
        const int src = quad | (u % 4);
        const uint4 w = make_uint4(__shfl_sync(FULL, wq.x, src, G),
                                   __shfl_sync(FULL, wq.y, src, G),
                                   __shfl_sync(FULL, wq.z, src, G),
                                   __shfl_sync(FULL, wq.w, src, G));
        const int drawn =
            (int)(philox_word(w, word) & (uint32_t)(g.max_order - 1));
        act = tab ? act_in : drawn;
      }
      orders = v2 ? act : incoming + act;
      // 6. observation and reward
      int cost = g.inv_cost * inv + g.backlog_cost * back;
      const int pen = max(inv - g.max_stock, 0) + max(back - g.max_stock, 0);
      cost = v2 ? cost + g.penalty * pen : cost;
      const bool played = s < S;  // not a padding week
      if (!EPISODE && played && live && level)
        *obs_row = (v2 ? g.max_stock : 0) + inv - back;
      obs_row += step;
      cost = level ? cost : 0;
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2)
        cost += __shfl_down_sync(FULL, cost, o, G);
      if (played && live && l == 0) *rew_row = -cost;
      rew_row += Bz;

      load(u);
    }
  }
}

typedef void (*BgKernel)(BgArgs, const int*, const int*, int*, int*);

// the instance for G lanes and a ring of `ring` slots (1..16), rounded up
// to a pipeline of 4, 8 or 16
template <int EPISODE>
static BgKernel bg_kernel(int G, int ring) {
#define BG_CASE(GG, CAP)                         \
  if (G == GG && ring <= CAP)                    \
    return bg_collect_kernel<GG, CAP, EPISODE>;
  BG_CASE(4, 4) BG_CASE(4, 8) BG_CASE(4, 16)
  BG_CASE(8, 4) BG_CASE(8, 8) BG_CASE(8, 16)
  BG_CASE(16, 4) BG_CASE(16, 8) BG_CASE(16, 16)
#undef BG_CASE
  return nullptr;
}

// the plan's limits: 1..16 levels on G = 2^gshift >= max(L, 4) lanes, E
// envs a block within BG_MAX_THREADS threads, a ring of 1..BG_MAX_RING
// slots
static bool bg_plan_ok(int L, int ring, int gshift, int E) {
  return L >= 1 && L <= BG_MAX_L && ring >= 1 && ring <= BG_MAX_RING &&
         gshift >= 2 && gshift <= 4 && (1 << gshift) >= L && E >= 1 &&
         (E << gshift) <= BG_MAX_THREADS;
}

static int bg_launch(BgKernel kernel, const BgArgs& g, const int* actions,
                     const int* inv0, int* obs, int* rew, void* stream) {
  if (kernel == nullptr) return -2;
  const int blocks = (g.B + g.E - 1) / g.E;
  if (blocks > 0)
    kernel<<<blocks, g.E << g.gshift, 0, (cudaStream_t)stream>>>(
        g, actions, inv0, obs, rew);
  return (int)cudaGetLastError();
}

// K3: demand and per-lane delays as [rows(, B)] tables (rows, row stride,
// lane stride), read in place
extern "C" int bg_collect_launch(
    int mode, int S, int B, int weeks, int L, int ring, int per_lane,
    int delay, int max_delay, int init_delay, int init_ship, int init_orders,
    int init_inv, int inv_cost, int backlog_cost, int max_order, int v2,
    int max_stock, int penalty, int gshift, int E, int dem_rows,
    int dem_row_stride, int dem_lane_stride, int dl_rows, int dl_row_stride,
    int dl_lane_stride, const int* demand, const int* delays,
    const int* actions, unsigned int k0, unsigned int k1, int* obs, int* rew,
    void* stream) {
  if (!bg_plan_ok(L, ring, gshift, E)) return -2;
  if (mode != 0 && mode != 1) return -3;
  BgArgs g = {mode,       S,          B,         weeks,        L,
              gshift,     E,          per_lane,  delay,        max_delay,
              init_delay, init_ship,  init_orders, init_inv,   inv_cost,
              backlog_cost, max_order, v2,       max_stock,    penalty,
              k0,         k1,
              {demand, dem_rows, dem_row_stride, dem_lane_stride},
              {delays, dl_rows, dl_row_stride, dl_lane_stride}};
  return bg_launch(bg_kernel<0>(1 << gshift, ring), g, actions, nullptr,
                   obs, rew, stream);
}

// K6b: one v0 episode of `weeks` weeks, demand [weeks, B], constant delay,
// rewards only
extern "C" int bg_episode_launch(int weeks, int B, int L, int ring, int delay,
                                 int init_delay, int init_ship,
                                 int init_orders, int inv_cost,
                                 int backlog_cost, int gshift, int E,
                                 const int* demand, const int* actions,
                                 const int* inv0, int* rew, void* stream) {
  if (!bg_plan_ok(L, ring, gshift, E)) return -2;
  BgArgs g = {1,          weeks,      B,         weeks,        L,
              gshift,     E,          0,         delay,        delay,
              init_delay, init_ship,  init_orders, 0,          inv_cost,
              backlog_cost, 1,        0,         0,            0,
              0u,         0u,
              {demand, weeks, B, 1},
              {demand, weeks, B, 1}};
  return bg_launch(bg_kernel<1>(1 << gshift, ring), g, actions, inv0,
                   nullptr, rew, stream);
}

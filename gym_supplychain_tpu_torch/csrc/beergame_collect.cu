// Beer-game trajectory collection (v0 and v2), one thread per environment.
//
// Replaces the TPU collect kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/beergame_pallas.py.  Each thread plays
// S = episodes * weeks weeks with auto-reset at every episode boundary and
// writes the post-week observation obs[s, l, b] and reward rew[s, b].  The
// int32 state (inventory, backlog and orders [L], shipment ring [RING * L])
// lives in per-thread arrays.  Delays are a constant or a per-lane table;
// actions come from a table (`actions`) or from Philox (`random`: the low
// bits of word l % 4 at counter (lane, step, l / 4, 0), masked to the
// power-of-two max_order).  All arithmetic is integer, so the kernel is
// bit-exact against its plain version (core/beergame.py).
//
// Bounds on the card: a few integer ops per level and week; the kernel is
// bound by the obs and reward stores ((L + 1) * 4 bytes per env-week) and,
// at B = 4096 with 128 threads a block, fills 32 of the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define BG_MAX_L 16
#define BG_MAX_RING 16

struct BgArgs {
  int mode;  // 0 random, 1 actions
  int S, B, weeks, L, ring;
  int per_lane, delay, max_delay, init_delay;
  int init_ship, init_orders, init_inv, inv_cost, backlog_cost;
  int max_order, v2, max_stock, penalty;
  uint32_t k0, k1;
};

__global__ void __launch_bounds__(128)
bg_collect_kernel(BgArgs g, const int* __restrict__ demand,
                  const int* __restrict__ delays,
                  const int* __restrict__ actions, int* __restrict__ obs,
                  int* __restrict__ rew) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.B) return;
  const int L = g.L, RING = g.ring;
  const size_t Bz = (size_t)g.B;
  int inv[BG_MAX_L], back[BG_MAX_L], orders[BG_MAX_L], ring[BG_MAX_RING * BG_MAX_L];
  int incoming[BG_MAX_L], otf[BG_MAX_L], td[BG_MAX_L];

  for (int s = 0; s < g.S; ++s) {
    const int te = s % g.weeks, week = te + 1;
    if (te == 0) {
      for (int l = 0; l < L; ++l) {
        inv[l] = g.init_inv;
        back[l] = 0;
        orders[l] = g.init_orders;
      }
      for (int r = 0; r < RING; ++r)
        for (int l = 0; l < L; ++l)
          ring[r * L + l] = (r >= 1 && r <= g.init_delay) ? g.init_ship : 0;
    }
    // 1. receive this week's shipments; clear the slot
    const int slot = week % RING;
    for (int l = 0; l < L; ++l) {
      inv[l] += ring[slot * L + l];
      ring[slot * L + l] = 0;
    }
    // 2. fill orders: customer demand, then the downstream level's orders
    const int dem = demand[(size_t)s * Bz + b];
    for (int l = 0; l < L; ++l) {
      incoming[l] = l == 0 ? dem : orders[l - 1];
      otf[l] = incoming[l] + back[l];
      td[l] = min(inv[l], otf[l]);
    }
    // 3. deliveries downstream and the factory's self-supply
    const int dl = g.per_lane ? delays[(size_t)s * Bz + b] : g.delay;
    for (int l = 0; l < L; ++l) {
      const int down = l < L - 1 ? td[l + 1] : orders[L - 1];
      if (dl == 0)
        inv[l] += down;
      else if (dl >= 1 && dl <= g.max_delay)
        ring[((week + dl) % RING) * L + l] += down;
    }
    // 4. record inventory / backlog
    for (int l = 0; l < L; ++l) {
      inv[l] -= td[l];
      back[l] = otf[l] - td[l];
    }
    // 5. place orders
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    for (int l = 0; l < L; ++l) {
      int act;
      if (g.mode == 0) {
        if (l % 4 == 0)
          w = philox4x32_10(make_uint4((uint32_t)b, (uint32_t)s,
                                       (uint32_t)(l / 4), 0u),
                            g.k0, g.k1);
        act = (int)(philox_word(w, l % 4) & (uint32_t)(g.max_order - 1));
      } else {
        act = actions[((size_t)s * L + l) * Bz + b];
      }
      orders[l] = g.v2 ? act : incoming[l] + act;
    }
    // 6. observation and reward
    int reward = 0;
    for (int l = 0; l < L; ++l) {
      reward -= g.inv_cost * inv[l] + g.backlog_cost * back[l];
      if (g.v2) {
        const int pen = max(inv[l] - g.max_stock, 0) + max(back[l] - g.max_stock, 0);
        reward -= g.penalty * pen;
      }
      obs[((size_t)s * L + l) * Bz + b] =
          (g.v2 ? g.max_stock : 0) + inv[l] - back[l];
    }
    rew[(size_t)s * Bz + b] = reward;
  }
}

extern "C" int bg_collect_launch(int mode, int S, int B, int weeks, int L,
                                 int ring, int per_lane, int delay,
                                 int max_delay, int init_delay, int init_ship,
                                 int init_orders, int init_inv, int inv_cost,
                                 int backlog_cost, int max_order, int v2,
                                 int max_stock, int penalty,
                                 const int* demand, const int* delays,
                                 const int* actions, unsigned int k0,
                                 unsigned int k1, int* obs, int* rew,
                                 void* stream) {
  if (L > BG_MAX_L || ring > BG_MAX_RING) return -2;
  BgArgs g = {mode,      S,          B,         weeks,        L,
              ring,      per_lane,   delay,     max_delay,    init_delay,
              init_ship, init_orders, init_inv, inv_cost,     backlog_cost,
              max_order, v2,         max_stock, penalty,      k0,
              k1};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  bg_collect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, demand, delays, actions, obs, rew);
  return (int)cudaGetLastError();
}

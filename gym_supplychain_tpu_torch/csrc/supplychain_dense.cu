// K5: supply-chain trajectory collection for large chains (26-40 nodes and
// more), one thread per environment, its state in shared memory.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas_dense.py
// (make_supplychain_dense_collect_pallas) in its modes `random` and
// `actions`: S = episodes * T steps with auto-reset at every episode
// boundary, writing the pre-action observation obs[s, o, b] and the reward
// rew[s, b] of every step, and the final stock.  The step is the one of
// supplychain_step.cuh (the collect kernels' step, same floating-point
// rules), so the trajectory matches the plain version (core/step.py) bit
// for bit in the dynamics.
//
// Layout.  A block is one warp holding E <= 32 envs (E = 32 unless a
// chain's state would not fit), one thread per env.  An env's state is its
// column of shared-memory tiles [rows][E]: stock [N*P], the pipeline ring
// [RING*N*P], the step's delivery sums [RING*N*P] and the demand row
// [R*P]; lane-consecutive columns keep every access free of bank
// conflicts.  At [5,4,7,10] x 4 products that is 96 KB a block, so the
// dynamic shared memory is opted in beyond 48 KB.  The chain descriptor
// (DnChain, 42 KB at the limits below) stays in device memory; every
// thread of the warp reads the same field, a broadcast served from cache.
//
// What is not carried over from the TPU kernel: its batch-trailing lane
// tile, its grid of one step per program and, above all, its pre-gather of
// the action-indexed inputs into [S, N, P, Dmax, B] tables.  Here each step
// reads its inputs where the step uses them:
// * `actions`: action a[i] of step s from the table [S, A, B] at
//   (s * A + i) * B + b, lead-time column k from [S, K, B], the demand row
//   from [S, R, P, B] into the tile; each read is coalesced across the warp.
//   The action-indexed selects (sup_act_idx, ship_act_idx) and the
//   action-dependent lead-time columns (lt_base + fired rank) happen in the
//   step, as in the collect kernels.
// * `random`: the same rows from Philox4x32-10 at counter (lane, step,
//   block, 0): A action uniforms, then K lead-time uniforms (stochastic
//   chains), then R*P demand uniforms, as the collect kernel draws them; a
//   word is drawn where it is used, one Philox block cached for the actions
//   and one for the lead-times and demands (their reads run in order).  So
//   `random` is `actions` fed the tables ops/supplychain_collect.py's
//   philox_tables makes.
// The ship phase stops at a node's own degree where that is exact (see
// sc_step), which is what the TPU kernel's degree groups save.
//
// Bounds on the card: the work that must reach memory is the obs stream
// (S * O * B * 4 bytes, 2.09 GB an episode at [5,4,7,10] x 4 and B = 4096).
// The step is branchy scalar float work over N*P*Dmax^2 sorted-cut pairs at
// run-time indices, latency-bound with one warp a block; splitting an env's
// nodes across a warp is the next design (PERF.md).
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
#define DN_WARP 32

using DnChain = ChainT<DN_MAX_N, DN_MAX_P, DN_MAX_NP, DN_MAX_D, DN_MAX_ND,
                       DN_MAX_NPD, DN_MAX_RING, DN_MAX_RP, DN_MAX_CDF>;

// `actions`: this step's rows of the tables; the demand row in the tile
struct TableIn {
  const float* a_row;  // act_tab + s * A * B + b
  const int* lt_row;   // lt_tab + s * K * B + b (stochastic chains)
  Strided d;
  size_t B;
  __device__ __forceinline__ float act(int i) {
    return (a_row[(size_t)i * B] + 1.0f) * 0.5f;
  }
  __device__ __forceinline__ int lt(int k) { return lt_row[(size_t)k * B]; }
  __device__ __forceinline__ float dem(int j) { return d[j]; }
};

// `random`: word `pos` of this step's Philox row, drawn at its use
struct PhiloxIn {
  const DnChain* ch;
  uint32_t b, s, k0, k1;
  int A;
  Strided d;
  int blk_a, blk_l;  // the Philox block cached for actions / the rest
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
  __device__ __forceinline__ float dem(int j) { return d[j]; }
};

// obs values go straight to their global column
struct GlobalSink {
  float* g;
  size_t stride;
  __device__ __forceinline__ void operator()(int o, float v) const {
    g[(size_t)o * stride] = v;
  }
};

__global__ void __launch_bounds__(DN_WARP)
sc_dense_kernel(const DnChain* __restrict__ gch, int mode, int S, int B, int E,
                const float* __restrict__ dem_tab,
                const int* __restrict__ lt_tab,
                const float* __restrict__ act_tab, uint32_t k0, uint32_t k1,
                float* __restrict__ obs, float* __restrict__ rew,
                float* __restrict__ stock_out) {
  extern __shared__ float sm[];
  const DnChain& ch = *gch;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * E + lane;
  if (lane >= E || b >= B) return;

  const int NP = ch.N * ch.P, RP = ch.R * ch.P, T = ch.T, A = ch.A;
  const int O = ch.obs_dim, RING = ch.ring;
  const int Kr = ch.stochastic ? ch.K : 0;
  const size_t Bz = (size_t)B;
  const Strided stock{sm + lane, E};
  const Strided ring{sm + NP * E + lane, E};
  const Strided upd{sm + (1 + RING) * NP * E + lane, E};
  const Strided dem{sm + (1 + 2 * RING) * NP * E + lane, E};

  for (int s = 0; s < S; ++s) {
    const int te = s % T;
    if (te == 0) sc_episode_init(ch, stock, ring);
    const GlobalSink sink{obs + (size_t)s * O * Bz + b, Bz};
    float r;
    if (mode == MODE_RANDOM) {
      PhiloxIn in{gch, (uint32_t)b, (uint32_t)s, k0, k1, A, dem, -1, -1,
                  make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      for (int j = 0; j < RP; ++j) {
        const int p = j % ch.P;
        const float u = in.u_at(A + Kr + j, in.blk_l, in.w_l);
        dem[j] = floorf(u * ch.dem_n[p]) + ch.dem_lo[p];
      }
      sc_obs(ch, stock, ring, dem, te, sink);
      r = sc_step(ch, stock, ring, upd, in, te + 1);
    } else {
      TableIn in{act_tab + (size_t)s * A * Bz + b,
                 ch.stochastic ? lt_tab + (size_t)s * ch.K * Bz + b : nullptr,
                 dem, Bz};
      for (int j = 0; j < RP; ++j) dem[j] = dem_tab[((size_t)s * RP + j) * Bz + b];
      sc_obs(ch, stock, ring, dem, te, sink);
      r = sc_step(ch, stock, ring, upd, in, te + 1);
    }
    rew[(size_t)s * Bz + b] = r;
  }
  if (stock_out != nullptr)
    for (int i = 0; i < NP; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
}

extern "C" int sc_dense_launch(const void* chain, int chain_bytes, int mode,
                               int S, int B, int E, int smem_bytes,
                               const float* dem_tab, const int* lt_tab,
                               const float* act_tab, unsigned int k0,
                               unsigned int k1, float* obs, float* rew,
                               float* stock_out, void* stream) {
  if (chain_bytes != (int)sizeof(DnChain)) return -1;
  if (mode != MODE_RANDOM && mode != MODE_ACTIONS) return -3;
  if (E < 1 || E > DN_WARP) return -5;
  cudaError_t e = cudaFuncSetAttribute(
      sc_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + E - 1) / E;
  sc_dense_kernel<<<blocks, DN_WARP, smem_bytes, (cudaStream_t)stream>>>(
      (const DnChain*)chain, mode, S, B, E, dem_tab, lt_tab, act_tab, k0, k1,
      obs, rew, stock_out);
  return (int)cudaGetLastError();
}

extern "C" int dn_chain_bytes() { return (int)sizeof(DnChain); }

// Supply-chain trajectory collection with the policy in the loop, and the
// greedy whole-episode rollout, one thread stepping each environment.
//
// Replaces the TPU collect kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py in its policy modes, and its
// episode kernel `_kernel` in mode `policy`.  Each env runs through S =
// episodes * T steps with auto-reset at every episode boundary.  The
// per-env state (stock [N*P], pipeline ring [RING*N*P]) lives in per-thread
// arrays; the topology tables are one ScChain descriptor, copied to shared
// memory per block and read with loops over nodes, products and
// destinations at run time.  Stores of [.., B] rows are coalesced across a
// warp.  (K1's modes `random` and `actions` and the rewards-only episode
// kernel K6a run on the lane-group step instead: supplychain_lanes.cu,
// supplychain_episode.cu.)
//
// * sc_policy_kernel (K1 `policy`, `policy_eps`): the sampled tanh-Gaussian
//   actor-critic in the loop.  A block of 4 warps holds 32
//   envs: warp 0 steps them (one thread per env), then all 4 warps run the
//   MLP together on the block's obs tile [O, 32] in shared memory, each
//   thread computing 8 output rows of one env's column.  The packed weights
//   (ops/_mlp.py; 173 KB for ntom at hidden (128, 128)) are copied into
//   dynamic shared memory once per launch, so at B = 4096 the 128 blocks
//   spread over 128 of the 132 SMs, one block each.  It writes obs, the
//   pre-tanh action, its log-prob, the critic's value and the reward.
// * sc_greedy_kernel (K4: `policy`): one episode of T steps from demand
//   [T+1,R,P,B] and lead-time [T,K,B] tables, writing only the reward [T,B]
//   and the final stock: sc_policy_kernel with the actor alone: warp 0
//   steps 32 envs, all 4 warps run the actor trunk and the mu head on the
//   obs tile, and the action is tanh(mu), with no noise and no critic.  Only
//   the actor section of the packed weights (88 KB for ntom at hidden
//   (128, 128)) is copied to shared memory.
//
// Bounds on the card: the step is branchy scalar float work with indices
// known only at run time, so the state sits in local memory (L1) and the
// step is latency-bound; the large traffic is the obs stream (S * O * B * 4
// bytes) and the tables read.  The MLP reads weights as shared-memory
// broadcasts and activations without bank conflicts; it is issue-bound (a
// rounded product and an add per weight per env), which makes the greedy
// kernel's floor its float32 multiply-adds (2 * 21,632 FLOP per env-step for
// ntom at (128, 128)).
//
// The step itself (chain descriptor, episode init, observation, the six
// phases) and its floating-point rules are in supplychain_step.cuh.  Beyond
// them: MLP layers accumulate w[j][k] * x[k]
// over k in order, starting from the k = 0 product, then add the bias; the
// log-prob sums its A terms in order; tanhf, expf, log1pf, cosf and sqrtf
// are the functions PyTorch's CUDA kernels call, so policy actions match
// the plain version bit for bit as well.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "supplychain_step.cuh"

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

using ScChain = ChainT<SC_MAX_N, SC_MAX_P, SC_MAX_NP, SC_MAX_D, SC_MAX_ND,
                       SC_MAX_NPD, SC_MAX_RING, SC_MAX_RP, SC_MAX_CDF>;

__device__ __forceinline__ void copy_chain(const ScChain* gch, ScChain* ch) {
  const int* src = reinterpret_cast<const int*>(gch);
  int* dst = reinterpret_cast<int*>(ch);
  for (int i = threadIdx.x; i < (int)(sizeof(ScChain) / 4); i += blockDim.x)
    dst[i] = src[i];
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

// the obs tile alone (the greedy kernel writes no obs stream)
struct TileSink {
  float* tile;  // [O][PK_ENVS] at this env's column
  __device__ __forceinline__ void operator()(int o, float v) const {
    tile[o * PK_ENVS] = v;
  }
};

// ---- the shared step (supplychain_step.cuh) on per-thread arrays --------
__device__ __forceinline__ float sc_step_local(const ScChain& ch, float* stock,
                                               float* ring, float* upd,
                                               const float* a,
                                               const int* lt_row,
                                               const float* dem, int t) {
  LocalIn in{a, lt_row, dem};
  return sc_step(ch, stock, ring, upd, in, t);
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
  float upd[SC_MAX_RING * SC_MAX_NP];
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
      rew[(size_t)s * Bz + b] = sc_step_local(ch, stock, ring, upd, a, lt_row, dem, te + 1);
    }
    // the next step's obs tile is written after every warp read this one
    __syncthreads();
  }
  if (env && stock_out != nullptr)
    for (int i = 0; i < ch.N * ch.P; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
}

// ---- K4: one episode of the greedy policy tanh(mu) ------------------------
__global__ void __launch_bounds__(PK_THREADS)
sc_greedy_kernel(const ScChain* __restrict__ gch, const int* __restrict__ glay,
                 const float* __restrict__ gw, int B,
                 const float* __restrict__ dem_tab,
                 const int* __restrict__ lt_tab, float* __restrict__ rew,
                 float* __restrict__ stock_out) {
  __shared__ ScChain ch;
  __shared__ int lay[MLP_LAYOUT_INTS];
  extern __shared__ float4 dyn[];
  copy_chain(gch, &ch);
  for (int i = threadIdx.x; i < MLP_LAYOUT_INTS; i += blockDim.x) lay[i] = glay[i];
  __syncthreads();
  const int O = lay[1], A = lay[2], Hmax = lay[9];
  const int nw = lay[3];  // the actor section, a multiple of 8 floats
  float* W = reinterpret_cast<float*>(dyn);
  {
    const float4* src = reinterpret_cast<const float4*>(gw);
    for (int i = threadIdx.x; i < nw / 4; i += blockDim.x) dyn[i] = src[i];
  }
  float* xs = W + nw;                   // obs tile [O][32]
  float* hA = xs + O * PK_ENVS;         // hidden activations [Hmax][32]
  float* hB = hA + Hmax * PK_ENVS;
  float* mu_s = hB + Hmax * PK_ENVS;    // actor head [Jp][32]
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * PK_ENVS + lane;
  const bool env = warp == 0 && b < B;
  const int T = ch.T;
  const size_t Bz = (size_t)B;

  float stock[SC_MAX_NP], ring[SC_MAX_RING * SC_MAX_NP];
  float upd[SC_MAX_RING * SC_MAX_NP];
  float a[SC_MAX_A], dem[SC_MAX_RP];
  int lt_row[SC_MAX_K];

  if (env) sc_episode_init(ch, stock, ring);
  for (int s = 0; s < T; ++s) {
    if (env) {
      sc_read_inputs(ch, s, b, Bz, dem_tab, lt_tab, lt_row, dem);
      sc_obs(ch, stock, ring, dem, s, TileSink{xs + lane});
    } else if (warp == 0) {
      for (int o = 0; o < O; ++o) xs[o * PK_ENVS + lane] = 0.0f;
    }
    __syncthreads();
    mlp_net(lay, W, 0, xs, hA, hB, mu_s);
    if (env) {
      for (int i = 0; i < A; ++i)
        a[i] = (tanhf(mu_s[i * PK_ENVS + lane]) + 1.0f) * 0.5f;
      rew[(size_t)s * Bz + b] = sc_step_local(ch, stock, ring, upd, a, lt_row, dem, s + 1);
    }
    // the next step's obs tile is written after every warp read this one
    __syncthreads();
  }
  if (env && stock_out != nullptr)
    for (int i = 0; i < ch.N * ch.P; ++i) stock_out[(size_t)i * Bz + b] = stock[i];
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

extern "C" int sc_greedy_launch(const void* chain, int chain_bytes,
                                const int* layout, const float* weights,
                                int smem_bytes, int B, const float* dem_tab,
                                const int* lt_tab, float* rew, float* stock_out,
                                void* stream) {
  if (chain_bytes != (int)sizeof(ScChain)) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      sc_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + PK_ENVS - 1) / PK_ENVS;
  sc_greedy_kernel<<<blocks, PK_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const ScChain*)chain, layout, weights, B, dem_tab, lt_tab, rew,
      stock_out);
  return (int)cudaGetLastError();
}

extern "C" int sc_chain_bytes() { return (int)sizeof(ScChain); }
extern "C" int mlp_layout_ints() { return MLP_LAYOUT_INTS; }

extern "C" const char* gst_error_string(int code) {
  if (code == -1) return "chain descriptor size differs from the kernel's";
  if (code == -2) return "beer game levels or ring exceed the kernel limits";
  if (code == -3) return "unknown collect mode";
  if (code == -4) return "MLP layout differs from the kernel's";
  if (code == -5) return "shared memory too small for the block's envs";
  if (code == -6) return "no lane-kernel instance for these lanes, envs and slots";
  return cudaGetErrorString((cudaError_t)code);
}

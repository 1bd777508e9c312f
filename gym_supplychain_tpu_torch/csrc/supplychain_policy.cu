// The supply-chain kernels with the actor in the loop, on the lane-group
// step of supplychain_lanes.cuh: K1's policy modes (the sampled
// tanh-Gaussian actor-critic, `policy` / `policy_eps`, obs in either layout)
// and K4 (one greedy episode, `greedy`).  One kernel template,
// sc_policy_lane_kernel<G, DT>: each env on a group of G lanes, E envs a
// block (E = 8, 16 or 32 at run time), the MLP run by every thread of the
// block.
//
// Replaces, with its wrappers (ops/supplychain_dense.py launch_policy_lanes),
// the TPU kernels `_collect_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py in its modes `policy` and
// `policy_eps` (make_supplychain_collect_pallas) and `_kernel` in its mode
// `policy` (make_supplychain_policy_rollout_pallas).  Each env runs through
// S steps with auto-reset every T steps (K4: S = T).
//
// Dynamic shared memory, a block (planned by policy_block in
// ops/supplychain_dense.py): the packed weights of the nets it runs
// (ops/_mlp.py: the actor section, then for K1 the critic's), copied once a
// block; two hidden tiles [Hmax][E]; the actor head [Jp][E] and for K1 the
// critic head [8][E]; then E env stretches of `stride` words (odd): the
// lane-group step's state and observation (supplychain_lanes.cuh) and the
// env's action [A], which the action phase forms for the step.  The MLP's
// input is the observation in the stretches: the odd stride puts a block's
// envs in distinct banks.  The chain descriptor (DnChain + DnEdges) stays in
// device memory behind the read-only cache, as for K6a and K5.
//
// A step: the group's lanes stage the demand row and the observation
// (ln_obs); the block writes the obs stream out (K1), o-major in runs of E
// envs, [S,O,B] or sample-major [O,S*B]; every thread runs the MLP (env
// columns over threads, rows over the rest, the k loop in order); the lanes
// form the action and take the step (ln_step, unchanged); lane 0 writes the
// reward (K1 also the log-prob and the value; every lane its act_pre).
//
// Float rules, beyond the step's (supplychain_step.cuh): a layer accumulates
// w[j][k] * x[k] over k in order from the k = 0 product, each product
// rounded (--fmad=false), then adds the bias, as ops/supplychain_collect.py
// _mlp_ordered does; the log-prob sums its A terms in order; tanhf, expf,
// log1pf, cosf and sqrtf are the functions PyTorch's CUDA kernels call.  So
// actions, log-probs and values match the plain version bit for bit, and
// the dynamics too (one ulp in tanh flips capacity gates downstream).
//
// Bounds on the card: the MLP is issue-bound.  The parity rule forbids FMA
// contraction, so each multiply-add is an FMUL and an FADD: 2 * 21,632
// instructions an env-step for ntom's actor at (128, 128), twice that with
// the critic.  Every warp of the block feeds the MLP (8 warps an SM for ntom
// at B = 4096); each thread keeps R = 8 rows of two env columns in
// registers (two broadcast LDS.128 of weights and two LDS of x per 32 float
// instructions, the k loop unrolled 4 deep), and the heads, too narrow for
// 8-row chunks on every thread, take one row a thread.  The step is
// latency-bound, as for the other lane-group kernels.
#include "supplychain_lanes.cuh"

// the packed MLP's layout ints (ops/_mlp.py)
#define MLP_MAX_L 4
#define MLP_HEADER 10
#define MLP_PER_LAYER 7
#define MLP_LAYOUT_INTS (MLP_HEADER + 2 * (MLP_MAX_L + 1) * MLP_PER_LAYER)

#define LOG_STD_MIN -5.0f
#define LOG_STD_MAX 2.0f
#define LOG_2PI_F 1.8378770664093453f   // log(2 pi), rounded as float
#define LN2_F 0.6931471805599453f        // log(2)

// env columns a thread takes in the MLP, each weight load serving all of
// them (2 measured 12-17% faster than 1 on the H100 for K4 and K1 on ntom)
#define PL_EPT 2
// threads a block at most (G * E), so that one block an SM may hold 255
// registers a thread: under a cap of 128 the 10-slot step spilled
#define PL_MAX_THREADS 256

struct MlpLayer {
  int K, J, Jp, w_off, b_off;
};

__device__ __forceinline__ MlpLayer mlp_layer(const int* lay, int net, int l) {
  const int* r = lay + MLP_HEADER + (net * (MLP_MAX_L + 1) + l) * MLP_PER_LAYER;
  return MlpLayer{r[0], r[1], r[2], r[3], r[4]};
}

template <int R>
__device__ __forceinline__ void pl_rows(const float* w, float (&v)[R]) {
  if constexpr (R == 8) {
    const float4 a = *reinterpret_cast<const float4*>(w);
    const float4 b = *reinterpret_cast<const float4*>(w + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (R == 4) {
    const float4 a = *reinterpret_cast<const float4*>(w);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = w[0];
  }
}

// y[j][e] = act(sum_k w[j][k] * x[k][e] + b[j]) for the block's E envs; Wt
// is w transposed, [K][Jp]; x[k][e] sits at x + k * xk + e * xe (the obs in
// the env stretches, or a hidden tile [K][E]); y is [J][E].  Thread t takes
// env columns c + q * ne (ne = E / PL_EPT, c = t % ne) and the R-row chunks
// j0 = R * (t / ne), stepping by R * (threads / ne).
template <int R>
__device__ __forceinline__ void pl_layer(const float* __restrict__ Wt,
                                         const float* __restrict__ bias,
                                         const MlpLayer& L, const float* x,
                                         int xk, int xe, float* y, int E,
                                         bool tanh_act) {
  const int ne = E / PL_EPT, c = threadIdx.x % ne;
  const int step = R * (blockDim.x / ne);
  const float* xc = x + c * xe;
  const int xq = ne * xe;
  for (int j0 = R * (threadIdx.x / ne); j0 < L.J; j0 += step) {
    float acc[PL_EPT][R], w[R];
    const float* wp = Wt + j0;
    const float* xp = xc;
    pl_rows<R>(wp, w);
#pragma unroll
    for (int q = 0; q < PL_EPT; ++q) {
      const float xv = xp[q * xq];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[q][r] = w[r] * xv;
    }
#pragma unroll 4
    for (int k = 1; k < L.K; ++k) {
      wp += L.Jp;
      xp += xk;
      pl_rows<R>(wp, w);
#pragma unroll
      for (int q = 0; q < PL_EPT; ++q) {
        const float xv = xp[q * xq];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] = acc[q][r] + w[r] * xv;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (j0 + r < L.J) {
        const float b = bias[j0 + r];
#pragma unroll
        for (int q = 0; q < PL_EPT; ++q) {
          const float h = acc[q][r] + b;
          y[(j0 + r) * E + c + q * ne] = tanh_act ? tanhf(h) : h;
        }
      }
    }
  }
}

// one network (0 actor, 1 critic) over the block's envs, from the obs in the
// env stretches (obs[o] of env e at x0 + e * stride + o) to its head [Jp][E].
// A layer takes 8-row chunks where every thread gets one, else 4, else
// single rows (the heads).
__device__ __forceinline__ void pl_net(const int* lay, const float* wsec,
                                       int net, const float* x0, int stride,
                                       int E, float* hA, float* hB,
                                       float* head) {
  const int nL = lay[0], groups = blockDim.x / (E / PL_EPT);
  const float* x = x0;
  int xk = 1, xe = stride;
  for (int l = 0; l <= nL; ++l) {
    const MlpLayer L = mlp_layer(lay, net, l);
    float* y = l == nL ? head : (l % 2 == 0 ? hA : hB);
    const float* W = wsec + L.w_off;
    const float* b = wsec + L.b_off;
    if (L.J >= 8 * groups)
      pl_layer<8>(W, b, L, x, xk, xe, y, E, l < nL);
    else if (L.J >= 4 * groups)
      pl_layer<4>(W, b, L, x, xk, xe, y, E, l < nL);
    else
      pl_layer<1>(W, b, L, x, xk, xe, y, E, l < nL);
    __syncthreads();
    x = y;
    xk = E;
    xe = 1;
  }
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// the step's inputs: the action the MLP formed, in the env's stretch and in
// [0, 1]; the lead-times from the table (K4, `policy_eps`) or Philox (`policy`)
template <class LT>
struct LnActIn {
  const float* a;
  LT lts;
  __device__ __forceinline__ float act(int i) { return a[i]; }
  __device__ __forceinline__ int lt(int k) { return lts.lt(k); }
};

// mode MODE_GREEDY (K4): actor only, tables, rewards and final stock only;
// MODE_POLICY_EPS / MODE_POLICY (K1): actor and critic, the noise from a
// table or from Philox at counter (b, s, block, 0): 2A uniforms (Box-Muller
// pairs (i, A + i)), then K lead-time uniforms (stochastic chains), then R*P
// demand uniforms (2 R*P with a normal demand: ln_draw_demand).  Every lane
// of the block runs every step (an env past B steps a real env's rows and
// writes nothing), so the syncs see full warps.
template <int G, int DT>
static __global__ void __launch_bounds__(PL_MAX_THREADS, 1)
sc_policy_lane_kernel(const DnChain* __restrict__ gch,
                      const int* __restrict__ glay,
                      const float* __restrict__ gw, int mode, int S, int B,
                      int E, int stride, const float* __restrict__ dem_tab,
                      const int* __restrict__ lt_tab,
                      const float* __restrict__ eps_tab, uint32_t k0,
                      uint32_t k1, int sample_major, float* __restrict__ obs,
                      float* __restrict__ act_pre, float* __restrict__ logp_out,
                      float* __restrict__ value_out, float* __restrict__ rew,
                      float* __restrict__ stock_out) {
  static_assert(32 % G == 0, "whole groups a warp");
  __shared__ int lay[MLP_LAYOUT_INTS];
  extern __shared__ float4 dyn[];
  const DnChain& ch = *gch;
  const DnEdges& ed = *reinterpret_cast<const DnEdges*>(gch + 1);
  const int tid = threadIdx.x, nt = blockDim.x, e = tid / G, g = tid % G;
  const int b = blockIdx.x * E + e;
  const bool active = b < B;
  const int bb = active ? b : B - 1;  // inactive lanes read a real env's rows
  for (int i = tid; i < MLP_LAYOUT_INTS; i += nt) lay[i] = glay[i];
  __syncthreads();

  const bool greedy = mode == MODE_GREEDY;
  const int O = lay[1], A = lay[2], Hmax = lay[9];
  const int nw = greedy ? lay[3] : lay[3] + lay[4];  // multiples of 8 floats
  float* W = reinterpret_cast<float*>(dyn);
  {
    const float4* src = reinterpret_cast<const float4*>(gw);
    for (int i = tid; i < nw / 4; i += nt) dyn[i] = src[i];
  }
  float* hA = W + nw;                  // hidden activations [Hmax][E]
  float* hB = hA + Hmax * E;
  float* mu_s = hB + Hmax * E;         // actor head [Jp][E]
  float* v_s = mu_s + mlp_layer(lay, 0, lay[0]).Jp * E;  // critic head [8][E]
  float* envs = v_s + (greedy ? 0 : mlp_layer(lay, 1, lay[0]).Jp * E);
  const float* log_std = W + lay[5];

  const int NP = ch.N * ch.P, RP = ch.R * ch.P, T = ch.T;
  const int NE = ed.n_edges;
  const int Kr = ch.stochastic ? ch.K : 0;
  const size_t Bz = (size_t)B, SB = (size_t)S * B;
  int obs_off;
  const int words = ln_env_words(ch, NE, obs_off);
  if (words + A > stride || ch.dmax > DT || O != ch.obs_dim || A != ch.A)
    __trap();
  float* base = envs + (size_t)e * stride;
  LnEnv env;
  env.stock = base;
  env.ring = base + NP;
  env.dem = env.ring + ch.ring * NP;
  env.eval = env.dem + RP;
  env.eL = reinterpret_cast<int*>(env.eval + NE * ch.P);
  env.nfired = env.eL + NE;
  env.obs = base + obs_off;
  float* act = env.obs + O;            // the step's action, in [0, 1]
  for (int k = g; k < NE; k += G) env.eL[k] = 0;
  __syncthreads();                     // the weights are in

  for (int s = 0; s < S; ++s) {
    const int te = s % T;
    if (te == 0) ln_init<G>(ch, env, g);
    // the step's demand row
    if (mode == MODE_POLICY) {
      // the previous step's MLP read the obs before its first sync, so the
      // stretch's obs may stage the Box-Muller partners
      ln_draw_demand<G>(ch, env, env.obs, (uint32_t)b, (uint32_t)s, 2 * A + Kr,
                        te, k0, k1, g);
    } else {
      for (int j = g; j < RP; j += G)
        env.dem[j] = __ldg(dem_tab + ((size_t)s * RP + j) * Bz + bb);
    }
    __syncwarp();
    ln_obs<G>(ch, env, te, g);
    __syncthreads();
    if (obs != nullptr) {
      // the block's observations, o-major, E consecutive envs a run
      const size_t ostr = sample_major ? SB : Bz;
      float* obs_s = obs + (sample_major ? (size_t)s * Bz : (size_t)s * O * Bz);
      for (int idx = tid; idx < O * E; idx += nt) {
        const int o = idx / E, ee = idx - o * E;
        const int bo = blockIdx.x * E + ee;
        if (bo < B) obs_s[(size_t)o * ostr + bo] = envs[(size_t)ee * stride + obs_off + o];
      }
    }
    pl_net(lay, W, 0, envs + obs_off, stride, E, hA, hB, mu_s);
    if (!greedy) pl_net(lay, W + lay[3], 1, envs + obs_off, stride, E, hA, hB, v_s);

    // the action, its rows over the group's lanes
    LnPhiloxIn ph{gch, (uint32_t)b, (uint32_t)s, k0, k1, 2 * A, -1, -1,
                  make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (greedy) {
      for (int i = g; i < A; i += G)
        act[i] = (tanhf(mu_s[i * E + e]) + 1.0f) * 0.5f;
    } else {
      for (int i = g; i < A; i += G) {
        float eps;
        if (mode == MODE_POLICY) {
          const float u1 = ph.u_at(i, ph.blk_a, ph.w_a);
          const float u2 = ph.u_at(A + i, ph.blk_l, ph.w_l);
          eps = sqrtf(-2.0f * log1pf(-u1)) * cosf(TWO_PI_F * u2);
        } else {
          eps = __ldg(eps_tab + ((size_t)s * A + i) * Bz + bb);
        }
        // sampled tanh-Gaussian action and its log-density term
        const float ls = fminf(fmaxf(log_std[i], LOG_STD_MIN), LOG_STD_MAX);
        const float sd = expf(ls);
        const float mu = mu_s[i * E + e];
        const float pre = mu + sd * eps;
        const float z = (pre - mu) / sd;
        const float gs = -0.5f * (z * z + 2.0f * ls + LOG_2PI_F);
        const float corr = 2.0f * (LN2_F - pre - softplus_f(-2.0f * pre));
        mu_s[i * E + e] = gs - corr;   // the head's row, read by this lane only
        act[i] = (tanhf(pre) + 1.0f) * 0.5f;
        if (active)
          act_pre[sample_major ? (size_t)i * SB + (size_t)s * Bz + b
                               : ((size_t)s * A + i) * Bz + b] = pre;
      }
      __syncwarp();
      if (active && g == 0) {
        float lp = mu_s[e];
        for (int i = 1; i < A; ++i) lp = lp + mu_s[i * E + e];
        logp_out[(size_t)s * Bz + b] = lp;
        value_out[(size_t)s * Bz + b] = v_s[e];
      }
    }
    __syncwarp();
    float r;
    if (mode == MODE_POLICY) {
      LnActIn<LnPhiloxIn> in{act, ph};
      r = ln_step<G, DT>(ch, ed, env, in, te + 1, g);
    } else {
      LnActIn<LnTabIn> in{
          act,
          {nullptr, ch.stochastic ? lt_tab + (size_t)s * ch.K * Bz + bb : nullptr,
           Bz}};
      r = ln_step<G, DT>(ch, ed, env, in, te + 1, g);
    }
    if (active && g == 0) rew[(size_t)s * Bz + b] = r;
  }
  if (stock_out != nullptr && active)
    for (int i = g; i < NP; i += G) stock_out[(size_t)i * Bz + b] = env.stock[i];
}

template <int G, int DT>
static int pl_launch(const void* chain, const int* layout,
                     const float* weights, int mode, int S, int B, int E,
                     int stride, int smem_bytes, const float* dem_tab,
                     const int* lt_tab, const float* eps_tab, unsigned int k0,
                     unsigned int k1, int sample_major, float* obs,
                     float* act_pre, float* logp, float* value, float* rew,
                     float* stock_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sc_policy_lane_kernel<G, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + E - 1) / E;
  sc_policy_lane_kernel<G, DT><<<blocks, G * E, smem_bytes, stream>>>(
      (const DnChain*)chain, layout, weights, mode, S, B, E, stride, dem_tab,
      lt_tab, eps_tab, k0, k1, sample_major, obs, act_pre, logp, value, rew,
      stock_out);
  return (int)cudaGetLastError();
}

#define PL_CASE(g, dt)                                                        \
  if (G == g && DT == dt)                                                     \
    return pl_launch<g, dt>(chain, layout, weights, mode, S, B, E, stride,    \
                            smem_bytes, dem_tab, lt_tab, eps_tab, k0, k1,     \
                            sample_major, obs, act_pre, logp, value, rew,     \
                            stock_out, (cudaStream_t)stream);

// G lanes an env, E envs a block, DT >= dmax slots a node: the instances
// built, as policy_block in ops/supplychain_dense.py plans them (4 lanes
// hold at most 4 nodes, so at most 3 slots a node)
extern "C" int sc_policy_lane_launch(
    const void* chain, int desc_bytes, const int* layout,
    const float* weights, int mode, int S, int B, int G, int E, int DT,
    int stride, int smem_bytes, const float* dem_tab, const int* lt_tab,
    const float* eps_tab, unsigned int k0, unsigned int k1, int sample_major,
    float* obs, float* act_pre, float* logp, float* value, float* rew,
    float* stock_out, void* stream) {
  if (desc_bytes != (int)(sizeof(DnChain) + sizeof(DnEdges))) return -1;
  if (mode != MODE_POLICY && mode != MODE_POLICY_EPS && mode != MODE_GREEDY)
    return -3;
  if ((E != 8 && E != 16 && E != 32) || E % PL_EPT != 0 ||
      G * E > PL_MAX_THREADS)
    return -6;
  if ((size_t)E * stride * 4 > (size_t)smem_bytes) return -5;
  PL_CASE(4, 2) PL_CASE(4, 4)
  PL_CASE(8, 2) PL_CASE(8, 4) PL_CASE(8, 10)
  PL_CASE(16, 2) PL_CASE(16, 4) PL_CASE(16, 10)
  return -6;
}

extern "C" int mlp_layout_ints() { return MLP_LAYOUT_INTS; }

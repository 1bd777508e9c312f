// What the two forms of the fused clipped-PPO update share: the layout of
// the packed weights (ops/_mlp.py), the input slot a tile is fetched into,
// the per-sample loss and the head's output gradient (each for a group of
// threads: the float32 kernel's block, a warpgroup of the bf16 kernel), and
// the fixed-order sum of the blocks' partial rows.  ppo_update.cu (float32
// products) and ppo_update_bf16.cuh (bf16 products on wgmma) include it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PU_THREADS 512
#define PU_TS 64   // samples a tile
#define PU_TQ (PU_TS / 4)
#define PU_LD 68   // row stride of the float32 tile buffers
#define PU_MAX_L 4
#define PU_HEADER 10
#define PU_PER_LAYER 7
#define PU_LAYOUT_INTS (PU_HEADER + 2 * (PU_MAX_L + 1) * PU_PER_LAYER)

#define PU_LOG_STD_MIN -5.0f
#define PU_LOG_STD_MAX 2.0f
#define PU_LOG_2PI 1.8378770664093453f
#define PU_LN2 0.6931471805599453f

struct PuLayer {
  int K, J, Jp, w_off, b_off, gw_off, gb_off;
};

__device__ __forceinline__ PuLayer pu_layer(const int* lay, int net, int l) {
  const int* r = lay + PU_HEADER + (net * (PU_MAX_L + 1) + l) * PU_PER_LAYER;
  return PuLayer{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
}

__device__ __forceinline__ int pu_pad8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ float pu_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A barrier over the block, for the helpers below that a group of NT
// threads runs (the whole block, or a warpgroup with a named barrier).
struct PuBlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// Input row r of a fetch (obs rows, then pre, old_logp, adv for the actor,
// ret for the critic) at sample m: its source and its slot row.
__device__ __forceinline__ const float* pu_src(int r, int net, int O, int A,
                                               int R0, size_t m, int M,
                                               const float* obs,
                                               const float* pre,
                                               const float* old_logp,
                                               const float* adv,
                                               const float* ret, int& dr) {
  if (r < O) {
    dr = r;
    return obs + (size_t)r * M + m;
  }
  if (net) {
    dr = R0 + A + 2;
    return ret + m;
  }
  if (r < O + A) {
    dr = R0 + r - O;
    return pre + (size_t)(r - O) * M + m;
  }
  dr = R0 + A + (r - O - A);
  return (r == O + A ? old_logp : adv) + m;
}

// Input slot of a tile: obs rows [0, O), pre rows [R0, R0 + A), then
// old_logp, adv, ret rows; ragged samples (m >= M) are zero-filled.
// Fetched by the NT threads of a group, thread tid of it: 16 bytes (4
// samples) a copy where the whole tile lies inside M and every row starts
// 16-byte aligned, else 4.
template <int NT>
__device__ __forceinline__ void pu_fetch_n(int tid, float* slot, int net,
                                           int O, int A, int R0, int m0,
                                           int M, const float* obs,
                                           const float* pre,
                                           const float* old_logp,
                                           const float* adv,
                                           const float* ret) {
  const int rows = net ? O + 1 : O + A + 2;
  const bool quads =
      (M & 3) == 0 && m0 + PU_TS <= M &&
      ((reinterpret_cast<size_t>(obs) | reinterpret_cast<size_t>(pre) |
        reinterpret_cast<size_t>(old_logp) | reinterpret_cast<size_t>(adv) |
        reinterpret_cast<size_t>(ret)) & 15) == 0;
  if (quads) {
    for (int e = tid; e < rows * PU_TQ; e += NT) {
      const int r = e / PU_TQ, t = (e % PU_TQ) * 4;
      int dr;
      const float* src = pu_src(r, net, O, A, R0, (size_t)(m0 + t), M, obs,
                                pre, old_logp, adv, ret, dr);
      cp_async16(slot + dr * PU_LD + t, src);
    }
    return;
  }
  for (int e = tid; e < rows * PU_TS; e += NT) {
    const int r = e / PU_TS, t = e % PU_TS, m = m0 + t;
    const bool valid = m < M;
    int dr;
    const float* src = pu_src(r, net, O, A, R0, valid ? (size_t)m : 0, M,
                              obs, pre, old_logp, adv, ret, dr);
    cp_async4(slot + dr * PU_LD + t, src, valid);
  }
}

__device__ __forceinline__ void pu_fetch(float* slot, int net, int O, int A,
                                         int R0, int m0, int M,
                                         const float* obs, const float* pre,
                                         const float* old_logp,
                                         const float* adv, const float* ret) {
  pu_fetch_n<PU_THREADS>(threadIdx.x, slot, net, O, A, R0, m0, M, obs, pre,
                         old_logp, adv, ret);
}

// The tile's per-sample loss terms and the head's output gradient.  hbuf
// [rows][PU_LD] holds the head's output (mu [A] for the actor, v [1] for the
// critic) and leaves holding d loss / d output, zero for ragged samples;
// zb and term ([A][PU_LD], actor) are scratch, ls_raw the unclipped
// log_std.  The tile's loss is added to loss_acc (thread 0) by a fixed
// shuffle tree, the log_std gradient to gls (threads < A).  Run by the NT
// threads of a group (thread tid of it, NT >= PU_TS), `sync` its barrier.
template <int NT, class Sync>
__device__ __forceinline__ void pu_tile_loss_n(
    int tid, Sync sync, int net, int A, const float* ls_raw, float* hbuf,
    float* zb, float* term, const float* pres, const float* olps,
    const float* advs, const float* rets, int m0, int M, float clip,
    float inv_m, float c_vf, float ent_coef, float c_reg, float c_dreg,
    float* dl, float* lossbuf, float& loss_acc, float& gls) {
  const float lo = 1.0f - clip, hi = 1.0f + clip;
  if (net == 0) {
    for (int e = tid; e < A * PU_TS; e += NT) {
      const int i = e / PU_TS, t = e % PU_TS;
      const float mu = hbuf[i * PU_LD + t];
      const float ls = fminf(fmaxf(ls_raw[i], PU_LOG_STD_MIN), PU_LOG_STD_MAX);
      const float sd = expf(ls);
      const float pr = pres[i * PU_LD + t];
      const float z = (pr - mu) / sd;
      const float gg = -0.5f * (z * z + 2.0f * ls + PU_LOG_2PI);
      const float corr = 2.0f * (PU_LN2 - pr - pu_softplus(-2.0f * pr));
      term[i * PU_LD + t] = gg - corr;
      zb[i * PU_LD + t] = z;
    }
    sync();
    if (tid < PU_TS) {
      const int t = tid;
      const bool valid = m0 + t < M;
      float lp = 0.0f, musq = 0.0f;
      for (int i = 0; i < A; ++i) {
        const float mu = hbuf[i * PU_LD + t];
        lp += term[i * PU_LD + t];
        musq = fmaf(mu, mu, musq);
      }
      const float olp = olps[t], ad = advs[t];
      const float ratio = expf(lp - olp);
      const float u = ratio * ad;
      const float w = fminf(fmaxf(ratio, lo), hi) * ad;
      const float loss_t =
          -fminf(u, w) * inv_m + ent_coef * lp * inv_m + c_reg * musq;
      // d loss / d logp: the clipped-surrogate branch plus the entropy bonus
      const bool inside = ratio > lo && ratio < hi;
      const float sel = u <= w ? ad : (inside ? ad : 0.0f);
      dl[t] = valid ? (-sel * ratio + ent_coef) * inv_m : 0.0f;
      lossbuf[t] = valid ? loss_t : 0.0f;
    }
    sync();
    for (int e = tid; e < A * PU_TS; e += NT) {
      const int i = e / PU_TS, t = e % PU_TS;
      const bool valid = m0 + t < M;
      const float ls = fminf(fmaxf(ls_raw[i], PU_LOG_STD_MIN), PU_LOG_STD_MAX);
      const float sd = expf(ls);
      const float dlogp = dl[t];
      const float z = zb[i * PU_LD + t];
      const float mu = hbuf[i * PU_LD + t];
      hbuf[i * PU_LD + t] = valid ? dlogp * z / sd + c_dreg * mu : 0.0f;
      zb[i * PU_LD + t] = valid ? dlogp * (z * z - 1.0f) : 0.0f;
    }
  } else if (tid < PU_TS) {
    const int t = tid;
    const bool valid = m0 + t < M;
    const float vres = hbuf[t] - rets[t];
    lossbuf[t] = valid ? 0.5f * c_vf * vres * vres : 0.0f;
    hbuf[t] = valid ? c_vf * vres : 0.0f;
  }
  sync();
  if (tid < 32) {  // the tile's loss, a fixed shuffle tree
    float v = lossbuf[tid] + lossbuf[tid + 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid == 0) loss_acc += v;
  }
  if (net == 0 && tid < A) {
    // log_std, through its clip gate: d logp / d ls = z^2 - 1
    const float raw = ls_raw[tid];
    float s = 0.0f;
    for (int t = 0; t < PU_TS; ++t) s += zb[tid * PU_LD + t];
    if (raw > PU_LOG_STD_MIN && raw < PU_LOG_STD_MAX) gls += s;
  }
}

__device__ __forceinline__ void pu_tile_loss(
    int net, int A, const float* ls_raw, float* hbuf, float* zb, float* term,
    const float* pres, const float* olps, const float* advs,
    const float* rets, int m0, int M, float clip, float inv_m, float c_vf,
    float ent_coef, float c_reg, float c_dreg, float* dl, float* lossbuf,
    float& loss_acc, float& gls) {
  pu_tile_loss_n<PU_THREADS>(threadIdx.x, PuBlockSync(), net, A, ls_raw,
                             hbuf, zb, term, pres, olps, advs, rets, m0, M,
                             clip, inv_m, c_vf, ent_coef, c_reg, c_dreg, dl,
                             lossbuf, loss_acc, gls);
}

// out[p] = sum_g part[g][p], g in order
static __global__ void ppo_reduce_kernel(const float* __restrict__ part,
                                         int G, int P,
                                         float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += part[(size_t)g * P + p];
  out[p] = s;
}

// Fused clipped-PPO update: forward, loss and hand-derived backward of the
// actor-critic over M samples, in one pass per sample tile.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/ppo_update_pallas.py (make_ppo_update_grads).
// The loss is learn/ppo.py's _make_cont_loss: clipped surrogate + value
// MSE + entropy bonus estimated as -E[logp] + pre-tanh L2 on mu.
//
// Shape of the work: grid (G, 2).  Blocks with blockIdx.y = 0 take the
// actor (trunk, mu head, log_std), blocks with y = 1 the critic (trunk, v
// head): the two nets share no parameter, and the loss splits into an
// actor part and a critic part.  Block g walks its share of the 32-sample
// tiles; its net's packed weights and its gradient accumulators sit in
// dynamic shared memory (about 88 KB each for ntom at hidden (128, 128)),
// beside the tile's activations [rows][33] (stride 33 keeps the
// sample-major and the feature-major reads free of bank conflicts).  Per
// tile: forward (8 warps, 8 output rows a thread, one sample a lane), the
// per-sample loss terms (warp 0), then per layer from the head down the
// weight-gradient accumulation (one (j, k) entry set a thread, summed over
// the tile's samples in order) and the input gradient, written in place
// over the activation it replaces.  Each block writes its partial
// gradients and loss to row g of a [G, P] buffer, and ppo_reduce_kernel
// sums the G rows in order: no float atomics, so two launches on the same
// inputs give the same bits.
//
// Bounds on the card: issue-bound FMAs from shared memory (operands are
// broadcast weights and conflict-free activations); device-memory traffic
// is the obs/pre tiles read once (M * (O + A + 3) * 4 bytes) and the
// partial rows.  One block fits an SM (shared memory), so G = 66 fills 132
// SMs in one wave.  Products accumulate with fmaf (this kernel matches its
// plain version to a tolerance, not bit for bit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PU_THREADS 256
#define PU_WARPS 8
#define PU_TS 32   // samples a tile, one a lane
#define PU_LD 33   // row stride of the tile buffers
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

// y[j][t] = act(sum_k w[j][k] x[k][t] + b[j]); Wt is w transposed [K][Jp]
__device__ __forceinline__ void pu_forward(const float* Wt, const float* bias,
                                           const PuLayer& L, const float* x,
                                           float* y, bool tanh_act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = warp * 8; j0 < L.J; j0 += PU_WARPS * 8) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < L.K; ++k) {
      const float xv = x[k * PU_LD + lane];
      const float* wr = Wt + (size_t)k * L.Jp + j0;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
      acc[0] = fmaf(w0.x, xv, acc[0]); acc[1] = fmaf(w0.y, xv, acc[1]);
      acc[2] = fmaf(w0.z, xv, acc[2]); acc[3] = fmaf(w0.w, xv, acc[3]);
      acc[4] = fmaf(w1.x, xv, acc[4]); acc[5] = fmaf(w1.y, xv, acc[5]);
      acc[6] = fmaf(w1.z, xv, acc[6]); acc[7] = fmaf(w1.w, xv, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (j0 + r < L.J) {
        const float h = acc[r] + bias[j0 + r];
        y[(j0 + r) * PU_LD + lane] = tanh_act ? tanhf(h) : h;
      }
    }
  }
}

// Gw[j*K + k] += sum_t dY[j][t] X[k][t];  Gb[j] += sum_t dY[j][t]
__device__ __forceinline__ void pu_grad_accum(const float* dY, const float* X,
                                              const PuLayer& L, float* Gw,
                                              float* Gb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nkc = (L.K + 31) / 32, njg = (L.J + 3) / 4;
  for (int p = warp; p < nkc * njg; p += PU_WARPS) {
    const int j0 = (p / nkc) * 4, k = (p % nkc) * 32 + lane;
    if (k >= L.K) continue;
    const float* d0 = dY + min(j0, L.J - 1) * PU_LD;
    const float* d1 = dY + min(j0 + 1, L.J - 1) * PU_LD;
    const float* d2 = dY + min(j0 + 2, L.J - 1) * PU_LD;
    const float* d3 = dY + min(j0 + 3, L.J - 1) * PU_LD;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int t = 0; t < PU_TS; ++t) {
      const float xv = X[k * PU_LD + t];
      a0 = fmaf(d0[t], xv, a0);
      a1 = fmaf(d1[t], xv, a1);
      a2 = fmaf(d2[t], xv, a2);
      a3 = fmaf(d3[t], xv, a3);
    }
    Gw[j0 * L.K + k] += a0;
    if (j0 + 1 < L.J) Gw[(j0 + 1) * L.K + k] += a1;
    if (j0 + 2 < L.J) Gw[(j0 + 2) * L.K + k] += a2;
    if (j0 + 3 < L.J) Gw[(j0 + 3) * L.K + k] += a3;
  }
  for (int j = threadIdx.x; j < L.J; j += PU_THREADS) {
    float s = 0.0f;
    for (int t = 0; t < PU_TS; ++t) s += dY[j * PU_LD + t];
    Gb[j] += s;
  }
}

// X[k][t] <- (sum_j w[j][k] dY[j][t]) * (1 - X[k][t]^2): the gradient at the
// layer's tanh input, in place over the activation X it is taken from
__device__ __forceinline__ void pu_backward_input(const float* Wt,
                                                  const PuLayer& L,
                                                  const float* dY, float* X) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = warp * 8; k0 < L.K; k0 += PU_WARPS * 8) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float* wr[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) wr[r] = Wt + (size_t)min(k0 + r, L.K - 1) * L.Jp;
    for (int j = 0; j < L.J; ++j) {
      const float d = dY[j * PU_LD + lane];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = fmaf(wr[r][j], d, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (k0 + r < L.K) {
        float* xp = X + (k0 + r) * PU_LD + lane;
        const float x = *xp;
        *xp = acc[r] * (1.0f - x * x);
      }
    }
  }
}

__device__ __forceinline__ float pu_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(PU_THREADS)
ppo_grad_kernel(const int* __restrict__ glay, const float* __restrict__ gw,
                const float* __restrict__ obs, const float* __restrict__ pre,
                const float* __restrict__ old_logp,
                const float* __restrict__ adv, const float* __restrict__ ret,
                int M, float clip, float inv_m, float c_vf, float ent_coef,
                float c_reg, float c_dreg, float* __restrict__ part) {
  __shared__ int lay[PU_LAYOUT_INTS];
  __shared__ float lossbuf[PU_TS];
  extern __shared__ float4 dyn[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < PU_LAYOUT_INTS; i += PU_THREADS) lay[i] = glay[i];
  __syncthreads();
  const int net = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int nL = lay[0], O = lay[1], A = lay[2], ls_woff = lay[5];
  const int La = lay[6], Lc = lay[7], P = lay[8];
  const int wlen = net ? lay[4] : lay[3];
  const int glen = net ? Lc : La + A;
  const PuLayer head = pu_layer(lay, net, nL);

  float* W = reinterpret_cast<float*>(dyn);
  {
    const float4* src = reinterpret_cast<const float4*>(gw + (net ? lay[3] : 0));
    for (int i = tid; i < wlen / 4; i += PU_THREADS) dyn[i] = src[i];
  }
  float* Gacc = W + wlen;
  for (int i = tid; i < glen; i += PU_THREADS) Gacc[i] = 0.0f;
  float* xs = Gacc + glen;  // obs tile [O][33]
  float* act[PU_MAX_L];     // hidden activations [H_l][33]
  {
    float* p = xs + O * PU_LD;
    for (int l = 0; l < nL; ++l) {
      act[l] = p;
      p += pu_layer(lay, net, l).J * PU_LD;
    }
  }
  float* hbuf = act[nL - 1] + pu_layer(lay, net, nL - 1).J * PU_LD;
  float* zb = hbuf + head.Jp * PU_LD;  // actor: z, then dlogp (z^2 - 1)
  __syncthreads();

  const float lo = 1.0f - clip, hi = 1.0f + clip;
  const int nT = (M + PU_TS - 1) / PU_TS;
  const int t0 = (int)((long long)g * nT / G);
  const int t1 = (int)((long long)(g + 1) * nT / G);
  float loss_acc = 0.0f;

  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * PU_TS;
    for (int i = tid; i < O * PU_TS; i += PU_THREADS) {
      const int k = i / PU_TS, t = i % PU_TS, m = m0 + t;
      xs[k * PU_LD + t] = m < M ? obs[(size_t)k * M + m] : 0.0f;
    }
    __syncthreads();
    // ---- forward ----------------------------------------------------------
    const float* x = xs;
    for (int l = 0; l < nL; ++l) {
      const PuLayer L = pu_layer(lay, net, l);
      pu_forward(W + L.w_off, W + L.b_off, L, x, act[l], true);
      __syncthreads();
      x = act[l];
    }
    pu_forward(W + head.w_off, W + head.b_off, head, x, hbuf, false);
    __syncthreads();

    // ---- per-sample loss terms and the head's output gradient -------------
    if (warp == 0) {
      const int m = m0 + lane;
      const bool valid = m < M;
      float loss_t = 0.0f;
      if (net == 0) {
        float lp = 0.0f, musq = 0.0f;
        for (int i = 0; i < A; ++i) {
          const float mu = hbuf[i * PU_LD + lane];
          const float ls = fminf(fmaxf(W[ls_woff + i], PU_LOG_STD_MIN),
                                 PU_LOG_STD_MAX);
          const float sd = expf(ls);
          const float pr = valid ? pre[(size_t)i * M + m] : 0.0f;
          const float z = (pr - mu) / sd;
          const float gg = -0.5f * (z * z + 2.0f * ls + PU_LOG_2PI);
          const float corr = 2.0f * (PU_LN2 - pr - pu_softplus(-2.0f * pr));
          lp += gg - corr;
          musq = fmaf(mu, mu, musq);
          zb[i * PU_LD + lane] = z;
        }
        const float olp = valid ? old_logp[m] : 0.0f;
        const float ad = valid ? adv[m] : 0.0f;
        const float ratio = expf(lp - olp);
        const float u = ratio * ad;
        const float w = fminf(fmaxf(ratio, lo), hi) * ad;
        loss_t = -fminf(u, w) * inv_m + ent_coef * lp * inv_m + c_reg * musq;
        // d loss / d logp: the clipped-surrogate branch plus the entropy bonus
        const bool inside = ratio > lo && ratio < hi;
        const float sel = u <= w ? ad : (inside ? ad : 0.0f);
        const float dlogp = (-sel * ratio + ent_coef) * inv_m;
        for (int i = 0; i < A; ++i) {
          const float ls = fminf(fmaxf(W[ls_woff + i], PU_LOG_STD_MIN),
                                 PU_LOG_STD_MAX);
          const float sd = expf(ls);
          const float z = zb[i * PU_LD + lane];
          const float mu = hbuf[i * PU_LD + lane];
          hbuf[i * PU_LD + lane] = valid ? dlogp * z / sd + c_dreg * mu : 0.0f;
          zb[i * PU_LD + lane] = valid ? dlogp * (z * z - 1.0f) : 0.0f;
        }
      } else {
        const float v = hbuf[lane];
        const float vres = v - (valid ? ret[m] : 0.0f);
        loss_t = 0.5f * c_vf * vres * vres;
        hbuf[lane] = valid ? c_vf * vres : 0.0f;
      }
      lossbuf[lane] = valid ? loss_t : 0.0f;
    }
    __syncthreads();
    if (tid == 0)
      for (int t = 0; t < PU_TS; ++t) loss_acc += lossbuf[t];
    if (net == 0)  // log_std, through its clip gate: d logp / d ls = z^2 - 1
      for (int i = tid; i < A; i += PU_THREADS) {
        const float raw = W[ls_woff + i];
        float s = 0.0f;
        for (int t = 0; t < PU_TS; ++t) s += zb[i * PU_LD + t];
        if (raw > PU_LOG_STD_MIN && raw < PU_LOG_STD_MAX) Gacc[La + i] += s;
      }

    // ---- backward, from the head down ---------------------------------------
    const float* dY = hbuf;
    for (int l = nL; l >= 0; --l) {
      const PuLayer L = pu_layer(lay, net, l);
      float* X = l == 0 ? xs : act[l - 1];
      pu_grad_accum(dY, X, L, Gacc + L.gw_off, Gacc + L.gb_off);
      __syncthreads();
      if (l > 0) {
        pu_backward_input(W + L.w_off, L, dY, X);
        __syncthreads();
      }
      dY = X;
    }
  }

  float* row = part + (size_t)g * P;
  if (net == 0) {
    for (int i = tid; i < La; i += PU_THREADS) row[i] = Gacc[i];
    for (int i = tid; i < A; i += PU_THREADS) row[La + Lc + i] = Gacc[La + i];
    if (tid == 0) row[P - 2] = loss_acc;
  } else {
    for (int i = tid; i < Lc; i += PU_THREADS) row[La + i] = Gacc[i];
    if (tid == 0) row[P - 1] = loss_acc;
  }
}

// out[p] = sum_g part[g][p], g in order
__global__ void ppo_reduce_kernel(const float* __restrict__ part, int G, int P,
                                  float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += part[(size_t)g * P + p];
  out[p] = s;
}

extern "C" int ppo_layout_ints() { return PU_LAYOUT_INTS; }

extern "C" int ppo_update_launch(const int* layout, const float* weights,
                                 int smem_bytes, int G, const float* obs,
                                 const float* pre, const float* old_logp,
                                 const float* adv, const float* ret, int M,
                                 float clip, float inv_m, float c_vf,
                                 float ent_coef, float c_reg, float c_dreg,
                                 float* part, float* out, int P,
                                 void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ppo_grad_kernel<<<dim3(G, 2), PU_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      layout, weights, obs, pre, old_logp, adv, ret, M, clip, inv_m, c_vf,
      ent_coef, c_reg, c_dreg, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ppo_reduce_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, G, P, out);
  return (int)cudaGetLastError();
}

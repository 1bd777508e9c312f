// Fused clipped-PPO update: forward, loss and hand-derived backward of the
// actor-critic over M samples, in one pass per sample tile.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/ppo_update_pallas.py (make_ppo_update_grads).
// The loss is learn/ppo.py's _make_cont_loss: clipped surrogate + value
// MSE + entropy bonus estimated as -E[logp] + pre-tanh L2 on mu.
//
// Shape of the work: grid (G, 2) of 512-thread blocks.  Blocks with
// blockIdx.y = 0 take the actor (trunk, mu head, log_std), blocks with
// y = 1 the critic (trunk, v head): the two nets share no parameter, and
// the loss splits into an actor part and a critic part.  Block g walks its
// share of the 64-sample tiles.  Shared memory holds its net's packed
// weights (W transposed, [K][Jp]), the tile's activations feature-major
// [rows][68] (row stride 68 floats = 16 bytes past a multiple of 128, so
// consecutive rows fall in distinct bank quads), and two input slots
// (obs, pre, old_logp, adv, ret) filled by cp.async one tile ahead.
//
// Every product runs on register micro-tiles whose operands are float4
// loads from shared memory:
// * forward y = W x: a thread owns 4 outputs x 4 samples, one float4 of
//   W^T and one of x per k for 16 FMAs (the narrow head: 1 output x 4);
// * input gradient dX = (W^T dY) (1 - x^2): 4 inputs x 4 samples, four
//   float4 of W^T and four of dY per 4 outputs, 64 FMAs;
// * weight gradient dW += dY X^T: a thread owns fixed 4 x 4 blocks of dW
//   (rows jb + r*ceil(J/4), columns kb + c*ceil(K/4), so the warp's dY
//   rows are consecutive; the blocks of all layers dealt round-robin over
//   the threads) for the whole walk, summed over samples in
//   order in registers, and writes them once to the block's partial row;
//   bias gradients likewise, one register slot per bias.
// The per-sample loss runs on all threads, one (action, sample) pair or
// one sample a thread; the tile's loss is summed by a fixed warp-shuffle
// tree.  Each block writes its partial gradients and loss to row g of a
// [G, P] buffer and ppo_reduce_kernel sums the G rows in order: no float
// atomics, so two launches on the same inputs give the same bits.
//
// Bounds on the card: float32 FMAs on CUDA cores (57.9 GFLOP at ntom,
// hidden (128, 128), M = 245,760; plain TF32 tensor cores would lose the
// gradient gate's precision, and a first 3xTF32 mma.sync form of the three
// products ran slower than this one); device-memory traffic is the inputs
// read once.  ~194 KB of shared memory at ntom (128, 128), so one block an SM:
// G = 66 fills the 132 SMs with 16 warps each.  Products accumulate with
// fmaf (the library is built with --fmad=false; this kernel matches its
// plain version to a tolerance, not bit for bit).
#include "ppo_update.cuh"

#define PU_MAXQ 3  // 4x4 weight-gradient blocks a thread holds in registers
#define PU_MAXB 2  // bias-gradient registers a thread holds

// The 4x4 weight-gradient blocks of all layers, block (jb, kb) of layer l
// numbered jb + kb * ceil(J/4) after the blocks of the layers before it,
// go round-robin over the threads: thread tid holds blocks tid + q *
// PU_THREADS in its register slots q.  Layer l's blocks start at `off`,
// its biases (numbered likewise) at `boff`.
__device__ __forceinline__ void pu_offsets(const int* lay, int net, int l,
                                           int& off, int& boff) {
  off = 0;
  boff = 0;
  for (int i = 0; i < l; ++i) {
    const PuLayer L = pu_layer(lay, net, i);
    off += ((L.J + 3) >> 2) * ((L.K + 3) >> 2);
    boff += L.J;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// y[j][t] = act(sum_k w[j][k] x[k][t] + b[j]), 4 outputs x 4 samples a
// thread; Wt is w transposed [K][Jp]
__device__ __forceinline__ void pu_forward4(const float* Wt, const float* bias,
                                            const PuLayer& L, const float* x,
                                            float* y, bool tanh_act) {
  const int nJb = (L.J + 3) >> 2;
  for (int id = threadIdx.x; id < nJb * PU_TQ; id += PU_THREADS) {
    const int t0 = (id % PU_TQ) * 4, j0 = (id / PU_TQ) * 4;
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) a[r][s] = 0.0f;
    const float* wp = Wt + j0;
    const float* xp = x + t0;
#pragma unroll 4
    for (int k = 0; k < L.K; ++k) {
      const float4 w = ld4(wp + k * L.Jp);
      const float4 xv = ld4(xp + k * PU_LD);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) a[r][s] = fmaf(f4(w, r), f4(xv, s), a[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (j0 + r < L.J) {
        const float b = bias[j0 + r];
        float4 o;
        o.x = a[r][0] + b; o.y = a[r][1] + b;
        o.z = a[r][2] + b; o.w = a[r][3] + b;
        if (tanh_act) {
          o.x = tanhf(o.x); o.y = tanhf(o.y);
          o.z = tanhf(o.z); o.w = tanhf(o.w);
        }
        *reinterpret_cast<float4*>(y + (j0 + r) * PU_LD + t0) = o;
      }
    }
  }
}

// the head, narrow: one output x 4 samples a thread, no activation
__device__ __forceinline__ void pu_forward1(const float* Wt, const float* bias,
                                            const PuLayer& L, const float* x,
                                            float* y) {
  for (int id = threadIdx.x; id < L.J * PU_TQ; id += PU_THREADS) {
    const int t0 = (id % PU_TQ) * 4, j = id / PU_TQ;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < L.K; ++k) {
      const float w = Wt[k * L.Jp + j];
      const float4 xv = ld4(x + k * PU_LD + t0);
      a0 = fmaf(w, xv.x, a0); a1 = fmaf(w, xv.y, a1);
      a2 = fmaf(w, xv.z, a2); a3 = fmaf(w, xv.w, a3);
    }
    const float b = bias[j];
    *reinterpret_cast<float4*>(y + j * PU_LD + t0) =
        make_float4(a0 + b, a1 + b, a2 + b, a3 + b);
  }
}

// X[k][t] <- (sum_j w[j][k] dY[j][t]) * (1 - X[k][t]^2): the gradient at the
// layer's tanh input, in place over the activation X it is taken from.
// dY's rows J..pad4(J) are finite and W^T's padding is zero.
__device__ __forceinline__ void pu_backward_input(const float* Wt,
                                                  const PuLayer& L,
                                                  const float* dY, float* X) {
  const int nKb = (L.K + 3) >> 2, J4 = (L.J + 3) & ~3;
  for (int id = threadIdx.x; id < nKb * PU_TQ; id += PU_THREADS) {
    const int t0 = (id % PU_TQ) * 4, k0 = (id / PU_TQ) * 4;
    float a[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int s = 0; s < 4; ++s) a[c][s] = 0.0f;
    const float* wr[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) wr[c] = Wt + min(k0 + c, L.K - 1) * L.Jp;
    for (int j = 0; j < J4; j += 4) {
      float4 w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = ld4(wr[c] + j);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 d = ld4(dY + (j + r) * PU_LD + t0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wv = f4(w[c], r);
          a[c][0] = fmaf(wv, d.x, a[c][0]);
          a[c][1] = fmaf(wv, d.y, a[c][1]);
          a[c][2] = fmaf(wv, d.z, a[c][2]);
          a[c][3] = fmaf(wv, d.w, a[c][3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (k0 + c < L.K) {
        float* xp = X + (k0 + c) * PU_LD + t0;
        const float4 x = ld4(xp);
        float4 o;
        o.x = a[c][0] * (1.0f - x.x * x.x);
        o.y = a[c][1] * (1.0f - x.y * x.y);
        o.z = a[c][2] * (1.0f - x.z * x.z);
        o.w = a[c][3] * (1.0f - x.w * x.w);
        *reinterpret_cast<float4*>(xp) = o;
      }
    }
  }
}

// g[q] += dY X^T over the tile's samples, for the slots q of this layer
__device__ __forceinline__ void pu_grad_accum(float (&g)[PU_MAXQ][16],
                                              const float* dY, const float* X,
                                              const PuLayer& L, int off) {
  const int Jq = (L.J + 3) >> 2, Kq = (L.K + 3) >> 2, n = Jq * Kq;
#pragma unroll
  for (int q = 0; q < PU_MAXQ; ++q) {
    const int lid = threadIdx.x + q * PU_THREADS - off;
    if (lid < 0 || lid >= n) continue;
    const int jb = lid % Jq, kb = lid / Jq;
    const float* dr = dY + jb * PU_LD;
    const float* xr = X + kb * PU_LD;
    const int dstep = Jq * PU_LD, xstep = Kq * PU_LD;
#pragma unroll 2
    for (int t = 0; t < PU_TS; t += 4) {
      float4 xv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = ld4(xr + c * xstep + t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 d = ld4(dr + r * dstep + t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = g[q][r * 4 + c];
          acc = fmaf(d.x, xv[c].x, acc);
          acc = fmaf(d.y, xv[c].y, acc);
          acc = fmaf(d.z, xv[c].z, acc);
          acc = fmaf(d.w, xv[c].w, acc);
          g[q][r * 4 + c] = acc;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(PU_THREADS, 1)
ppo_grad_kernel(const int* __restrict__ glay, const float* __restrict__ gw,
                const float* __restrict__ obs, const float* __restrict__ pre,
                const float* __restrict__ old_logp,
                const float* __restrict__ adv, const float* __restrict__ ret,
                int M, float clip, float inv_m, float c_vf, float ent_coef,
                float c_reg, float c_dreg, float* __restrict__ part) {
  __shared__ int lay[PU_LAYOUT_INTS];
  __shared__ float dl[PU_TS];
  __shared__ float lossbuf[PU_TS];
  extern __shared__ float4 dyn[];
  const int tid = threadIdx.x;
  for (int i = tid; i < PU_LAYOUT_INTS; i += PU_THREADS) lay[i] = glay[i];
  __syncthreads();
  const int net = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int nL = lay[0], O = lay[1], A = lay[2], ls_woff = lay[5];
  const int La = lay[6], Lc = lay[7], P = lay[8];
  const int wlen = net ? lay[4] : lay[3];
  const PuLayer head = pu_layer(lay, net, nL);
  const int R0 = pu_pad8(O), Ap = pu_pad8(A);
  const int slot_rows = R0 + A + 3;

  // shared memory: weights, activations per hidden layer [Jp][LD], head
  // [Jp][LD], z and logp terms [Ap][LD] (actor), two input slots
  float* W = reinterpret_cast<float*>(dyn);
  {
    const float4* src = reinterpret_cast<const float4*>(gw + (net ? lay[3] : 0));
    for (int i = tid; i < wlen / 4; i += PU_THREADS) dyn[i] = src[i];
  }
  float* act[PU_MAX_L];
  float* p = W + wlen;
  for (int l = 0; l < nL; ++l) {
    act[l] = p;
    p += pu_layer(lay, net, l).Jp * PU_LD;
  }
  float* hbuf = p;
  p += head.Jp * PU_LD;
  float* zb = p;
  float* term = zb + Ap * PU_LD;
  p = term + Ap * PU_LD;
  float* slots[2] = {p, p + slot_rows * PU_LD};
  // zero everything past the weights: padding rows stay finite (zero)
  for (float* q = W + wlen + tid; q < p + 2 * slot_rows * PU_LD; q += PU_THREADS)
    *q = 0.0f;
  __syncthreads();

  const int nT = (M + PU_TS - 1) / PU_TS;
  const int t0 = (int)((long long)g * nT / G);
  const int t1 = (int)((long long)(g + 1) * nT / G);
  float loss_acc = 0.0f, gls = 0.0f;
  float gacc[PU_MAXQ][16];
  float gbias[PU_MAXB];
#pragma unroll
  for (int q = 0; q < PU_MAXQ; ++q)
#pragma unroll
    for (int i = 0; i < 16; ++i) gacc[q][i] = 0.0f;
#pragma unroll
  for (int q = 0; q < PU_MAXB; ++q) gbias[q] = 0.0f;

  if (t0 < t1)
    pu_fetch(slots[0], net, O, A, R0, t0 * PU_TS, M, obs, pre, old_logp, adv,
             ret);
  cp_async_commit();
  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) & 1, m0 = tile * PU_TS;
    if (tile + 1 < t1)
      pu_fetch(slots[cur ^ 1], net, O, A, R0, m0 + PU_TS, M, obs, pre,
               old_logp, adv, ret);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float* xs = slots[cur];
    const float* pres = xs + R0 * PU_LD;
    const float* olps = pres + A * PU_LD;
    const float* advs = olps + PU_LD;
    const float* rets = advs + PU_LD;

    // ---- forward ----------------------------------------------------------
    const float* x = xs;
    for (int l = 0; l < nL; ++l) {
      const PuLayer L = pu_layer(lay, net, l);
      pu_forward4(W + L.w_off, W + L.b_off, L, x, act[l], true);
      __syncthreads();
      x = act[l];
    }
    pu_forward1(W + head.w_off, W + head.b_off, head, x, hbuf);
    __syncthreads();

    // ---- per-sample loss terms and the head's output gradient -------------
    pu_tile_loss(net, A, W + ls_woff, hbuf, zb, term, pres, olps, advs, rets,
                 m0, M, clip, inv_m, c_vf, ent_coef, c_reg, c_dreg, dl,
                 lossbuf, loss_acc, gls);

    // ---- backward, from the head down ---------------------------------------
    const float* dY = hbuf;
    for (int l = nL; l >= 0; --l) {
      const PuLayer L = pu_layer(lay, net, l);
      float* X = l == 0 ? xs : act[l - 1];
      int off, boff;
      pu_offsets(lay, net, l, off, boff);
      pu_grad_accum(gacc, dY, X, L, off);
#pragma unroll
      for (int q = 0; q < PU_MAXB; ++q) {
        const int j = tid + q * PU_THREADS - boff;
        if (j >= 0 && j < L.J) {
          float s = 0.0f;
          for (int t = 0; t < PU_TS; ++t) s += dY[j * PU_LD + t];
          gbias[q] += s;
        }
      }
      __syncthreads();
      if (l > 0) {
        pu_backward_input(W + L.w_off, L, dY, X);
        __syncthreads();
      }
      dY = X;
    }
  }

  // ---- the block's partial row ---------------------------------------------
  float* row = part + (size_t)g * P + (net ? La : 0);
  for (int l = 0; l <= nL; ++l) {
    const PuLayer L = pu_layer(lay, net, l);
    int off, boff;
    pu_offsets(lay, net, l, off, boff);
    const int Jq = (L.J + 3) >> 2, Kq = (L.K + 3) >> 2, n = Jq * Kq;
#pragma unroll
    for (int q = 0; q < PU_MAXQ; ++q) {
      const int lid = tid + q * PU_THREADS - off;
      if (lid < 0 || lid >= n) continue;
      const int jb = lid % Jq, kb = lid / Jq;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = jb + r * Jq, k = kb + c * Kq;
          if (j < L.J && k < L.K) row[L.gw_off + j * L.K + k] = gacc[q][r * 4 + c];
        }
    }
#pragma unroll
    for (int q = 0; q < PU_MAXB; ++q) {
      const int j = tid + q * PU_THREADS - boff;
      if (j >= 0 && j < L.J) row[L.gb_off + j] = gbias[q];
    }
  }
  row = part + (size_t)g * P;
  if (net == 0) {
    if (tid < A) row[La + Lc + tid] = gls;
    if (tid == 0) row[P - 2] = loss_acc;
  } else if (tid == 0) {
    row[P - 1] = loss_acc;
  }
}

extern "C" int ppo_layout_ints() { return PU_LAYOUT_INTS; }

// threads a block, samples a tile, weight-gradient slots, bias slots
extern "C" int ppo_kernel_consts(int* out) {
  out[0] = PU_THREADS;
  out[1] = PU_TS;
  out[2] = PU_MAXQ;
  out[3] = PU_MAXB;
  return 0;
}

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

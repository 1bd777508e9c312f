// The bf16 mode of the fused clipped-PPO update on mma.sync, for the nets
// the wgmma kernel (ppo_update_bf16.cuh) has no instance for: hidden layers
// of 256, three layers or two past 64 at the multi-product chains' 53 obs
// rows and 28 actions, 79 obs rows and 60 actions (ops/ppo_update.py
// ppo_update_bf16_plan chooses by the net's shape alone).  The same launch
// entry (ppo_update_bf16.cu) runs it; it reads the same float32 MlpLayout
// pack and rounds the weights to bf16 as it stages them.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/ppo_update_pallas.py:91 (make_ppo_update_grads)
// with compute_dtype=bfloat16: every product has bf16 operands where `_c`
// rounds them (`_dot`, `_dot_nt`, `_dot_tn`: the trunks, the mu and v heads,
// the input gradients and the weight gradients) and float32 accumulation;
// the biases, tanh, its derivative (1 - a^2 of the float32 activation), the
// loss, the log-prob terms and the bias and log_std gradients stay float32.
//
// Shape of the work: as ppo_update.cu (csrc/ppo_update.cuh): a grid (G, 2)
// of 512-thread blocks, y = 0 the actor, y = 1 the critic, each block walking
// its share of the 64-sample tiles with the next tile's inputs prefetched by
// cp.async; partial rows summed by ppo_reduce_kernel in a fixed order, so
// two launches on the same inputs give the same bits.
//
// Every product is mma.sync.m16n8k16 (bf16 in, float32 accumulate) over
// operand tiles in shared memory loaded with ldmatrix.  The net's weights
// sit in shared memory as w [Jp][ldw] bf16 (rows padded to 16, ldw =
// pad16(K) + 8 so the 8 rows of an 8x8 matrix fall in distinct bank quads;
// pm_section lays them out); the forward reads w, the input gradient w^T
// through ldmatrix.trans.  Activations and gradients sit feature-major,
// [rows][72] bf16 (144-byte rows, conflict-free), beside float32 copies
// [rows][68] for tanh's derivative and the bias sums:
// * forward Y = W X: A = w, B = X (.trans); a warp takes 16x8 output tiles;
// * input gradient dX = W^T dY, times 1 - a^2: A = w (.trans), B = dY
//   (.trans), written in place over the layer's input a (float32 and bf16:
//   nothing reads them after the weight gradient of that layer);
// * weight gradient dW += dY X^T, samples as the k axis: A = dY, B = X (both
//   plain ldmatrix); a warp holds fixed 16x8 tiles of every layer's dW
//   (tile i of the net's list in warp i % 16, slot i / 16) in registers for
//   the whole walk, and writes them once to the block's partial row.
//
// Bounds on the card: the bf16 tensor-core operations or the inputs read
// once, whichever takes longer for the net (chip_smoke.py phase 16 prints
// both for each net it runs).  This form is simple: one warp an mma, an
// ldmatrix for each operand fragment, a block barrier between layers, one
// block an SM (up to 227 KB of shared memory); G = 66 fills the 132 SMs.
#include <cuda_bf16.h>

#include "ppo_update.cuh"

#define PM_MAXQ 12  // 16x8 weight-gradient tiles a warp holds in registers
#define PM_MAXB 2   // bias-gradient registers a thread holds
#define PM_WARPS (PU_THREADS / 32)
#define PM_LDB 72   // row stride (bf16) of the bf16 tile buffers
#define PM_NT (PU_TS / 8)  // 8-sample n tiles a tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int pm_pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ unsigned pm_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void pm_ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(pm_smem(p))
      : "memory");
}

__device__ __forceinline__ void pm_ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(pm_smem(p))
      : "memory");
}

__device__ __forceinline__ void pm_ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(pm_smem(p))
               : "memory");
}

__device__ __forceinline__ void pm_ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(pm_smem(p))
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void pm_mma(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the 16x16 tile at (r0, c0) of a row-major buffer S
// [rows][ld]: lane l points at row r0 + l % 8 (+ 8 for matrices 1, 3),
// column c0 (+ 8 for matrices 2, 3).
__device__ __forceinline__ void pm_frag_a(uint32_t (&a)[4], const bf16* S,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  pm_ldsm_x4(a, S + (r0 + r + (mi & 1) * 8) * ld + c0 + (mi >> 1) * 8);
}

// The A fragment of the 16x16 tile at (r0, c0) of S^T, S row-major [rows]
// [ld]: S's rows c0.. are the tile's columns, read transposed.
__device__ __forceinline__ void pm_frag_a_t(uint32_t (&a)[4], const bf16* S,
                                         int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  pm_ldsm_x4_t(a, S + (c0 + r + (mi >> 1) * 8) * ld + r0 + (mi & 1) * 8);
}

// The B fragment (16x8) B[k][n] = S[k0 + k][n0 + n], S's rows the k axis
__device__ __forceinline__ void pm_frag_b_k(uint32_t (&b)[2], const bf16* S,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = (lane >> 3) & 1, r = lane & 7;
  pm_ldsm_x2_t(b, S + (k0 + r + mi * 8) * ld + n0);
}

// The B fragment (16x8) B[k][n] = S[n0 + n][k0 + k], S's rows the n axis
__device__ __forceinline__ void pm_frag_b_n(uint32_t (&b)[2], const bf16* S,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = (lane >> 3) & 1, r = lane & 7;
  pm_ldsm_x2(b, S + (n0 + r) * ld + k0 + mi * 8);
}

// Y[j][t] = sum_k w[j][k] X[k][t] + b[j] over the tile, tanh'd into Yf
// (float32) and Yb (bf16) for a hidden layer, as is into Yf for the head.
// A warp takes 16x8 output tiles; rows past J give tanh(0 + 0) = 0 (zero
// weight rows and biases), which the next layer's padding needs.
__device__ __forceinline__ void pm_forward(const bf16* W, const float* bias,
                                           const PuLayer& L, const bf16* X,
                                           float* Yf, bf16* Yb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldw = pm_pad16(L.K) + 8, nk = pm_pad16(L.K) >> 4;
  for (int tile = warp; tile < (L.Jp >> 4) * PM_NT; tile += PM_WARPS) {
    const int m0 = (tile / PM_NT) * 16, n0 = (tile % PM_NT) * 8;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t a[4], b[2];
      pm_frag_a(a, W, ldw, m0, kk * 16);
      pm_frag_b_k(b, X, PM_LDB, kk * 16, n0);
      pm_mma(c, a, b);
    }
    const int t = n0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = m0 + (lane >> 2) + 8 * h;
      float y0 = c[2 * h] + bias[j], y1 = c[2 * h + 1] + bias[j];
      if (Yb != nullptr) {
        y0 = tanhf(y0);
        y1 = tanhf(y1);
        *reinterpret_cast<__nv_bfloat162*>(Yb + j * PM_LDB + t) =
            __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<float2*>(Yf + j * PU_LD + t) = make_float2(y0, y1);
    }
  }
}

// dX[k][t] = sum_j w[j][k] dY[j][t], times 1 - a^2 with a = Af[k][t] the
// layer's float32 input: the gradient at the previous layer's output, in
// place over a (float32 into Af, bf16 into Ab).  dY's rows past J are zero
// and so are w's columns past K, so the padding rows come out zero.
__device__ __forceinline__ void pm_backward_input(const bf16* W,
                                                  const PuLayer& L,
                                                  const bf16* dY, float* Af,
                                                  bf16* Ab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldw = pm_pad16(L.K) + 8, nj = L.Jp >> 4;
  for (int tile = warp; tile < (pm_pad16(L.K) >> 4) * PM_NT;
       tile += PM_WARPS) {
    const int m0 = (tile / PM_NT) * 16, n0 = (tile % PM_NT) * 8;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int jj = 0; jj < nj; ++jj) {
      uint32_t a[4], b[2];
      pm_frag_a_t(a, W, ldw, m0, jj * 16);
      pm_frag_b_k(b, dY, PM_LDB, jj * 16, n0);
      pm_mma(c, a, b);
    }
    const int t = n0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = m0 + (lane >> 2) + 8 * h;
      float2* ap = reinterpret_cast<float2*>(Af + k * PU_LD + t);
      const float2 x = *ap;
      const float d0 = c[2 * h] * (1.0f - x.x * x.x);
      const float d1 = c[2 * h + 1] * (1.0f - x.y * x.y);
      *ap = make_float2(d0, d1);
      *reinterpret_cast<__nv_bfloat162*>(Ab + k * PM_LDB + t) =
          __floats2bfloat162_rn(d0, d1);
    }
  }
}

// The 16x8 weight-gradient tiles of a net, (m, n) of layer l numbered
// m * ceil(K/8) + n after the tiles of the layers before it; tile i lives
// in warp i % PM_WARPS, register slot i / PM_WARPS.  Layer l's tiles start
// at `off`, its biases at `boff`.
__device__ __forceinline__ void pm_offsets(const int* lay, int net, int l,
                                           int& off, int& boff) {
  off = 0;
  boff = 0;
  for (int i = 0; i < l; ++i) {
    const PuLayer L = pu_layer(lay, net, i);
    off += (L.Jp >> 4) * ((L.K + 7) >> 3);
    boff += L.J;
  }
}

// g[q] += dY X^T over the tile's samples, for the slots q of this layer
__device__ __forceinline__ void pm_grad_accum(float (&g)[PM_MAXQ][4],
                                              const bf16* dY, const bf16* X,
                                              const PuLayer& L, int off) {
  const int warp = threadIdx.x >> 5;
  const int nn = (L.K + 7) >> 3, n = (L.Jp >> 4) * nn;
#pragma unroll
  for (int q = 0; q < PM_MAXQ; ++q) {
    const int lid = warp + q * PM_WARPS - off;
    if (lid < 0 || lid >= n) continue;
    const int m0 = (lid / nn) * 16, n0 = (lid % nn) * 8;
#pragma unroll
    for (int t0 = 0; t0 < PU_TS; t0 += 16) {
      uint32_t a[4], b[2];
      pm_frag_a(a, dY, PM_LDB, m0, t0);
      pm_frag_b_n(b, X, PM_LDB, t0, n0);
      pm_mma(g[q], a, b);
    }
  }
}

// The sections of the nets in shared memory: each layer's w as bf16
// [pad16(J)][pad16(K) + 8], then the float32 biases (pad16(J) each) and, in
// the actor's, log_std (pad8(A)), a section padded to 4 words.  Rewrites
// the layout ints lay in place: each layer's Jp (16-padded), w_off (bf16
// elements) and b_off (words from the section's start), the sections'
// sizes (words) and log_std's offset; the gradient offsets stay.
static __device__ void pm_section(int* lay) {
  const int nL = lay[0], A = lay[2];
  for (int net = 0; net < 2; ++net) {
    int* rows = lay + PU_HEADER + net * (PU_MAX_L + 1) * PU_PER_LAYER;
    int w_el = 0;
    for (int l = 0; l <= nL; ++l) {
      int* r = rows + l * PU_PER_LAYER;
      r[2] = pm_pad16(r[1]);
      r[3] = w_el;
      w_el += r[2] * (pm_pad16(r[0]) + 8);
    }
    int words = w_el / 2;
    for (int l = 0; l <= nL; ++l) {
      int* r = rows + l * PU_PER_LAYER;
      r[4] = words;
      words += r[2];
    }
    if (net == 0) {
      lay[5] = words;
      words += pu_pad8(A);
    }
    lay[3 + net] = (words + 3) & ~3;
  }
}

__global__ void __launch_bounds__(PU_THREADS, 1)
ppo_grad_bf16_mma_kernel(const int* __restrict__ glay,
                         const float* __restrict__ gw,
                         const float* __restrict__ obs,
                         const float* __restrict__ pre,
                         const float* __restrict__ old_logp,
                         const float* __restrict__ adv,
                         const float* __restrict__ ret, int M, float clip,
                         float inv_m, float c_vf, float ent_coef, float c_reg,
                         float c_dreg, float* __restrict__ part) {
  __shared__ int lay[PU_LAYOUT_INTS];
  __shared__ float dl[PU_TS];
  __shared__ float lossbuf[PU_TS];
  extern __shared__ float4 dyn[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < PU_LAYOUT_INTS; i += PU_THREADS) lay[i] = glay[i];
  __syncthreads();
  // lay becomes the layout of the sections in shared memory; glay keeps
  // the float32 pack's, which the weights are copied from
  if (tid == 0) pm_section(lay);
  __syncthreads();
  const int net = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int nL = lay[0], O = lay[1], A = lay[2], ls_woff = lay[5];
  const int La = lay[6], Lc = lay[7], P = lay[8];
  const int wlen = net ? lay[4] : lay[3];
  const PuLayer head = pu_layer(lay, net, nL);
  const int R0 = pu_pad8(O), Ap = pu_pad8(A);
  const int slot_rows = R0 + A + 3;

  // shared memory, every piece a multiple of 16 bytes: the net's section
  // (bf16 weights, float32 biases and log_std), the bf16 tiles xb[l] (the
  // obs, then each hidden layer's output; in the backward the gradient at
  // that output), their float32 copies act[l], l >= 1, the head's output
  // hbuf (float32) and its gradient hb (bf16), z and the log-prob terms,
  // two input slots
  float* Wf = reinterpret_cast<float*>(dyn);
  const bf16* Wb = reinterpret_cast<const bf16*>(dyn);
  char* p = reinterpret_cast<char*>(Wf + wlen);
  bf16* xb[PU_MAX_L + 1];
  float* act[PU_MAX_L + 1];
  xb[0] = reinterpret_cast<bf16*>(p);
  p += pm_pad16(O) * PM_LDB * 2;
  for (int l = 1; l <= nL; ++l) {
    xb[l] = reinterpret_cast<bf16*>(p);
    p += pm_pad16(pu_layer(lay, net, l).K) * PM_LDB * 2;
  }
  act[0] = nullptr;
  for (int l = 1; l <= nL; ++l) {
    act[l] = reinterpret_cast<float*>(p);
    p += pm_pad16(pu_layer(lay, net, l).K) * PU_LD * 4;
  }
  float* hbuf = reinterpret_cast<float*>(p);
  p += head.Jp * PU_LD * 4;
  bf16* hb = reinterpret_cast<bf16*>(p);
  p += head.Jp * PM_LDB * 2;
  float* zb = reinterpret_cast<float*>(p);
  float* term = zb + Ap * PU_LD;
  float* slots[2] = {term + Ap * PU_LD, term + Ap * PU_LD + slot_rows * PU_LD};
  float* end = slots[1] + slot_rows * PU_LD;
  // zero everything (padding rows and columns stay zero), then the net's
  // weights from the float32 pack (w^T [K][pad8(J)] a layer), rounded to
  // bf16, the biases and log_std as they are
  for (float* q = Wf + tid; q < end; q += PU_THREADS) *q = 0.0f;
  __syncthreads();
  {
    const float* wsec = gw + (net ? glay[3] : 0);
    bf16* Ws = reinterpret_cast<bf16*>(dyn);
    for (int l = 0; l <= nL; ++l) {
      const PuLayer F = pu_layer(glay, net, l), L = pu_layer(lay, net, l);
      const int ldw = pm_pad16(L.K) + 8;
      for (int e = tid; e < F.K * F.Jp; e += PU_THREADS) {
        const int k = e / F.Jp, j = e - k * F.Jp;
        if (j < F.J)
          Ws[L.w_off + j * ldw + k] = __float2bfloat16_rn(wsec[F.w_off + e]);
      }
      for (int j = tid; j < F.J; j += PU_THREADS)
        Wf[L.b_off + j] = wsec[F.b_off + j];
    }
    if (net == 0)
      for (int i = tid; i < A; i += PU_THREADS)
        Wf[ls_woff + i] = wsec[glay[5] + i];
  }
  __syncthreads();

  const int nT = (M + PU_TS - 1) / PU_TS;
  const int t0 = (int)((long long)g * nT / G);
  const int t1 = (int)((long long)(g + 1) * nT / G);
  float loss_acc = 0.0f, gls = 0.0f;
  float gacc[PM_MAXQ][4];
  float gbias[PM_MAXB];
#pragma unroll
  for (int q = 0; q < PM_MAXQ; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) gacc[q][i] = 0.0f;
#pragma unroll
  for (int q = 0; q < PM_MAXB; ++q) gbias[q] = 0.0f;

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
    const float* xs = slots[cur];
    const float* pres = xs + R0 * PU_LD;
    const float* olps = pres + A * PU_LD;
    const float* advs = olps + PU_LD;
    const float* rets = advs + PU_LD;

    // ---- the obs in bf16, then the forward --------------------------------
    for (int e = tid; e < O * (PU_TS / 2); e += PU_THREADS) {
      const int k = e / (PU_TS / 2), t = (e % (PU_TS / 2)) * 2;
      const float2 v = *reinterpret_cast<const float2*>(xs + k * PU_LD + t);
      *reinterpret_cast<__nv_bfloat162*>(xb[0] + k * PM_LDB + t) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    __syncthreads();
    for (int l = 0; l < nL; ++l) {
      const PuLayer L = pu_layer(lay, net, l);
      pm_forward(Wb + L.w_off, Wf + L.b_off, L, xb[l], act[l + 1], xb[l + 1]);
      __syncthreads();
    }
    pm_forward(Wb + head.w_off, Wf + head.b_off, head, xb[nL], hbuf, nullptr);
    __syncthreads();

    // ---- per-sample loss terms and the head's output gradient -------------
    pu_tile_loss(net, A, Wf + ls_woff, hbuf, zb, term, pres, olps, advs,
                 rets, m0, M, clip, inv_m, c_vf, ent_coef, c_reg, c_dreg, dl,
                 lossbuf, loss_acc, gls);
    for (int e = tid; e < head.Jp * (PU_TS / 2); e += PU_THREADS) {
      const int j = e / (PU_TS / 2), t = (e % (PU_TS / 2)) * 2;
      const float2 v = *reinterpret_cast<const float2*>(hbuf + j * PU_LD + t);
      *reinterpret_cast<__nv_bfloat162*>(hb + j * PM_LDB + t) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    __syncthreads();

    // ---- backward, from the head down ---------------------------------------
    for (int l = nL; l >= 0; --l) {
      const PuLayer L = pu_layer(lay, net, l);
      const bf16* dYb = l == nL ? hb : xb[l + 1];
      const float* dYf = l == nL ? hbuf : act[l + 1];
      int off, boff;
      pm_offsets(lay, net, l, off, boff);
      pm_grad_accum(gacc, dYb, xb[l], L, off);
#pragma unroll
      for (int q = 0; q < PM_MAXB; ++q) {
        const int j = tid + q * PU_THREADS - boff;
        if (j >= 0 && j < L.J) {
          float s = 0.0f;
          for (int t = 0; t < PU_TS; ++t) s += dYf[j * PU_LD + t];
          gbias[q] += s;
        }
      }
      __syncthreads();
      if (l > 0) {
        pm_backward_input(Wb + L.w_off, L, dYb, act[l], xb[l]);
        __syncthreads();
      }
    }
  }

  // ---- the block's partial row ---------------------------------------------
  float* row = part + (size_t)g * P + (net ? La : 0);
  for (int l = 0; l <= nL; ++l) {
    const PuLayer L = pu_layer(lay, net, l);
    int off, boff;
    pm_offsets(lay, net, l, off, boff);
    const int nn = (L.K + 7) >> 3, n = (L.Jp >> 4) * nn;
#pragma unroll
    for (int q = 0; q < PM_MAXQ; ++q) {
      const int lid = warp + q * PM_WARPS - off;
      if (lid < 0 || lid >= n) continue;
      const int j0 = (lid / nn) * 16 + (lane >> 2);
      const int k0 = (lid % nn) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + 8 * (i >> 1), k = k0 + (i & 1);
        if (j < L.J && k < L.K) row[L.gw_off + j * L.K + k] = gacc[q][i];
      }
    }
#pragma unroll
    for (int q = 0; q < PM_MAXB; ++q) {
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

// threads a block, samples a tile, weight-gradient tiles a warp, bias slots
extern "C" int ppo_bf16_mma_consts(int* out) {
  out[0] = PU_THREADS;
  out[1] = PU_TS;
  out[2] = PM_MAXQ;
  out[3] = PM_MAXB;
  return 0;
}

// Launch the kernel (the entry ppo_update_bf16_launch then sums the
// partial rows); returns a cudaError_t.
int pm_launch(const int* layout, const float* weights, int smem_bytes, int G,
              const float* obs, const float* pre, const float* old_logp,
              const float* adv, const float* ret, int M, float clip,
              float inv_m, float c_vf, float ent_coef, float c_reg,
              float c_dreg, float* part, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ppo_grad_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ppo_grad_bf16_mma_kernel<<<dim3(G, 2), PU_THREADS, smem_bytes, stream>>>(
      layout, weights, obs, pre, old_logp, adv, ret, M, clip, inv_m, c_vf,
      ent_coef, c_reg, c_dreg, part);
  return (int)cudaGetLastError();
}

// Fused clipped-PPO update with bf16 products on Hopper's warpgroup tensor
// cores (wgmma): forward, loss and hand-derived backward of the
// actor-critic over M samples, in one pass per tile of 128 samples.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/ppo_update_pallas.py:91 (make_ppo_update_grads)
// with compute_dtype=bfloat16: every product has bf16 operands where `_c`
// rounds them (`_dot`, `_dot_nt`, `_dot_tn`: the trunks, the mu and v heads,
// the input gradients and the weight gradients) and float32 accumulation;
// the biases, tanh, its derivative (1 - a^2 of the float32 activation), the
// loss, the log-prob terms and the bias and log_std gradients stay float32.
//
// Shape of the work: a grid (G, 2) of 256-thread blocks, y = 0 the actor,
// y = 1 the critic, each block walking its share of the 128-sample tiles;
// partial rows summed by ppo_reduce_kernel in a fixed order, so two
// launches on the same inputs give the same bits.  The block is two
// warpgroups.  Warpgroup w carries samples [64w, 64w + 64) of the tile
// through the forward, the loss (pu_tile_loss_n) and the input gradients
// on its own, meeting only itself at named barriers (bar.sync 1 + w, 128);
// it fetches its own next inputs with cp.async as soon as the loss has read
// the current ones.  The block meets twice a tile: before the weight
// gradients, which contract the samples of both warpgroups, and after them.
//
// Every product is wgmma.mma_async m64nNk16, bf16 operands from 128-byte
// swizzled shared memory (descriptors, no ldmatrix), float32 accumulators,
// with the samples on the M axis wherever they are not the contraction:
// * forward Y^T[t][j] = X^T[t][k] W^T[k][j] (N = 64 a chunk; the head N =
//   16, the critic's one row padded to 16);
// * input gradient dX^T[t][k] = dY^T[t][j] W[j][k], times 1 - a^2;
// * weight gradient dW[j][k] += dY[j][t] X^T[t][k], the samples as the k
//   axis; the heads as dW^T[k][j] += X[k][t] dY^T[t][j], so J = 14 or 1
//   never pads a 64-row M.
// One layout serves every operand: rows of 64 bf16 (128 bytes), 16-byte
// chunk c of row r at chunk c ^ (r % 8), 64-column blocks of rows stacked.
// A weight W_l [J rows][K] is the K-major B of the forward and the N-major
// B of the input gradient; an activation or gradient [t rows][features]
// is the K-major A of the next product and the M-major A or N-major B of
// the weight gradients; the obs X0 [k rows][t] and the head gradient dH [j
// rows][t] are sample-trailing as the inputs arrive.
//
// Instances <H, NL, KP, HA>: hidden layers padded to H = 64 or 128, NL of
// them, the obs to KP rows and the heads to HA.  With KP = 32 and HA = 16:
// H 128 with 1-2 hidden layers, H 64 with 1-4; with KP = 64 and HA = 32
// (the multi-product chains): H 128 with one, H 64 with 1-3.  With H =
// 128 the weight gradients split by rows over the two warpgroups (rows 64w
// of every layer, and features 64w of the head), each over the tile's 128
// samples; with H = 64 each warpgroup holds all 64 rows over its own 64
// samples and the two are summed at the end.  Bias gradients are summed
// from the float32 dY while it is in registers: the fragment's two rows,
// then a reduce-scatter over lanes (shuffles 16, 8, 4), a fixed order, into
// the warp's partial row in shared memory.
//
// Budget, ntom (O 27, A 14), hidden (128, 128), a thread of a warpgroup:
// weight gradients 16 (layer 0, m64n32) + 64 (layer 1, 2 x m64n64) + 8 (head,
// m64n16) = 88 registers held for the walk; the last hidden layer's float32
// activation, held from the forward to the head's input gradient, 32 in
// registers and its second chunk in the warpgroup's dZ_0 half (dead until
// then); one 32-register chunk at work, two in the backward, where the
// first hidden layer's activation is recomputed from the bf16 obs and W_0
// in the same instruction shapes as the forward, so bit for bit (no room
// for its float32 copy).  ptxas: 255 registers, 0 spill bytes, 0 stack
// (chip_smoke.py phase 1; PERF.md).  Shared memory (PbSmem): bf16 weights
// 44 KB (W_0's rows 64.. beside rows 0..), obs 8 KB, activations 64 KB,
// gradients at the hidden layers 64 KB (each warpgroup's loss scratch in
// its dZ_1 half while that is dead), dH 4 KB, biases 1 KB, the warps' bias
// partials 8 KB, the two input slots 27 KB: 226,848 bytes with the
// alignment, one block an SM; G = 66 fills the 132 SMs.  The wide
// instances (KP 64, HA 32) hold dW_0 in m64n64 and the head's in m64n32
// (ptxas: <64,2,64,32> 232 registers, <128,1,64,32> 213, <64,1,64,32>
// 196, 0 spill bytes, 0 stack); their loss scratch fits no gradient half
// and takes 53 KB of its own: 223,904 and 228,000 bytes.  <64,3,64,32>
// moves each warpgroup's dH after its dZ half, which with it holds the
// scratch (kPackDH): 213,960 bytes where 266,848 would not fit.  The nets
// no instance takes run on the mma.sync kernel (ppo_update_bf16_mma.cu).
//
// Bounds on the card: bf16 tensor-core operations (57.9 GFLOP at ntom,
// hidden (128, 128), M = 245,760: 0.059 ms at 989 TFLOP/s); device memory
// traffic is the inputs read once (43 MB, 0.013 ms).
#pragma once

#include <cuda_bf16.h>

#include "ppo_update.cuh"

#define PB_THREADS 256                 // two warpgroups
#define PB_TS (2 * PU_TS)              // samples a tile: 64 a warpgroup

typedef __nv_bfloat16 bf16;

// Byte offsets of the dynamic shared memory of instance <H, NL, KP, HA>
// (from a 1024-byte boundary, the swizzle's period): hidden layers padded
// to H, NL of them, the obs to KP rows (32 or 64), the heads to HA (16 or
// 32).  Every bf16 buffer is made of 8 KB blocks of [64 rows][128 bytes]
// (or [rows][128 bytes] for the short ones).
template <int H, int NL, int KP, int HA>
struct PbSmem {
  static_assert((KP == 32 || KP == 64) && (HA == 16 || HA == 32), "KP, HA");
  static constexpr int kSR = KP + HA + 3;        // input-slot rows at most
  static constexpr int kScratchBytes = (3 * HA * PU_LD + 2 * PU_TS) * 4;
  // W_0: with KP = 32 row j in row j % 64, col 32 (j / 64) (one block);
  // with KP = 64 [H/64][64][64]
  static constexpr int kW0 = 0;
  static constexpr int kWl = H * H * 2;          // W_l, l >= 1: [H/64][H][64]
  static constexpr int kW = kW0 + (KP == 32 ? 64 : H) * 128;
  static constexpr int kWh = kW + (NL - 1) * kWl;        // [H/64][HA][64]
  static constexpr int kX0 = kWh + HA * H * 2;           // [2 halves][KP][64]
  static constexpr int kHalf = H * 128;          // 64 samples of a layer
  static constexpr int kA = kX0 + 2 * KP * 128;          // a_1..a_NL: [l][half]
  static constexpr int kDZ = kA + NL * 2 * kHalf;        // dZ_0..: [half][l]
  static constexpr int kDZHalf = NL * kHalf;
  static constexpr int kDHHalf = HA * 128;       // dH of 64 samples
  // where no dZ half holds a warpgroup's loss scratch but the half with
  // the warpgroup's dH after it does, dH moves there: [dZ half w][dH half
  // w] a warpgroup (the scratch's last rows, dead once the loss is taken,
  // lie under dH); else the dH halves follow the dZ halves
  static constexpr bool kPackDH =
      kDZHalf < kScratchBytes && kDZHalf + kDHHalf >= kScratchBytes;
  static constexpr int kDZStride = kDZHalf + (kPackDH ? kDHHalf : 0);
  static constexpr int kDH = kDZ + 2 * kDZStride;        // [2 halves][HA][64]
  static constexpr int kDHAt = kPackDH ? kDZ + kDZHalf : kDH;   // half 0's
  static constexpr int kDHStride = kPackDH ? kDZStride : kDHHalf;
  static constexpr int kBias =                           // b_l [H], bh, log_std
      kDH + (kPackDH ? 0 : 2 * kDHHalf);
  static constexpr int kBacc = kBias + (NL * H + 2 * HA) * 4;  // [8][NL][H]
  static constexpr int kSlot = kBacc + 8 * NL * H * 4;
  static constexpr int kSlotBytes = kSR * PU_LD * 4;     // a warpgroup's
  // the loss scratch of warpgroup w lies in its dZ half while that is
  // dead: at dZ_{NL-1} where a layer's half holds it (H = 128), else from
  // dZ_0 on; with H = 128 and two or more hidden layers, dZ_0's half holds
  // the last activation's second chunk (float32, [32][128 threads]) from
  // the forward to the head's input gradient
  static constexpr bool kOverlay = kDZStride >= kScratchBytes;
  static constexpr int kScratchAt =
      kHalf >= kScratchBytes ? (NL - 1) * kHalf : 0;
  static constexpr bool kStash = H == 128 && NL >= 2;
  static constexpr int kScratch = kSlot + 2 * kSlotBytes;  // if not overlaid
  static constexpr int kLay = kScratch + (kOverlay ? 0 : 2 * kScratchBytes);
  static constexpr int kBytes = kLay + PU_LAYOUT_INTS * 4;
};

__device__ __forceinline__ uint32_t pb_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte chunk c of 128-byte row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ int pb_swz(int r, int c) {
  return (c ^ (r & 7)) << 4;
}

// A wgmma descriptor, 128-byte swizzle: start address, leading byte offset
// (16 for a K-major operand, where it is unused; 1024 for an M/N-major one
// whose M or N is one 64-element row), stride byte offset 1024 (the next 8
// rows).
__device__ __forceinline__ uint64_t pb_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void pb_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void pb_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void pb_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pins accumulator registers in place around the asynchronous products.
template <int R>
__device__ __forceinline__ void pb_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void pb_zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// The warpgroup's barrier (ids 1 and 2; 0 is __syncthreads).
struct PbGroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
  }
};

// d (m64 nN, float32) += a b, bf16 operands; TA / TB: A M-major, B N-major
template <int TA, int TB>
__device__ __forceinline__ void pb_wgmma(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void pb_wgmma(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void pb_wgmma(float (&d)[8], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d += A B over k-steps [k0, k0 + nk) of 16: step s starts A at a + (s / 4)
// * a4 + (s % 4) * a1 (a1 = 32 bytes along a K-major row, 2048 = 16 rows of
// an M-major one; a4 the next column block or sample half), B alike.
template <int TA, int TB, int R>
__device__ __forceinline__ void pb_run(float (&d)[R], uint32_t a, int a4,
                                       int a1, uint32_t b, int b4, int b1,
                                       int k0, int nk) {
  for (int s = k0; s < k0 + nk; ++s)
    pb_wgmma<TA, TB>(
        d, pb_desc(a + (s >> 2) * a4 + (s & 3) * a1, TA ? 1024u : 16u),
        pb_desc(b + (s >> 2) * b4 + (s & 3) * b1, TB ? 1024u : 16u));
}

// Row (of 64) and column of value v of a thread's m64 accumulator fragment
// (wt the thread of the warpgroup): warp wt / 32 owns rows 16 (wt / 32) ..
// + 15; value v = 4 g + 2 h + e is row lane / 4 + 8 h, column 8 g + 2 (lane
// % 4) + e.
__device__ __forceinline__ int pb_frow(int wt, int v) {
  return ((wt >> 5) << 4) + ((wt & 31) >> 2) + (((v >> 1) & 1) << 3);
}

__device__ __forceinline__ int pb_fcol(int wt, int v) {
  return ((v >> 2) << 3) + ((wt & 3) << 1) + (v & 1);
}

__device__ __forceinline__ uint32_t pb_pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Values v, v + 1 of a 64x64 fragment, rounded to bf16, into the [64
// rows][64] block at blk (its row = the fragment's row).
__device__ __forceinline__ void pb_st2(unsigned char* blk, int wt, int v,
                                       float y0, float y1) {
  const int r = pb_frow(wt, v);
  *reinterpret_cast<uint32_t*>(blk + r * 128 + pb_swz(r, v >> 2) +
                               ((wt & 3) << 2)) = pb_pack(y0, y1);
}

// The column sums over the 64 rows of a 64x64 fragment d (consumed),
// added to the warp's partial row acc (shared memory) at columns 2 lane and
// 2 lane + 1: the thread's two rows, then a reduce-scatter over the eight
// lanes of a column (xor 16, 8, 4); a fixed order.  The warps' rows are
// summed in order at the end of the walk.  pb_scatter is one step: a lane
// keeps the lower N of d[0, 2N) if its bit BIT is clear, else the upper N,
// added to its partner's copy of them, into d[0, N).
template <int BIT, int N>
__device__ __forceinline__ void pb_scatter(float (&v)[32], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

__device__ __forceinline__ void pb_colsum(float (&d)[32], float* acc,
                                          int lane) {
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) d[2 * g + e] = d[4 * g + e] + d[4 * g + 2 + e];
  pb_scatter<16, 8>(d, lane);
  pb_scatter<8, 4>(d, lane);
  pb_scatter<4, 2>(d, lane);
  float2* p = reinterpret_cast<float2*>(acc + 2 * lane);
  float2 x = *p;
  x.x += d[0];
  x.y += d[1];
  *p = x;
}

// Forward products of hidden layer l, output chunk c (features 64c..), for
// warpgroup w's 64 samples: layer 0 reads the obs (M-major), later layers
// a_l (K-major); B is W_l (K-major).
template <int H, int NL, int KP, int HA>
__device__ __forceinline__ void pb_forward_mma(float (&d)[32], int l, int c,
                                               int w, int O, uint32_t sa) {
  using S = PbSmem<H, NL, KP, HA>;
  if (l == 0)
    pb_run<1, 0>(d, sa + S::kX0 + w * KP * 128, 8192, 2048,
                 sa + S::kW0 + c * (KP == 32 ? 64 : 8192), 0, 32, 0,
                 (O + 15) >> 4);
  else
    pb_run<0, 0>(d, sa + S::kA + (l - 1) * 2 * S::kHalf + w * S::kHalf,
                 8192, 32, sa + S::kW + (l - 1) * S::kWl + c * 8192, H * 128,
                 32, 0, H / 16);
}

template <int H, int NL, int KP, int HA>
__global__ void __launch_bounds__(PB_THREADS, 1)
ppo_grad_bf16_kernel(const int* __restrict__ glay,
                     const float* __restrict__ gw,
                     const float* __restrict__ obs,
                     const float* __restrict__ pre,
                     const float* __restrict__ old_logp,
                     const float* __restrict__ adv,
                     const float* __restrict__ ret, int M, float clip,
                     float inv_m, float c_vf, float ent_coef, float c_reg,
                     float c_dreg, float* __restrict__ part) {
  using S = PbSmem<H, NL, KP, HA>;
  constexpr int NC = H / 64;   // 64-feature chunks of a hidden layer
  constexpr bool RS = NC == 2;  // weight gradients split by rows, else samples
  constexpr int NKS = RS ? 8 : 4;  // sample k-steps of a weight gradient
  extern __shared__ __align__(16) unsigned char pb_dyn[];
  const uint32_t raw = pb_smem(pb_dyn);
  const uint32_t sa = (raw + 1023u) & ~1023u;
  unsigned char* sm = pb_dyn + (sa - raw);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127, lane = tid & 31;
  int* lay = reinterpret_cast<int*>(sm + S::kLay);
  for (int i = tid; i < S::kBytes / 16; i += PB_THREADS)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int i = tid; i < PU_LAYOUT_INTS; i += PB_THREADS) lay[i] = glay[i];
  __syncthreads();
  const int net = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int O = lay[1], A = lay[2];
  const float* wsec = gw + (net ? lay[3] : 0);

  // the net's weights, rounded to bf16 and swizzled, from the float32
  // section MlpLayout packs (w^T [K][Jp], then b [Jp], a layer); biases
  // and log_std float32.  Everything past [J, K] stays zero.
  float* bias = reinterpret_cast<float*>(sm + S::kBias);
  for (int l = 0; l <= NL; ++l) {
    const PuLayer L = pu_layer(lay, net, l);
    const int base = l == NL ? S::kWh : l == 0 ? S::kW0 : S::kW + (l - 1) * S::kWl;
    // [H/64 or 1 column blocks][rows][64] for W_l and the head; W_0 (K <=
    // KP) as [H/64][64][64], or with KP = 32 rows 64.. beside rows 0.., in
    // columns 32..
    const int blk = (l == NL ? HA : H) * 128;
    for (int e = tid; e < L.K * L.Jp; e += PB_THREADS) {
      const int k = e / L.Jp, j = e - k * L.Jp;
      const int r = l == 0 ? j & 63 : j;
      const int c = l == 0 && KP == 32 ? k + 32 * (j >> 6) : k;
      const int b = l == 0 ? (KP == 32 ? 0 : (j >> 6) * 8192)
                           : (c >> 6) * blk;
      if (j < L.J)
        *reinterpret_cast<bf16*>(sm + base + b + r * 128 +
                                 pb_swz(r, (c & 63) >> 3) + (c & 7) * 2) =
            __float2bfloat16_rn(wsec[L.w_off + e]);
    }
    for (int j = tid; j < L.J; j += PB_THREADS)
      bias[l * H + j] = wsec[L.b_off + j];
  }
  float* ls_raw = bias + NL * H + HA;
  if (net == 0)
    for (int i = tid; i < A; i += PB_THREADS) ls_raw[i] = wsec[lay[5] + i];
  pb_proxy_fence();
  __syncthreads();

  // the warpgroup's input slot
  const int R0 = pu_pad8(O);
  float* slot = reinterpret_cast<float*>(sm + S::kSlot + w * S::kSlotBytes);
  const PbGroupSync wsync{1 + w};

  // held for the walk: the weight gradients (rows 64w of every layer with
  // RS, else all 64 rows over the warpgroup's samples), the head's bias,
  // the loss and log_std; the warp's hidden-layer bias partials lie in
  // shared memory, [8 warps][NL][H] at kBacc
  float dw0[KP / 2], dwh[HA / 2], dwl[NL > 1 ? NL - 1 : 1][NC][32];
  float* bacc = reinterpret_cast<float*>(sm + S::kBacc) + (tid >> 5) * NL * H;
  float hacc[HA / 16], loss_acc = 0.0f, gls = 0.0f;
  pb_zero(dw0);
  pb_zero(dwh);
  pb_zero(hacc);
#pragma unroll
  for (int l = 0; l < (NL > 1 ? NL - 1 : 1); ++l)
#pragma unroll
    for (int c = 0; c < NC; ++c) pb_zero(dwl[l][c]);
  // the last hidden layer's float32 activation (its second chunk in
  // shared memory with kStash)
  float aL[S::kStash ? 1 : NC][32];
  float* stash = reinterpret_cast<float*>(sm + S::kDZ + w * S::kDZStride) + wt;

  const int nP = (M + PB_TS - 1) / PB_TS;
  const int p0 = (int)((long long)g * nP / G);
  const int p1 = (int)((long long)(g + 1) * nP / G);
  if (p0 < p1)
    pu_fetch_n<128>(wt, slot, net, O, A, R0, p0 * PB_TS + w * PU_TS, M, obs,
                    pre, old_logp, adv, ret);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    const int m0 = p * PB_TS + w * PU_TS;
    // the slot's rows and the loss scratch, made anew a tile so that they
    // need no register across the walk
    const float* pres = slot + R0 * PU_LD;
    const float* olps = pres + A * PU_LD;
    const float* advs = olps + PU_LD;
    const float* rets = advs + PU_LD;
    float* hbuf = reinterpret_cast<float*>(
        sm + (S::kOverlay ? S::kDZ + w * S::kDZStride + S::kScratchAt
                          : S::kScratch + w * S::kScratchBytes));
    float* zb = hbuf + HA * PU_LD;
    // with dH packed after the dZ half, term goes last, under dH
    float* dl = zb + (S::kPackDH ? 1 : 2) * HA * PU_LD;
    float* lossbuf = dl + PU_TS;
    float* term = S::kPackDH ? lossbuf + PU_TS : zb + HA * PU_LD;
    cp_async_wait0();
    wsync();

    // ---- the obs in bf16 (rows k < O of X0's half w), then the forward ----
    for (int e = wt; e < O * 8; e += 128) {
      const int k = e >> 3, c = e & 7;
      const float4 u = *reinterpret_cast<const float4*>(slot + k * PU_LD + 8 * c);
      const float4 v =
          *reinterpret_cast<const float4*>(slot + k * PU_LD + 8 * c + 4);
      *reinterpret_cast<uint4*>(sm + S::kX0 + w * KP * 128 + k * 128 +
                                pb_swz(k, c)) =
          make_uint4(pb_pack(u.x, u.y), pb_pack(u.z, u.w), pb_pack(v.x, v.y),
                     pb_pack(v.z, v.w));
    }
    pb_proxy_fence();
    wsync();
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* b = bias + l * H;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float acc[32];
        pb_zero(acc);
        pb_pin(acc);
        pb_wg_fence();
        pb_forward_mma<H, NL, KP, HA>(acc, l, c, w, O, sa);
        pb_commit_wait();
        pb_pin(acc);
        unsigned char* dst =
            sm + S::kA + l * 2 * S::kHalf + w * S::kHalf + c * 8192;
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const float2 bb = *reinterpret_cast<const float2*>(
              b + 64 * c + pb_fcol(wt, v));
          const float y0 = tanhf(acc[v] + bb.x), y1 = tanhf(acc[v + 1] + bb.y);
          if (l == NL - 1 && S::kStash && c == 1) {
            stash[v * 128] = y0;
            stash[(v + 1) * 128] = y1;
          } else if (l == NL - 1) {
            aL[S::kStash ? 0 : c][v] = y0;
            aL[S::kStash ? 0 : c][v + 1] = y1;
          }
          pb_st2(dst, wt, v, y0, y1);
        }
      }
      pb_proxy_fence();
      wsync();
    }
    {  // the head, N = HA: mu (A rows) or v (1 row) into hbuf [j][t]
      float acc[HA / 2];
      pb_zero(acc);
      pb_pin(acc);
      pb_wg_fence();
      pb_run<0, 0>(acc, sa + S::kA + (NL - 1) * 2 * S::kHalf + w * S::kHalf,
                   8192, 32, sa + S::kWh, HA * 128, 32, 0, H / 16);
      pb_commit_wait();
      pb_pin(acc);
      const float* bh = bias + NL * H;
#pragma unroll
      for (int v = 0; v < HA / 2; ++v) {
        const int j = pb_fcol(wt, v);
        hbuf[j * PU_LD + pb_frow(wt, v)] = acc[v] + bh[j];
      }
    }
    wsync();

    // ---- per-sample loss terms and the head's output gradient -------------
    pu_tile_loss_n<128>(wt, wsync, net, A, ls_raw, hbuf, zb, term, pres, olps,
                        advs, rets, m0, M, clip, inv_m, c_vf, ent_coef, c_reg,
                        c_dreg, dl, lossbuf, loss_acc, gls);
    // the slot is read: fetch the next tile's inputs into it
    if (p + 1 < p1)
      pu_fetch_n<128>(wt, slot, net, O, A, R0, m0 + PB_TS, M, obs, pre,
                      old_logp, adv, ret);
    cp_async_commit();
    // dH in bf16 into its half (row j, 8 samples a thread, 16 rows at a
    // time); the head's bias gradient, 8 samples a thread then a fixed
    // shuffle tree
#pragma unroll
    for (int q = 0; q < HA / 16; ++q) {
      const int j = 16 * q + (wt >> 3), c = wt & 7;
      const float4 u = *reinterpret_cast<const float4*>(hbuf + j * PU_LD + 8 * c);
      const float4 v =
          *reinterpret_cast<const float4*>(hbuf + j * PU_LD + 8 * c + 4);
      float s = ((u.x + u.y) + (u.z + u.w)) + ((v.x + v.y) + (v.z + v.w));
      *reinterpret_cast<uint4*>(sm + S::kDHAt + w * S::kDHStride + j * 128 +
                                pb_swz(j, c)) =
          make_uint4(pb_pack(u.x, u.y), pb_pack(u.z, u.w), pb_pack(v.x, v.y),
                     pb_pack(v.z, v.w));
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      hacc[q] += s;
    }
    pb_proxy_fence();
    wsync();

    // ---- backward through the warpgroup's samples --------------------------
    // the head's input gradient dX^T = dH^T Wh (A: dH M-major, B: Wh
    // N-major), times 1 - a^2 of the last hidden layer: dZ_{NL-1}
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float acc[32];
      pb_zero(acc);
      pb_pin(acc);
      pb_wg_fence();
      pb_run<1, 1>(acc, sa + S::kDHAt + w * S::kDHStride, 0, 2048,
                   sa + S::kWh + c * HA * 128, 0, 2048, 0, HA / 16);
      pb_commit_wait();
      pb_pin(acc);
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const float a =
            S::kStash && c == 1 ? stash[v * 128] : aL[S::kStash ? 0 : c][v];
        acc[v] *= 1.0f - a * a;
      }
      unsigned char* dst = sm + S::kDZ + w * S::kDZStride +
                           (NL - 1) * S::kHalf + c * 8192;
#pragma unroll
      for (int v = 0; v < 32; v += 2) pb_st2(dst, wt, v, acc[v], acc[v + 1]);
      pb_colsum(acc, bacc + (NL - 1) * H + 64 * c, lane);
    }
    pb_proxy_fence();
    wsync();
    // hidden layer i's input gradient dZ_i W_i (A: dZ_i K-major, B: W_i
    // N-major), times 1 - a_i^2, with a_i recomputed from layer i - 1
#pragma unroll
    for (int i = NL - 1; i >= 1; --i) {
      const float* b = bias + (i - 1) * H;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float ar[32], acc[32];
        pb_zero(ar);
        pb_zero(acc);
        pb_pin(ar);
        pb_pin(acc);
        pb_wg_fence();
        pb_forward_mma<H, NL, KP, HA>(ar, i - 1, c, w, O, sa);
        pb_run<0, 1>(acc, sa + S::kDZ + w * S::kDZStride + i * S::kHalf, 8192,
                     32, sa + S::kW + (i - 1) * S::kWl + c * H * 128, 8192,
                     2048, 0, H / 16);
        pb_commit_wait();
        pb_pin(ar);
        pb_pin(acc);
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const float2 bb = *reinterpret_cast<const float2*>(
              b + 64 * c + pb_fcol(wt, v));
          const float a0 = tanhf(ar[v] + bb.x), a1 = tanhf(ar[v + 1] + bb.y);
          acc[v] *= 1.0f - a0 * a0;
          acc[v + 1] *= 1.0f - a1 * a1;
        }
        unsigned char* dst = sm + S::kDZ + w * S::kDZStride +
                             (i - 1) * S::kHalf + c * 8192;
#pragma unroll
        for (int v = 0; v < 32; v += 2) pb_st2(dst, wt, v, acc[v], acc[v + 1]);
        pb_colsum(acc, bacc + (i - 1) * H + 64 * c, lane);
      }
      pb_proxy_fence();
      wsync();
    }

    // ---- weight gradients: the block meets, then contracts the samples ----
    __syncthreads();
    {
      const int jb = RS ? w : 0, k0 = RS ? 0 : 4 * w;
      pb_pin(dw0);
      pb_pin(dwh);
#pragma unroll
      for (int l = 0; l + 1 < NL; ++l)
#pragma unroll
        for (int c = 0; c < NC; ++c) pb_pin(dwl[l][c]);
      pb_wg_fence();
      // head: dWh^T[f][j] += a_NL[t][f] dH[j][t]
      pb_run<1, 0>(dwh, sa + S::kA + (NL - 1) * 2 * S::kHalf + jb * 8192,
                   S::kHalf, 2048, sa + S::kDHAt, S::kDHStride, 32, k0, NKS);
      // hidden layer l >= 1: dW_l[j][f] += dZ_l[t][j] a_l[t][f]
#pragma unroll
      for (int l = 1; l < NL; ++l)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          pb_run<1, 1>(dwl[l - 1][c], sa + S::kDZ + l * S::kHalf + jb * 8192,
                       S::kDZStride, 2048,
                       sa + S::kA + (l - 1) * 2 * S::kHalf + c * 8192,
                       S::kHalf, 2048, k0, NKS);
      // layer 0: dW_0[j][k] += dZ_0[t][j] X0[k][t]
      pb_run<1, 0>(dw0, sa + S::kDZ + jb * 8192, S::kDZStride, 2048,
                   sa + S::kX0, KP * 128, 32, k0, NKS);
      pb_commit_wait();
      pb_pin(dw0);
      pb_pin(dwh);
#pragma unroll
      for (int l = 0; l + 1 < NL; ++l)
#pragma unroll
        for (int c = 0; c < NC; ++c) pb_pin(dwl[l][c]);
    }
    __syncthreads();
  }

  // ---- the block's partial row (the tile buffers are free now) ------------
  __syncthreads();
  const int La = lay[6], Lc = lay[7], P = lay[8];
  const float* red = reinterpret_cast<const float*>(sm + S::kBacc);
  float* red2 = reinterpret_cast<float*>(sm + S::kA);  // head bias, log_std,
  float* red3 = red2 + 4 * HA + 2;  // loss; warpgroup 1's weight gradients
  if ((wt & 7) == 0)
#pragma unroll
    for (int q = 0; q < HA / 16; ++q) red2[w * HA + 16 * q + (wt >> 3)] = hacc[q];
  if (wt < HA) red2[(2 + w) * HA + wt] = gls;
  if (wt == 0) red2[4 * HA + w] = loss_acc;
  if (!RS && w == 1) {
    int r = 0;
#pragma unroll
    for (int v = 0; v < KP / 2; ++v) red3[(r++) * 128 + wt] = dw0[v];
#pragma unroll
    for (int l = 0; l + 1 < NL; ++l)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int v = 0; v < 32; ++v) red3[(r++) * 128 + wt] = dwl[l][c][v];
#pragma unroll
    for (int v = 0; v < HA / 2; ++v) red3[(r++) * 128 + wt] = dwh[v];
  }
  __syncthreads();
  float* row = part + (size_t)g * P + (net ? La : 0);
  if (RS || w == 0) {
    const int jr0 = RS ? 64 * w : 0;
    int r = 0;
    {
      const PuLayer L = pu_layer(lay, net, 0);
#pragma unroll
      for (int v = 0; v < KP / 2; ++v, ++r) {
        const float x = dw0[v] + (RS ? 0.0f : red3[r * 128 + wt]);
        const int j = jr0 + pb_frow(wt, v), k = pb_fcol(wt, v);
        if (j < L.J && k < L.K) row[L.gw_off + j * L.K + k] = x;
      }
    }
#pragma unroll
    for (int l = 1; l < NL; ++l) {
      const PuLayer L = pu_layer(lay, net, l);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int v = 0; v < 32; ++v, ++r) {
          const float x = dwl[l - 1][c][v] + (RS ? 0.0f : red3[r * 128 + wt]);
          const int j = jr0 + pb_frow(wt, v), k = 64 * c + pb_fcol(wt, v);
          if (j < L.J && k < L.K) row[L.gw_off + j * L.K + k] = x;
        }
    }
    {
      const PuLayer L = pu_layer(lay, net, NL);
#pragma unroll
      for (int v = 0; v < HA / 2; ++v, ++r) {
        const float x = dwh[v] + (RS ? 0.0f : red3[r * 128 + wt]);
        const int f = jr0 + pb_frow(wt, v), j = pb_fcol(wt, v);
        if (j < L.J && f < L.K) row[L.gw_off + j * L.K + f] = x;
      }
    }
  }
  for (int e = tid; e < NL * H; e += PB_THREADS) {
    const int l = e / H, f = e - l * H;
    const PuLayer L = pu_layer(lay, net, l);
    if (f < L.J) {
      float s = 0.0f;
      for (int q = 0; q < 8; ++q) s += red[(q * NL + l) * H + f];
      row[L.gb_off + f] = s;
    }
  }
  {
    const PuLayer L = pu_layer(lay, net, NL);
    if (tid < L.J) row[L.gb_off + tid] = red2[tid] + red2[HA + tid];
  }
  row = part + (size_t)g * P;
  const float loss = red2[4 * HA] + red2[4 * HA + 1];
  if (net == 0) {
    if (tid < A) row[La + Lc + tid] = red2[2 * HA + tid] + red2[3 * HA + tid];
    if (tid == 0) row[P - 2] = loss;
  } else if (tid == 0) {
    row[P - 1] = loss;
  }
}

// Launch instance <H, NL, KP, HA>; returns a cudaError_t.
template <int H, int NL, int KP, int HA>
static int pb_launch(const int* layout, const float* weights, int smem_bytes,
                     int G, const float* obs, const float* pre,
                     const float* old_logp, const float* adv, const float* ret,
                     int M, float clip, float inv_m, float c_vf,
                     float ent_coef, float c_reg, float c_dreg, float* part,
                     cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ppo_grad_bf16_kernel<H, NL, KP, HA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ppo_grad_bf16_kernel<H, NL, KP, HA>
      <<<dim3(G, 2), PB_THREADS, smem_bytes, stream>>>(
      layout, weights, obs, pre, old_logp, adv, ret, M, clip, inv_m, c_vf,
      ent_coef, c_reg, c_dreg, part);
  return (int)cudaGetLastError();
}

#define PB_LAUNCH_ARGS                                                        \
  const int *layout, const float *weights, int smem_bytes, int G,            \
      const float *obs, const float *pre, const float *old_logp,             \
      const float *adv, const float *ret, int M, float clip, float inv_m,    \
      float c_vf, float ent_coef, float c_reg, float c_dreg, float *part,    \
      cudaStream_t stream
#define PB_LAUNCH_PASS                                                        \
  layout, weights, smem_bytes, G, obs, pre, old_logp, adv, ret, M, clip,      \
      inv_m, c_vf, ent_coef, c_reg, c_dreg, part, stream

// The H = 64 instances live in ppo_update_bf16_h64.cu, those with 64 obs
// rows and 32 head rows in ppo_update_bf16_wide.cu (built in parallel).
int pb_launch_h64(int NL, PB_LAUNCH_ARGS);
int pb_launch_wide(int H, int NL, PB_LAUNCH_ARGS);

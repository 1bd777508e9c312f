// The bf16 mode of the fused PPO update (the kernel: ppo_update_bf16.cuh):
// its H = 128 instances with up to 32 obs rows and 16 head rows, the launch
// entry of both of the mode's kernels, and the constants and shared memory
// the wrapper (ops/ppo_update.py) takes from the library.
#include "ppo_update_bf16.cuh"

// the mma.sync kernel (ppo_update_bf16_mma.cu), for the nets no instance
// of the wgmma kernel takes
int pm_launch(PB_LAUNCH_ARGS);

// threads a block, samples a tile
extern "C" int ppo_bf16_kernel_consts(int* out) {
  out[0] = PB_THREADS;
  out[1] = PB_TS;
  return 0;
}

#define PB_INSTANCES(X)                                                      \
  X(128, 1, 32, 16) X(128, 2, 32, 16) X(64, 1, 32, 16) X(64, 2, 32, 16)      \
  X(64, 3, 32, 16) X(64, 4, 32, 16) X(128, 1, 64, 32) X(64, 1, 64, 32)       \
  X(64, 2, 64, 32) X(64, 3, 64, 32)

// dynamic shared memory of instance <H, NL, KP, HA>, its alignment
// included; -1 where there is no such instance
extern "C" int ppo_bf16_smem_bytes(int H, int NL, int KP, int HA) {
#define PB_SMEM(h, nl, kp, ha)                                 \
  if (H == h && NL == nl && KP == kp && HA == ha)              \
    return PbSmem<h, nl, kp, ha>::kBytes + 1024;
  PB_INSTANCES(PB_SMEM)
#undef PB_SMEM
  return -1;
}

// kernel 0: the wgmma instance <H, NL, KP, HA>; kernel 1: the mma.sync
// kernel (H, NL, KP, HA unused)
extern "C" int ppo_update_bf16_launch(const int* layout, const float* weights,
                                      int smem_bytes, int G, const float* obs,
                                      const float* pre, const float* old_logp,
                                      const float* adv, const float* ret,
                                      int M, float clip, float inv_m,
                                      float c_vf, float ent_coef, float c_reg,
                                      float c_dreg, float* part, float* out,
                                      int P, void* stream_ptr, int kernel,
                                      int H, int NL, int KP, int HA) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int e = -7;
  if (kernel == 1)  // mma.sync, any net (the wrapper's plan checks it)
    e = pm_launch(PB_LAUNCH_PASS);
  else if (kernel != 0)
    e = -7;
  else if (KP == 64)
    e = pb_launch_wide(H, NL, PB_LAUNCH_PASS);
  else if (H == 64)
    e = pb_launch_h64(NL, PB_LAUNCH_PASS);
  else if (NL == 1)
    e = pb_launch<128, 1, 32, 16>(PB_LAUNCH_PASS);
  else if (NL == 2)
    e = pb_launch<128, 2, 32, 16>(PB_LAUNCH_PASS);
  if (e != 0) return e;
  ppo_reduce_kernel<<<(P + 255) / 256, 256, 0, stream>>>(part, G, P, out);
  return (int)cudaGetLastError();
}

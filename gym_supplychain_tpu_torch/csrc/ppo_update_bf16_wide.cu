// The wide instances of the bf16 update kernel (ppo_update_bf16.cuh): up to
// 64 obs rows and 32 head rows (the multi-product chains, O = 53, A = 28),
// hidden layers of at most 64 units (one to three) or one of at most 128.
// A source of their own, so that nvcc builds them beside the others.
#include "ppo_update_bf16.cuh"

int pb_launch_wide(int H, int NL, PB_LAUNCH_ARGS) {
  if (H == 64 && NL == 1) return pb_launch<64, 1, 64, 32>(PB_LAUNCH_PASS);
  if (H == 64 && NL == 2) return pb_launch<64, 2, 64, 32>(PB_LAUNCH_PASS);
  if (H == 64 && NL == 3) return pb_launch<64, 3, 64, 32>(PB_LAUNCH_PASS);
  if (H == 128 && NL == 1) return pb_launch<128, 1, 64, 32>(PB_LAUNCH_PASS);
  return -7;
}

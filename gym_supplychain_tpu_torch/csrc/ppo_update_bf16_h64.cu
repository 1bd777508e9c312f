// The H = 64 instances of the bf16 update kernel (ppo_update_bf16.cuh) with
// up to 32 obs rows and 16 head rows: hidden layers of at most 64 units,
// one to four of them.  A source of their own, so that nvcc builds them
// beside the others.
#include "ppo_update_bf16.cuh"

int pb_launch_h64(int NL, PB_LAUNCH_ARGS) {
  switch (NL) {
    case 1: return pb_launch<64, 1, 32, 16>(PB_LAUNCH_PASS);
    case 2: return pb_launch<64, 2, 32, 16>(PB_LAUNCH_PASS);
    case 3: return pb_launch<64, 3, 32, 16>(PB_LAUNCH_PASS);
    case 4: return pb_launch<64, 4, 32, 16>(PB_LAUNCH_PASS);
  }
  return -7;
}

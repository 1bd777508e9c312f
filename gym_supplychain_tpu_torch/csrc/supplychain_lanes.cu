// K1 in its modes `random` and `actions`: the instances of the lane-group
// kernel (supplychain_lanes.cuh, where its layout, step and bounds are set
// out) for the chains within the collect kernel's limits
// (ops/supplychain_collect.py _MAX), which ops/supplychain_collect.py
// launches through ops/supplychain_dense.py's launch_lanes.
//
// Replaces the TPU kernel `_collect_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py in its PRNG and table modes
// (make_supplychain_collect_pallas); its policy modes run the policy lane
// kernel of supplychain_policy.cu on the same step.
//
// A group of G = 4, 8 or 16 lanes an env (the least that holds max(N*P,
// shipping nodes): 4 for supplychain-linear-v0, 8 for supplychain-ntom-v0)
// and E = 8 envs a block, so at B = 4096 the 16,384 or 32,768 threads spread
// over all 132 SMs of the H100 where one thread an env filled 32 of them,
// each thread's serial chain a step shrinks to its lanes' share, and the
// obs write-out runs are one 32-byte sector.
#include "supplychain_lanes.cuh"

// G, E, DT >= dmax slots a node, OBS: the instances built, as lane_block in
// ops/supplychain_dense.py plans them (4 lanes hold at most 4 nodes, so at
// most 3 slots a node)
extern "C" int sc_lane_launch(LN_ENTRY_ARGS) {
  const int bad = ln_check(desc_bytes, mode, OBS, E, stride, smem_bytes);
  if (bad != 0) return bad;
  LN_CASE(4, 8, 2, 1) LN_CASE(4, 8, 4, 1)
  LN_CASE(8, 8, 2, 1) LN_CASE(8, 8, 4, 1) LN_CASE(8, 8, 10, 1)
  LN_CASE(16, 8, 2, 1) LN_CASE(16, 8, 4, 1) LN_CASE(16, 8, 10, 1)
  return -6;
}

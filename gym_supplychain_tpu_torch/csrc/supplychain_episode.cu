// K6a, the rewards-only episode kernel, in its modes `seeded` and
// `actions`: the instances of the lane-group kernel (supplychain_lanes.cuh,
// where its layout, step and bounds are set out) without the observation
// stream (OBS = 0), which ops/supplychain_episode.py launches through
// ops/supplychain_dense.py's launch_lanes.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas.py in its modes `seeded` and
// `actions` (make_supplychain_episode_pallas): one episode of T steps from
// demand [T+1,R,P,B] and lead-time [T,K,B] tables, its actions from a table
// or from Philox at counter (lane, step, block, 0), writing only the reward
// [T,B] and the final stock.  K4 (`policy`) runs the policy lane kernel of
// supplychain_policy.cu on the same step.  Lanes and envs a block as K1's
// (supplychain_lanes.cu).
#include "supplychain_lanes.cuh"

// G, E, DT >= dmax slots a node, OBS: the instances built, as lane_block in
// ops/supplychain_dense.py plans them (4 lanes hold at most 4 nodes, so at
// most 3 slots a node)
extern "C" int sc_episode_launch(LN_ENTRY_ARGS) {
  const int bad = ln_check(desc_bytes, mode, OBS, E, stride, smem_bytes);
  if (bad != 0) return bad;
  LN_CASE(4, 8, 2, 0) LN_CASE(4, 8, 4, 0)
  LN_CASE(8, 8, 2, 0) LN_CASE(8, 8, 4, 0) LN_CASE(8, 8, 10, 0)
  LN_CASE(16, 8, 2, 0) LN_CASE(16, 8, 4, 0) LN_CASE(16, 8, 10, 0)
  return -6;
}

// K5: supply-chain trajectory collection for large chains (26-40 nodes and
// more), a group of 16 lanes per environment, 8 envs a block, its state in
// shared memory: the instances of the lane-group kernel
// (supplychain_lanes.cuh, where its layout, step and bounds are set out)
// that ops/supplychain_dense.py launches.
//
// Replaces the TPU kernel `_kernel` of
// gym_supplychain_tpu/ops/supplychain_pallas_dense.py
// (make_supplychain_dense_collect_pallas) in its modes `random` and
// `actions`.  16 lanes an env, 8 envs a block and 4 blocks an SM hold all of
// B = 4096 envs at once, 15-16 warps an SM; on the H100, 16 lanes beat 8 (a
// longer ship phase per lane) and 32 (registers for 2 blocks an SM only:
// two waves at 4096 envs) on each of the large-topology benchmark's chains.
// The bound on the card is the obs stream (S * O * B * 4 bytes, 2.09 GB an
// episode at [5,4,7,10] x 4 and B = 4096); the step is latency-bound.
#include "supplychain_lanes.cuh"

// G, E and DT >= dmax slots a node: the instances built (OBS = 1)
extern "C" int sc_dense_launch(LN_ENTRY_ARGS) {
  const int bad = ln_check(desc_bytes, mode, OBS, E, stride, smem_bytes);
  if (bad != 0) return bad;
  LN_CASE(16, 8, 2, 1) LN_CASE(16, 8, 4, 1) LN_CASE(16, 8, 10, 1)
  LN_CASE(16, 8, 16, 1)
  return -6;
}

extern "C" int dn_chain_bytes() { return (int)sizeof(DnChain); }
extern "C" int dn_edges_bytes() { return (int)sizeof(DnEdges); }
